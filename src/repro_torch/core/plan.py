"""OverlapPlan — the deployable artifact the LC-OPG solver emits
(paper: "a reusable overlap plan that incurs no runtime overhead").

Maps every op index to the weight-chunk load tasks issued there, carries the
preload set, serializes to JSON, and provides:

  * an analytic simulator (HWSpec-based) producing integrated-latency and
    residency timelines — used by benchmarks to sweep configurations the CPU
    cannot execute at full scale, and
  * naive baseline plan constructors (Always-Next, Same-Op-Type, Preload-All)
    for the Fig 9 comparison.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.capacity import HWSpec, THRESHOLDS
from repro_torch.core.graph import ModelGraph
from repro_torch.core.opg import OPGProblem, OPGSolution


@dataclass(frozen=True)
class LoadTask:
    weight: str
    chunk_lo: int
    chunk_hi: int          # exclusive

    @property
    def n_chunks(self) -> int:
        return self.chunk_hi - self.chunk_lo


@dataclass
class OverlapPlan:
    model: str
    chunk_bytes: int
    preload: tuple
    loads: Dict[int, List[LoadTask]] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @staticmethod
    def from_solution(prob: OPGProblem, sol: OPGSolution) -> "OverlapPlan":
        plan = OverlapPlan(model=prob.graph.name, chunk_bytes=prob.chunk_bytes,
                           preload=tuple(sorted(sol.preload)),
                           meta={"status": sol.status,
                                 "solve_s": sol.solve_s,
                                 "fallbacks": list(sol.fallbacks_used),
                                 "m_peak": prob.m_peak})
        cursor: Dict[str, int] = {}
        by_l: Dict[int, List[tuple]] = {}
        for (w, l), cnt in sorted(sol.x.items(), key=lambda kv: kv[0][1]):
            if cnt > 0 and w not in sol.preload:
                by_l.setdefault(l, []).append((w, cnt))
        for l in sorted(by_l):
            for w, cnt in by_l[l]:
                lo = cursor.get(w, 0)
                plan.loads.setdefault(l, []).append(LoadTask(w, lo, lo + cnt))
                cursor[w] = lo + cnt
        return plan

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "model": self.model, "chunk_bytes": self.chunk_bytes,
            "preload": list(self.preload),
            "loads": {str(l): [[t.weight, t.chunk_lo, t.chunk_hi] for t in ts]
                      for l, ts in self.loads.items()},
            "meta": self.meta}

    @staticmethod
    def from_dict(d: dict) -> "OverlapPlan":
        plan = OverlapPlan(d["model"], d["chunk_bytes"],
                           tuple(d["preload"]), meta=d.get("meta", {}))
        for l, ts in d["loads"].items():
            plan.loads[int(l)] = [LoadTask(w, lo, hi) for w, lo, hi in ts]
        return plan

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1)

    @staticmethod
    def from_json(s: str) -> "OverlapPlan":
        return OverlapPlan.from_dict(json.loads(s))

    def streamed_bytes(self) -> int:
        return sum(t.n_chunks for ts in self.loads.values()
                   for t in ts) * self.chunk_bytes

    def preload_bytes(self, graph: ModelGraph) -> int:
        return sum(graph.weights[w].bytes for w in self.preload)


# ---------------------------------------------------------------------------
# analytic simulator
# ---------------------------------------------------------------------------

@dataclass
class SimResult:
    init_s: float
    exec_s: float
    residency: List[int]
    peak_bytes: int
    avg_bytes: float
    stalls_s: float

    @property
    def integrated_s(self) -> float:
        return self.init_s + self.exec_s


def simulate(plan: OverlapPlan, graph: ModelGraph, hw: Optional[HWSpec] = None,
             thresholds=None) -> SimResult:
    """Event simulation: loads stream at hw.stream_bw on an independent
    queue; an op stalls if a weight it consumes has not finished loading;
    ops whose concurrent load exceeds their class threshold inflate."""
    hw = hw or HWSpec()
    thresholds = thresholds or THRESHOLDS
    rate = hw.stream_bw if hw.disk_bw <= 0 else min(hw.stream_bw, hw.disk_bw)
    init_s = plan.preload_bytes(graph) / rate

    arrival: Dict[str, float] = {}      # weight -> load-finish time
    resident: Dict[str, int] = {w: graph.weights[w].bytes
                                for w in plan.preload}
    for w in plan.preload:
        arrival[w] = 0.0

    t = 0.0                              # compute-queue clock
    load_t = 0.0                         # load-queue clock
    stalls = 0.0
    residency = []
    pending: Dict[str, int] = {}

    for op in graph.ops:
        # issue this op's load tasks (async queue)
        for task in plan.loads.get(op.index, []):
            b = task.n_chunks * plan.chunk_bytes
            load_t = max(load_t, t) + b / rate
            w = task.weight
            pending[w] = pending.get(w, 0) + b
            wref = graph.weights[w]
            arrival[w] = load_t
            resident[w] = min(pending[w], wref.bytes)
        # wait for weights this op consumes
        for wname in op.weights:
            if wname not in arrival:      # plan bug: synchronous fetch
                b = graph.weights[wname].bytes
                load_t = max(load_t, t) + b / hw.stream_bw
                arrival[wname] = load_t
                resident[wname] = b
            if arrival[wname] > t:
                stalls += arrival[wname] - t
                t = arrival[wname]
        # op compute time, inflated when loads overlap beyond threshold
        base = hw.op_time(op)
        overlap_bytes = sum(task.n_chunks * plan.chunk_bytes
                            for task in plan.loads.get(op.index, []))
        th = thresholds[op.op_class]
        cap_bytes = th * base * hw.stream_bw
        inflate = 0.0
        if overlap_bytes > cap_bytes:
            inflate = (overlap_bytes - cap_bytes) / hw.stream_bw
        t += base + inflate
        # free weights consumed here (last use)
        for wname in op.weights:
            resident.pop(wname, None)
            pending.pop(wname, None)
        residency.append(sum(resident.values()))

    peak = max(residency) if residency else 0
    avg = sum(residency) / max(len(residency), 1)
    return SimResult(init_s=init_s, exec_s=t, residency=residency,
                     peak_bytes=peak, avg_bytes=avg, stalls_s=stalls)


# ---------------------------------------------------------------------------
# naive baseline plans (Fig 9) + preload-all (SmartMem-style)
# ---------------------------------------------------------------------------

def plan_always_next(graph: ModelGraph, chunk_bytes: int) -> OverlapPlan:
    """Prefetch each weight wholly at the op immediately before its consumer."""
    plan = OverlapPlan(graph.name + "+alwaysnext", chunk_bytes, preload=tuple(
        w.name for w in graph.weights.values() if w.consumer == 0))
    for w in graph.weights.values():
        if w.consumer == 0:
            continue
        n = max(1, math.ceil(w.bytes / chunk_bytes))
        plan.loads.setdefault(w.consumer - 1, []).append(LoadTask(w.name, 0, n))
    return plan


def plan_same_op_type(graph: ModelGraph, chunk_bytes: int) -> OverlapPlan:
    """Prefetch at the nearest preceding op of the same class."""
    plan = OverlapPlan(graph.name + "+sameop", chunk_bytes, preload=tuple(
        w.name for w in graph.weights.values() if w.consumer == 0))
    cls = [op.op_class for op in graph.ops]
    for w in graph.weights.values():
        if w.consumer == 0:
            continue
        target = None
        want = cls[w.consumer]
        for l in range(w.consumer - 1, -1, -1):
            if cls[l] == want:
                target = l
                break
        if target is None:
            target = w.consumer - 1
        n = max(1, math.ceil(w.bytes / chunk_bytes))
        plan.loads.setdefault(target, []).append(LoadTask(w.name, 0, n))
    return plan


def plan_preload_all(graph: ModelGraph, chunk_bytes: int) -> OverlapPlan:
    return OverlapPlan(graph.name + "+preload", chunk_bytes,
                       preload=tuple(graph.weights))


# ---------------------------------------------------------------------------
# multi-model planning (paper §4.4 — multi-DNN loading schedules)
# ---------------------------------------------------------------------------

@dataclass
class MultiModelPlan:
    """Merged per-model OverlapPlans under one global device-memory cap.

    ``peaks`` holds each model's estimated execution peak (preload bytes +
    the plan's streamed-residency peak) — the planner iterates per-model
    ``m_peak`` until every peak fits under ``budget_bytes``, so serialized
    execution of any registered model stays under the cap. The headroom
    left while model *k* executes, ``prefetch_budget(k)``, is what the
    serving engine may spend overlapping model *k+1*'s earliest-scheduled
    chunks — the cross-model analogue of the paper's intra-model overlap.
    """
    budget_bytes: int
    plans: Dict[str, OverlapPlan] = field(default_factory=dict)
    peaks: Dict[str, int] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @property
    def order(self) -> List[str]:
        return list(self.plans)

    def global_peak(self) -> int:
        return max(self.peaks.values(), default=0)

    def fits_budget(self) -> bool:
        return self.global_peak() <= self.budget_bytes

    def prefetch_budget(self, current: str, reserve: float = 0.0) -> int:
        """Bytes the engine may spend on the next model while `current`
        executes, without the pair exceeding the global cap. ``reserve``
        holds back a fraction of the cap (the engine uses 10%: per-model
        peaks are plan-time estimates and pinning right up to the budget
        starves the executor into pool-rejected transients). Bytes the
        plan RESERVED for non-weight kinds (activation arenas + funded KV
        sequences, ``meta["reserved_bytes"]``) are excluded up front —
        prefetched weights must never crowd out the scratch and context
        the unified allocator promised. The result is clamped at 0;
        ``reserve`` outside [0, 1] is a caller bug and raises (a
        reserve > 1 silently produced negative budgets)."""
        if not (isinstance(reserve, (int, float)) and math.isfinite(reserve)
                and 0.0 <= reserve <= 1.0):
            raise ValueError(f"reserve must be a finite fraction in [0, 1], "
                             f"got {reserve!r}")
        reserved = int(self.meta.get("reserved_bytes", 0))
        return max(0, int((1.0 - reserve) * (self.budget_bytes - reserved))
                   - self.peaks.get(current, 0))

    def prefetch_schedule(self, name: str, weight_bytes: Dict[str, int],
                          max_bytes: int,
                          lookahead_ops: Optional[int] = None):
        """Earliest-scheduled loads of ``name`` fitting ``max_bytes``:
        (whole preload weights, chunk tasks in plan op order).

        ``lookahead_ops`` bounds how deep into the plan the schedule
        reaches: only the first ``lookahead_ops`` preload weights AND the
        first ``lookahead_ops`` load-issuing ops are considered (None =
        the whole plan) — bounding the chunk tasks alone would let a
        preload-heavy plan still fill the entire budget. The arrival-aware
        engine uses a shallow lookahead when warming a model whose request
        has not arrived yet — speculative bytes shouldn't crowd out queued
        work — and the full plan when requests are already waiting."""
        plan = self.plans[name]
        whole: List[str] = []
        chunks: List[LoadTask] = []
        used = 0
        preload = list(plan.preload)
        if lookahead_ops is not None:
            preload = preload[: max(0, int(lookahead_ops))]
        for w in preload:
            b = weight_bytes[w]
            if used + b > max_bytes:
                continue           # oversized weight: skip, keep filling
            whole.append(w)
            used += b
        load_ops = sorted(plan.loads)
        if lookahead_ops is not None:
            load_ops = load_ops[: max(0, int(lookahead_ops))]
        for l in load_ops:
            for t in plan.loads[l]:
                take = min(t.n_chunks,
                           max(0, (max_bytes - used) // plan.chunk_bytes))
                if take <= 0:
                    return whole, chunks
                chunks.append(LoadTask(t.weight, t.chunk_lo,
                                       t.chunk_lo + take))
                used += take * plan.chunk_bytes
        return whole, chunks

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "budget_bytes": self.budget_bytes,
            "plans": {n: p.to_dict() for n, p in self.plans.items()},
            "peaks": dict(self.peaks),
            "meta": self.meta}, indent=1)

    @staticmethod
    def from_json(s: str) -> "MultiModelPlan":
        d = json.loads(s)
        if not isinstance(d, dict):
            raise ValueError(
                f"MultiModelPlan JSON must be an object, got {type(d).__name__}")
        missing = [k for k in ("budget_bytes", "plans") if k not in d]
        if missing:
            raise ValueError(f"MultiModelPlan JSON missing required "
                             f"key(s) {missing}; got keys {sorted(d)}")
        return MultiModelPlan(
            budget_bytes=int(d["budget_bytes"]),
            plans={n: OverlapPlan.from_dict(pd)
                   for n, pd in d["plans"].items()},
            peaks={n: int(v) for n, v in d.get("peaks", {}).items()},
            meta=d.get("meta", {}))


def _plan_one(g: ModelGraph, chunk_bytes: int, cap_bytes: int,
              hw: Optional[HWSpec] = None, solver_cfg=None,
              max_rounds: int = 4):
    """Plan one model under its own byte cap; returns (peak, plan).

    The ``m_peak`` handed to the LC-OPG solver starts at the full cap and
    shrinks by the solver's own preload choice each round — preload grows
    under capacity fallbacks, so the loop re-solves with
    ``m_peak = cap - preload`` until the execution peak (preload +
    streamed residency) fits (or rounds run out; the best achieved peak
    is returned either way and recorded in the plan's ``meta``)."""
    from repro_torch.core.capacity import capacities
    from repro_torch.core.opg import OPGProblem, residency_profile
    from repro_torch.core.solver import solve

    hw = hw or HWSpec()
    caps = capacities(g, chunk_bytes, hw)
    cap_bytes = int(cap_bytes)
    m_peak = cap_bytes
    prev_m_peak = None
    best = None                       # (peak, plan)
    for _ in range(max_rounds):
        if m_peak == prev_m_peak:     # refinement converged
            break
        prev_m_peak = m_peak
        prob = OPGProblem(g, chunk_bytes, m_peak, caps)
        sol = solve(prob, solver_cfg)
        plan = OverlapPlan.from_solution(prob, sol)
        peak = plan.preload_bytes(g) + max(
            residency_profile(prob, sol), default=0)
        plan.meta["exec_peak"] = peak
        if best is None or peak < best[0]:
            best = (peak, plan)
        if peak <= cap_bytes:
            break
        m_peak = max(chunk_bytes, cap_bytes - plan.preload_bytes(g))
    return best


def plan_multi_model(graphs: Dict[str, ModelGraph], chunk_bytes: int,
                     budget_bytes: int, hw: Optional[HWSpec] = None,
                     solver_cfg=None, max_rounds: int = 4,
                     mix=None, alloc_mode: str = "auto",
                     reserves=None, calibration=None) -> MultiModelPlan:
    """Solve one OverlapPlan per model such that every model's execution
    peak (preload + streamed residency) fits the shared device budget.

    Without ``mix`` every model plans against the FULL budget and shrinks
    independently (the uniform baseline: correct for serialized execution,
    blind to traffic). With ``mix`` (a ``core.allocator.MixSpec`` or a raw
    ``{model: rate}`` dict) the per-model caps come from the joint
    allocator instead: the budget is partitioned so the mix-weighted mean
    of the analytic per-model latencies is minimized — hot models keep
    resident bytes, cold models stream — and the split/mix/search
    provenance is recorded in ``meta``. ``alloc_mode`` is forwarded to
    ``allocate_joint`` ("auto" | "waterfill" | "brute").

    ``reserves`` (``{model: core.allocator.ReservationSpec}``) switches
    the allocator to the unified weights-vs-KV-vs-activations pass: arena
    bytes become hard floors, funded KV sequences share the spare with
    weight quanta, and ``meta`` gains ``kv_seqs`` / ``kv_split`` /
    ``arena`` / ``reserved_bytes`` (the total the engine must keep clear
    of weight prefetch — see ``prefetch_budget``). Reserves imply a mix
    (uniform when none is given: the unified pass needs weights).

    ``calibration`` (``{model: observed/analytic latency scale}``) makes
    the allocator price caps with the FITTED latency curve — the learned
    correction from ``OnlineLatencyModel.calibration_scales`` — instead
    of the raw analytic simulator; recorded in ``meta["calibration"]``
    for provenance. Only meaningful with ``mix``."""
    hw = hw or HWSpec()
    mm = MultiModelPlan(budget_bytes=int(budget_bytes),
                        meta={"chunk_bytes": chunk_bytes})
    caps_of = {n: int(budget_bytes) for n in graphs}
    reserved_of = {n: 0 for n in graphs}
    if reserves and mix is None:
        from repro_torch.core.allocator import MixSpec
        mix = MixSpec.uniform(graphs)
    if mix is not None:
        from repro_torch.core.allocator import (BudgetInfeasibleError, MixSpec,
                                                allocate_joint)
        if not isinstance(mix, MixSpec):
            mix = MixSpec.from_rates(dict(mix))
        try:
            alloc = allocate_joint(graphs, chunk_bytes, budget_bytes, mix,
                                   hw=hw, solver_cfg=solver_cfg,
                                   mode=alloc_mode, reserves=reserves,
                                   calibration=calibration)
        except BudgetInfeasibleError as e:
            # no partition exists (per-model floors exceed the budget):
            # fall back to the uniform full-budget caps — serialized
            # execution may still fit — and record why in meta instead of
            # refusing to plan a pool the uniform path can serve
            mm.meta.update({"mix": mix.as_dict(), "alloc_error": str(e)})
        else:
            caps_of = dict(alloc.split)
            mm.meta.update({"mix": alloc.mix, "split": dict(alloc.split),
                            "alloc_mode": alloc.mode,
                            "alloc_cost_s": alloc.cost,
                            "alloc_evals": alloc.evals})
            if calibration:
                mm.meta["calibration"] = dict(calibration)
            if reserves:
                reserved_of = {n: alloc.arena.get(n, 0)
                               + alloc.kv_split.get(n, 0) for n in graphs}
                mm.meta.update({
                    "kv_seqs": dict(alloc.kv_seqs),
                    "kv_split": dict(alloc.kv_split),
                    "arena": dict(alloc.arena),
                    "reserved_bytes": int(sum(reserved_of.values()))})
            prebuilt = (alloc.peaks, alloc.plans)
    for name, g in graphs.items():
        if mix is not None and "split" in mm.meta and name in prebuilt[1]:
            # the allocator already solved this model at its final cap —
            # reuse the plan instead of re-running the shrink loop
            peak, plan = prebuilt[0][name], prebuilt[1][name]
        else:
            peak, plan = _plan_one(g, chunk_bytes, caps_of[name], hw,
                                   solver_cfg, max_rounds)
        if peak > int(budget_bytes) and caps_of[name] < int(budget_bytes):
            # the allocator's arena share was infeasible for this model
            # (capacity fallbacks forced more preload than the share
            # allows) — fall back to the full-budget plan so the hard
            # invariant, every model's execution peak fits the SHARED
            # cap, survives the split
            peak2, plan2 = _plan_one(g, chunk_bytes, int(budget_bytes), hw,
                                     solver_cfg, max_rounds)
            if peak2 < peak:
                peak, plan = peak2, plan2
                plan.meta["cap_fallback"] = True
                if "split" in mm.meta:
                    # keep the recorded partition honest: this model now
                    # plans against the FULL budget, so downstream
                    # consumers (bench split_mb, replan_log) must not
                    # present an arena share that no longer holds
                    mm.meta["split"][name] = int(budget_bytes)
                    mm.meta.setdefault("cap_fallbacks", []).append(name)
        if "split" in mm.meta and peak > mm.meta["split"].get(name, peak):
            # achieved peak exceeds the arena share (but fits the shared
            # cap): the partition guarantee is weakened for this model —
            # record the overshoot rather than presenting a split the
            # installed plan does not satisfy
            mm.meta.setdefault("share_overshoot", {})[name] = \
                int(peak) - int(mm.meta["split"][name])
        plan.model = name
        mm.plans[name] = plan
        mm.peaks[name] = int(peak)
    mm.meta["fits_budget"] = mm.fits_budget()
    return mm
