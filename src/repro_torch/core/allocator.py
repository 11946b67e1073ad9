"""Joint budget allocation across co-served models (ROADMAP open item:
"jointly optimizing the split across models, weighted by request mix").

``plan_multi_model`` historically shrank every model's ``m_peak``
independently under the shared cap — correct for serialized execution, but
blind to traffic: a model serving 90% of requests got exactly the same
planning budget as one serving 1%. Demand Layering's restream-cost framing
and the arena-assignment view of Pisarchyk & Lee both say the split should
follow the mix: hot models deserve resident bytes, cold models should
stream.

This module owns that split:

  * ``MixSpec`` — normalized per-model request-mix weights (arrival rates
    and/or SLO weights);
  * ``allocate_joint`` — searches the partition ``sum(split) <= budget``
    minimizing the mix-weighted mean of each model's analytic latency
    under its own cap. Latency comes from planning the model at that cap
    (the same shrink loop serving uses) and running the plan through the
    analytic simulator — so the allocator optimizes exactly the artifact
    the engine will execute. Two search modes:
      - ``"waterfill"`` — greedy water-filling over marginal
        latency-per-byte: start every model at its feasibility floor and
        repeatedly hand the next budget quantum to the model whose
        weighted latency drops most per byte. Exact when the per-model
        latency curves are convex in the cap (they are non-increasing by
        construction; the differential tests bound the residual gap);
      - ``"brute"`` — exhaustive enumeration of all quantum compositions,
        exact on the quantized grid. Feasible only for small instances
        (2–3 models, a handful of quanta) — the differential-test oracle.
  * ``MixTracker`` — EWMA per-model arrival-rate tracker the serving
    engine feeds with observed arrivals; ``drift`` (total-variation
    distance against the planned mix) is the online re-plan trigger.

Import discipline: ``plan_multi_model`` delegates here lazily, and this
module imports planning pieces lazily inside functions, so
``core/plan.py`` <-> ``core/allocator.py`` never cycle at import time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ALLOC_MODES = ("waterfill", "brute", "auto")


class BudgetInfeasibleError(ValueError):
    """No partition exists: the per-model floors exceed the budget.

    A distinct type so ``plan_multi_model`` can fall back to uniform caps
    for exactly this case while caller bugs (typo'd mix names, bad mode)
    still propagate loudly."""

# brute-force enumeration explodes combinatorially: C(steps + n - 1, n - 1)
# splits, each costing one plan+simulate per model-cap — keep "auto" honest
_BRUTE_MAX_EVALS = 512


@dataclass(frozen=True)
class MixSpec:
    """Normalized per-model request-mix weights.

    Built from raw arrival rates (req/s) and/or SLO importance weights —
    only proportions matter, so ``from_rates({"a": 8, "b": 1})`` and
    ``from_rates({"a": 0.8, "b": 0.1})`` allocate identically."""
    weights: Tuple[Tuple[str, float], ...]

    @staticmethod
    def from_rates(rates: Dict[str, float]) -> "MixSpec":
        if not rates:
            raise ValueError("mix needs at least one model")
        bad = {n: r for n, r in rates.items()
               if not math.isfinite(r) or r < 0}
        if bad:
            raise ValueError(f"mix rates must be finite and >= 0: {bad}")
        total = sum(rates.values())
        if total <= 0:
            raise ValueError("mix needs at least one positive rate")
        return MixSpec(tuple(sorted((n, r / total)
                                    for n, r in rates.items())))

    @staticmethod
    def uniform(names) -> "MixSpec":
        names = list(names)
        return MixSpec.from_rates({n: 1.0 for n in names})

    def weight(self, name: str) -> float:
        return dict(self.weights).get(name, 0.0)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.weights)

    def drift(self, other: "MixSpec") -> float:
        """Total-variation distance in [0, 1] — the re-plan trigger
        metric (0 = identical mixes, 1 = disjoint support)."""
        a, b = self.as_dict(), other.as_dict()
        return 0.5 * sum(abs(a.get(n, 0.0) - b.get(n, 0.0))
                         for n in set(a) | set(b))


@dataclass(frozen=True)
class ReservationSpec:
    """Per-model NON-WEIGHT memory demand for the unified budget pool.

    ``arena_bytes`` is the model's profile-driven activation-arena peak
    (``core.arena.arena_size``): hard — a batch cannot execute without
    its scratch, so the bytes are subtracted from the budget before any
    weight/KV trading (an infeasible total raises
    ``BudgetInfeasibleError`` exactly like weight floors do).

    KV demand is elastic: each admitted concurrent sequence pins
    ``kv_seq_bytes`` of paged KV (pages × page size at the planned
    context length), admitting one more is worth ``kv_benefit_s`` of
    latency (the restream-equivalent cost — recompute or reload — that a
    rejected/preempted sequence would pay to come back), and demand
    saturates at ``kv_target_seqs`` concurrent sequences. The water-fill
    prices a KV sequence-quantum at ``kv_benefit_s / kv_seq_bytes``
    gain-per-byte, directly against the weight quanta's marginal
    latency-per-byte — one currency, one pass."""
    arena_bytes: int = 0
    kv_seq_bytes: int = 0
    kv_target_seqs: int = 0
    kv_benefit_s: float = 0.0

    def __post_init__(self):
        if self.arena_bytes < 0 or self.kv_seq_bytes < 0 \
                or self.kv_target_seqs < 0 or self.kv_benefit_s < 0:
            raise ValueError(f"ReservationSpec fields must be >= 0: {self}")

    @property
    def reserved_floor(self) -> int:
        """Hard bytes this model removes from the weight/KV pool."""
        return int(self.arena_bytes)


@dataclass
class AllocationResult:
    """One solved split: per-model byte caps plus search provenance.

    ``plans``/``peaks`` are the evaluator's already-solved artifacts at
    the chosen caps — ``plan_multi_model`` installs them directly instead
    of re-running the solver at the same caps (planning latency directly
    delays the serving engine's online re-plan swap).

    With reservations (``allocate_joint(reserves=...)``) the unified pass
    also reports where the non-weight bytes went: ``kv_seqs`` /
    ``kv_split`` are the concurrent sequences (and their bytes) the split
    funds per model, ``arena`` the hard arena floors taken off the top —
    ``split + kv_split + arena`` never exceeds the budget."""
    split: Dict[str, int]                 # model -> planning cap (bytes)
    cost: float                           # mix-weighted mean latency (s)
    mode: str                             # "waterfill" | "brute"
    evals: int                            # distinct (model, cap) plans built
    per_model_latency: Dict[str, float] = field(default_factory=dict)
    mix: Dict[str, float] = field(default_factory=dict)
    plans: Dict[str, object] = field(default_factory=dict)
    peaks: Dict[str, int] = field(default_factory=dict)
    kv_seqs: Dict[str, int] = field(default_factory=dict)
    kv_split: Dict[str, int] = field(default_factory=dict)
    arena: Dict[str, int] = field(default_factory=dict)


def model_floor(graph, chunk_bytes: int) -> int:
    """Smallest per-model cap a feasible plan can exist under: op-0
    weights have no earlier op and MUST preload, plus at least a couple
    of chunks of in-flight streaming headroom."""
    forced = sum(w.bytes for w in graph.weights.values() if w.consumer == 0)
    return forced + 2 * chunk_bytes


class PlanCostEvaluator:
    """Memoized (model, cap) -> (latency, peak, plan) evaluator.

    The cost of giving model ``name`` a cap of ``cap`` bytes is the
    analytic integrated latency (preload init + execution incl. stalls)
    of the plan the production shrink loop emits at that cap — the
    allocator and the serving engine therefore price budget in the same
    currency. Memoization matters: water-filling re-visits neighbouring
    caps constantly and brute mode shares caps across splits.

    ``calibration`` substitutes the FITTED latency curve for the pure
    analytic one: a per-model multiplicative correction (observed /
    analytic latency, from ``OnlineLatencyModel.calibration_scales``)
    applied on top of ``simulate``. The analytic curve keeps its shape
    over caps (that is what the simulator knows); the learned factor
    re-anchors its level to what the serving clock actually charged on
    this machine, so models the analytic model underprices pull
    correspondingly more budget. Models absent from the dict price
    purely analytically — an empty/None dict is bit-for-bit the
    uncalibrated evaluator."""

    def __init__(self, graphs, chunk_bytes: int, hw=None, solver_cfg=None,
                 max_rounds: int = 4,
                 calibration: Optional[Dict[str, float]] = None):
        from repro_torch.core.capacity import HWSpec
        self.graphs = graphs
        self.chunk_bytes = int(chunk_bytes)
        self.hw = hw or HWSpec()
        self.solver_cfg = solver_cfg
        self.max_rounds = max_rounds
        self.calibration = dict(calibration or {})
        for m, s in self.calibration.items():
            if not (s > 0.0 and math.isfinite(s)):
                raise ValueError(
                    f"calibration scale for {m!r} must be finite and > 0, "
                    f"got {s!r}")
        self._cache: Dict[Tuple[str, int], Tuple[float, int, object]] = {}
        self.evals = 0

    def evaluate(self, name: str, cap: int):
        """Latency (s), achieved peak (bytes), and the plan at this cap."""
        cap = int(cap)
        hit = self._cache.get((name, cap))
        if hit is not None:
            return hit
        from repro_torch.core.plan import _plan_one, simulate
        g = self.graphs[name]
        peak, plan = _plan_one(g, self.chunk_bytes, cap, self.hw,
                               self.solver_cfg, self.max_rounds)
        lat = simulate(plan, g, self.hw).integrated_s \
            * self.calibration.get(name, 1.0)
        self.evals += 1
        out = (lat, peak, plan)
        self._cache[(name, cap)] = out
        return out

    def latency(self, name: str, cap: int) -> float:
        return self.evaluate(name, cap)[0]


def split_cost(evaluator: PlanCostEvaluator, mix: MixSpec,
               split: Dict[str, int]) -> float:
    """Mix-weighted mean latency of one candidate split. Zero-weight
    models are skipped entirely — their latency would be multiplied by 0,
    so pricing them would burn a full plan+simulate per candidate cap for
    nothing (brute mode enumerates many caps per model)."""
    return sum(mix.weight(n) * evaluator.latency(n, cap)
               for n, cap in split.items() if mix.weight(n) > 0)


def _compositions(total: int, parts: int):
    """Stars-and-bars: every way to write ``total`` as an ordered sum of
    ``parts`` non-negative ints — yields exactly C(total+parts-1, parts-1)
    tuples (no generate-and-filter blowup on large grids)."""
    if parts == 1:
        yield (total,)
        return
    for head in range(total + 1):
        for rest in _compositions(total - head, parts - 1):
            yield (head,) + rest


def enumerate_splits(names: List[str], floors: Dict[str, int],
                     budget_bytes: int, quantum: int):
    """All quantum-granular allocations of the spare budget over ``names``
    (each model keeps at least its floor; ``sum(split) <= budget``).
    Partial allocations are included — latency is NOT monotone in the cap
    (a bigger cap can push the solver toward more preload and a higher
    init time), so leaving spare budget unassigned can be optimal. An
    extra slack part in the composition absorbs the unallocated quanta."""
    spare = budget_bytes - sum(floors.values())
    steps = max(0, spare // quantum)
    for combo in _compositions(steps, len(names) + 1):
        yield {n: floors[n] + k * quantum
               for n, k in zip(names, combo[:-1])}


def allocate_joint(graphs, chunk_bytes: int, budget_bytes: int,
                   mix: MixSpec, hw=None, solver_cfg=None,
                   quantum: Optional[int] = None, mode: str = "auto",
                   evaluator: Optional[PlanCostEvaluator] = None,
                   reserves: Optional[Dict[str, ReservationSpec]] = None,
                   calibration: Optional[Dict[str, float]] = None
                   ) -> AllocationResult:
    """Search the per-model budget split jointly under the request mix.

    Feasibility: every model keeps at least ``model_floor`` bytes and the
    caps partition the budget (``sum(split) <= budget_bytes``) — the
    arena view: while any model executes within its own cap, the other
    models' resident bytes fit beside it, so a hot model's weights
    survive a cold model's execution instead of being evicted by it.

    ``quantum`` is the allocation granularity (default: spare budget in
    ~16 steps, chunk-aligned). ``mode="auto"`` brute-forces when the grid
    is small enough to enumerate exactly, else water-fills.

    ``reserves`` (``{model: ReservationSpec}``) turns on the UNIFIED pass:
    arena bytes come off the top as hard per-model floors, and paged-KV
    demand competes with weight quanta inside one water-fill — each step
    hands the next bytes to whichever candidate (a weight quantum's
    mix-weighted marginal latency, or one more concurrent sequence's
    ``kv_benefit_s``) buys the most gain per byte. Without ``reserves``
    the weights-only search below runs untouched, bit-for-bit. Reserved
    mode is water-fill only (``mode="brute"`` raises: enumerating the
    joint weight x KV grid explodes and the brute oracle prices weights
    only).

    ``calibration`` (``{model: observed/analytic latency scale}``, see
    ``PlanCostEvaluator``) prices caps with the FITTED latency curve
    instead of the pure analytic one. Mutually exclusive with passing a
    pre-built ``evaluator`` (whose own calibration would silently win)."""
    if mode not in ALLOC_MODES:
        raise ValueError(f"unknown allocation mode {mode!r}; "
                         f"expected one of {ALLOC_MODES}")
    if calibration and evaluator is not None:
        raise ValueError("allocate_joint: pass calibration either inline or "
                         "via the evaluator, not both")
    names = list(graphs)
    if sum(mix.weight(n) for n in names) <= 0:
        # a mix that names none of the graphs (typo'd keys) would silently
        # allocate every model its bare floor and report success
        raise ValueError(
            f"mix weights {sorted(mix.as_dict())} put zero total weight on "
            f"the models being planned {sorted(names)} — check the names")
    budget_bytes = int(budget_bytes)
    if reserves:
        if mode == "brute":
            raise ValueError("allocate_joint: mode='brute' does not price "
                             "KV/arena reservations — use 'waterfill' or "
                             "'auto' with reserves")
        return _allocate_reserved(graphs, chunk_bytes, budget_bytes, mix,
                                  hw, solver_cfg, quantum, evaluator,
                                  reserves, calibration=calibration)
    floors = {n: min(model_floor(graphs[n], chunk_bytes), budget_bytes)
              for n in names}
    spare = budget_bytes - sum(floors.values())
    if spare < 0:
        raise BudgetInfeasibleError(
            f"budget {budget_bytes} cannot cover the per-model floors "
            f"{floors} (sum {sum(floors.values())}): even an all-streaming "
            f"joint split does not fit — raise the budget or serve fewer "
            f"models")
    if quantum is None:
        chunk = int(chunk_bytes)
        quantum = max(chunk, (spare // 16 // chunk) * chunk or chunk)
    quantum = max(1, int(quantum))
    steps = spare // quantum
    ev = evaluator or PlanCostEvaluator(graphs, chunk_bytes, hw=hw,
                                        solver_cfg=solver_cfg,
                                        calibration=calibration)

    n_splits = math.comb(steps + len(names), len(names))
    if mode == "auto":
        mode = "brute" if n_splits * len(names) <= _BRUTE_MAX_EVALS \
            else "waterfill"

    if mode == "brute":
        best, best_cost, best_walloc = None, math.inf, -1.0
        for split in enumerate_splits(names, floors, budget_bytes, quantum):
            c = split_cost(ev, mix, split)
            # cost ties break toward the larger traffic-weighted
            # allocation: on flat latency curves the analytic cost is
            # indifferent, but headroom on hot models still buys the
            # engine protect/prefetch room the simulator cannot see
            walloc = sum(mix.weight(n) * split[n] for n in names)
            if c < best_cost - 1e-12 or (abs(c - best_cost) <= 1e-12
                                         and walloc > best_walloc):
                best, best_cost, best_walloc = split, c, walloc
        split = best if best is not None else dict(floors)
        cost = best_cost if best is not None \
            else split_cost(ev, mix, split)
    else:
        split = dict(floors)
        remaining = steps
        while remaining > 0:
            # weighted marginal latency gain per quantum for each model;
            # strict > 0 keeps zero-weight (cold) models at their floor
            gains = {}
            for n in names:
                w = mix.weight(n)
                if w <= 0:
                    continue
                gains[n] = w * (ev.latency(n, split[n])
                                - ev.latency(n, split[n] + quantum))
            if not gains:
                break
            # deterministic tie-break: heavier mix weight, then name
            pick = max(gains, key=lambda n: (gains[n], mix.weight(n), n))
            if gains[pick] <= 0:
                # no model improves at this granularity — try parking the
                # rest of the spare on the heaviest model, but KEEP the
                # current split if that is actually worse (latency is not
                # monotone in the cap: a bigger cap can shift the solver
                # toward more preload and a higher init time)
                heavy = max(names, key=lambda n: (mix.weight(n), n))
                parked = dict(split)
                parked[heavy] += remaining * quantum
                if split_cost(ev, mix, parked) <= split_cost(ev, mix, split):
                    split = parked
                remaining = 0
                break
            split[pick] += quantum
            remaining -= 1
        cost = split_cost(ev, mix, split)
        mode = "waterfill"

    final = {n: ev.evaluate(n, split[n]) for n in names}
    return AllocationResult(
        split=split, cost=cost, mode=mode, evals=ev.evals,
        per_model_latency={n: lat for n, (lat, _pk, _pl) in final.items()},
        mix=mix.as_dict(),
        plans={n: pl for n, (_lat, _pk, pl) in final.items()},
        peaks={n: pk for n, (_lat, pk, _pl) in final.items()})


def _allocate_reserved(graphs, chunk_bytes: int, budget_bytes: int,
                       mix: MixSpec, hw, solver_cfg,
                       quantum: Optional[int],
                       evaluator: Optional[PlanCostEvaluator],
                       reserves: Dict[str, ReservationSpec],
                       calibration: Optional[Dict[str, float]] = None
                       ) -> AllocationResult:
    """The unified water-fill: weights vs KV vs activations in one pass.

    Arena bytes are hard floors taken off the top. The remaining spare is
    handed out one candidate at a time, each priced in GAIN PER BYTE:

      * a weight quantum for model n buys
        ``w_n * (lat(cap) - lat(cap + q)) / q`` — the mix-weighted
        marginal latency of the analytic plan at that cap, exactly the
        weights-only currency;
      * one more concurrent KV sequence for model n buys
        ``w_n * kv_benefit_s / kv_seq_bytes`` — the restream-equivalent
        seconds a shed/preempted sequence would pay, flat until demand
        saturates at ``kv_target_seqs``.

    The mix-weighted objective the result's ``cost`` reports adds an
    unserved-KV penalty (``w * kv_benefit_s`` per sequence short of
    target) to the usual weighted latency, so splits remain comparable
    across KV allocations."""
    names = list(graphs)
    zero = ReservationSpec()
    arena = {n: int(reserves.get(n, zero).arena_bytes) for n in names}
    arena_total = sum(arena.values())
    weight_budget = budget_bytes - arena_total
    floors = {n: min(model_floor(graphs[n], chunk_bytes),
                     max(weight_budget, 1)) for n in names}
    spare = weight_budget - sum(floors.values())
    if spare < 0:
        raise BudgetInfeasibleError(
            f"budget {budget_bytes} cannot cover the per-model weight "
            f"floors {floors} plus activation-arena reservations "
            f"{arena} (arenas {arena_total}): raise the budget, shrink "
            f"the profiled batch, or serve fewer models")
    if quantum is None:
        chunk = int(chunk_bytes)
        quantum = max(chunk, (spare // 16 // chunk) * chunk or chunk)
    quantum = max(1, int(quantum))
    ev = evaluator or PlanCostEvaluator(graphs, chunk_bytes, hw=hw,
                                        solver_cfg=solver_cfg,
                                        calibration=calibration)
    split = dict(floors)
    kv_seqs = {n: 0 for n in names}
    avail = spare
    while True:
        cands = []
        for n in names:
            w = mix.weight(n)
            if w <= 0:
                continue
            if avail >= quantum:
                g = w * (ev.latency(n, split[n])
                         - ev.latency(n, split[n] + quantum)) / quantum
                cands.append((g, 0, w, n, quantum, "w"))
            rs = reserves.get(n)
            if (rs is not None and rs.kv_seq_bytes > 0
                    and kv_seqs[n] < rs.kv_target_seqs
                    and avail >= rs.kv_seq_bytes):
                g = w * rs.kv_benefit_s / rs.kv_seq_bytes
                # tie-flag 1: at equal gain-per-byte prefer the KV
                # sequence — it serves admission directly, while a weight
                # quantum at zero marginal latency buys nothing the
                # simulator can see
                cands.append((g, 1, w, n, rs.kv_seq_bytes, "kv"))
        if not cands:
            break
        g, _kv, _w, n, nbytes, kind = max(
            cands, key=lambda c: (c[0], c[1], c[2], c[3]))
        if g <= 0:
            # no candidate improves anything: try parking the remaining
            # spare on the heaviest model (same guarded move as the
            # weights-only fill — latency is not monotone in the cap)
            heavy = max(names, key=lambda n2: (mix.weight(n2), n2))
            parked = dict(split)
            parked[heavy] += (avail // quantum) * quantum
            if split_cost(ev, mix, parked) <= split_cost(ev, mix, split):
                split = parked
            break
        if kind == "w":
            split[n] += nbytes
        else:
            kv_seqs[n] += 1
        avail -= nbytes
    kv_penalty = sum(
        mix.weight(n) * rs.kv_benefit_s
        * max(0, rs.kv_target_seqs - kv_seqs[n])
        for n, rs in reserves.items()
        if n in graphs and rs.kv_seq_bytes > 0)
    cost = split_cost(ev, mix, split) + kv_penalty
    final = {n: ev.evaluate(n, split[n]) for n in names}
    return AllocationResult(
        split=split, cost=cost, mode="waterfill", evals=ev.evals,
        per_model_latency={n: lat for n, (lat, _pk, _pl) in final.items()},
        mix=mix.as_dict(),
        plans={n: pl for n, (_lat, _pk, pl) in final.items()},
        peaks={n: pk for n, (_lat, pk, _pl) in final.items()},
        kv_seqs=kv_seqs,
        kv_split={n: kv_seqs[n] * reserves.get(n, zero).kv_seq_bytes
                  for n in names},
        arena=arena)


# ---------------------------------------------------------------------------
# online mix observation (the serving engine's re-plan trigger)
# ---------------------------------------------------------------------------

class MixTracker:
    """EWMA per-model arrival-rate tracker on the serving clock.

    ``observe(model, t)`` decays every model's count by
    ``0.5 ** (dt / halflife_s)`` then credits the arriving model — so
    ``mix()`` is the exponentially-weighted share of recent arrivals and
    old traffic fades on the *virtual* timeline (deterministic under
    SimClock replay). ``drift(reference)`` is the total-variation
    distance the engine compares against its re-plan threshold."""

    def __init__(self, models, halflife_s: float = 0.5):
        if halflife_s <= 0:
            raise ValueError("halflife_s must be positive")
        self.halflife_s = float(halflife_s)
        self.counts: Dict[str, float] = {n: 0.0 for n in models}
        self.observed = 0
        self._t_last: Optional[float] = None

    def observe(self, model: str, t: float):
        if self._t_last is not None and t > self._t_last:
            decay = 0.5 ** ((t - self._t_last) / self.halflife_s)
            for n in self.counts:
                self.counts[n] *= decay
        self._t_last = max(t, self._t_last or t)
        self.counts[model] = self.counts.get(model, 0.0) + 1.0
        self.observed += 1

    def mix(self) -> MixSpec:
        total = sum(self.counts.values())
        if total <= 0:
            return MixSpec.uniform(self.counts or ["_"])
        return MixSpec.from_rates(dict(self.counts))

    def drift(self, reference: MixSpec) -> float:
        return self.mix().drift(reference)
