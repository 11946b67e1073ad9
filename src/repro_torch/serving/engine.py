"""Multi-DNN streaming serving engine (paper §2.2 / §4.4, Fig 6).

Models are registered with the engine; all executors share one budgeted
``WeightCache`` — the device-memory pool — and the engine plans every
registered model jointly via ``plan_multi_model`` so each model's
execution peak fits the pool budget.

Two entry points:

  * ``run_all()`` — drain a pre-filled queue with a static round-robin
    interleave (per-model FIFO preserved): the paper's Fig 6 batch mode.
  * ``serve(stream)`` — the continuous, arrival-aware online loop: pulls
    from a live ``RequestStream``, coalesces same-model arrivals through
    ``serving/batcher.py`` (responses are de-batched back to per-request
    latencies), and picks the *next model to run* — and the next model to
    PREFETCH — from actual queue depths and arrival times instead of the
    static interleave order. Every timestamp goes through an injectable
    clock (``serving/clock.py``), so the whole loop is deterministically
    testable with ``SimClock`` — no real sleeps in tests.

While one request (or batch) executes, the engine overlaps the predicted
next model:

  * plan-aware protection — cached entries the next model's OverlapPlan
    schedules earliest are PINNED, so the current model's streaming
    pressure recycles its own bytes instead of evicting exactly what the
    schedule needs next (a shared pool thrashes on sequential weight
    scans without this);
  * prefetch — within the headroom ``budget - peak(current)``, the next
    model's preload weights and earliest-scheduled chunks are loaded into
    the pool by a background thread (the cross-model analogue of the
    paper's intra-model compute/load overlap). When the predicted model's
    request has not arrived yet (speculative warm from the trace's
    upcoming arrivals), the prefetch uses a shallow plan lookahead so
    speculative bytes do not crowd out queued work.

Pool eviction is pluggable (``eviction="lru" | "cost"``): LRU, or
cheapest-to-restream-first (restream bytes / disk bandwidth, à la Demand
Layering) — threaded through to ``WeightCache``.

SLO-aware serving sits on top of the online loop:

  * ``scheduler="slo"`` orders runnable queues by earliest-FEASIBLE-
    deadline: a head's urgency is its deadline minus the per-batch exec
    estimate (``BatchLatencyEstimator`` EWMA over clock-charged durations)
    minus the pool's restream cost for the model's cold chunks — so "which
    model runs next" accounts for weight-loading time, not just compute;
    with per-request ``priority`` weights the key becomes
    priority-WEIGHTED slack — a priority-p request's slack shrinks (or its
    lateness amplifies) by p, so heavier work runs, admits, and survives
    shedding first while EDF's deadline-driven aging still guarantees
    lighter work is served as its own deadline approaches;
  * batch formation is deadline-aware: ``make_batch`` admits
    members greedily only while the grown batch's exec estimate plus
    restream cost still makes the tightest admitted deadline, so a late
    joiner can never blow the head's deadline (excluded members are
    requeued at the head of the line and logged in ``defer_log``);
  * long batches are preemptible at op (chunk-schedule) boundaries: the
    running ``StreamingExecutor`` yields when a waiting queue would
    otherwise miss a strictly-earlier deadline, and the suspended run's
    loader thread, arrived chunks, and cache pins survive the preemption,
    so resuming never re-streams already-resident bytes;
  * an admission controller rejects arrivals whose deadlines are
    infeasible given queue depth (and sheds queue heads that became
    hopeless), returning explicit ``Response(status="rejected")`` instead
    of silently inflating tail latency.

Two execution policies:
  * "stream"  — FlashMem: per-model OverlapPlans, chunks checked in/out of
    the shared pool, freed at last use.
  * "preload" — each request loads its full model then runs (MNN-style);
    with a shared pool it still gets cross-request residency hits.

Without ``budget_bytes`` the engine runs cache-less (seed behaviour):
per-request streaming against ``m_peak``, no cross-model state, and
global-FIFO response order (interleaving defaults on only with a shared
pool; pass ``interleave=`` explicitly to override either way).

Unified memory budget: with ``kv=KVSpec(...)`` and/or
``arena=True`` the shared pool prices more than weights — each model
reserves a profile-driven activation arena for the duration of a batch
(``core.arena.arena_size``), and every active sequence pins paged KV
blocks that GROW per decode step, so admission, shedding, and the
deadline-aware batch cap see true memory pressure instead of a
weights-only fiction. ``plan_multi_model`` receives matching
``ReservationSpec``s and trades weights vs KV vs activations in one
water-filling pass; KV pages are offloaded (evict-warm) on preemption
and re-pinned on resume, dropped when the sequence finishes, with the
recompute-vs-reload restream cost carried by ``KVSpec.restore``. With
neither knob set, serving outputs and the cache byte ledger are
bit-for-bit the weights-only path.
"""
from __future__ import annotations

import bisect
import itertools
import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.allocator import MixSpec, MixTracker, ReservationSpec
from repro_torch.core.arena import arena_size
from repro_torch.core.capacity import HWSpec, capacities
from repro_torch.core.latency_model import (BatchLatencyEstimator,
                                            OnlineLatencyModel)
from repro_torch.core.opg import OPGProblem
from repro_torch.core.plan import MultiModelPlan, OverlapPlan, plan_multi_model
from repro_torch.core.solver import SolverConfig, solve
from repro_torch.core.streaming import (ExecState, HostModel, PreloadExecutor,
                                        RunStats, StreamingExecutor, chunk_rows,
                                        put_chunk)
from repro_torch.device import DeviceLike, HostToDevice, resolve_device
from repro_torch.serving.batcher import (Batch, BatcherConfig, can_join, make_batch,
                                         split_batch_result)
from repro_torch.serving.clock import MonotonicClock
from repro_torch.serving.config import (SCHEDULERS, ServeConfig,
                                        resolve_serve_config)
from repro_torch.serving.reports import ModelReport, SLOReport
from repro_torch.serving.response_table import ResponseTable
from repro_torch.serving.stream import RequestStream
from repro_torch.serving.types import (Request, Response, RingLog, SLOConfig,
                                       deadline_miss_rate, per_priority_stats,
                                       priority_miss_rate, rejection_rate,
                                       status_counts)
from repro_torch.serving.weight_cache import KVSpec, WeightCache

__all__ = ["Request", "Response", "SLOConfig", "ServeConfig", "SLOReport",
           "ModelReport", "ResponseTable", "ServeSession", "ServingEngine",
           "SCHEDULERS"]


def weighted_urgency(latest_start: float, now: float,
                     priority: float) -> float:
    """The priority-weighted EDF key (smaller = runs first), expressed as
    an absolute virtual time so queue heads and suspended batches compare
    directly. ``latest_start`` is the plain-EDF key (deadline − exec
    estimate − restream cost); its slack relative to ``now`` is divided by
    the priority when positive (heavier work's headroom shrinks — it runs
    earlier) and multiplied when negative (heavier work's lateness weighs
    more — it recovers first). Priority 1 is exactly plain EDF; priority 0
    (best-effort) and deadline-less work sort last (+inf)."""
    if priority <= 0 or not math.isfinite(latest_start):
        return math.inf
    slack = latest_start - now
    return now + (slack / priority if slack >= 0 else slack * priority)


class _SortedQueue:
    """Indexed sorted pending queue for the weighted-EDF ("slo")
    scheduler — the de-quadratic replacement for the deque + O(n)
    right-scan insert.

    Entries live in key-sorted buckets of ~``LOAD`` items
    (``sortedcontainers``-style), keyed ``(virtual deadline, arrival_s,
    admit seq)`` by the serve loop's ``keyfn``. Every component is
    time-invariant per request, so an entry's key never changes while
    queued and the sorted invariant holds without re-sorting. Admit is
    O(log buckets + LOAD), head pop O(LOAD) memmove, and
    ``rank_leq_vd`` — the admission controller's "how much queued work
    runs before this deadline" count — is O(buckets + log LOAD) instead
    of a full queue walk per arrival.

    Order is bit-for-bit the old deque's: the old stable insert placed a
    newcomer after the last entry with ``(vd, arrival) <=`` its key
    (FIFO for exact ties == ascending admit seq), which is exactly
    ascending ``(vd, arrival, seq)``; and the engine's front-requeues
    (``appendleft`` of a just-popped group prefix, before any
    intervening admit) re-insert entries by their ORIGINAL keys — the
    minimal keys present — which IS the front under the invariant.
    """

    LOAD = 512

    def __init__(self, keyfn: Callable[[Request], tuple]):
        self._key = keyfn
        self._keys: List[List[tuple]] = []
        self._reqs: List[List[Request]] = []
        self._maxes: List[tuple] = []
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        for b in self._reqs:
            yield from b

    def __getitem__(self, i: int) -> Request:
        if i < 0:
            i += self._len
        for b in self._reqs:
            if i < len(b):
                return b[i]
            i -= len(b)
        raise IndexError("queue index out of range")

    def push(self, r: Request):
        key = self._key(r)
        if not self._keys:
            self._keys, self._reqs, self._maxes = [[key]], [[r]], [key]
            self._len = 1
            return
        bi = min(bisect.bisect_left(self._maxes, key),
                 len(self._maxes) - 1)
        keys = self._keys[bi]
        i = bisect.bisect_right(keys, key)
        keys.insert(i, key)
        self._reqs[bi].insert(i, r)
        self._maxes[bi] = keys[-1]
        self._len += 1
        if len(keys) > 2 * self.LOAD:
            h = len(keys) // 2
            reqs = self._reqs[bi]
            self._keys[bi:bi + 1] = [keys[:h], keys[h:]]
            self._reqs[bi:bi + 1] = [reqs[:h], reqs[h:]]
            self._maxes[bi:bi + 1] = [keys[h - 1], keys[-1]]

    # the engine's deferred-members requeue: re-inserting by the original
    # (time-invariant) key reproduces the deque's front-requeue exactly —
    # see the class docstring's invariant argument
    appendleft = push

    def popleft(self) -> Request:
        if not self._len:
            raise IndexError("pop from empty _SortedQueue")
        self._keys[0].pop(0)
        r = self._reqs[0].pop(0)
        self._len -= 1
        if not self._keys[0]:
            del self._keys[0], self._reqs[0], self._maxes[0]
        return r

    def rank_leq_vd(self, vd: float) -> int:
        """Count queued requests whose virtual deadline (key[0]) is
        <= ``vd`` — replaces the per-arrival O(n) queue walk in the
        admission controller's backlog estimate, same count."""
        probe = (vd, math.inf, math.inf)
        n = 0
        for keys in self._keys:
            if keys[0][0] > vd:
                break               # buckets are sorted: later ones too
            if keys[-1][0] <= vd:
                n += len(keys)
            else:
                n += bisect.bisect_right(keys, probe)
                break
        return n


@dataclass
class _RunningBatch:
    """One (possibly preempted-and-resumed) batch execution in serve().

    Carries the resumable executor state across a preemption plus the
    scheduling facts the engine needs to decide when to resume it: the
    tightest member deadline, the batch's priority weight, and how much
    of its estimated execution remains."""
    name: str
    batch: Batch
    n_ops: int
    deadline_s: float = math.inf
    priority: float = 1.0
    state: Optional[ExecState] = None
    t_start: float = 0.0
    started: bool = False
    charged_s: float = 0.0          # virtual seconds ticked so far
    # unified-budget accounting: decode tokens already charged to the KV
    # pool per member sequence (None until the batch starts / non-unified)
    kv_done: Optional[Dict] = None
    # cost-model sample features, captured once when the batch first
    # starts: what the scheduler priced this batch at, bytes the pool had
    # to restream for it, and the members' total planned decode length —
    # fed to OnlineLatencyModel.observe_sample at completion and stamped
    # onto the batch's Responses
    predicted_s: float = 0.0
    cold_bytes: int = 0
    decode_tokens: int = 0

    def remaining_s(self, cost: BatchLatencyEstimator) -> float:
        if self.state is None:
            return cost.estimate(self.name, self.batch.size)
        left = max(0, self.n_ops - self.state.op_idx)
        return cost.estimate(self.name, self.batch.size) \
            * left / max(self.n_ops, 1)

    def effective_deadline(self, cost: BatchLatencyEstimator) -> float:
        """Latest virtual time the remaining work can start and still meet
        the batch deadline — the EDF key a suspended run competes with."""
        return self.deadline_s - self.remaining_s(cost)

    def urgency(self, cost: BatchLatencyEstimator, now: float) -> float:
        """Priority-weighted resume key (same scale as a queue head's)."""
        return weighted_urgency(self.effective_deadline(cost), now,
                                self.priority)


class ServeSession:
    """One steppable ``serve()`` call: the engine's online loop as a
    generator the caller advances, instead of a blocking drain.

    ``serve()`` == ``ServeSession.run()`` — same responses, same logs,
    same idle sleeps, bit-for-bit. The step form exists for the fleet
    tier (``serving/router.py``): a Router holds one session per replica,
    each on its own clock, and always steps the replica whose
    ``next_time()`` is earliest — a deterministic single-threaded
    discrete-event pump over N engines.

    ``step()`` advances the loop to its next event and returns
    ``(kind, payload)``:

      * ``("batch", (model, charged_s))`` — a batch finished; its
        responses were appended to ``responses``;
      * ``("preempt", (model, op_idx))`` — the running batch yielded and
        sits in ``suspended`` (clock already charged for the segment);
      * ``("idle", next_arrival | None)`` — nothing runnable NOW. The
        session does NOT sleep; its caller advances the clock (or pushes
        work) and steps again;
      * ``("done", None)`` — stream exhausted, every response collected.
    """

    def __init__(self, engine: "ServingEngine", stream: RequestStream,
                 clock, config: ServeConfig):
        self.engine = engine
        self.stream = stream
        self.clock = clock
        # the validated knob set this session runs under —
        # poll_interval_s/step_mode mirror it for existing callers
        self.config = config
        self.poll_interval_s = config.poll_interval_s
        self.step_mode = config.step_mode
        # result_mode="columnar": struct-of-arrays ResponseTable instead
        # of a List[Response] — same row order, no result tensors
        self.responses = (ResponseTable()
                          if config.result_mode == "columnar" else [])
        # per-model pending queues: deque under fifo/static, _SortedQueue
        # under the weighted-EDF "slo" scheduler
        self.pending: Dict[str, Deque[Request]] = {}
        self.suspended: Optional[_RunningBatch] = None
        self.done = False
        self.idle = False           # last step yielded "idle"
        self.steps = 0              # step() calls that advanced the loop —
                                    # the trace-scale O(events) check
        self._gen = engine._serve_loop(
            self, stream, clock, batcher=config.batcher,
            scheduler=config.scheduler,
            speculative_lookahead_ops=config.speculative_lookahead_ops,
            slo=config.slo, admission=config.admission,
            preempt=config.preempt, batch_cap=config.batch_cap,
            cost_model=config.cost_model, replan=config.replan,
            replan_drift=config.replan_drift,
            replan_min_observed=config.replan_min_observed,
            mix_halflife_s=config.mix_halflife_s,
            replan_background=config.replan_background,
            replan_feasibility=config.replan_feasibility)

    def step(self) -> Tuple[str, object]:
        if self.done:
            return ("done", None)
        self.steps += 1
        try:
            kind, payload = next(self._gen)
        except StopIteration:
            self.done = True
            self.idle = False
            return ("done", None)
        self.idle = kind == "idle"
        return (kind, payload)

    def queued(self) -> int:
        """Admitted-but-unserved depth (queued requests + suspended batch
        members) — the in-engine half of a replica's load."""
        n = sum(len(q) for q in self.pending.values())
        if self.suspended is not None:
            n += self.suspended.batch.size
        return n

    def next_time(self) -> float:
        """The session's TRUE next-event time — the earliest clock
        reading at which stepping can make progress: ``now`` when work is
        runnable (queued requests, a suspended batch awaiting resume, or
        a finished re-plan awaiting its swap boundary — the loop only
        reports idle when none of those exist), the next pending arrival
        when the loop idles for one, ``+inf`` when it can never progress
        again (done, or an open stream with nothing queued — blocked on
        an external push). The Router's pump key and the event-driven
        ``run()``'s sleep target: idle gaps cost one step, not
        O(gap / poll_interval_s)."""
        if self.done:
            return math.inf
        if not self.idle:
            return self.clock.now()
        nxt = self.stream.next_arrival()
        if nxt is not None:
            return max(self.clock.now(), nxt)
        # idle on an open, empty stream: blocked until someone pushes
        return self.clock.now() if self.stream.exhausted else math.inf

    def run(self):
        """Drain to completion, returning ``self.responses`` — a
        ``List[Response]``, or a ``ResponseTable`` under
        ``result_mode="columnar"``.

        ``step_mode="event"`` (default): every idle gap costs ONE step.
        Closed streams (trace replays) sleep exactly to the next arrival
        — which the polling loop already did, so replays are bit-for-bit
        identical under both modes. Open (live) streams on a real clock
        park on the stream's push/close condition
        (``RequestStream.wait_for_push``) until the next known arrival is
        due or a producer signals, instead of burning a wake-up every
        ``poll_interval_s``. Open streams on a VIRTUAL clock cannot block
        on real producers and keep the legacy poll stepping.

        ``step_mode="poll"``: the legacy fixed-interval stepping for open
        streams — the equivalence-test baseline."""
        event = self.step_mode == "event"
        while True:
            kind, payload = self.step()
            if kind == "done":
                return self.responses
            if kind != "idle":
                continue
            if self.stream.closed:
                # trace replay: the next event IS the next arrival
                if payload is not None:
                    self.clock.sleep(max(0.0, payload - self.clock.now()))
                continue
            if not event or getattr(self.clock, "virtual", False):
                # a live producer may push an earlier request at any
                # moment and a virtual clock cannot wait for one: step
                # at most poll_interval_s ahead (the legacy behaviour)
                gap = max(0.0, payload - self.clock.now()) \
                    if payload is not None else self.poll_interval_s
                self.clock.sleep(min(gap, self.poll_interval_s))
                continue
            # live stream, real clock: block until a push/close lands or
            # the known next arrival comes due — one step per event
            if payload is not None:
                self.stream.wait_for_push(
                    timeout=max(0.0, payload - self.clock.now()),
                    before_s=payload)
            else:
                self.stream.wait_for_push()


class ServingEngine:
    def __init__(self, *, policy: str = "stream", chunk_bytes: int = 1 << 20,
                 m_peak: int = 256 << 20, hw: Optional[HWSpec] = None,
                 disk_bw: float = 0.0,
                 solver_cfg: Optional[SolverConfig] = None,
                 budget_bytes: Optional[int] = None,
                 prefetch: bool = True,
                 interleave: Optional[bool] = None,
                 eviction: str = "lru",
                 mix: Optional[MixSpec] = None,
                 alloc_mode: str = "auto",
                 kv: Optional[KVSpec] = None,
                 kv_seq_tokens: int = 0,
                 kv_target_seqs: int = 4,
                 arena: bool = False,
                 log_cap: int = 10000,
                 device: DeviceLike = None):
        assert policy in ("stream", "preload")
        self.policy = policy
        self.chunk_bytes = chunk_bytes
        self.m_peak = m_peak
        # the device every registered model runs on (cuda:0 unless the
        # caller asks for the CPU); planning measures that device unless
        # the caller fixes an HWSpec
        self.device = resolve_device(device)
        self.hw = hw or (HWSpec.cuda_calibrated(self.device)
                         if self.device.type == "cuda"
                         else HWSpec.cpu_calibrated())
        self.disk_bw = disk_bw
        self.solver_cfg = solver_cfg
        self.budget_bytes = budget_bytes
        self.eviction = eviction
        # request-mix weighting for the joint budget allocator: with a mix,
        # plan_multi_model partitions the shared budget across models by
        # traffic share instead of shrinking each one under the full cap
        self.mix = (mix if isinstance(mix, MixSpec) or mix is None
                    else MixSpec.from_rates(dict(mix)))
        self.alloc_mode = alloc_mode
        # unified budget pool: KV pages + activation arenas join
        # the weight chunks in one budget. kv_seq_tokens is the planned
        # context length per sequence for reservation sizing (0 = the
        # model's built seq length); kv_target_seqs is the concurrency
        # the allocator funds per model
        self.kv_spec = kv
        self.kv_seq_tokens = int(kv_seq_tokens)
        self.kv_target_seqs = int(kv_target_seqs)
        self.use_arena = bool(arena)
        self.cache = WeightCache(budget_bytes, policy=eviction,
                                 disk_bw=disk_bw,
                                 kv=kv) if budget_bytes else None
        self.unified = self.cache is not None and (kv is not None or arena)
        self.prefetch = prefetch and self.cache is not None
        # default: interleave only with a shared pool; cache-less mode keeps
        # the seed engine's global-FIFO response order (callers pair
        # responses with submissions by index)
        self.interleave = (self.cache is not None) if interleave is None \
            else interleave
        self.models: Dict[str, HostModel] = {}
        self.plans: Dict[str, OverlapPlan] = {}
        self.multi_plan: Optional[MultiModelPlan] = None
        self.queue: List[Request] = []
        # every decision log below is a bounded RingLog: the most
        # recent `log_cap` entries are retained for scenario assertions
        # while `.total` and the streaming counters further down keep the
        # lifetime aggregates exact — memory stays O(log_cap) over a
        # 10^5+-request trace. Aggregates recomputed from retained
        # entries (peak/avg memory, model_report) are approximations once
        # a log wraps; `slo_report` never is.
        self.log_cap = int(log_cap)
        self.timeline = RingLog(log_cap)      # (t, resident_bytes, model)
        self.stats_log = RingLog(log_cap)     # RunStats per executed batch
        # online-loop observability (serve()): every prefetch decision,
        # idle wait, and executed batch — what the scenario tests assert on
        self.prefetch_log = RingLog(log_cap)  # (t, current, target, specul.)
        self.idle_log = RingLog(log_cap)      # (t, next_arrival)
        self.batch_log = RingLog(log_cap)     # (t, model, batch_size)
        self.rejected = RingLog(log_cap)      # arrivals for unknown models
        # SLO-loop observability: every admission decision against a
        # deadline and every preemption point — scenario-test ground truth
        self.admission_log = RingLog(log_cap)  # (t, model, eta, deadl, kind)
        self.preempt_log = RingLog(log_cap)   # (t, model, op_idx)
        # deadline-aware batch cap observability: every group the cap
        # truncated — (t, model, admitted_size, deferred_size)
        self.defer_log = RingLog(log_cap)
        # online re-planning observability (serve(replan=True)): every
        # drift trigger and plan swap, with the cache-ledger snapshots
        # that prove the swap reused resident bytes instead of evicting
        self.replan_log = RingLog(log_cap)
        # unified-budget observability: every KV/arena pool event —
        # (t, model, event, bytes) with event in {"grow", "grow_rejected",
        # "offload", "drop", "resume", "arena", "arena_rejected"}
        self.kv_log = RingLog(log_cap)
        # exact streaming aggregates (survive ring-buffer truncation):
        # what slo_report() and launch/serve.py read at trace scale
        self.deferred_joins = 0               # members requeued by caps
        self.admission_counts: Dict[str, int] = {}   # kind -> rejections
        self.kv_grown_bytes = 0               # accepted KV pool growth
        self.kv_rejects = 0                   # *_rejected pool events
        self.mix_tracker: Optional[MixTracker] = None
        self.cost_model: Optional[BatchLatencyEstimator] = None
        self._kv_tok_bytes: Dict[str, int] = {}
        self._arena_need: Dict[str, int] = {}
        self._model_bytes_total: Dict[str, int] = {}
        self._plan_latency_cache: Dict[str, float] = {}
        self._executors: Dict[str, object] = {}
        self._protected: Dict[str, List[tuple]] = {}
        self._planned = False

    # -- registration ------------------------------------------------------
    def register(self, name: str, model: HostModel):
        if model.device != self.device:
            raise ValueError(f"model {name!r} runs on {model.device}, the "
                             f"engine on {self.device}")
        self.models[name] = model
        self._planned = False
        self._model_bytes_total.pop(name, None)
        self._kv_tok_bytes.pop(name, None)
        self._arena_need.pop(name, None)
        # re-planning replaces EVERY model's plan (the budget is shared),
        # so every cached executor is stale, not just this model's
        self._executors.clear()
        if self.policy == "stream" and self.cache is None:
            # legacy single-model planning against m_peak (no shared pool)
            g = model.graph
            caps = capacities(g, self.chunk_bytes, self.hw)
            prob = OPGProblem(g, self.chunk_bytes, self.m_peak, caps)
            sol = solve(prob, self.solver_cfg)
            self.plans[name] = OverlapPlan.from_solution(prob, sol)

    # -- unified-budget sizing ----------------------------------------------
    def _kv_token_bytes(self, name: str) -> int:
        """Bytes of KV cache one decoded token adds for `name`: K and V
        per attention layer at the graph's dtype (HostModel builds with
        dtype_bytes=4), GQA-aware via n_kv_heads."""
        b = self._kv_tok_bytes.get(name)
        if b is None:
            m = self.models[name]
            n_attn = sum(1 for op in m.graph.ops if op.kind == "attention")
            b = 2 * n_attn * m.cfg.n_kv_heads * m.cfg.resolved_head_dim * 4
            self._kv_tok_bytes[name] = b
        return b

    def _kv_seq_bytes(self, name: str, tokens: int) -> int:
        """Page-aligned KV bytes a `tokens`-long context pins."""
        page = self.kv_spec.page_bytes
        raw = self._kv_token_bytes(name) * max(0, int(tokens))
        return -(-raw // page) * page if raw else 0

    def _arena_bytes(self, name: str) -> int:
        need = self._arena_need.get(name)
        if need is None:
            need = arena_size(self.models[name].graph)
            self._arena_need[name] = need
        return need

    def _build_reserves(self) -> Optional[Dict[str, ReservationSpec]]:
        """Per-model ReservationSpecs for the joint allocator — None when
        the engine runs the weights-only path (keeps plan_multi_model
        bit-for-bit the weights-only call)."""
        if not self.unified:
            return None
        out: Dict[str, ReservationSpec] = {}
        for n, m in self.models.items():
            ab = self._arena_bytes(n) if self.use_arena else 0
            sb = tgt = 0
            ben = 0.0
            if self.kv_spec is not None and self.kv_target_seqs > 0:
                toks = self.kv_seq_tokens or m.seq
                sb = self._kv_seq_bytes(n, toks)
                tgt = self.kv_target_seqs if sb else 0
                # admitting one more resident sequence saves its restream
                # cost (reload bytes or recompute-equivalents) per visit
                bw = self.disk_bw if self.disk_bw > 0 else self.hw.stream_bw
                pages = sb // self.kv_spec.page_bytes
                ben = self.kv_spec.restore_bytes() * pages / bw
            out[n] = ReservationSpec(arena_bytes=ab, kv_seq_bytes=sb,
                                     kv_target_seqs=tgt, kv_benefit_s=ben)
        return out

    def _ensure_planned(self):
        if self._planned:
            return
        if self.policy == "stream" and self.cache is not None:
            self.multi_plan = plan_multi_model(
                {n: m.graph for n, m in self.models.items()},
                self.chunk_bytes, self.budget_bytes, hw=self.hw,
                solver_cfg=self.solver_cfg, mix=self.mix,
                alloc_mode=self.alloc_mode, reserves=self._build_reserves())
            self.plans = dict(self.multi_plan.plans)
        self._plan_latency_cache.clear()
        self._planned = True

    def _executor(self, name: str):
        ex = self._executors.get(name)
        if ex is None:
            if self.policy == "stream":
                ex = StreamingExecutor(self.models[name], self.plans[name],
                                       disk_bw=self.disk_bw, cache=self.cache,
                                       cache_key=name)
            else:
                ex = PreloadExecutor(self.models[name], disk_bw=self.disk_bw,
                                     cache=self.cache, cache_key=name)
            self._executors[name] = ex
        return ex

    # -- scheduling --------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _schedule(self) -> List[Request]:
        """Interleave across models round-robin, preserving each model's
        FIFO order — the multi-DNN mix the paper's Fig 6 measures."""
        if not self.interleave:
            out, self.queue = self.queue, []
            return out
        per_model: Dict[str, List[Request]] = {}
        for r in self.queue:
            per_model.setdefault(r.model, []).append(r)
        self.queue = []
        out: List[Request] = []
        while any(per_model.values()):
            for name in list(per_model):
                if per_model[name]:
                    out.append(per_model[name].pop(0))
        return out

    # -- arrival-aware scheduling (serve) ----------------------------------
    def _rr_distance(self, name: str, last: Optional[str]) -> int:
        """Cyclic registration-order distance after `last` — the round-robin
        tie-break that keeps equal-arrival models rotating fairly."""
        order = list(self.models)
        if name not in order:
            return 0
        if last is None or last not in order:
            return order.index(name)
        return (order.index(name) - order.index(last) - 1) % len(order)

    def _weights_total_bytes(self, name: str) -> int:
        """Total host-weight bytes of one model (memoized)."""
        total = self._model_bytes_total.get(name)
        if total is None:
            total = sum(a.nbytes
                        for a in self.models[name].host_weights.values())
            self._model_bytes_total[name] = total
        return total

    def _cold_bytes(self, name: str) -> int:
        """Bytes of `name`'s weights NOT resident in the shared pool right
        now — what the next batch must restream, and the cold-bytes
        feature an ``OnlineLatencyModel`` cost model fits."""
        if self.cache is None:
            return 0
        return max(0, self._weights_total_bytes(name)
                   - self.cache.model_bytes(name))

    def _restream_cost_s(self, name: str) -> float:
        """Seconds of storage streaming `name` needs before it can execute
        at full speed: bytes of its weights NOT resident in the shared pool
        over disk bandwidth. The slo scheduler folds this into urgency, so
        "which model runs next" accounts for weight-loading time — a cold
        model must start earlier than a warm one to make the same deadline
        (Demand Layering's deadline-aware pipelined loading)."""
        if self.cache is None or self.disk_bw <= 0:
            return 0.0
        return self._cold_bytes(name) / self.disk_bw

    def _pick_next_model(self, pending: Dict[str, Deque[Request]],
                         last: Optional[str],
                         scheduler: str = "arrival",
                         urgency: Optional[Callable[[str], float]] = None
                         ) -> Optional[str]:
        """Next model to RUN.

        * "fifo" / "arrival" — the model whose head request has waited
          longest (earliest arrival = global cross-model FIFO, which is
          starvation-free under skewed rates); ties rotate round-robin
          after `last`.
        * "slo" — earliest-feasible-deadline first: ``urgency(name)`` is
          the latest virtual time the head's work can start and still meet
          its deadline (deadline − exec estimate − restream cost for cold
          chunks); deadline-less heads sort last and fall back to FIFO.
        * "static" — the original interleave: rotate registration order after
          `last`, first non-empty queue wins, arrival times ignored."""
        names = [n for n, q in pending.items() if q]
        if not names:
            return None
        if scheduler == "static":
            return min(names, key=lambda n: self._rr_distance(n, last))
        if scheduler == "slo" and urgency is not None:
            return min(names, key=lambda n: (urgency(n),
                                             pending[n][0].arrival_s,
                                             self._rr_distance(n, last)))
        return min(names, key=lambda n: (pending[n][0].arrival_s,
                                         self._rr_distance(n, last)))

    def _pick_prefetch_target(self, pending: Dict[str, Deque[Request]],
                              stream: Optional[RequestStream],
                              current: str,
                              scheduler: str = "arrival",
                              urgency: Optional[Callable[[str], float]] = None
                              ) -> Tuple[Optional[str], bool]:
        """Next model to PREFETCH while `current` executes.

        * "fifo" / "arrival" — from actual queue state: the queued model
          whose head has waited longest (depth breaks ties — a deeper queue
          is the likelier next run under batching). With no other queue
          non-empty, fall back to the trace's upcoming arrivals
          (speculative warm; shallow lookahead).
        * "slo" — the most deadline-urgent queued model: warming the model
          the EDF pick will run next shrinks exactly the restream time its
          feasibility hinges on. Speculative fallback as above.
        * "static" — next non-empty queue in registration rotation after
          `current`, blind to arrivals and depths (the original keying that
          bursty traffic invalidates)."""
        cands = [n for n, q in pending.items() if q and n != current]
        if cands:
            if scheduler == "static":
                return min(cands,
                           key=lambda n: self._rr_distance(n, current)), False
            if scheduler == "slo" and urgency is not None:
                return min(cands,
                           key=lambda n: (urgency(n),
                                          pending[n][0].arrival_s,
                                          -len(pending[n]))), False
            return min(cands, key=lambda n: (pending[n][0].arrival_s,
                                             -len(pending[n]))), False
        if scheduler != "static" and stream is not None:
            # O(1) fast path: the next future arrival is almost always a
            # warmable target — only scan deeper (O(n) nsmallest over a
            # trace-scale heap) when the top can't be warmed
            nxt = stream.peek_next()
            if nxt is None:
                return None, False
            if nxt.model != current and nxt.model in self.models:
                return nxt.model, True
            for r in stream.peek_upcoming():
                if r.model != current and r.model in self.models:
                    return r.model, True
        return None, False

    def _take_group(self, q: Deque[Request],
                    cfg: Optional[BatcherConfig]) -> List[Request]:
        """Pop the head plus any already-arrived requests the batcher's
        grouping rule admits (per-model FIFO preserved)."""
        group = [q.popleft()]
        if cfg is None:
            return group
        while q and can_join(group[0], q[0], len(group), cfg):
            group.append(q.popleft())
        return group

    # -- cross-model overlap ----------------------------------------------
    def _peak_estimate(self, name: str) -> int:
        if self.multi_plan is not None and name in self.multi_plan.peaks:
            return self.multi_plan.peaks[name]
        return sum(a.nbytes for a in self.models[name].host_weights.values())

    def _prefetch_limit(self, current: str) -> int:
        if self.multi_plan is not None:
            return self.multi_plan.prefetch_budget(current, reserve=0.1)
        # preload policy: no plan, size from model bytes
        return max(0, int(0.9 * self.budget_bytes)
                   - self._peak_estimate(current))

    def _protect_and_prefetch(self, name: str, limit: int,
                              stop: threading.Event,
                              lookahead_ops: Optional[int] = None):
        """Pin the next model's earliest-scheduled resident entries and
        stream its missing ones into the pool, spending at most `limit`
        bytes of pinned+prefetched residency. Runs on a background thread
        while the current model computes; `stop` is set when that model
        finishes so the thread winds down before pins are released.
        `lookahead_ops` bounds how deep into the plan the prefetch reaches
        (speculative warms stay shallow)."""
        cache, model = self.cache, self.models[name]
        pinned = self._protected.setdefault(name, [])
        used = 0
        h2d = HostToDevice(self.device)

        def hold(key, nbytes_if_load=None, host=None):
            nonlocal used
            if stop.is_set():
                return False
            got = cache.pin_existing(key)
            if got is not None:
                if used + got > limit:
                    cache.release(key)
                    return False
                pinned.append(key)
                used += got
                return True
            if host is None:
                return True                       # nothing resident, no load
            if used + nbytes_if_load > limit:
                return False
            if self.disk_bw > 0:
                # simulated storage stage, interruptible: a set stop flag
                # must not leave the join through a long sleep
                if stop.wait(timeout=nbytes_if_load / self.disk_bw):
                    return False
            if stop.is_set():
                return False
            with h2d.copies():
                arr = put_chunk(h2d, host)
            # a pool entry is ready to read: the copy lands before check-in
            ev = h2d.mark()
            if ev is not None:
                ev.synchronize()
            if cache.put(key, arr, nbytes_if_load, pin=True):
                pinned.append(key)
                used += nbytes_if_load
            return True

        if self.policy == "stream":
            plan = self.plans[name]
            sizes = {w: model.host_weights[w].nbytes
                     for w in model.graph.weights}
            whole, chunks = self.multi_plan.prefetch_schedule(
                name, sizes, limit, lookahead_ops=lookahead_ops) \
                if self.multi_plan is not None \
                else (list(plan.preload), [])
            for w in whole:
                if not hold((name, w, "w"), sizes[w], model.host_weights[w]):
                    return
            host_chunks = {}
            for t in chunks:
                if cache.contains((name, t.weight, "w")):
                    hold((name, t.weight, "w"))   # pin assembled, skip chunks
                    continue
                if t.weight not in host_chunks:
                    host_chunks[t.weight] = chunk_rows(
                        model.host_weights[t.weight], plan.chunk_bytes)
                hcs = host_chunks[t.weight]
                for ci in range(t.chunk_lo, min(t.chunk_hi, len(hcs))):
                    if not hold((name, t.weight, ci), hcs[ci].nbytes, hcs[ci]):
                        return
            if lookahead_ops is not None:
                return        # speculative warm: stop at the lookahead edge
            # protect the remainder of what's already resident, in op order
            for w in model.graph.weights:
                if used >= limit or stop.is_set():
                    return
                hold((name, w, "w"))
        else:
            for w in model.graph.weights:
                if not hold((name, w, "w"), model.host_weights[w].nbytes,
                            model.host_weights[w]):
                    return

    def _start_prefetch(self, target: str, current: str,
                        lookahead_ops: Optional[int] = None):
        limit = self._prefetch_limit(current)
        stop = threading.Event()
        th = threading.Thread(target=self._protect_and_prefetch,
                              args=(target, limit, stop, lookahead_ops),
                              daemon=True)
        th.start()
        return th, stop

    def _stop_prefetch(self, th: Optional[threading.Thread],
                       stop: Optional[threading.Event]):
        if th is not None:
            # the stop flag bounds the join: the thread checks it before
            # every hold, so no pin can be appended after this returns
            # and _release_protection cannot orphan a live pin list
            stop.set()
            th.join()

    def _release_protection(self, name: str):
        for key in self._protected.pop(name, []):
            self.cache.release(key)

    # -- unified-budget runtime ---------------------------------------------
    @staticmethod
    def _sid(r: Request):
        """KV sequence key for a request: the caller's correlation id when
        present (stable across a Router retry) else object identity."""
        return r.req_id if r.req_id is not None else id(r)

    def _kv_need_bytes(self, name: str, r: Request) -> int:
        """Page-aligned KV bytes `r` will pin end-to-end: prompt prefill
        plus its planned decode tokens."""
        return self._kv_seq_bytes(name, len(r.tokens) + r.decode_tokens)

    def _kv_event(self, entry: tuple):
        """Record one ``(t, model, event, bytes)`` KV/arena pool event:
        the ring-buffered ``kv_log`` entry plus the exact streaming
        counters (``kv_grown_bytes`` / ``kv_rejects``) that stay correct
        after the ring wraps."""
        event, nbytes = entry[2], entry[3]
        if event == "grow":
            self.kv_grown_bytes += nbytes
        elif event.endswith("rejected"):
            self.kv_rejects += 1
        self.kv_log.append(entry)

    def _kv_batch_begin(self, name: str, item: _RunningBatch, t: float):
        """Charge a starting batch's fixed reservations to the pool: the
        model's activation arena for the duration of the batch, and each
        member sequence's prompt KV (prefill writes the whole context)."""
        cache = self.cache
        if self.use_arena:
            nb = self._arena_bytes(name)
            ok = cache.reserve_arena(name, nb)
            self._kv_event((t, name, "arena" if ok
                                else "arena_rejected", nb))
        if self.kv_spec is None:
            return
        item.kv_done = {}
        for r in item.batch.requests:
            sid = self._sid(r)
            item.kv_done[sid] = 0
            nb = self._kv_token_bytes(name) * len(r.tokens)
            if nb and not cache.kv_grow(name, sid, nb):
                self._kv_event((t, name, "grow_rejected", nb))
            elif nb:
                self._kv_event((t, name, "grow", nb))

    def _kv_decode_growth(self, name: str, item: _RunningBatch, t: float):
        """Charge decode-step KV growth after an executed segment, prorated
        by plan progress: a request with ``decode_tokens`` planned has
        written ``decode_tokens * completed_frac`` of them by this op
        boundary. The page tail in the cache accumulates raw bytes, so
        incremental charges never over-allocate pages."""
        if item.kv_done is None:
            return
        frac = 1.0 if item.state is None else \
            min(1.0, item.state.op_idx / max(item.n_ops, 1))
        per_tok = self._kv_token_bytes(name)
        for r in item.batch.requests:
            sid = self._sid(r)
            target = int(r.decode_tokens * frac)
            delta = target - item.kv_done.get(sid, 0)
            if delta <= 0:
                continue
            if self.cache.kv_grow(name, sid, delta * per_tok):
                self._kv_event((t, name, "grow", delta * per_tok))
            else:
                self._kv_event((t, name, "grow_rejected",
                                    delta * per_tok))
            item.kv_done[sid] = target

    def _kv_suspend(self, name: str, item: _RunningBatch, t: float):
        """A batch was preempted: its sequences' pages are offloaded in
        place (unpinned — warm, evictable at the restore cost) and the
        arena reservation ends so the preempting model's scratch fits."""
        if item.kv_done is not None:
            for r in item.batch.requests:
                sid = self._sid(r)
                pages = self.cache.kv_release(name, sid)
                self._kv_event((t, name, "offload",
                                    pages * self.kv_spec.page_bytes))
        if self.use_arena:
            self.cache.release_arena(name)

    def _kv_resume_batch(self, name: str, item: _RunningBatch, t: float):
        """A suspended batch resumes: re-reserve the arena and re-pin each
        sequence's pages, restoring (reload or recompute) the ones evicted
        while it was offloaded. A sequence that cannot be restored is
        logged and its bytes re-charged lazily by the next decode step."""
        if self.use_arena:
            nb = self._arena_bytes(name)
            ok = self.cache.reserve_arena(name, nb)
            self._kv_event((t, name, "arena" if ok
                                else "arena_rejected", nb))
        if item.kv_done is None:
            return
        for r in item.batch.requests:
            sid = self._sid(r)
            got = self.cache.kv_resume(name, sid)
            if got is None:
                self._kv_event((t, name, "resume_rejected",
                                    self.cache.kv_seq_bytes(name, sid)))
            else:
                self._kv_event((t, name, "resume",
                                    got[1] * self.kv_spec.page_bytes))

    def _kv_finish(self, name: str, item: _RunningBatch,
                   t: float) -> Dict:
        """A batch completed: drop every member sequence's pages (the
        context is dead) and unpin the arena (warm scratch for the model's
        next batch). Returns per-sequence KV bytes held at completion —
        the Response's ``kv_bytes`` field."""
        out: Dict = {}
        if item.kv_done is not None:
            for r in item.batch.requests:
                sid = self._sid(r)
                out[sid] = self.cache.kv_seq_bytes(name, sid)
                self.cache.kv_release(name, sid, drop=True)
                self._kv_event((t, name, "drop", out[sid]))
        if self.use_arena:
            self.cache.release_arena(name)
        return out

    # -- online re-planning (serve(replan=True)) ---------------------------
    def _replan_worker(self, mix: MixSpec, slot: dict,
                       calibration: Optional[Dict[str, float]] = None):
        """Background thread body: compute a fresh MultiModelPlan for the
        observed mix. The result lands in ``slot`` and the serving loop
        swaps it in at a batch boundary — planning never blocks serving.
        ``calibration`` (per-model observed/analytic latency scales from
        a calibrated ``OnlineLatencyModel``) makes the allocator price
        caps with the fitted curves instead of the raw simulator."""
        try:
            slot["plan"] = plan_multi_model(
                {n: m.graph for n, m in self.models.items()},
                self.chunk_bytes, self.budget_bytes, hw=self.hw,
                solver_cfg=self.solver_cfg, mix=mix,
                alloc_mode=self.alloc_mode, reserves=self._build_reserves(),
                calibration=calibration)
        except Exception as e:  # noqa: BLE001 — surfaced via replan_log,
            slot["error"] = e  # a planner bug must not strand the queue

    def _analytic_latency_s(self, name: str) -> float:
        """Analytic per-visit latency of the model's CURRENTLY INSTALLED
        plan (memoized per swap) — the denominator of the learned
        observed/analytic calibration scale."""
        lat = self._plan_latency_cache.get(name)
        if lat is None:
            plan = self.plans.get(name)
            if plan is None:
                return 0.0
            from repro_torch.core.plan import simulate
            lat = simulate(plan, self.models[name].graph,
                           self.hw).integrated_s
            self._plan_latency_cache[name] = lat
        return lat

    def _calibration_scales(self, cost) -> Optional[Dict[str, float]]:
        """Fitted latency corrections for the allocator, or None when the
        cost model is not a calibrated OnlineLatencyModel (the analytic
        path then runs untouched — the dormancy contract)."""
        if not isinstance(cost, OnlineLatencyModel):
            return None
        scales = cost.calibration_scales(
            {n: self._analytic_latency_s(n) for n in self.models})
        return scales or None

    def _predict_infeasible(self, cost, slo: Optional[SLOConfig],
                            mix: MixSpec) -> Dict[str, dict]:
        """The proactive re-plan predicate: for every model carrying
        observed traffic, evaluate the FITTED latency curve at the current
        split's cap (a visit restreams at least ``total - cap`` bytes
        when the model is held to its cap) and flag models whose
        predicted per-visit seconds exceed their SLO — the current split
        cannot meet the observed mix's deadlines. Empty until the cost
        model calibrates, so the default path never fires."""
        if slo is None or not isinstance(cost, OnlineLatencyModel):
            return {}
        split = dict(self.multi_plan.meta.get("split", {})) \
            if self.multi_plan is not None else {}
        flagged: Dict[str, dict] = {}
        for n in self.models:
            if mix.weight(n) <= 0 or not cost.calibrated(n):
                continue
            limit = slo.slo_for(n)
            if not math.isfinite(limit):
                continue
            cap = int(split.get(n, self.budget_bytes))
            cold = max(0, self._weights_total_bytes(n) - cap)
            pred = cost.predict(n, 1, cold_bytes=cold)
            if pred > limit + 1e-9:
                flagged[n] = {"predicted_s": pred, "slo_s": limit,
                              "cap_bytes": cap, "cold_bytes": cold}
        return flagged

    def _swap_plan(self, new_mm: MultiModelPlan, now: float, mix: MixSpec,
                   proactive: bool = False):
        """Install a re-planned MultiModelPlan at a batch boundary.

        The shared pool is deliberately left untouched: every resident
        entry of a still-registered model is bytes the new plan wants
        (cache keys are (model, weight, chunk) — plan-independent), so
        the swap reuses them instead of forcing evictions. The ledger
        snapshots taken around the swap prove it moved zero bytes; the
        mix-drift scenario test asserts on exactly this log entry.

        ``proactive=True`` (a feasibility-triggered re-plan) additionally
        SHRINKS models whose new cap is below their current residency:
        their unpinned over-cap bytes are evicted now, ahead of the
        predicted miss, so the favored model's prefetch finds room
        immediately instead of evicting one chunk at a time mid-stream.
        The freed bytes are recorded in the swap's log entry."""
        cache = self.cache
        before = cache.stats_snapshot() if cache is not None else None
        resident = cache.keys() if cache is not None else []
        wanted = [k for k in resident
                  if isinstance(k, tuple) and k and k[0] in new_mm.plans
                  and k[1] in self.models[k[0]].graph.weights]
        self.multi_plan = new_mm
        self.plans = dict(new_mm.plans)
        self._executors.clear()          # executors bind plans at build time
        self._plan_latency_cache.clear()  # calibration denominators rebind
        shrunk = 0
        if proactive and cache is not None:
            split = new_mm.meta.get("split", {})
            for n, cap in split.items():
                if cache.model_bytes(n) > int(cap):
                    shrunk += cache.evict_model_to(n, int(cap))
        after = cache.stats_snapshot() if cache is not None else None
        still_resident = cache is not None and \
            all(cache.contains(k) for k in wanted)
        self.replan_log.append({
            "t": now, "event": "swap", "mix": mix.as_dict(),
            "split": dict(new_mm.meta.get("split", {})),
            "proactive": proactive, "shrunk_bytes": shrunk,
            "reused_keys": len(wanted),
            "reused_bytes": sum(cache.model_bytes(n) for n in new_mm.plans)
            if cache is not None else 0,
            "wanted_still_resident": still_resident,
            "ledger_before": before, "ledger_after": after})
        self.mix = mix

    # -- execution ---------------------------------------------------------
    def run_all(self) -> List[Response]:
        self._ensure_planned()
        ordered = self._schedule()
        out: List[Response] = []
        t_base = time.perf_counter()
        prefetcher: Optional[threading.Thread] = None
        pf_stop: Optional[threading.Event] = None
        for i, req in enumerate(ordered):
            nxt = ordered[i + 1] if i + 1 < len(ordered) else None
            if (self.prefetch and nxt is not None
                    and nxt.model != req.model):
                prefetcher, pf_stop = self._start_prefetch(nxt.model,
                                                           req.model)
            t0 = time.perf_counter()
            stats = self._executor(req.model).run(req.tokens)
            dt = time.perf_counter() - t0
            self._stop_prefetch(prefetcher, pf_stop)
            prefetcher, pf_stop = None, None
            self._release_protection(req.model)
            result, stats.result = stats.result, None   # keep the log light:
            self.stats_log.append(stats)                # the tensor goes to
                                                        # the Response only
            base_t = t0 - t_base
            n = max(len(stats.residency), 1)
            for j, r in enumerate(stats.residency):
                self.timeline.append((base_t + dt * (j + 1) / n, r,
                                      req.model))
            out.append(Response(
                req.model, dt, stats.init_s, stats.exec_s, stats.peak_bytes,
                avg_bytes=stats.avg_bytes, cache_hits=stats.cache_hits,
                cache_misses=stats.cache_misses,
                cache_hit_rate=stats.cache_hit_rate, result=result,
                arrival_s=req.arrival_s, priority=req.priority,
                req_id=req.req_id))
        return out

    def serve(self, stream: RequestStream, *,
              config: Optional[ServeConfig] = None, clock=None, **kw):
        """Continuous arrival-aware loop: serve a live ``RequestStream``
        until it is closed and drained. Same-model arrivals inside the
        batcher window coalesce into one padded execution; responses are
        de-batched back to per-request latencies (arrival → completion).

        ``config`` is the serve-loop knob set as one validated
        ``ServeConfig``; the legacy loose keyword arguments (every
        ``ServeConfig`` field name) are still accepted and merged — an
        explicit kwarg overrides the matching config field, with a
        ``DeprecationWarning``. Returns a ``List[Response]`` under the
        default ``result_mode="object"``, or a columnar
        ``ResponseTable`` (struct-of-arrays, no result tensors) under
        ``ServeConfig(result_mode="columnar")`` — the 10^6-request
        trace-replay mode; the metric reducers accept both.

        ``clock`` is the injectable time source (default: real time). With
        a ``SimClock`` and a trace stream the loop — including every
        prefetch, admission, and preemption decision in the logs — is
        fully deterministic.

        ``step_mode`` picks how ``run()`` crosses idle gaps:
        ``"event"`` (default) makes every gap cost one step — closed
        streams sleep straight to the next arrival (bit-for-bit the old
        behaviour) and live streams on a real clock park on the stream's
        push/close condition; ``"poll"`` keeps the legacy
        ``poll_interval_s`` stepping for open streams (the
        equivalence-test baseline). See ``ServeSession.run``.

        ``scheduler`` selects run/prefetch-target picking:
          * "fifo" (alias "arrival") — global cross-model FIFO over queue
            heads (queue-depth + arrival-time aware prefetch);
          * "slo" — earliest-feasible-deadline first: each queue head's
            urgency is its deadline minus the per-batch exec estimate
            (``cost_model``, EWMA over ticked durations) minus the pool's
            restream cost for its cold chunks;
          * "static" — the original registration-order interleave, kept for
            A/B benchmarking.

        ``slo`` derives deadlines for requests that don't carry one
        (``arrival + slo_for(model)``); requests stay deadline-less when
        it's None. ``admission`` (default: on for "slo") rejects requests
        whose deadline is infeasible given current queue depth — and sheds
        queue heads that became hopeless — returning explicit
        ``Response(status="rejected")`` instead of silently inflating tail
        latency. ``preempt`` (default: on for "slo" under the stream
        policy) lets a running batch yield at an op boundary when a
        waiting queue would otherwise miss a strictly-earlier deadline;
        the suspended run keeps its loader, arrived chunks, and cache pins,
        so resuming never re-streams resident bytes.

        ``batch_cap`` (default: on for "slo") makes batch formation
        deadline-aware: a group stops admitting members as soon as the
        grown batch's exec estimate (``cost_model.estimate(model, size)``)
        plus the model's cold-chunk restream cost would overshoot the
        tightest admitted deadline, so coalescing a late arrival can never
        make the head miss. Excluded members are requeued at the head of
        the model's queue (FIFO preserved) and every truncation is logged
        in ``defer_log``. With slack deadlines the cap never binds and the
        schedule is bit-for-bit the uncapped one.

        Per-request ``priority`` weights (``Request.priority``, default
        1.0) bend the "slo" policy toward heavier work: runnable queues
        and each model's queue order by priority-weighted slack (a
        priority-p request's positive slack is divided by p, its lateness
        multiplied by p), admission counts only work that would actually
        run before the newcomer under that weighted order, and shedding
        therefore reaches hopeless low-priority heads first. Priority 0 is
        best-effort: it sorts after all deadline work and is shed rather
        than allowed to displace it. Because the primary key is still
        slack, a low-priority request's urgency rises as its deadline
        approaches (EDF aging) — heavy traffic cannot starve it forever.

        ``replan=True`` turns on online mix-aware re-planning: every
        arrival feeds an EWMA per-model rate tracker (``mix_halflife_s``
        on the serving clock), and once at least ``replan_min_observed``
        arrivals are in and the observed mix has drifted more than
        ``replan_drift`` (total-variation distance) from the mix the
        current plan was built for, a background thread re-runs the joint
        allocator for the observed mix. The finished plan is swapped in
        at a batch boundary; the shared pool is never cleared — resident
        bytes the new plan still wants are reused, and the swap's ledger
        snapshots (``replan_log``) prove no forced eviction happened.
        ``replan_background=False`` plans synchronously at the trigger
        boundary instead — serving pauses for the solve, but WHICH batch
        boundary the swap lands on no longer depends on wall-clock solver
        speed (SimClock replays and A/B benchmarks use this for
        schedule-deterministic artifacts). A re-plan that fails is logged
        (``event="failed"``) and disables re-planning for the rest of the
        call — a persistent planner error must not retrigger every loop
        iteration.

        ``replan_feasibility`` (on by default, but inert unless
        ``cost_model`` is a CALIBRATED ``OnlineLatencyModel``) adds the
        PROACTIVE trigger: when the fitted latency curve evaluated at the
        current split's caps predicts some observed-traffic model cannot
        meet its SLO per visit, the re-plan fires immediately
        (``event="feasibility"`` in ``replan_log``) — before the
        predicted-infeasible batch boundary, not at the miss — the
        allocator prices the new split with the fitted curves
        (``calibration=``), and the swap proactively shrinks/evicts
        over-cap models so the favored model finds room at once. Each
        distinct split triggers at most once — a split the re-planner
        cannot improve must not retrigger every iteration."""
        return self.serve_session(stream, config=config, clock=clock,
                                  **kw).run()

    def serve_session(self, stream: RequestStream, *,
                      config: Optional[ServeConfig] = None, clock=None,
                      **kw) -> "ServeSession":
        """The steppable form of ``serve()``: build a ``ServeSession``
        whose ``step()`` advances the loop by one event (executed batch
        segment / idle point) and whose ``run()`` drains it to completion
        — ``serve()`` is exactly ``serve_session(...).run()``. A fleet
        front end (``serving/router.py``) interleaves many sessions on their
        own clocks by stepping whichever replica's ``next_time()`` is
        earliest, without threads and without the engine ever sleeping on
        its own. Takes the same ``config=`` / legacy keyword surface as
        ``serve()`` (validation — unknown scheduler/step_mode/
        result_mode, incoherent replan knobs — raises here, at
        construction)."""
        cfg = resolve_serve_config(config, kw)
        return ServeSession(self, stream, clock or MonotonicClock(), cfg)

    def _serve_loop(self, ses: "ServeSession", stream: RequestStream,
                    clock, *, batcher: Optional[BatcherConfig] = None,
                    scheduler: str = "arrival",
                    speculative_lookahead_ops: int = 8,
                    slo: Optional[SLOConfig] = None,
                    admission: Optional[bool] = None,
                    preempt: Optional[bool] = None,
                    batch_cap: Optional[bool] = None,
                    cost_model: Optional[BatchLatencyEstimator] = None,
                    replan: bool = False,
                    replan_drift: float = 0.3,
                    replan_min_observed: int = 8,
                    mix_halflife_s: float = 0.5,
                    replan_background: bool = True,
                    replan_feasibility: bool = True):
        """Generator body of the online loop (see ``serve`` for the full
        contract). Yields control at every point the loop would otherwise
        block or complete work — WITHOUT sleeping; the caller owns time:

          * ``("idle", next_arrival | None)`` — nothing runnable; the
            caller sleeps/advances the clock (``ServeSession.run`` exactly
            reproduces the old in-loop sleeps);
          * ``("batch", (model, charged_s))`` — one batch completed and
            its responses were appended to ``ses.responses``;
          * ``("preempt", (model, op_idx))`` — the running batch yielded
            at an op boundary and now sits in ``ses.suspended``.
        """
        sched = "fifo" if scheduler == "arrival" else scheduler
        self._ensure_planned()
        if admission is None:
            admission = sched == "slo"
        if preempt is None:
            preempt = sched == "slo" and self.policy == "stream"
        if batch_cap is None:
            batch_cap = sched == "slo"
        cost = cost_model or BatchLatencyEstimator()
        self.cost_model = cost
        # online re-planning state: the tracker sees every arrival for a
        # registered model; a drift past the threshold kicks a background
        # planning thread whose result is swapped in at a batch boundary
        can_replan = (replan and self.policy == "stream"
                      and self.cache is not None)
        tracker = MixTracker(self.models, halflife_s=mix_halflife_s) \
            if can_replan else None
        self.mix_tracker = tracker
        replan_thread: Optional[threading.Thread] = None
        replan_slot: Optional[dict] = None
        # proactive-trigger latch: each distinct installed split fires the
        # feasibility re-plan at most once — when the allocator cannot
        # improve a split the fitted model dislikes, retriggering every
        # iteration would spin the planner forever
        feas_tried: set = set()
        # queue + response state lives ON the session so a fleet front end
        # can observe load / collect responses between steps; ses.suspended
        # is the single preemption slot
        pending = ses.pending
        out = ses.responses
        # columnar mode: append rows into the struct-of-arrays
        # table instead of constructing one Response object per request
        columnar = isinstance(out, ResponseTable)
        last: Optional[str] = None
        max_b = batcher.max_batch if batcher is not None else 1

        # deadlines derived from the SLOConfig live in a serve-local map —
        # caller-owned Request objects are never mutated, so replaying the
        # same trace under a different SLOConfig derives fresh deadlines
        derived: Dict[int, float] = {}

        def deadline_of(r: Request) -> float:
            if r.deadline_s is not None:
                return r.deadline_s
            d = derived.get(id(r))
            if d is None:
                d = slo.deadline_for(r) if slo is not None else math.inf
                derived[id(r)] = d
            return d

        def vd_of(r: Request) -> float:
            """Priority-scaled virtual deadline — the time-invariant key a
            model's queue is ordered by under "slo": ``arrival +
            (deadline − arrival) / priority``. Priority 1 keeps the real
            deadline (plain EDF, FIFO for equal SLOs); heavier requests
            pull their virtual deadline toward arrival; priority 0 /
            deadline-less work sorts last (+inf)."""
            d = deadline_of(r)
            if r.priority <= 0 or not math.isfinite(d):
                return math.inf
            return r.arrival_s + (d - r.arrival_s) / r.priority

        # admit-order sequence per request: the FIFO tie-break component
        # of the _SortedQueue key (assigned lazily at first key
        # computation == first insert; requeues reuse it, so a deferred
        # member's key — and therefore its position — never changes).
        # Serve-local like `derived`: caller Requests are never mutated.
        seqs: Dict[int, int] = {}
        seq_counter = itertools.count()

        def qkey(r: Request) -> tuple:
            s = seqs.get(id(r))
            if s is None:
                s = seqs[id(r)] = next(seq_counter)
            return (vd_of(r), r.arrival_s, s)

        for n in self.models:
            pending.setdefault(
                n, _SortedQueue(qkey) if sched == "slo" else deque())

        def urgency(name: str, t: Optional[float] = None) -> float:
            # latest feasible start for this queue's head (deadline minus
            # compute estimate minus cold-chunk restream time), bent by
            # the head's priority weight relative to ``t`` (the loop-top
            # ``now`` by default; yield_check passes its prorated time)
            head = pending[name][0]
            lfs = (deadline_of(head) - cost.estimate(name)
                   - self._restream_cost_s(name))
            return weighted_urgency(lfs, now if t is None else t,
                                    head.priority)

        def backlog_before(r: Request) -> float:
            """Estimated seconds of queued+suspended work that will run
            BEFORE ``r``. Under weighted EDF only work with an
            earlier-or-equal priority-scaled virtual deadline goes first
            — queued low-priority work does not block a heavy newcomer's
            admission; under fifo/static everything already queued does."""
            vd, d = vd_of(r), deadline_of(r)
            s = 0.0
            if ses.suspended is not None:
                if sched != "slo":
                    blocks = True
                else:
                    # the suspended run delays r only if weighted EDF
                    # would actually resume it first — the same key the
                    # resume decision uses, so a suspended best-effort
                    # batch never inflates a heavy newcomer's ETA
                    lfs = (d - cost.estimate(r.model)
                           - self._restream_cost_s(r.model))
                    blocks = ses.suspended.urgency(cost, now) \
                        <= weighted_urgency(lfs, now, r.priority)
                if blocks:
                    s += ses.suspended.remaining_s(cost)
            for n, q in pending.items():
                if not q:
                    continue
                # fifo/static: everything queued runs first (O(1) len);
                # slo: only earlier-or-equal virtual deadlines do — the
                # indexed rank replaces the per-arrival O(n) queue walk
                ahead = len(q) if sched != "slo" else q.rank_leq_vd(vd)
                # price the backlog at the batch sizes it will actually
                # form: under a growth-aware estimator a full batch
                # charges more than a size-1 one (with growth=0 this is
                # exactly ceil(ahead/max_b) * estimate)
                full, rem = divmod(ahead, max_b)
                s += full * cost.estimate(n, max_b)
                if rem:
                    s += cost.estimate(n, rem)
            return s

        def reject(r: Request, now: float, eta: float, kind: str):
            d = deadline_of(r)
            derived.pop(id(r), None)      # r leaves the loop: drop its entry
            seqs.pop(id(r), None)
            self.admission_counts[kind] = \
                self.admission_counts.get(kind, 0) + 1
            self.admission_log.append((now, r.model, eta, d, kind))
            if columnar:
                out.append(r.model, latency_s=max(0.0, now - r.arrival_s),
                           status="rejected", arrival_s=r.arrival_s,
                           deadline_s=d, priority=r.priority,
                           req_id=r.req_id)
            else:
                out.append(Response(r.model, max(0.0, now - r.arrival_s),
                                    0.0, 0.0, 0, status="rejected",
                                    arrival_s=r.arrival_s, deadline_s=d,
                                    priority=r.priority, req_id=r.req_id))

        def admit(r: Request, now: float, in_flight_s: float = 0.0,
                  in_flight_deadline: float = math.inf):
            if r.model not in self.models:
                # never let one bad request crash the loop and strand
                # everything queued behind it
                self.rejected.append(r)
                return
            if tracker is not None:
                # observed OFFERED mix (rejected arrivals included): the
                # split should follow traffic, not the admission filter
                tracker.observe(r.model, now)
            if admission and self.unified and self.kv_spec is not None:
                # true-memory-pressure admission: a sequence whose
                # end-to-end KV (prompt + planned decode) can never fit
                # alongside the model's arena is infeasible at ANY queue
                # depth — reject it now instead of serving it into a
                # mid-decode grow failure
                cap = self.cache.budget_bytes \
                    - (self._arena_bytes(r.model) if self.use_arena else 0)
                if self._kv_need_bytes(r.model, r) > cap:
                    reject(r, now, math.inf, "kv")
                    return
            d = deadline_of(r)
            if admission and math.isfinite(d):
                # the in-flight batch delays r only if it finishes first
                # (earlier-or-equal deadline) or cannot be preempted —
                # otherwise EDF yields to r at the next op boundary
                blocking = in_flight_s if (not preempt
                                           or in_flight_deadline <= d) else 0.0
                eta = (now + blocking + backlog_before(r)
                       + cost.estimate(r.model)
                       + self._restream_cost_s(r.model))
                if eta > d + 1e-9:
                    reject(r, now, eta, "infeasible")
                    return
            q = pending[r.model]
            if sched == "slo":
                # weighted-EDF queue order (stable: equal (vd, arrival)
                # keys keep FIFO via the admit seq — with uniform
                # priorities and one SLO this IS arrival order). The
                # indexed insert replaces the old O(n) reverse scan +
                # O(n) deque.insert, bit-for-bit order-preserving.
                q.push(r)
            else:
                q.append(r)

        def finish_replan(now: float):
            """Join the planning thread and swap its result in (or log the
            failure and stop re-planning for this call — a persistent
            planner error must not retrigger every iteration). Callers
            only invoke this between batches."""
            nonlocal replan_thread, replan_slot, can_replan
            replan_thread.join()
            err = replan_slot.get("error")
            if err is not None:
                self.replan_log.append({"t": now, "event": "failed",
                                        "error": repr(err)})
                can_replan = False
            else:
                self._swap_plan(replan_slot["plan"], now, replan_slot["mix"],
                                proactive=replan_slot.get("proactive",
                                                          False))
            replan_thread, replan_slot = None, None

        def split_signature() -> tuple:
            split = self.multi_plan.meta.get("split", {}) \
                if self.multi_plan is not None else {}
            return tuple(sorted((n, int(c)) for n, c in split.items()))

        def start_replan(now: float, mix_now: MixSpec, proactive: bool):
            nonlocal replan_thread, replan_slot
            calibration = self._calibration_scales(cost)
            replan_slot = {"mix": mix_now, "proactive": proactive}
            replan_thread = threading.Thread(
                target=self._replan_worker,
                args=(mix_now, replan_slot),
                kwargs={"calibration": calibration}, daemon=True)
            replan_thread.start()
            if not replan_background:
                # deterministic mode: solve at THIS boundary (trigger
                # conditions guarantee no suspended batch is in flight)
                finish_replan(now)

        while True:
            now = clock.now()
            for r in stream.poll(now):
                admit(r, now)
            if can_replan:
                if (replan_thread is not None and ses.suspended is None
                        and not replan_thread.is_alive()):
                    # batch boundary + plan ready: swap (pool untouched)
                    finish_replan(now)
                if (replan_thread is None
                        and tracker.observed >= replan_min_observed
                        # sync mode cannot swap over a suspended batch:
                        # defer the TRIGGER itself so the swap boundary
                        # stays wall-clock independent as documented
                        and (replan_background or ses.suspended is None)):
                    ref = self.mix if self.mix is not None \
                        else MixSpec.uniform(self.models)
                    drift = tracker.drift(ref)
                    if drift > replan_drift:
                        mix_now = tracker.mix()
                        self.replan_log.append(
                            {"t": now, "event": "trigger", "drift": drift,
                             "mix": mix_now.as_dict()})
                        start_replan(now, mix_now, proactive=False)
                    elif replan_feasibility:
                        # proactive trigger: the FITTED curve says the
                        # current split cannot meet the observed mix's
                        # deadlines — re-plan now, ahead of the miss,
                        # instead of waiting for drift or the boundary
                        # where the miss lands. Inert until the cost
                        # model calibrates (predicate returns {}).
                        mix_now = tracker.mix()
                        flagged = self._predict_infeasible(cost, slo,
                                                           mix_now)
                        sig = split_signature()
                        if flagged and sig not in feas_tried:
                            feas_tried.add(sig)
                            self.replan_log.append(
                                {"t": now, "event": "feasibility",
                                 "infeasible": flagged,
                                 "mix": mix_now.as_dict()})
                            start_replan(now, mix_now, proactive=True)
            if not any(pending.values()) and ses.suspended is None:
                if stream.exhausted:
                    break
                nxt_arrival = stream.next_arrival()
                if nxt_arrival is not None:
                    self.idle_log.append((now, nxt_arrival))
                    yield ("idle", nxt_arrival)
                elif stream.closed:
                    break
                else:                       # live stream, nothing queued yet
                    self.idle_log.append((now, None))
                    yield ("idle", None)
                continue
            urg = urgency if sched == "slo" else None
            name = self._pick_next_model(pending, last, sched, urg)
            if ses.suspended is not None and (
                    name is None
                    or ses.suspended.urgency(cost, now) <= urgency(name)):
                # weighted EDF says the suspended run's remaining work
                # goes next
                item, ses.suspended = ses.suspended, None
                name = item.name
                if self.unified:
                    # re-pin the batch's offloaded KV pages (restoring any
                    # evicted meanwhile) and re-reserve its arena
                    self._kv_resume_batch(name, item, now)
            else:
                q = pending[name]
                if admission:
                    # shed heads whose deadline became hopeless while they
                    # queued — an explicit rejection beats a guaranteed
                    # miss. The weighted-EDF queue order keeps heavier
                    # work ahead, so low-priority work reaches the head
                    # only once heavier work has drained — and is dropped
                    # there (or refused at admission) instead of ever
                    # being served into a miss ahead of it.
                    while q:
                        d = deadline_of(q[0])
                        eta = (now + cost.estimate(name)
                               + self._restream_cost_s(name))
                        if math.isfinite(d) and eta > d + 1e-9:
                            reject(q.popleft(), now, eta, "shed")
                        else:
                            break
                    if not q:
                        continue
                group = self._take_group(q, batcher)
                if self.unified and self.kv_spec is not None \
                        and len(group) > 1:
                    # KV-pressure batch cap: pinned bytes cannot be
                    # evicted, so the batch's end-to-end KV demand must
                    # fit inside budget − pinned. Keep the longest prefix
                    # that fits (the head always runs — its grow failures
                    # surface in kv_log, never a livelock) and requeue the
                    # rest at the FRONT (FIFO preserved), logged alongside
                    # the deadline cap's truncations.
                    headroom = self.cache.budget_bytes \
                        - self.cache.pinned_bytes()
                    acc = self._kv_need_bytes(name, group[0])
                    keep = 1
                    for r2 in group[1:]:
                        nb = self._kv_need_bytes(name, r2)
                        if acc + nb > headroom:
                            break
                        acc += nb
                        keep += 1
                    if keep < len(group):
                        for r2 in reversed(group[keep:]):
                            q.appendleft(r2)
                        self.deferred_joins += len(group) - keep
                        self.defer_log.append((now, name, keep,
                                               len(group) - keep))
                        group = group[:keep]
                bcfg = batcher or BatcherConfig()
                if batch_cap and len(group) > 1:
                    # deadline-aware feasibility cap: stop admitting
                    # members once the grown batch's estimate would blow
                    # the tightest admitted deadline; excluded members go
                    # back to the FRONT of the queue (FIFO preserved)
                    batch = make_batch(
                        group, bcfg, now=now,
                        estimate=lambda k, _n=name: cost.estimate(_n, k),
                        restream_cost_s=self._restream_cost_s(name),
                        deadline_of=deadline_of)
                    if batch.deferred:
                        for r2 in reversed(batch.deferred):
                            q.appendleft(r2)
                        self.deferred_joins += len(batch.deferred)
                        self.defer_log.append((now, name, batch.size,
                                               len(batch.deferred)))
                else:
                    batch = make_batch(group, bcfg)
                item = _RunningBatch(
                    name=name, batch=batch,
                    n_ops=len(self.models[name].graph.ops),
                    # the whole fused execution must land by the tightest
                    # member deadline (resolved through the SLO config)
                    deadline_s=min(deadline_of(r) for r in batch.requests),
                    priority=batch.priority)
            prefetcher = pf_stop = None
            target, speculative = self._pick_prefetch_target(
                pending, stream, name, sched, urg)
            if self.prefetch and target is not None and target != name:
                self.prefetch_log.append((now, name, target, speculative))
                prefetcher, pf_stop = self._start_prefetch(
                    target, name,
                    lookahead_ops=speculative_lookahead_ops if speculative
                    else None)
            if not item.started:
                item.t_start = clock.now()
                self.batch_log.append((item.t_start, name, item.batch.size))
                item.started = True
                # cost-model sample features, frozen at first start: the
                # price the scheduler believed, the restream this batch
                # pays, and its planned decode length
                item.predicted_s = cost.estimate(name, item.batch.size)
                item.cold_bytes = self._cold_bytes(name)
                item.decode_tokens = sum(r.decode_tokens
                                         for r in item.batch.requests)
                if self.unified:
                    # arena for the batch + each member's prompt KV
                    self._kv_batch_begin(name, item, item.t_start)
            yield_check = None
            if preempt and ses.suspended is None and self.policy == "stream":
                seg_v0 = clock.now()
                est_total = cost.estimate(name, item.batch.size)
                n_ops, batch_deadline = item.n_ops, item.deadline_s
                seg_entry_idx = item.state.op_idx if item.state else 0

                def yield_check(ops_done, _v0=seg_v0, _e=est_total,
                                _n=n_ops, _d=batch_deadline,
                                _i0=seg_entry_idx):
                    # projected virtual time at this op boundary: the clock
                    # only ticks at segment end, so progress is prorated
                    # from the cost estimate (exact under SimClock once the
                    # estimator has one observation)
                    projected = _v0 + _e * (ops_done - _i0) / max(_n, 1)
                    remaining = _e * max(0, _n - ops_done) / max(_n, 1)
                    for r in stream.poll(projected):
                        admit(r, projected, in_flight_s=remaining,
                              in_flight_deadline=_d)
                    cands = [n for n, qq in pending.items() if qq]
                    if not cands:
                        return False
                    # rank at the prorated op-boundary time, not the
                    # stale loop-top now — the weighted key is
                    # time-dependent when priorities differ
                    best = min(cands,
                               key=lambda n: urgency(n, projected))
                    d_best = deadline_of(pending[best][0])
                    if not math.isfinite(d_best):
                        return False
                    setup = (cost.estimate(best)
                             + self._restream_cost_s(best))
                    waiting_misses = (projected + remaining + setup
                                      > d_best + 1e-9)
                    # yield only to a strictly earlier deadline that cannot
                    # wait this batch out — never ping-pong between equals
                    return waiting_misses and d_best < _d
            ex = self._executor(name)
            seg_real_t0 = time.perf_counter()
            if isinstance(ex, StreamingExecutor):
                if item.state is None:
                    item.state = ex.begin(item.batch.tokens)
                ops_before = item.state.op_idx
                done = ex.advance(item.state, yield_check)
                frac = ((item.state.op_idx - ops_before)
                        / max(item.n_ops, 1))
                stats = item.state.stats
            else:                    # preload executor: never preemptible
                stats = ex.run(item.batch.tokens)
                done, frac = True, 1.0
            seg_real = time.perf_counter() - seg_real_t0
            item.charged_s += clock.tick(seg_real, name, frac=frac,
                                         batch_size=item.batch.size)
            if self.unified:
                # decode steps executed this segment wrote KV: charge the
                # growth so the next admission/cap decision sees it
                self._kv_decode_growth(name, item, clock.now())
            self._stop_prefetch(prefetcher, pf_stop)
            if not done:
                if self.unified:
                    # offload the preempted batch's pages (warm) and free
                    # its arena for whoever runs next
                    self._kv_suspend(name, item, clock.now())
                self.preempt_log.append((clock.now(), name,
                                         item.state.op_idx))
                ses.suspended = item
                last = name
                yield ("preempt", (name, item.state.op_idx))
                continue
            self._release_protection(name)
            if isinstance(cost, OnlineLatencyModel):
                # the learned model fits the full feature vector; its
                # EWMA fallback sees exactly the plain observe() update
                cost.observe_sample(name, item.charged_s, item.batch.size,
                                    cold_bytes=item.cold_bytes,
                                    decode_tokens=item.decode_tokens)
            else:
                cost.observe(name, item.charged_s, item.batch.size)
            batch, t0 = item.batch, item.t_start
            dt = clock.now() - t0
            result, stats.result = stats.result, None
            stats.requests = batch.size     # model_report counts requests,
            self.stats_log.append(stats)    # not executed batches
            n = max(len(stats.residency), 1)
            for j, r in enumerate(stats.residency):
                self.timeline.append((t0 + dt * (j + 1) / n, r, name))
            finish = clock.now()
            kvb = self._kv_finish(name, item, finish) if self.unified else {}
            for req, res in zip(batch.requests,
                                split_batch_result(batch, result)
                                if result is not None
                                else [None] * batch.size):
                d = deadline_of(req)
                derived.pop(id(req), None)
                seqs.pop(id(req), None)
                if columnar:
                    # res (the de-batched result tensor) is dropped:
                    # columnar mode carries telemetry, not outputs
                    out.append(
                        name, latency_s=finish - req.arrival_s,
                        init_s=stats.init_s, exec_s=stats.exec_s,
                        peak_bytes=stats.peak_bytes,
                        avg_bytes=stats.avg_bytes,
                        cache_hits=stats.cache_hits,
                        cache_misses=stats.cache_misses,
                        cache_hit_rate=stats.cache_hit_rate,
                        arrival_s=req.arrival_s,
                        queue_s=max(0.0, t0 - req.arrival_s),
                        batch_size=batch.size,
                        deadline_s=(d if math.isfinite(d)
                                    else req.deadline_s),
                        priority=req.priority, req_id=req.req_id,
                        kv_bytes=kvb.get(self._sid(req), 0),
                        predicted_s=item.predicted_s,
                        charged_s=item.charged_s)
                else:
                    out.append(Response(
                        name, finish - req.arrival_s, stats.init_s,
                        stats.exec_s,
                        stats.peak_bytes, avg_bytes=stats.avg_bytes,
                        cache_hits=stats.cache_hits,
                        cache_misses=stats.cache_misses,
                        cache_hit_rate=stats.cache_hit_rate, result=res,
                        arrival_s=req.arrival_s,
                        queue_s=max(0.0, t0 - req.arrival_s),
                        batch_size=batch.size,
                        deadline_s=d if math.isfinite(d) else req.deadline_s,
                        priority=req.priority, req_id=req.req_id,
                        kv_bytes=kvb.get(self._sid(req), 0),
                        predicted_s=item.predicted_s,
                        charged_s=item.charged_s))
            last = name
            yield ("batch", (name, item.charged_s))
        if replan_thread is not None:
            # stream drained while planning was still in flight — finish
            # the swap so the engine's plan matches the observed mix for
            # whatever serves next
            finish_replan(clock.now())

    # -- metrics -----------------------------------------------------------
    # peak/avg memory, cache_hit_rate, and model_report are derived from
    # the RETAINED entries of the ring-buffered timeline/stats_log (tests
    # clear those logs and recompute over what follows) — on a replay
    # longer than log_cap batches they describe the most recent window,
    # not the lifetime. slo_report's counters are exact regardless.
    def peak_memory(self) -> int:
        return max((r for _, r, _ in self.timeline), default=0)

    def avg_memory(self) -> float:
        vals = [r for _, r, _ in self.timeline]
        return float(np.mean(vals)) if vals else 0.0

    def cache_hit_rate(self) -> float:
        hits = sum(s.cache_hits for s in self.stats_log)
        misses = sum(s.cache_misses for s in self.stats_log)
        return hits / (hits + misses) if hits + misses else 0.0

    def slo_report(self, responses) -> SLOReport:
        """SLO/priority summary: global, priority-weighted, and
        per-priority deadline outcomes over ``responses`` (a
        ``List[Response]`` or columnar ``ResponseTable`` — identical
        numbers either way) plus the scheduler's intervention counts —
        the typed ``SLOReport`` the benchmarks and ``launch/serve.py``
        print (``as_dict()`` for JSON). Note the response-derived rates
        cover exactly the ``responses`` passed in, while ``preemptions``
        / ``deferred_joins`` read the engine-LIFETIME logs (every log on
        this engine accumulates across calls): pass one serve() run's
        responses on a fresh engine — as the benchmarks do — for a
        consistent picture.

        ``calibration`` reports the learned cost model's per-model fit
        (``OnlineLatencyModel.calibration_report``: sample counts,
        calibrated flag, prequential error, and ``drift`` — the EWMA of
        recent relative error that rises when the machine moves away from
        the fit) — ``{}`` when the last serve ran the plain EWMA
        estimator."""
        cost = getattr(self, "cost_model", None)
        return SLOReport(
            requests=len(responses),
            served=status_counts(responses)["ok"],
            miss_rate=deadline_miss_rate(responses),
            rejection_rate=rejection_rate(responses),
            priority_miss_rate=priority_miss_rate(responses),
            per_priority=per_priority_stats(responses),
            # exact streaming counters — NOT len() over the ring-buffered
            # logs, which truncate at log_cap on trace-scale replays
            preemptions=self.preempt_log.total,
            deferred_joins=self.deferred_joins,
            calibration=(cost.calibration_report()
                         if isinstance(cost, OnlineLatencyModel)
                         else {}),
        )

    def model_report(self) -> Dict[str, ModelReport]:
        """Per-model peak/avg memory and cache hit rate over run history."""
        rep: Dict[str, ModelReport] = {}
        for s in self.stats_log:
            r = rep.setdefault(s.model, ModelReport())
            k = max(getattr(s, "requests", 1), 1)   # serve(): batch of k
            r.requests += k                         # counts user requests
            r.peak_bytes = max(r.peak_bytes, s.peak_bytes)
            r.avg_bytes += (s.avg_bytes - r.avg_bytes) * k / r.requests
            r.cache_hits += s.cache_hits
            r.cache_misses += s.cache_misses
        return rep
