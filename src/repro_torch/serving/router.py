"""Front-end Router for a fleet of ``Replica``s: cache-affinity routing,
health checks, retry with backoff + jitter, and a circuit breaker.

The fleet is the paper's memory-hierarchy argument one level up: each
replica owns a budgeted ``WeightCache``, so N replicas form one big
PARTITIONED weight cache. Sending a request to a replica that holds its
model hot costs nothing extra; sending it to a cold one costs exactly the
restream bytes the single-engine scheduler already prices. Affinity
routing therefore minimizes fleet restream traffic the same way the
engine's cost-aware eviction minimizes per-device traffic:

  * consistent hash (md5 ring, virtual nodes) of the model name picks a
    stable HOME replica — successive requests for a model keep hitting
    the cache they warmed;
  * when the home is backed up past ``spill_depth``, spill to the
    least-loaded replica whose pool already holds the model hot
    (``WeightCache.model_bytes`` residency);
  * when nobody holds it hot, cold-start on the replica with the most
    free pool budget (least eviction damage).

Failures are handled the way a real front end must — with NO privileged
view of replica state. ``Router.serve`` runs a deterministic
discrete-event pump on virtual time: request arrivals, per-attempt
timeouts, retries, scheduled fault injections, and periodic health
checks are heap events; between events the pump steps whichever replica
session's ``next_time()`` is earliest. A routed attempt that produces no
response within ``timeout_s`` counts as a failure: the request is
retried on a sibling with exponential backoff + seeded jitter, and K
consecutive failures trip the replica's circuit breaker (closed → open);
after ``cooldown_s`` a half-open probe admits one request, and a success
re-closes. The ``StragglerDetector`` (ft/resilience.py) watches
per-batch latencies from each replica's feed and trips the breaker of a
replica that is alive-but-slow — the failure mode timeouts alone catch
only after eating deadlines.

Exactly-once responses: every accepted request yields exactly ONE
terminal ``Response`` — served ("ok"), refused by a replica's admission
controller ("rejected"), or abandoned after exhausting retries
("failed"). A timed-out attempt may still complete on its original
replica after the retry was dispatched (at-least-once execution is
unavoidable without distributed consensus); the pump resolves whichever
terminal outcome lands first and suppresses later duplicates
(``dup_suppressed``).
"""
from __future__ import annotations

import bisect
import hashlib
import heapq
import itertools
import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.ft.resilience import StragglerDetector
from repro_torch.serving.replica import FaultPlan, Replica
from repro_torch.serving.reports import FleetReport, ReplicaHealth
from repro_torch.serving.response_table import ResponseTable
from repro_torch.serving.types import (Request, Response, RingLog, SLOConfig,
                                 _judged_missed, deadline_miss_rate,
                                 rejection_rate, response_columns,
                                 status_counts)

ROUTING_POLICIES = ("affinity", "round_robin")


@dataclass
class RetryPolicy:
    """Exponential backoff with seeded jitter. ``max_attempts`` counts
    every dispatch (first try included); ``delay(k)`` is the wait after
    the k-th failed attempt (k >= 1)."""
    max_attempts: int = 4
    base_s: float = 0.05
    factor: float = 2.0
    cap_s: float = 0.5
    jitter_frac: float = 0.25

    def delay(self, attempt: int, rng: np.random.Generator) -> float:
        d = min(self.cap_s, self.base_s * self.factor ** max(0, attempt - 1))
        return d * (1.0 + self.jitter_frac * float(rng.random()))


class CircuitBreaker:
    """closed → open after ``failure_threshold`` consecutive failures;
    after ``cooldown_s`` the next route becomes the half-open probe; a
    probe success re-closes, a probe failure re-opens. ``trip`` forces
    open from any state (the straggler detector's path)."""

    def __init__(self, rid: int, *, failure_threshold: int = 3,
                 cooldown_s: float = 0.25):
        self.rid = rid
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.failures = 0
        self.opened_at = -math.inf
        self.probe_inflight = 0
        self.transitions: List[Tuple[float, str, str, str]] = []

    def _move(self, now: float, state: str, why: str):
        if state != self.state:
            self.transitions.append((now, self.state, state, why))
            self.state = state

    def available(self, now: float) -> bool:
        """May the router send this replica a request at ``now``?"""
        if self.state == "closed":
            return True
        if self.state == "half_open":
            return self.probe_inflight == 0
        return now >= self.opened_at + self.cooldown_s   # open → probe ok

    def on_route(self, now: float):
        """A request was just routed here; open→half_open on the probe."""
        if self.state == "open":
            self._move(now, "half_open", "probe")
            self.probe_inflight = 0
        if self.state == "half_open":
            self.probe_inflight += 1

    def on_success(self, now: float):
        self.failures = 0
        if self.state == "half_open":
            self.probe_inflight = 0
            self._move(now, "closed", "probe_ok")

    def on_failure(self, now: float):
        self.failures += 1
        if self.state == "half_open":
            self.probe_inflight = 0
            self.opened_at = now
            self._move(now, "open", "probe_failed")
        elif self.state == "closed" \
                and self.failures >= self.failure_threshold:
            self.opened_at = now
            self._move(now, "open",
                       f"{self.failures}_consecutive_failures")

    def trip(self, now: float, why: str = "straggler"):
        """Force open (health-check path); cooldown restarts at ``now``."""
        self.opened_at = now
        self.probe_inflight = 0
        self.failures = max(self.failures, self.failure_threshold)
        self._move(now, "open", why)


class HashRing:
    """Consistent hash ring over replica ids (md5, virtual nodes) — the
    model→home mapping is stable across runs and processes (``hash()`` is
    salted per process; md5 is not) and moves only ~1/N of models when a
    replica joins or leaves."""

    def __init__(self, rids: Sequence[int], vnodes: int = 64):
        points = sorted((self._h(f"r{rid}#v{v}"), rid)
                        for rid in rids for v in range(vnodes))
        self._hashes = [h for h, _ in points]
        self._rids = [r for _, r in points]

    @staticmethod
    def _h(key: str) -> int:
        return int(hashlib.md5(key.encode()).hexdigest()[:8], 16)

    def lookup(self, model: str) -> int:
        i = bisect.bisect_left(self._hashes, self._h(model))
        return self._rids[i % len(self._rids)]


@dataclass
class _Tracked:
    """Router-side state of one not-yet-terminal request."""
    request: Request                 # original (caller timeline)
    deadline_s: Optional[float]      # absolute, fixed at first dispatch
    attempts: int = 0                # dispatches so far
    rid: Optional[int] = None        # replica of the live attempt
    tried: Set[int] = field(default_factory=set)


class Router:
    """Cache-affinity front end over N started ``Replica``s.

    ``serve(trace)`` replays a request trace through the fleet on virtual
    time and returns exactly one terminal ``Response`` per request (in
    arrival order). All decision state is observable afterwards:
    ``route_log`` (every dispatch), ``breakers[rid].transitions``,
    ``health_log`` (straggler trips), ``fault_log`` (injected events),
    ``retries`` / ``failed`` / ``dup_suppressed`` counters.
    """

    def __init__(self, replicas: Sequence[Replica], *,
                 routing: str = "affinity",
                 retry: Optional[RetryPolicy] = None,
                 timeout_s: float = 0.5,
                 spill_depth: int = 4,
                 failure_threshold: int = 3,
                 cooldown_s: float = 0.25,
                 health_interval_s: float = 0.1,
                 straggler: Optional[StragglerDetector] = None,
                 seed: int = 0,
                 log_cap: int = 10000):
        if routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing {routing!r}; "
                             f"expected one of {ROUTING_POLICIES}")
        self.replicas = list(replicas)
        self.by_rid = {r.rid: r for r in self.replicas}
        self.routing = routing
        self.retry = retry or RetryPolicy()
        self.timeout_s = timeout_s
        self.spill_depth = spill_depth
        self.health_interval_s = health_interval_s
        self.breakers = {r.rid: CircuitBreaker(
            r.rid, failure_threshold=failure_threshold,
            cooldown_s=cooldown_s) for r in self.replicas}
        self.straggler = straggler or StragglerDetector(
            window=16, z_thresh=3.0, patience=2)
        self._rng = np.random.default_rng(seed)
        self._rr = 0
        # observability — ring-buffered: dispatches are O(events)
        # over a trace-scale replay; `.total` keeps lifetime counts exact
        self.route_log = RingLog(log_cap)   # (t, req_id, model, rid, why, k)
        self.health_log = RingLog(log_cap)  # (t, event, rid)
        self.fault_log = RingLog(log_cap)   # (t, kind, rid)
        self.retries = 0
        self.failed = 0
        self.dup_suppressed = 0

    # -- replica choice ----------------------------------------------------
    def _candidates(self, now: float,
                    exclude: Set[int]) -> List[Replica]:
        cands = [r for r in self.replicas
                 if self.breakers[r.rid].available(now)
                 and r.rid not in exclude]
        if not cands and exclude:
            # every untried replica is breaker-blocked: allow retrying a
            # previously-failed one rather than dropping the request
            cands = [r for r in self.replicas
                     if self.breakers[r.rid].available(now)]
        return cands

    def _pick(self, model: str, now: float,
              exclude: Set[int]) -> Tuple[Optional[Replica], str]:
        cands = self._candidates(now, exclude)
        if not cands:
            return None, "none"
        if self.routing == "round_robin":
            n = len(self.replicas)
            for i in range(n):
                r = self.replicas[(self._rr + i) % n]
                if r in cands:
                    self._rr = (self._rr + i + 1) % n
                    return r, "rr"
            return None, "none"
        ring = getattr(self, "_ring", None)
        if ring is None:        # serve() builds it once; direct calls here
            self._ring = ring = HashRing([r.rid for r in self.replicas])
        home = next((r for r in cands if r.rid == ring.lookup(model)), None)
        if home is not None and home.load() <= self.spill_depth:
            return home, "home"
        hot = [r for r in cands if r.hot_bytes(model) > 0]
        if hot:
            return min(hot, key=lambda r: (r.load(), r.rid)), "hot"
        if home is not None:
            # overloaded home, nobody else hot: queueing behind the warm
            # cache still beats restreaming the model somewhere cold
            return home, "home_backlogged"
        return min(cands,
                   key=lambda r: (-r.free_budget(), r.load(), r.rid)), "cold"

    # -- the event pump ----------------------------------------------------
    def serve(self, trace: Sequence[Request], *,
              slo: Optional[SLOConfig] = None,
              fault_plan: Optional[FaultPlan] = None):
        for r in self.replicas:
            if r.session is None:
                raise RuntimeError(f"replica {r.rid} not started — call "
                                   "replica.start(**serve_kw) first")
        # result mode follows the replicas: when every session stores a
        # columnar ResponseTable the fleet aggregate is a ResponseTable
        # too — per-replica rows are rebased onto the caller's timeline
        # column-wise, never materialized as Response objects.
        modes = {isinstance(r.session.responses, ResponseTable)
                 for r in self.replicas}
        if len(modes) > 1:
            raise ValueError(
                "mixed result modes across replicas: start every replica "
                "with the same ServeConfig.result_mode")
        columnar = modes.pop()
        out = ResponseTable() if columnar else None
        self._ring = HashRing([r.rid for r in self.replicas])
        seq = itertools.count()
        events: List[tuple] = []    # (t, seq, kind, payload)

        def push(t: float, kind: str, payload):
            heapq.heappush(events, (t, next(seq), kind, payload))

        inflight: Dict[int, _Tracked] = {}
        # object mode: req_id -> terminal Response;
        # columnar mode: req_id -> row index into `out`
        terminal: Dict[int, object] = {}
        order: List[int] = []
        drained = {r.rid: 0 for r in self.replicas}   # response cursors

        for i, req in enumerate(trace):
            rid_ = req.req_id if req.req_id is not None else i
            if rid_ in set(order):
                raise ValueError(f"duplicate req_id {rid_} in trace")
            order.append(rid_)
            push(req.arrival_s, "arrival", (rid_, req))
        if fault_plan is not None:
            for ev in fault_plan.sorted_events():
                push(ev.t_s, "fault", ev)
        push(self.health_interval_s, "health", None)

        def resolve(req_id: int, resp, now: float,
                    origin_rid: Optional[int]):
            tr = inflight.pop(req_id, None)
            if tr is None:
                self.dup_suppressed += 1
                return
            orig = tr.request
            # rebase onto the caller's timeline: latency is arrival →
            # terminal outcome, backoff/queue gaps included
            finish = resp.arrival_s + resp.latency_s
            latency = max(0.0, finish - orig.arrival_s)
            queue = resp.queue_s + max(0.0, resp.arrival_s - orig.arrival_s)
            if columnar:
                # `resp` is a row view over the replica's table; append the
                # rebased row to the fleet table and remember its index
                terminal[req_id] = len(out)
                out.append(
                    resp.model, latency_s=latency, init_s=resp.init_s,
                    exec_s=resp.exec_s, peak_bytes=resp.peak_bytes,
                    avg_bytes=resp.avg_bytes, cache_hits=resp.cache_hits,
                    cache_misses=resp.cache_misses,
                    cache_hit_rate=resp.cache_hit_rate,
                    arrival_s=orig.arrival_s, queue_s=queue,
                    batch_size=resp.batch_size, status=resp.status,
                    deadline_s=tr.deadline_s, priority=orig.priority,
                    req_id=req_id, kv_bytes=resp.kv_bytes,
                    predicted_s=resp.predicted_s, charged_s=resp.charged_s)
            else:
                terminal[req_id] = replace(
                    resp, req_id=req_id, arrival_s=orig.arrival_s,
                    latency_s=latency, queue_s=queue,
                    deadline_s=tr.deadline_s, priority=orig.priority)
            if origin_rid is not None:
                self.breakers[origin_rid].on_success(now)

        def drain(rep: Replica, now: float):
            resps = rep.session.responses
            while drained[rep.rid] < len(resps):
                resp = resps[drained[rep.rid]]
                drained[rep.rid] += 1
                resolve(resp.req_id, resp, now, rep.rid)

        def give_up(req_id: int, now: float):
            tr = inflight.pop(req_id, None)
            if tr is None:
                return
            orig = tr.request
            self.failed += 1
            if columnar:
                terminal[req_id] = len(out)
                out.append(orig.model,
                           latency_s=max(0.0, now - orig.arrival_s),
                           status="failed", arrival_s=orig.arrival_s,
                           deadline_s=tr.deadline_s, priority=orig.priority,
                           req_id=req_id)
            else:
                terminal[req_id] = Response(
                    orig.model, max(0.0, now - orig.arrival_s), 0.0, 0.0, 0,
                    status="failed", arrival_s=orig.arrival_s,
                    deadline_s=tr.deadline_s, priority=orig.priority,
                    req_id=req_id)

        def dispatch(req_id: int, now: float):
            tr = inflight.get(req_id)
            if tr is None:
                return
            if tr.attempts >= self.retry.max_attempts:
                give_up(req_id, now)
                return
            rep, why = self._pick(tr.request.model, now, tr.tried)
            tr.attempts += 1
            if rep is None:
                # nobody routable: burn the attempt and back off — the
                # fleet may recover (half-open cooldowns) before the next
                push(now + self.retry.delay(tr.attempts, self._rng),
                     "retry", req_id)
                return
            tr.rid = rep.rid
            tr.tried.add(rep.rid)
            self.breakers[rep.rid].on_route(now)
            self.route_log.append((now, req_id, tr.request.model, rep.rid,
                                   why, tr.attempts))
            rep.inbox.push(replace(tr.request, arrival_s=now,
                                   deadline_s=tr.deadline_s, req_id=req_id))
            push(now + self.timeout_s, "timeout", (req_id, tr.attempts))

        def on_fault(ev, now: float):
            rep = self.by_rid[ev.rid]
            self.fault_log.append((now, ev.kind, ev.rid))
            if ev.kind == "kill":
                rep.dead = True
            elif ev.kind == "wedge":
                rep.wedged = True
            elif ev.kind == "slow":
                rep.clock.slow_factor = ev.factor
            elif ev.kind == "recover":
                rep.wedged = False
                rep.clock.slow_factor = 1.0
                if not rep.dead and rep.clock.now() < now:
                    # the wedge held the replica's clock still; it wakes
                    # at the recovery time, not in the past
                    rep.clock.advance(now - rep.clock.now())

        def on_health(now: float):
            flagged = self.straggler.check()
            for rid in flagged:
                br = self.breakers[rid]
                if br.state == "closed":
                    br.trip(now, "straggler")
                    self.health_log.append((now, "straggler_trip", rid))
            if inflight or events:
                push(now + self.health_interval_s, "health", None)

        # pump: dispatch the earliest event, or step the earliest replica
        while True:
            t_ev = events[0][0] if events else math.inf
            runnable = [(r.next_time(), r.rid) for r in self.replicas]
            t_rep, rid_next = min(runnable, default=(math.inf, -1))
            if not math.isfinite(min(t_ev, t_rep)):
                break
            if not inflight and not events:
                break
            if t_ev <= t_rep:
                now, _, kind, payload = heapq.heappop(events)
                if kind == "arrival":
                    req_id, req = payload
                    d = req.deadline_s if req.deadline_s is not None else \
                        (slo.deadline_for(req) if slo is not None else None)
                    inflight[req_id] = _Tracked(request=req, deadline_s=d)
                    dispatch(req_id, now)
                elif kind == "timeout":
                    req_id, attempt = payload
                    tr = inflight.get(req_id)
                    if tr is None or tr.attempts != attempt \
                            or tr.rid is None:
                        continue            # stale: resolved or re-routed
                    self.breakers[tr.rid].on_failure(now)
                    tr.rid = None
                    self.retries += 1
                    push(now + self.retry.delay(tr.attempts, self._rng),
                         "retry", req_id)
                elif kind == "retry":
                    dispatch(payload, now)
                elif kind == "fault":
                    on_fault(payload, now)
                elif kind == "health":
                    on_health(now)
            else:
                rep = self.by_rid[rid_next]
                kind, payload = rep.step()
                if kind == "batch":
                    self.straggler.record(rep.rid, rep.batch_feed[-1][2])
                drain(rep, rep.clock.now())
        # anything still tracked when the pump stalls (should not happen:
        # every live attempt has a timeout event) fails loudly, not
        # silently — the exactly-one-terminal invariant must hold
        for req_id in list(inflight):
            give_up(req_id, max((r.clock.now() for r in self.replicas),
                                default=0.0))
        if columnar:
            # restore arrival order with one fancy-index over the table
            return out.take([terminal[i] for i in order if i in terminal])
        return [terminal[i] for i in order if i in terminal]

    # -- reporting ---------------------------------------------------------
    def report(self, responses) -> FleetReport:
        n = len(responses)
        c = response_columns(responses)
        counts = status_counts(responses)
        # bad = late + rejected + failed: requests that did NOT get a
        # timely served response — the fleet SLO number
        _, missed = _judged_missed(c)
        bad = (n - counts["ok"]) + int(np.count_nonzero(missed))
        return FleetReport(
            requests=n,
            served=counts["ok"],
            rejected=counts["rejected"],
            failed=counts["failed"],
            miss_rate=deadline_miss_rate(responses),
            rejection_rate=rejection_rate(responses),
            bad_rate=bad / n if n else 0.0,
            retries=self.retries,
            gave_up=self.failed,
            dup_suppressed=self.dup_suppressed,
            restream_bytes=sum(r.restream_bytes()
                               for r in self.replicas),
            per_replica={r.rid: ReplicaHealth(
                rid=r.rid, dead=r.dead, wedged=r.wedged,
                slow_factor=r.clock.slow_factor,
                batches=r.batch_feed.total,
                restream_bytes=r.restream_bytes(),
                breaker=self.breakers[r.rid].state,
                breaker_transitions=len(self.breakers[r.rid].transitions),
            ) for r in self.replicas})
