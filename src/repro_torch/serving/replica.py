"""One fleet replica: a ``ServingEngine`` + its own budgeted pool, clock,
and inbox, behind the front-end ``Router`` (serving/router.py).

A ``Replica`` wraps one engine in the steppable ``ServeSession`` form:
the Router pushes routed requests into the replica's ``RequestStream``
inbox and advances the replica's ``ReplicaClock`` to the session's
``next_time()`` before each step — N replicas interleave as one
deterministic discrete-event simulation on a shared virtual timeline (no
threads, no real sleeps). Each replica runs on one ``torch.device``,
``cuda:0`` unless the caller passes another (``"cpu"`` for the plain
PyTorch versions); every model it serves must live there. On one card
every replica shares ``cuda:0``: each keeps its own engine, loader
thread, copy stream and budgeted pool on it.

``FaultPlan`` is the injectable failure schedule, stamped in virtual
seconds on the ROUTER's watermark clock:

  * ``kill``  — the replica stops stepping permanently; requests already
    routed to it strand until the Router's per-request timeout fires.
  * ``wedge`` — same, but a later ``recover`` event revives it (its clock
    is advanced to the recovery time: the backlog it slept through is
    served late, exactly like a process unfrozen by the scheduler).
  * ``slow``  — every subsequent execution charge is multiplied by
    ``factor`` (thermal throttling / noisy neighbour). The Router's
    ``StragglerDetector`` sees the inflated per-batch latencies.
  * ``recover`` — clears wedge/slow.

The Router never reads fault state when routing — failures are only
observable the way a real front-end sees them: timeouts, stragglers, and
the circuit breaker those feed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.device import DeviceLike
from repro_torch.serving.clock import SimClock
from repro_torch.serving.engine import ServeSession, ServingEngine
from repro_torch.serving.reports import ReplicaHealth
from repro_torch.serving.stream import RequestStream
from repro_torch.serving.types import RingLog

FAULT_KINDS = ("kill", "wedge", "slow", "recover")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at virtual time ``t_s`` (router watermark),
    do ``kind`` to replica ``rid``. ``factor`` only applies to "slow"."""
    t_s: float
    rid: int
    kind: str
    factor: float = 4.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError(f"slow factor must be > 1, got {self.factor}")


@dataclass
class FaultPlan:
    """An ordered schedule of ``FaultEvent``s. Builder methods chain:

        FaultPlan().kill(0.5, rid=1)
        FaultPlan().slow(0.2, rid=0, factor=8.0).recover(0.8, rid=0)
    """
    events: List[FaultEvent] = field(default_factory=list)

    def add(self, ev: FaultEvent) -> "FaultPlan":
        self.events.append(ev)
        return self

    def kill(self, t_s: float, rid: int) -> "FaultPlan":
        return self.add(FaultEvent(t_s, rid, "kill"))

    def wedge(self, t_s: float, rid: int) -> "FaultPlan":
        return self.add(FaultEvent(t_s, rid, "wedge"))

    def slow(self, t_s: float, rid: int, factor: float = 4.0) -> "FaultPlan":
        return self.add(FaultEvent(t_s, rid, "slow", factor))

    def recover(self, t_s: float, rid: int) -> "FaultPlan":
        return self.add(FaultEvent(t_s, rid, "recover"))

    def sorted_events(self) -> List[FaultEvent]:
        return sorted(self.events, key=lambda e: (e.t_s, e.rid))


class ReplicaClock(SimClock):
    """Per-replica virtual clock: a ``SimClock`` whose execution charges
    can be inflated by a fault-injected ``slow_factor`` (>= 1). Idle
    advances are never inflated — a throttled device computes slowly but
    waits at normal speed."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.slow_factor = 1.0

    def tick(self, real_dt: float, model: str = "", frac: float = 1.0,
             batch_size: int = 1) -> float:
        dt = super().tick(real_dt, model, frac=frac, batch_size=batch_size)
        extra = dt * (self.slow_factor - 1.0)
        if extra > 0:
            self._t += extra
            dt += extra
        return dt


class Replica:
    """One engine + clock + inbox, stepped by the Router.

    ``engine_kw`` goes straight to ``ServingEngine`` (each replica gets
    its OWN ``budget_bytes`` pool — the fleet is a partitioned cache, not
    a shared one). ``device`` is where the engine runs (``cuda:0`` by
    default; without a card it raises unless ``"cpu"`` is passed); a
    given ``engine`` brings its own. Register models, then ``start()``
    to open the serve session; the Router owns pushing/stepping from
    there.
    """

    def __init__(self, rid: int, *, clock: Optional[ReplicaClock] = None,
                 engine: Optional[ServingEngine] = None,
                 device: DeviceLike = None, **engine_kw):
        self.rid = rid
        self.name = f"r{rid}"
        self.engine = engine if engine is not None \
            else ServingEngine(device=device, **engine_kw)
        self.clock = clock or ReplicaClock()
        self.inbox = RequestStream()
        self.session: Optional[ServeSession] = None
        # fault state (set by the Router's fault dispatcher, never read
        # by routing decisions)
        self.dead = False
        self.wedged = False
        self.device = self.engine.device
        # (finish_t, model, charged_s) per completed batch — the
        # straggler detector's per-replica latency feed. Ring-buffered
        # (engine log_cap): the detector only reads the latest entries,
        # and `.total` keeps the lifetime batch count exact at trace scale
        self.batch_feed = RingLog(self.engine.log_cap)

    def register(self, name: str, model) -> "Replica":
        self.engine.register(name, model)
        return self

    def start(self, **serve_kw):
        self.session = self.engine.serve_session(self.inbox,
                                                 clock=self.clock,
                                                 **serve_kw)
        return self

    # -- health / state the Router may observe -----------------------------
    @property
    def responsive(self) -> bool:
        return not (self.dead or self.wedged)

    def load(self) -> int:
        """Outstanding depth: inbox + admitted queues + suspended batch."""
        n = self.inbox.pending_count()
        if self.session is not None:
            n += self.session.queued()
        return n

    def hot_bytes(self, model: str) -> int:
        """Pool-resident bytes of ``model`` (0 without a shared pool)."""
        cache = self.engine.cache
        return cache.model_bytes(model) if cache is not None else 0

    def free_budget(self) -> int:
        cache = self.engine.cache
        return cache.free_bytes() if cache is not None else 0

    def restream_bytes(self) -> int:
        """Cold-chunk bytes streamed from storage into this replica's pool
        so far — the fleet A/B's affinity metric."""
        cache = self.engine.cache
        return cache.stats.inserted_bytes if cache is not None else 0

    # -- stepping (Router only) --------------------------------------------
    def next_time(self) -> float:
        """When stepping this replica can next make progress on the shared
        timeline (+inf while dead/wedged: a faulted replica holds time
        still until recovery — or forever)."""
        if self.session is None or not self.responsive:
            return math.inf
        return self.session.next_time()

    def step(self) -> Tuple[str, object]:
        """Advance the replica clock to its next progress point and step
        the session once. Completed batches land in ``batch_feed``."""
        nt = self.next_time()
        now = self.clock.now()
        if math.isfinite(nt) and nt > now:
            self.clock.advance(nt - now)
        kind, payload = self.session.step()
        if kind == "batch":
            model, charged = payload
            self.batch_feed.append((self.clock.now(), model, charged))
        return kind, payload

    def health(self) -> ReplicaHealth:
        """Live observable state as a typed report — the same
        ``ReplicaHealth`` shape the Router embeds per-replica in its
        ``FleetReport`` (there with breaker fields filled instead)."""
        return ReplicaHealth(
            rid=self.rid, dead=self.dead, wedged=self.wedged,
            slow_factor=self.clock.slow_factor, load=self.load(),
            clock_s=self.clock.now(), batches=self.batch_feed.total,
            free_budget=self.free_budget(),
            restream_bytes=self.restream_bytes())
