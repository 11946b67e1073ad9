"""Live request streams + arrival-trace generators for the online loop.

``RequestStream`` is the engine's pull interface: producers ``push``
requests (each stamped with an ``arrival_s`` on the serving clock's
timeline) and ``serve()`` polls for everything that has *arrived* by the
current clock reading. A pre-filled, closed stream replays a trace
deterministically — the benchmark/test mode; a live stream is the same
object with concurrent pushers.

``peek_upcoming`` exposes not-yet-arrived requests (known only for trace
replays). The engine uses it purely as a prefetch *hint* — to warm the
model of the next future arrival when every queue is empty — never for
scheduling decisions about arrived work.

Trace generators (``poisson_trace``, ``bursty_trace``) are seeded and
shared by tests and ``benchmarks/bursty_arrivals.py`` so both replay the
exact same workloads.
"""
from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.types import Request


class RequestStream:
    """Arrival-ordered request source (thread-safe heap on ``arrival_s``)."""

    def __init__(self, requests: Sequence[Request] = (),
                 closed: bool = False):
        self._lock = threading.Lock()
        # push/close signal: an event-driven consumer blocks here instead
        # of polling every poll_interval_s (ServeSession.run step_mode=
        # "event" on a real clock)
        self._cond = threading.Condition(self._lock)
        self._seq = itertools.count()     # FIFO tie-break for equal arrivals
        self._heap: List[Tuple[float, int, Request]] = []
        self._closed = False
        for r in requests:
            self.push(r)
        if closed:
            self.close()

    @staticmethod
    def from_trace(requests: Sequence[Request]) -> "RequestStream":
        """A closed, replayable stream — the deterministic benchmark mode."""
        return RequestStream(requests, closed=True)

    def push(self, req: Request):
        # a real error, not an assert: pushing to a closed stream is a
        # producer bug that must surface under `python -O` too (asserts
        # are stripped there and the request would vanish silently)
        with self._lock:
            if self._closed:
                raise RuntimeError("push on closed RequestStream")
            heapq.heappush(self._heap, (req.arrival_s, next(self._seq), req))
            self._cond.notify_all()

    def close(self):
        """Idempotent: closing an already-closed stream is a no-op (several
        producers may all signal end-of-trace)."""
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def exhausted(self) -> bool:
        """Closed and fully drained — the serve loop's stop condition."""
        with self._lock:
            return self._closed and not self._heap

    def poll(self, now: float) -> List[Request]:
        """Pop every request that has arrived by ``now`` (arrival order)."""
        out: List[Request] = []
        with self._lock:
            while self._heap and self._heap[0][0] <= now:
                out.append(heapq.heappop(self._heap)[2])
        return out

    def next_arrival(self) -> Optional[float]:
        """Earliest pending arrival time, or None if nothing is queued."""
        with self._lock:
            return self._heap[0][0] if self._heap else None

    def pending_count(self) -> int:
        """Requests pushed but not yet polled (the router's inbox-depth
        component of a replica's load)."""
        with self._lock:
            return len(self._heap)

    def peek_next(self) -> Optional[Request]:
        """The earliest pending request WITHOUT popping it, or None — the
        heap top, O(1). The engine's speculative-prefetch fallback checks
        this first and only falls back to ``peek_upcoming`` (O(n) over a
        trace-scale heap) when the top can't be warmed."""
        with self._lock:
            return self._heap[0][2] if self._heap else None

    def peek_upcoming(self, n: int = 8) -> List[Request]:
        """Up to ``n`` earliest pending requests WITHOUT popping them."""
        with self._lock:
            return [r for _, _, r in heapq.nsmallest(n, self._heap)]

    def wait_for_push(self, timeout: Optional[float] = None, *,
                      before_s: float = math.inf) -> bool:
        """Block (REAL time) until the stream closes or holds a pending
        arrival stamped earlier than ``before_s``, or ``timeout`` seconds
        pass. Returns True when woken by stream state, False on timeout.

        This is the event-driven idle wait for live (open) streams on a
        real clock: instead of spinning ``poll_interval_s`` ticks, the
        serve loop parks here and a producer's ``push``/``close`` wakes
        it immediately — one step per event. The check runs under the
        stream lock, so a push that landed between the caller's last poll
        and this wait is seen on entry, never missed."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            while True:
                if self._closed or (self._heap
                                    and self._heap[0][0] < before_s):
                    return True
                if deadline is None:
                    self._cond.wait()
                else:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cond.wait(left):
                        return False


# ---------------------------------------------------------------------------
# trace generators (seeded — tests and benchmarks replay identical traffic)
# ---------------------------------------------------------------------------

def _mk_request(model: str, t: float, rng: np.random.Generator,
                vocab: int, seq: int, batch: int = 1) -> Request:
    toks = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    return Request(model=model, tokens=toks, arrival_s=t)


def poisson_trace(rates: Dict[str, float], duration_s: float, *,
                  vocab: int, seq: int, seed: int = 0) -> List[Request]:
    """Independent Poisson arrivals per model (``rates`` in req/s)."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for model, rate in rates.items():
        # non-positive rates mean "no arrivals" (launch/serve.py --mix
        # drops zero-weight models the same way): rate == 0 would divide
        # by zero below, and rate < 0 would step time backwards forever
        if rate <= 0:
            continue
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= duration_s:
                break
            reqs.append(_mk_request(model, t, rng, vocab, seq))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def stamp_req_ids(trace: Sequence[Request], *, start: int = 0
                  ) -> List[Request]:
    """Stamp a unique per-trace request index onto ``req_id`` (NEW
    ``Request`` objects; tokens shared, not copied). The engine echoes
    ``req_id`` on every ``Response``, so metrics and reference outputs
    can be keyed by it — ``(model, arrival_s)`` keys silently collapse
    two same-model requests with identical arrivals (a fixed bug).
    Requests that already carry a ``req_id`` keep it; everything else
    gets ``start + position``."""
    from dataclasses import replace
    return [r if r.req_id is not None else replace(r, req_id=start + i)
            for i, r in enumerate(trace)]


def assign_priorities(trace: Sequence[Request],
                      mix: Dict[float, float], *, seed: int = 0
                      ) -> List[Request]:
    """Stamp seeded random priorities onto a trace: ``mix`` maps priority
    weight -> probability (normalized). Returns NEW ``Request`` objects
    (same tokens / arrivals / deadlines — tokens shared, not copied) so
    the unstamped trace can be replayed as the uniform-priority baseline
    while per-class metrics are still computed against this assignment.
    Key the assignment by unique ``req_id`` (``stamp_req_ids``) — NOT by
    ``(model, arrival_s)``, which overwrites silently when two same-model
    requests share an arrival time."""
    from dataclasses import replace
    rng = np.random.default_rng(seed)
    levels = sorted(mix)
    probs = np.array([mix[p] for p in levels], dtype=float)
    total = probs.sum()
    if total <= 0:
        raise ValueError(f"priority mix has no mass: {mix}")
    draws = rng.choice(len(levels), size=len(trace), p=probs / total)
    return [replace(r, priority=float(levels[d]))
            for r, d in zip(trace, draws)]


def bursty_trace(base_rates: Dict[str, float], duration_s: float, *,
                 burst_model: str, burst_at_s: float, burst_n: int,
                 burst_span_s: float, vocab: int, seq: int,
                 seed: int = 0) -> List[Request]:
    """Poisson background traffic plus one dense burst of a single model —
    the paper-motivated pattern that invalidates static interleave order."""
    reqs = poisson_trace(base_rates, duration_s, vocab=vocab, seq=seq,
                         seed=seed)
    rng = np.random.default_rng(seed + 1)
    step = burst_span_s / max(burst_n, 1)
    for i in range(burst_n):
        t = burst_at_s + i * step
        # a burst whose span crosses the end of the trace would stamp
        # arrivals past duration_s — outside the window every consumer
        # (and the Poisson background above) guarantees; drop them
        if t >= duration_s:
            break
        reqs.append(_mk_request(burst_model, t, rng, vocab, seq))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs
