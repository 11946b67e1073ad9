"""Injectable clocks for the online serving loop.

The engine's ``serve()`` never calls ``time`` directly — every timestamp,
idle wait, and execution charge goes through one of these, so the whole
arrival-aware loop is deterministically testable (and trace-replayable in
benchmarks) without real sleeps.

  * ``MonotonicClock`` — production: ``time.perf_counter`` + ``time.sleep``;
    execution advances wall time by itself, so ``tick`` is a no-op.
  * ``SimClock`` — virtual time. ``sleep`` advances the virtual clock
    instantly; ``tick(real_dt, model)`` charges execution time: the
    measured real duration by default, or a fixed/per-model override
    (``exec_time``) so scheduling tests are bit-reproducible regardless of
    host speed.
"""
from __future__ import annotations

import time
from typing import Callable, Union


class MonotonicClock:
    """Real time. ``tick`` is a no-op: execution already advanced it."""

    # real clocks can block on real events (RequestStream.wait_for_push);
    # virtual ones cannot — the event-driven idle wait keys off this
    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, dt: float):
        if dt > 0:
            time.sleep(dt)

    def tick(self, real_dt: float, model: str = "", frac: float = 1.0,
             batch_size: int = 1) -> float:
        return real_dt


class SimClock:
    """Deterministic virtual clock.

    ``exec_time`` controls what ``tick`` charges per executed batch:
      * None      — charge the measured real duration (realistic latencies
                    on a virtual arrival timeline);
      * float     — fixed virtual seconds per batch (fully deterministic);
      * callable  — ``f(model_name) -> seconds`` for skewed per-model rates.

    ``batch_growth`` makes fixed/per-model charges batch-size dependent:
    a batch of ``b`` rows charges ``exec_time * (1 + batch_growth*(b-1))``
    — the virtual analogue of a fused pass slowing down as rows are added,
    which is what makes deadline-aware batch capping observable in a
    SimClock scenario (it mirrors ``BatchLatencyEstimator(growth=...)``,
    so a matching estimator is exact from its priors). The default 0.0
    keeps every earlier schedule bit-identical.
    """

    # virtual time: sleeps advance instantly, so an event-driven idle
    # wait must step the clock, never block on real pushes
    virtual = True

    def __init__(self, start: float = 0.0,
                 exec_time: Union[None, float,
                                  Callable[[str], float]] = None,
                 batch_growth: float = 0.0):
        self._t = float(start)
        self.exec_time = exec_time
        self.batch_growth = float(batch_growth)
        self.slept_s = 0.0           # total idle time the loop waited out

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float):
        if dt > 0:
            self._t += dt
            self.slept_s += dt

    def advance(self, dt: float):
        self._t += max(0.0, dt)

    def tick(self, real_dt: float, model: str = "", frac: float = 1.0,
             batch_size: int = 1) -> float:
        """Charge one executed batch — or, with ``frac`` < 1, the fraction
        of it that ran before a preemption checkpoint. Fixed/per-model
        ``exec_time`` charges scale by ``frac`` (so a batch split into
        segments charges exactly one batch's worth in total) and by the
        ``batch_growth`` size factor; measured real durations
        (``exec_time=None``) are already per-segment and per-size."""
        scale = frac * (1.0 + self.batch_growth * max(0, int(batch_size) - 1))
        if self.exec_time is None:
            dt = real_dt
        elif callable(self.exec_time):
            dt = float(self.exec_time(model)) * scale
        else:
            dt = float(self.exec_time) * scale
        self._t += max(0.0, dt)
        return dt
