"""Typed serving reports: one dataclass per report surface,
replacing the ad-hoc string-keyed dicts ``slo_report()`` /
``model_report()`` / ``Router.report()`` / ``Replica.health()`` used to
return.

Every report shares the ``ReportBase`` contract:

  * ``as_dict()`` — plain nested dict/float/int payload (JSON-ready,
    what the benchmarks serialize into ``BENCH_*.json``);
  * ``from_dict(d)`` — the inverse (round-trip tested);
  * ``report["field"]`` — mapping-style access kept for migration, so
    callers that still string-pluck keys keep working;
  * NaN-aware equality — dataclass ``==`` treating NaN == NaN, so two
    reports from bit-identical runs compare equal even when an empty
    latency cell reads NaN;
  * ``WINDOWED_FIELDS`` — the class-level label separating exact
    lifetime counters from fields derived from ring-buffered windows
    (bounded logs): at trace scale a windowed field describes the
    most recent ``log_cap`` events, not the lifetime.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar, Dict, Tuple


def _eq(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)        # NaN == NaN
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    return a == b


class ReportBase:
    """Shared report behaviour: ``as_dict``/``from_dict`` round-trip,
    mapping-style ``report["field"]`` access, NaN-aware equality."""

    #: fields derived from ring-buffered logs — a WINDOW at trace scale,
    #: not a lifetime aggregate. Everything else is an exact counter or
    #: an exact reduction over the responses passed in.
    WINDOWED_FIELDS: ClassVar[Tuple[str, ...]] = ()

    def as_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ReportBase):
                v = v.as_dict()
            elif isinstance(v, dict):
                v = {k: (x.as_dict() if isinstance(x, ReportBase) else x)
                     for k, x in v.items()}
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "ReportBase":
        kw = dict(d)
        for f in dataclasses.fields(cls):
            sub = _NESTED.get((cls.__name__, f.name))
            if sub is not None and f.name in kw:
                v = kw[f.name]
                if isinstance(v, dict) and not isinstance(v, sub):
                    kw[f.name] = {k: (sub.from_dict(x)
                                      if isinstance(x, dict) else x)
                                  for k, x in v.items()}
        return cls(**kw)

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def keys(self):
        return [f.name for f in dataclasses.fields(self)]

    def __contains__(self, key: str) -> bool:
        return any(f.name == key for f in dataclasses.fields(self))

    def __eq__(self, other) -> bool:
        if other.__class__ is not self.__class__:
            return NotImplemented
        return all(_eq(getattr(self, f.name), getattr(other, f.name))
                   for f in dataclasses.fields(self))

    __hash__ = None


@dataclass(eq=False)
class PriorityStats(ReportBase):
    """One priority class's outcome (``per_priority_stats``): exact
    counts/rates plus served-latency percentiles (NaN when the class had
    no served request)."""
    requests: int = 0
    served: int = 0
    rejected: int = 0
    miss_rate: float = 0.0
    rejection_rate: float = 0.0
    p50_s: float = float("nan")
    p99_s: float = float("nan")


@dataclass(eq=False)
class SLOReport(ReportBase):
    """``ServingEngine.slo_report``: exact reductions over the responses
    passed in, plus the engine-lifetime intervention counters.
    ``calibration`` is the learned cost model's per-model fit telemetry
    (``{}`` under the plain EWMA estimator)."""
    requests: int = 0
    served: int = 0
    miss_rate: float = 0.0
    rejection_rate: float = 0.0
    priority_miss_rate: float = 0.0
    per_priority: Dict[float, PriorityStats] = field(default_factory=dict)
    preemptions: int = 0
    deferred_joins: int = 0
    calibration: dict = field(default_factory=dict)


@dataclass(eq=False)
class ModelReport(ReportBase):
    """Per-model aggregate over a run_all/serve history. Derived from
    the ring-buffered ``stats_log`` — at trace scale this is the most
    recent window, not the lifetime (see ``WINDOWED_FIELDS``)."""
    WINDOWED_FIELDS: ClassVar[Tuple[str, ...]] = (
        "requests", "peak_bytes", "avg_bytes", "cache_hits",
        "cache_misses")
    requests: int = 0
    peak_bytes: int = 0
    avg_bytes: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


@dataclass(eq=False)
class ReplicaHealth(ReportBase):
    """One replica's observable state. Produced by ``Replica.health()``
    (live view: load/clock/budget filled) and embedded per-replica in
    ``FleetReport`` (breaker fields filled by the Router)."""
    rid: int = 0
    dead: bool = False
    wedged: bool = False
    slow_factor: float = 1.0
    load: int = 0
    clock_s: float = 0.0
    batches: int = 0
    free_budget: int = 0
    restream_bytes: int = 0
    breaker: str = ""
    breaker_transitions: int = 0


@dataclass(eq=False)
class FleetReport(ReportBase):
    """``Router.report``: fleet-wide outcome counters (exact) plus the
    per-replica health snapshots."""
    requests: int = 0
    served: int = 0
    rejected: int = 0
    failed: int = 0
    miss_rate: float = 0.0
    rejection_rate: float = 0.0
    bad_rate: float = 0.0
    retries: int = 0
    gave_up: int = 0
    dup_suppressed: int = 0
    restream_bytes: int = 0
    per_replica: Dict[int, ReplicaHealth] = field(default_factory=dict)


# nested-report field registry for from_dict round-trips
_NESTED = {
    ("SLOReport", "per_priority"): PriorityStats,
    ("FleetReport", "per_replica"): ReplicaHealth,
}
