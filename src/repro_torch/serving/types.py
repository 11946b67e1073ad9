"""Serving-layer datatypes shared by the engine, batcher, and streams.

Kept free of engine imports so ``serving/batcher.py`` and
``serving/stream.py`` can build on ``Request`` without a cycle through
``serving/engine.py`` (which imports both).

SLO machinery: a ``Request`` may carry an explicit ``deadline_s``
on the serving clock's timeline; when it does not, the engine derives one
from the per-model ``SLOConfig`` (``arrival + slo``). A ``Response``
reports whether its request was served (``status="ok"``) or refused by
the admission controller (``status="rejected"``) — shedding infeasible
work is an explicit, observable outcome instead of silent tail-latency
inflation. ``deadline_miss_rate`` / ``rejection_rate`` are the shared
metric reductions the benchmarks and scenario tests both use, so A/B
numbers always mean the same thing.

Priorities: a ``Request`` also carries a ``priority`` weight
(default 1.0). Under ``scheduler="slo"`` the EDF key becomes
priority-weighted (weighted slack; see ``engine.serve``), admission and
shedding prefer dropping low-priority work first, and ``priority == 0``
marks best-effort traffic that never displaces deadline work.
``priority_miss_rate`` (priority-weighted misses) and
``per_priority_stats`` (per-weight latency percentiles) are the matching
metric reductions.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, Optional

import numpy as np


class RingLog:
    """Bounded decision log: keeps the most recent ``cap`` entries plus an
    exact lifetime ``total`` count, so observability memory is O(cap) in
    trace length while streaming aggregates stay exact.

    Every engine/router decision log (``batch_log``, ``admission_log``,
    ``kv_log``, ``route_log``, ...) is one of these. It quacks like the
    list the logs used to be — iteration in append order, ``len`` of the
    RETAINED entries, integer/slice indexing, equality against plain
    lists — so scenario tests that replay short traces (< cap events)
    see bit-identical contents. At trace scale the tail is truncated;
    anything that must stay exact reads ``total`` or a dedicated counter
    (``ServingEngine.slo_report`` does), never ``len``."""

    __slots__ = ("_buf", "total")

    def __init__(self, cap: int = 10000, items: Iterable = ()):
        self._buf: deque = deque(items, maxlen=int(cap))
        self.total: int = len(self._buf)

    @property
    def cap(self) -> int:
        return self._buf.maxlen

    def append(self, item):
        self._buf.append(item)
        self.total += 1

    def clear(self):
        """Drop retained entries AND reset ``total`` — the semantics of
        ``list.clear`` on the old unbounded logs (tests clear a log and
        recompute aggregates from what accumulates afterwards)."""
        self._buf.clear()
        self.total = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __iter__(self) -> Iterator:
        return iter(self._buf)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._buf)[idx]
        return self._buf[idx]

    def __eq__(self, other) -> bool:
        if isinstance(other, RingLog):
            return list(self._buf) == list(other._buf)
        if isinstance(other, (list, tuple, deque)):
            return list(self._buf) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"RingLog(cap={self._buf.maxlen}, total={self.total}, "
                f"retained={list(self._buf)!r})")


@dataclass
class Request:
    model: str
    tokens: np.ndarray
    arrival_s: float = field(default_factory=time.perf_counter)
    # absolute completion deadline on the serving clock (None = derive from
    # the engine's SLOConfig, or "no deadline" when no SLO is configured)
    deadline_s: Optional[float] = None
    # scheduling weight: 1.0 = the plain-EDF behaviour, > 1 shrinks the
    # request's effective slack (runs/admits earlier), 0 = best-effort
    # (served only when no deadline work competes, shed first)
    priority: float = 1.0
    # caller-assigned correlation id, echoed on the Response. The engine
    # never reads it; the fleet Router uses it to match terminal responses
    # to tracked requests across retries (a retry is a NEW Request object
    # with the same req_id)
    req_id: Optional[int] = None
    # planned decode length (generated tokens): with a unified budget pool
    # (engine kv=KVSpec(...)) the engine charges this sequence's paged KV
    # growth — prompt prefill plus decode_tokens, prorated per executed
    # segment — against the shared budget. 0 = prefill-only accounting.
    decode_tokens: int = 0

    def __post_init__(self):
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0, got {self.priority}")
        if self.decode_tokens < 0:
            raise ValueError(f"decode_tokens must be >= 0, "
                             f"got {self.decode_tokens}")


@dataclass
class Response:
    model: str
    latency_s: float
    init_s: float
    exec_s: float
    peak_bytes: int
    avg_bytes: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_hit_rate: float = 0.0
    result: object = None
    # online-loop fields (serve()): arrival-to-completion accounting and the
    # coalesced batch the request rode in. run_all() leaves them at defaults.
    arrival_s: float = 0.0
    queue_s: float = 0.0
    batch_size: int = 1
    # SLO fields: "ok" = served; "rejected" = the admission controller
    # refused the request (result is None, latency_s is time-to-decision)
    status: str = "ok"
    deadline_s: Optional[float] = None
    priority: float = 1.0
    # echo of Request.req_id (None when the caller didn't assign one)
    req_id: Optional[int] = None
    # KV bytes this request's sequence held in the unified pool at
    # completion (0 under weights-only serving)
    kv_bytes: int = 0
    # cost-model observability (serve()): what the scheduler's cost model
    # priced this request's batch at when the batch first started, and
    # what the serving clock actually charged for the whole execution.
    # Shared across a batch's members; 0.0 for rejected / run_all paths.
    predicted_s: float = 0.0
    charged_s: float = 0.0

    @property
    def finish_s(self) -> float:
        """Completion time on the serving clock (arrival + latency)."""
        return self.arrival_s + self.latency_s

    @property
    def deadline_met(self) -> Optional[bool]:
        """True/False against the deadline; None when there was no deadline
        or the request was never served (rejected)."""
        if self.deadline_s is None or not math.isfinite(self.deadline_s) \
                or self.status != "ok":
            return None
        return self.finish_s <= self.deadline_s + 1e-9


@dataclass
class SLOConfig:
    """Per-model latency SLOs: a request's default deadline is
    ``arrival_s + slo_for(model)``. ``per_model`` overrides the default
    for individual models (e.g. an interactive ASR model with a tighter
    bound than a background summarizer)."""
    default_slo_s: float = 0.25
    per_model: Dict[str, float] = field(default_factory=dict)

    def slo_for(self, model: str) -> float:
        return self.per_model.get(model, self.default_slo_s)

    def deadline_for(self, req: Request) -> float:
        return req.arrival_s + self.slo_for(req.model)


# ---------------------------------------------------------------------------
# shared SLO metric reductions (benchmarks + scenario tests)
#
# every reducer runs ONE vectorized numpy kernel over raw column
# arrays. A columnar ResponseTable hands its arrays over zero-copy
# (``reducer_columns()``); an iterable of Response objects is extracted
# into identical arrays first — so object and columnar modes agree
# bit-for-bit by construction (same dtypes, same element order, same
# numpy reduction).
# ---------------------------------------------------------------------------

_STATUS_OK, _STATUS_REJECTED, _STATUS_FAILED = 0, 1, 2
_STATUS_TO_CODE = {"ok": _STATUS_OK, "rejected": _STATUS_REJECTED,
                   "failed": _STATUS_FAILED}


def response_columns(responses) -> dict:
    """Reducer-ready column arrays from either a ``ResponseTable``
    (zero-copy via ``reducer_columns``) or an iterable of ``Response``
    objects (extracted, preserving order). Keys: status (int8 codes),
    arrival_s/latency_s/deadline_s (NaN = no deadline)/priority/
    predicted_s/charged_s (float64), req_id (int64, -1 = unassigned),
    model_id (int32) + vocab."""
    rc = getattr(responses, "reducer_columns", None)
    if rc is not None:
        return rc()
    rs = responses if isinstance(responses, (list, tuple)) \
        else list(responses)
    n = len(rs)
    vocab: list = []
    ids: Dict[str, int] = {}
    model_id = np.empty(n, dtype=np.int32)
    for i, r in enumerate(rs):
        mid = ids.get(r.model)
        if mid is None:
            mid = ids[r.model] = len(vocab)
            vocab.append(r.model)
        model_id[i] = mid
    return {
        "status": np.fromiter(
            (_STATUS_TO_CODE.get(r.status, _STATUS_FAILED) for r in rs),
            dtype=np.int8, count=n),
        "arrival_s": np.fromiter((r.arrival_s for r in rs),
                                 dtype=np.float64, count=n),
        "latency_s": np.fromiter((r.latency_s for r in rs),
                                 dtype=np.float64, count=n),
        "deadline_s": np.fromiter(
            (np.nan if r.deadline_s is None else r.deadline_s
             for r in rs), dtype=np.float64, count=n),
        "priority": np.fromiter((r.priority for r in rs),
                                dtype=np.float64, count=n),
        "predicted_s": np.fromiter((r.predicted_s for r in rs),
                                   dtype=np.float64, count=n),
        "charged_s": np.fromiter((r.charged_s for r in rs),
                                 dtype=np.float64, count=n),
        "req_id": np.fromiter(
            (-1 if r.req_id is None else r.req_id for r in rs),
            dtype=np.int64, count=n),
        "model_id": model_id,
        "vocab": vocab,
    }


def _judged_missed(c: dict):
    """(judged, missed) masks: judged = served with a finite deadline;
    missed = judged and finished past deadline + 1e-9 (the Response.
    deadline_met tolerance)."""
    judged = (c["status"] == _STATUS_OK) & np.isfinite(c["deadline_s"])
    finish = c["arrival_s"] + c["latency_s"]
    missed = judged & ~(finish <= c["deadline_s"] + 1e-9)
    return judged, missed


def status_counts(responses) -> Dict[str, int]:
    """Exact {status: count} over responses (either storage mode)."""
    status = response_columns(responses)["status"]
    return {"ok": int(np.count_nonzero(status == _STATUS_OK)),
            "rejected": int(np.count_nonzero(status == _STATUS_REJECTED)),
            "failed": int(np.count_nonzero(status == _STATUS_FAILED))}


def deadline_miss_rate(responses) -> float:
    """Fraction of SERVED deadlined requests that finished late. Rejected
    requests are not misses — rejection is the explicit alternative the
    admission controller offers — and deadline-less requests can't miss."""
    judged, missed = _judged_missed(response_columns(responses))
    n = int(np.count_nonzero(judged))
    if n == 0:
        return 0.0
    return int(np.count_nonzero(missed)) / n


def rejection_rate(responses) -> float:
    """Fraction of all responses the admission controller refused."""
    status = response_columns(responses)["status"]
    n = status.size
    if n == 0:
        return 0.0
    return int(np.count_nonzero(status == _STATUS_REJECTED)) / n


def priority_miss_rate(responses) -> float:
    """Priority-WEIGHTED deadline miss rate: each judged response counts
    with its priority, so a priority-2 miss hurts twice as much as a
    priority-1 miss and best-effort (priority-0) work never moves the
    number — the scalar the weighted-EDF scheduler is graded on."""
    c = response_columns(responses)
    judged, missed = _judged_missed(c)
    total = float(np.sum(c["priority"][judged]))
    if total <= 0:
        return 0.0
    return float(np.sum(c["priority"][missed])) / total


def prediction_error(responses) -> Dict[str, dict]:
    """Per-model realized cost-model error over SERVED responses: how far
    the scheduler's priced batch latency (``Response.predicted_s``) landed
    from what the clock actually charged (``Response.charged_s``).
    Aggregated per response, so larger batches weigh by their member
    count — the admission/urgency decisions were made once per member.
    Responses without stamps (run_all, rejected, older traces) are
    skipped."""
    c = response_columns(responses)
    sampled = (c["status"] == _STATUS_OK) & (c["charged_s"] > 0.0)
    vocab = c["vocab"]
    out: Dict[str, dict] = {}
    for mid in sorted(np.unique(c["model_id"][sampled]).tolist(),
                      key=lambda i: vocab[i]):
        m = sampled & (c["model_id"] == mid)
        charged = c["charged_s"][m]
        abs_err = np.abs(c["predicted_s"][m] - charged)
        rel_err = abs_err / np.maximum(charged, 1e-12)
        out[vocab[mid]] = {
            "samples": int(np.count_nonzero(m)),
            "mae_s": float(np.mean(abs_err)),
            "rel_err": float(np.mean(rel_err)),
        }
    return out


def per_priority_stats(responses) -> Dict[float, "PriorityStats"]:
    """Per-priority-level breakdown: request counts, miss/rejection rates,
    and served-latency percentiles — the engine report's view of how each
    traffic class fared (high priority should miss less under overload,
    low priority should still be served: the aging/starvation check).
    Returns typed ``PriorityStats`` keyed by priority weight,
    ascending."""
    from repro_torch.serving.reports import PriorityStats
    c = response_columns(responses)
    judged, missed = _judged_missed(c)
    served_mask = c["status"] == _STATUS_OK
    rejected_mask = c["status"] == _STATUS_REJECTED
    out: Dict[float, PriorityStats] = {}
    for p in np.unique(c["priority"]).tolist():
        m = c["priority"] == p
        n = int(np.count_nonzero(m))
        served = int(np.count_nonzero(m & served_mask))
        nj = int(np.count_nonzero(m & judged))
        lats = c["latency_s"][m & served_mask]
        out[float(p)] = PriorityStats(
            requests=n,
            served=served,
            rejected=int(np.count_nonzero(m & rejected_mask)),
            miss_rate=(int(np.count_nonzero(m & missed)) / nj
                       if nj else 0.0),
            rejection_rate=(int(np.count_nonzero(m & rejected_mask)) / n
                            if n else 0.0),
            p50_s=float(np.percentile(lats, 50)) if served
            else float("nan"),
            p99_s=float(np.percentile(lats, 99)) if served
            else float("nan"),
        )
    return out
