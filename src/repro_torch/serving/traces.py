"""Trace-scale workload library: seeded arrival-pattern generators that
stress the serving stack the way production traffic does, at 10^5-request
scale (benchmarks/trace_scale.py replays them).

Four families, each motivated by a real mobile/edge serving pattern:

  * ``diurnal_trace``      — sinusoidal day/night load via a thinned
    Poisson process: draw at the peak rate, accept each arrival with
    probability lambda(t)/lambda_max. Exact (no time-stepping bias) and
    seeded.
  * ``flash_crowd_trace``  — steady background traffic plus a windowed
    rate multiplier (default x20) on ONE model: the viral-moment pattern
    that floods a single entry in the weight pool.
  * ``multi_tenant_trace`` — per-tenant Poisson mixes with per-tenant
    SLOs and priorities; returns a ``req_id -> tenant`` map so per-tenant
    miss rates (and Jain fairness across tenants) can be computed from
    the engine's responses.
  * ``session_trace``      — correlated successive-model sessions (the
    paper's multi-DNN pipeline workload, e.g. ASR -> LLM -> TTS): session
    starts are Poisson, and each session walks a model chain with
    think-time gaps, so back-to-back requests hit DIFFERENT models — the
    access pattern that defeats single-model caching.

Every generator is seeded, returns arrival-sorted ``Request`` lists, and
keeps all arrivals inside ``[0, duration_s)``. Use ``stamp_req_ids``
(re-exported from serving.stream) before keying any per-request metric —
``(model, arrival_s)`` keys collapse identical arrivals.

``jain_fairness`` is the standard index ``(sum x)^2 / (n * sum x^2)``:
1.0 when every tenant gets equal service, -> 1/n when one tenant starves
the rest.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.serving.stream import (_mk_request, poisson_trace,
                                  stamp_req_ids)
from repro_torch.serving.types import (Request, _STATUS_OK, _judged_missed,
                                 response_columns)

__all__ = [
    "TenantSpec", "diurnal_trace", "flash_crowd_trace",
    "multi_tenant_trace", "session_trace", "jain_fairness",
    "stamp_req_ids",
]


def diurnal_trace(rates: Dict[str, float], duration_s: float, *,
                  period_s: float, depth: float = 0.8,
                  phase: float = 0.0, vocab: int, seq: int,
                  seed: int = 0) -> List[Request]:
    """Sinusoidally modulated Poisson arrivals per model.

    The instantaneous rate is ``base * (1 + depth * sin(2*pi*t/period_s
    + phase))`` — a day/night cycle compressed to ``period_s``. Sampling
    is by thinning: draw a homogeneous process at the peak rate
    ``base * (1 + depth)`` and accept each point with probability
    ``lambda(t) / lambda_max``, which is exact for any inhomogeneous
    intensity bounded by ``lambda_max`` (no discretization bias, unlike
    stepping time in fixed bins). ``depth`` in [0, 1): 0 degenerates to
    ``poisson_trace``; 1 would zero the trough (and the thinning bound
    still holds, so it is allowed but leaves dead air).
    """
    if not 0.0 <= depth <= 1.0:
        raise ValueError(f"depth must be in [0, 1], got {depth}")
    rng = np.random.default_rng(seed)
    omega = 2.0 * math.pi / float(period_s)
    reqs: List[Request] = []
    for model, base in rates.items():
        if base <= 0:
            continue
        lam_max = base * (1.0 + depth)
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / lam_max))
            if t >= duration_s:
                break
            lam_t = base * (1.0 + depth * math.sin(omega * t + phase))
            if rng.random() * lam_max < lam_t:
                reqs.append(_mk_request(model, t, rng, vocab, seq))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def flash_crowd_trace(base_rates: Dict[str, float], duration_s: float, *,
                      crowd_model: str, start_s: float, span_s: float,
                      factor: float = 20.0, vocab: int, seq: int,
                      seed: int = 0) -> List[Request]:
    """Steady Poisson background plus a rate spike on ONE model: within
    ``[start_s, start_s + span_s)`` the crowd model's arrival rate is
    multiplied by ``factor`` (default x20 — the viral-moment
    scenario). Implemented as the background trace superposed with an
    extra Poisson process at ``base * (factor - 1)`` inside the window
    (superposition of Poissons is Poisson, so the in-window rate is
    exactly ``base * factor``)."""
    if factor < 1.0:
        raise ValueError(f"flash-crowd factor must be >= 1, got {factor}")
    if crowd_model not in base_rates or base_rates[crowd_model] <= 0:
        raise ValueError(f"crowd model {crowd_model!r} needs a positive "
                         f"base rate (got {base_rates.get(crowd_model)})")
    reqs = poisson_trace(base_rates, duration_s, vocab=vocab, seq=seq,
                         seed=seed)
    extra_rate = base_rates[crowd_model] * (factor - 1.0)
    rng = np.random.default_rng(seed + 101)
    end_s = min(float(duration_s), start_s + span_s)
    if extra_rate > 0:
        t = float(start_s)
        while True:
            t += float(rng.exponential(1.0 / extra_rate))
            if t >= end_s:
                break
            reqs.append(_mk_request(crowd_model, t, rng, vocab, seq))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic contract: which models it calls, its Poisson
    arrival rate (req/s, split uniformly across its models), its SLO
    (stamped as ``deadline_s = arrival + slo_s``), and its scheduling
    priority (weighted-EDF weight)."""
    models: Tuple[str, ...]
    rate: float
    slo_s: float
    priority: float = 1.0

    def __post_init__(self):
        if not self.models:
            raise ValueError("tenant needs at least one model")
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be positive, got {self.slo_s}")


def multi_tenant_trace(tenants: Dict[str, TenantSpec], duration_s: float,
                       *, vocab: int, seq: int, seed: int = 0
                       ) -> Tuple[List[Request], Dict[int, str]]:
    """Superposed per-tenant Poisson mixes. Each tenant's arrivals pick
    uniformly among its models and carry the tenant's SLO deadline and
    priority. Returns ``(trace, tenant_of)`` where the trace is already
    ``stamp_req_ids``-stamped and ``tenant_of`` maps ``req_id`` ->
    tenant name — the only collision-safe key (two tenants can share a
    model AND an arrival time)."""
    rng = np.random.default_rng(seed)
    tagged: List[Tuple[str, Request]] = []
    for name in sorted(tenants):
        spec = tenants[name]
        if spec.rate <= 0:
            continue
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / spec.rate))
            if t >= duration_s:
                break
            model = spec.models[int(rng.integers(len(spec.models)))]
            r = _mk_request(model, t, rng, vocab, seq)
            tagged.append((name, replace(r, deadline_s=t + spec.slo_s,
                                         priority=spec.priority)))
    tagged.sort(key=lambda nr: nr[1].arrival_s)
    trace = stamp_req_ids([r for _, r in tagged])
    tenant_of = {r.req_id: name for (name, _), r in zip(tagged, trace)}
    return trace, tenant_of


def session_trace(models: Sequence[str], session_rate: float,
                  duration_s: float, *, chain_len: int = 3,
                  think_s: float = 0.5, vocab: int, seq: int,
                  seed: int = 0) -> List[Request]:
    """Correlated successive-model sessions: session STARTS are Poisson
    at ``session_rate``; each session enters the model list at a random
    offset and walks ``chain_len`` consecutive models (wrapping), with an
    exponential think-time gap (mean ``think_s``) between steps. This is
    the paper's multi-DNN pipeline pattern — consecutive requests from
    one user hit DIFFERENT models, so model-switch cost dominates and
    cache-affinity/prefetch policies are actually exercised. Chain steps
    that would land past ``duration_s`` are dropped (every generator here
    keeps arrivals inside the window)."""
    if not models:
        raise ValueError("session_trace needs at least one model")
    if session_rate <= 0 or chain_len < 1:
        raise ValueError("session_rate must be > 0 and chain_len >= 1")
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t0 = 0.0
    while True:
        t0 += float(rng.exponential(1.0 / session_rate))
        if t0 >= duration_s:
            break
        start = int(rng.integers(len(models)))
        t = t0
        for step in range(chain_len):
            if t >= duration_s:
                break
            model = models[(start + step) % len(models)]
            reqs.append(_mk_request(model, t, rng, vocab, seq))
            t += float(rng.exponential(think_s))
    reqs.sort(key=lambda r: r.arrival_s)
    return reqs


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over
    per-tenant service levels: 1.0 = perfectly equal, 1/n = one tenant
    gets everything. All-zero (or empty) input means no tenant was
    served differently from any other — returns 1.0."""
    xs = np.asarray([float(v) for v in values], dtype=np.float64)
    if xs.size == 0:
        return 1.0
    sq = float(np.dot(xs, xs))
    if sq <= 0.0:
        return 1.0
    s = float(np.sum(xs))
    return (s * s) / (xs.size * sq)


def tenant_on_time_rates(responses,
                         tenant_of: Dict[int, str]) -> Dict[str, float]:
    """Per-tenant on-time service level over a response set: the fraction
    of each tenant's requests that were served ("ok") AND met their
    deadline (no-deadline serves count as on time). One vectorized pass
    over the response columns — same kernel for object lists and columnar
    ``ResponseTable``s, so the trace-scale benchmarks get
    identical numbers in either mode. Requests whose ``req_id`` is absent
    from ``tenant_of`` are ignored; feed the result to
    ``jain_fairness``."""
    c = response_columns(responses)
    req_id, status = c["req_id"], c["status"]
    if not len(tenant_of) or not req_id.size:
        return {}
    _, missed = _judged_missed(c)
    on_time = (status == _STATUS_OK) & ~missed
    # tenants are few, requests are many: map each row to a tenant code
    # with one sorted-key searchsorted instead of a per-row dict lookup
    tenants = sorted(set(tenant_of.values()))
    code = {t: i for i, t in enumerate(tenants)}
    keys = np.fromiter(tenant_of.keys(), dtype=np.int64,
                       count=len(tenant_of))
    vals = np.fromiter((code[v] for v in tenant_of.values()),
                       dtype=np.int64, count=len(tenant_of))
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    pos = np.clip(np.searchsorted(keys, req_id), 0, keys.size - 1)
    row_code = np.where(keys[pos] == req_id, vals[pos], -1)
    tot = np.bincount(row_code[row_code >= 0], minlength=len(tenants))
    good = np.bincount(row_code[(row_code >= 0) & on_time],
                       minlength=len(tenants))
    return {t: (int(good[i]) / int(tot[i]) if tot[i] else 0.0)
            for i, t in enumerate(tenants)}
