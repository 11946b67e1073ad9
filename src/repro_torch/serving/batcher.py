"""Request batcher: groups same-model FIFO requests into padded batches up
to `max_batch`/`max_wait_s` — the serving front the online loop
(``ServingEngine.serve``) coalesces traffic through. Kept separate from
the engine so the FIFO semantics of the paper's evaluation stay pure
(batch size 1) unless explicitly enabled.

``make_batch`` pads a same-model group to the max sequence length and
records each member's row span + true length; ``split_batch_result``
inverts it, slicing the batched output back to per-request results.
Causal attention + per-position norms make the padded prefix rows
bit-for-bit equal to a solo run, so de-batched streamed outputs still
compare exactly against per-request preload references.

Deadline-aware capping: ``make_batch`` optionally takes the
scheduler's cost view (``now`` / ``estimate(batch_size)`` /
``restream_cost_s`` / ``deadline_of``) and then admits members greedily
only while the grown batch still makes the tightest admitted deadline —
joining can never blow the head's deadline (the real-time regression
Demand Layering warns against when loading/exec pipelines run under a
deadline). Members the cap excludes come back in ``Batch.deferred`` in
FIFO order so the engine can requeue them at the head of the line. With
slack deadlines the cap never binds and the batch is bit-for-bit
identical to the uncapped one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.types import Request


def _deadline_or_inf(r: Request) -> float:
    return r.deadline_s if r.deadline_s is not None else math.inf


@dataclass
class BatcherConfig:
    max_batch: int = 8
    max_wait_s: float = 0.005
    pad_id: int = 0


@dataclass
class Batch:
    """A coalesced same-model group + the bookkeeping to un-coalesce it."""
    model: str
    tokens: np.ndarray
    requests: List[Request] = field(default_factory=list)
    row_spans: List[Tuple[int, int]] = field(default_factory=list)
    seq_lens: List[int] = field(default_factory=list)
    # members the deadline-aware feasibility cap excluded, FIFO order —
    # the engine requeues these at the head of the model's queue
    deferred: List[Request] = field(default_factory=list)

    @property
    def arrival_s(self) -> float:
        return self.requests[0].arrival_s if self.requests else 0.0

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def deadline_s(self) -> float:
        """The batch's effective deadline: the tightest member deadline
        (the whole fused execution must land by then), +inf when no member
        carries one — what the engine's preemption check compares against."""
        ds = [r.deadline_s for r in self.requests if r.deadline_s is not None]
        return min(ds) if ds else math.inf

    @property
    def priority(self) -> float:
        """The batch's scheduling weight: the highest member priority (a
        high-priority rider must not lose its weight by being coalesced
        with background work)."""
        return max((r.priority for r in self.requests), default=1.0)


def feasible_prefix(group: List[Request], *, now: float,
                    estimate: Callable[[int], float],
                    restream_cost_s: float = 0.0,
                    deadline_of: Optional[Callable[[Request], float]] = None,
                    ) -> int:
    """Largest FIFO prefix of ``group`` that one fused execution can serve
    without blowing any admitted member's deadline: members are admitted
    greedily while ``now + estimate(k) + restream_cost_s`` stays within
    the tightest deadline among the first ``k`` members (the head's
    deadline when the head is tightest — a later member with an even
    tighter deadline tightens the bound further, never loosens it). The
    head itself is always admitted: its own feasibility is the admission
    controller's job, not the batcher's."""
    dl = deadline_of or _deadline_or_inf
    eff = dl(group[0])
    k = 1
    while k < len(group):
        cand_eff = min(eff, dl(group[k]))
        if now + estimate(k + 1) + restream_cost_s > cand_eff + 1e-9:
            break
        eff = cand_eff
        k += 1
    return k


def make_batch(group: List[Request], cfg: BatcherConfig, *,
               now: Optional[float] = None,
               estimate: Optional[Callable[[int], float]] = None,
               restream_cost_s: float = 0.0,
               deadline_of: Optional[Callable[[Request], float]] = None,
               ) -> Batch:
    """Pad a same-model FIFO group to one (sum_b, max_s) token batch.

    With ``estimate`` (and ``now``) the deadline-aware feasibility cap is
    applied first: only the ``feasible_prefix`` of the group is batched
    and the excluded tail lands in ``Batch.deferred`` (FIFO order) for the
    caller to requeue. Without them every member is admitted — the original
    behaviour, bit-for-bit."""
    if not group:
        raise ValueError("make_batch: empty request group")
    if len({r.model for r in group}) != 1:
        raise ValueError("make_batch: cross-model group "
                         f"{sorted({r.model for r in group})}")
    deferred: List[Request] = []
    if estimate is not None:
        if now is None:
            raise ValueError("make_batch: feasibility cap needs `now`")
        k = feasible_prefix(group, now=now, estimate=estimate,
                            restream_cost_s=restream_cost_s,
                            deadline_of=deadline_of)
        group, deferred = group[:k], group[k:]
    s = max(r.tokens.shape[1] for r in group)
    toks = np.full((sum(r.tokens.shape[0] for r in group), s),
                   cfg.pad_id, np.int32)
    batch = Batch(model=group[0].model, tokens=toks, requests=list(group),
                  deferred=deferred)
    row = 0
    for r in group:
        b, sl = r.tokens.shape
        toks[row: row + b, :sl] = r.tokens
        batch.row_spans.append((row, row + b))
        batch.seq_lens.append(sl)
        row += b
    return batch


def split_batch_result(batch: Batch, result) -> list:
    """De-batch a (batch, seq, ...) output back to per-request slices,
    dropping each member's padded tail — the round-trip inverse of
    ``make_batch``. Arrays and tensors (on any device) are sliced as they
    are; anything else goes through ``np.asarray``."""
    arr = result if hasattr(result, "shape") else np.asarray(result)
    if arr.shape[0] != batch.tokens.shape[0]:
        raise ValueError(
            f"split_batch_result: result has {arr.shape[0]} rows, batch "
            f"was made from {batch.tokens.shape[0]} — not this batch's "
            "output")
    out = []
    for (lo, hi), sl in zip(batch.row_spans, batch.seq_lens):
        out.append(arr[lo:hi, :sl])
    return out


def can_join(head: Request, candidate: Request, group_size: int,
             cfg: BatcherConfig) -> bool:
    """THE grouping rule, in one place (the engine's online loop and the
    legacy list batcher both delegate here): same model as the group head,
    within ``max_wait_s`` of the head's arrival, group below ``max_batch``."""
    return (candidate.model == head.model
            and group_size < cfg.max_batch
            and candidate.arrival_s - head.arrival_s <= cfg.max_wait_s)


def group_requests(reqs: List[Request], cfg: BatcherConfig) -> List[List[Request]]:
    """Split a FIFO request list into coalescible groups (``can_join``
    applied to consecutive requests). Cross-model requests never share a
    group and per-model FIFO order is preserved."""
    groups: List[List[Request]] = []
    i = 0
    while i < len(reqs):
        j = i + 1
        group = [reqs[i]]
        while j < len(reqs) and can_join(reqs[i], reqs[j], len(group), cfg):
            group.append(reqs[j])
            j += 1
        groups.append(group)
        i = j
    return groups


def batch_requests(reqs: List[Request], cfg: BatcherConfig) -> List[Request]:
    """Coalesce consecutive same-model requests (FIFO order preserved) into
    padded ``Request``s — the legacy list-in/list-out front used when the
    caller does not need de-batching."""
    out: List[Request] = []
    for group in group_requests(reqs, cfg):
        if len(group) == 1:
            out.append(group[0])
        else:
            b = make_batch(group, cfg)
            out.append(Request(model=b.model, tokens=b.tokens,
                               arrival_s=b.arrival_s))
    return out
