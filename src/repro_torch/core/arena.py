"""Activation-arena sizing via profile-driven offset calculation.

"Efficient Memory Management for Deep Neural Net Inference" (Pisarchyk &
Lee) and Sekiyama et al.'s profile-based memory optimization for deep
neural networks both size a single shared activation buffer by solving a
small interval-placement problem offline: every activation tensor is an
interval ``[first_use, last_use]`` with a byte size, tensors whose
lifetimes overlap must occupy disjoint offset ranges, and the arena's size
is the maximum offset+size any placement reaches. Greedy-by-size best-fit
offset assignment (their "greedy by size" heuristic) is within a few
percent of optimal in both papers and is exact enough for budgeting.

Here the "profile" is the op graph itself: ``build_lm_graph`` records
``act_bytes`` per op (the activation bytes the op touches), and
``op.layer`` spans give residual streams their cross-op lifetimes. The
resulting ``arena_size(graph)`` is the per-model peak the unified budget
pool reserves for the duration of a batch (``WeightCache.reserve_arena``)
and the hard per-model floor ``allocate_joint`` subtracts before trading
weight vs KV bytes.

Kept dependency-light: only ``core.graph`` types are consumed, and only
shape metadata is read — sizing a 126-layer llama config costs microseconds
and never builds a HostModel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.graph import ModelGraph


@dataclass(frozen=True)
class ActInterval:
    """One activation tensor's profiled lifetime: live over the half-open
    op range ``[start, end)``, occupying ``size`` bytes."""
    name: str
    size: int
    start: int
    end: int

    def overlaps(self, other: "ActInterval") -> bool:
        return self.start < other.end and other.start < self.end


@dataclass
class ArenaLayout:
    """Solved offsets: every interval placed at a fixed arena offset such
    that lifetime-overlapping tensors never share bytes."""
    size: int
    offsets: List[tuple]               # (interval, offset), placement order

    def peak_concurrent(self) -> int:
        """Sum of sizes live at the single worst op — the information-
        theoretic lower bound on any layout (reached only when the
        placement has no fragmentation)."""
        events = {}
        for iv, _off in self.offsets:
            events.setdefault(iv.start, []).append(iv.size)
            events.setdefault(iv.end, []).append(-iv.size)
        live = peak = 0
        for t in sorted(events):
            live += sum(events[t])
            peak = max(peak, live)
        return peak


def activation_intervals(graph: ModelGraph) -> List[ActInterval]:
    """Lift the graph's per-op activation profile into lifetime intervals.

    Two tensor classes cover the decoder-layer structure the graph emits:

      * per-op working set — each op's ``act_bytes`` live across exactly
        that op (inputs are consumed, outputs handed to the next op);
      * residual stream — each decoder layer's residual tensor (the
        ``2 * act`` adds at ``L{i}.res1/res2``) stays live across the
        whole layer's op span: it is produced at the layer's first op and
        consumed by the closing add, so it overlaps every op between.
        Its size is taken from the layer's smallest add-op ``act_bytes``
        halved (the add touches residual + branch output).
    """
    out: List[ActInterval] = []
    by_layer = {}
    for op in graph.ops:
        if op.act_bytes > 0:
            out.append(ActInterval(op.name, int(op.act_bytes),
                                   op.index, op.index + 1))
        if op.layer >= 0:
            lo, hi, res = by_layer.get(op.layer, (op.index, op.index, 0))
            if op.kind == "add":
                half = int(op.act_bytes // 2)
                res = min(res, half) if res else half
            by_layer[op.layer] = (min(lo, op.index),
                                  max(hi, op.index + 1), res)
    for layer, (lo, hi, res) in sorted(by_layer.items()):
        if res > 0 and hi - lo > 1:
            out.append(ActInterval(f"residual.L{layer}", res, lo, hi))
    return out


def assign_offsets(intervals: List[ActInterval]) -> ArenaLayout:
    """Greedy-by-size best-fit offset assignment (Pisarchyk & Lee §3):
    place tensors largest-first; each goes at the lowest offset where it
    fits under every already-placed tensor whose lifetime overlaps."""
    placed: List[tuple] = []
    for iv in sorted(intervals, key=lambda i: (-i.size, i.start, i.name)):
        # gaps between the lifetime-overlapping placements, scanned in
        # offset order: first gap large enough wins (best-fit-low)
        conflicts = sorted(((off, off + p.size) for p, off in placed
                            if p.overlaps(iv)), key=lambda t: t[0])
        offset = 0
        for lo, hi in conflicts:
            if offset + iv.size <= lo:
                break
            offset = max(offset, hi)
        placed.append((iv, offset))
    size = max((off + iv.size for iv, off in placed), default=0)
    return ArenaLayout(size=int(size), offsets=placed)


def arena_size(graph: ModelGraph) -> int:
    """Profile-driven activation-arena peak for one model — what the
    unified pool reserves per batch and the allocator floors per model."""
    return assign_offsets(activation_intervals(graph)).size
