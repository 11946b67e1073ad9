"""Miniature exact CP solver for OPG — branch & bound with constraint
propagation. Replaces the OR-Tools CP-SAT dependency for *verification*:
tests assert the production latest-fit solver matches the exact optimum on
randomized small instances (<= ~8 weights x 14 ops).

Search space: per weight, either preload, or a composition of T(w) chunks
over ops l < i_w respecting C3 capacity and the shared C2 residency
envelope. Objective identical to OPGSolution.objective.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.opg import OPGProblem, OPGSolution


def _compositions(total: int, slots: List[int], caps: List[int]):
    """Yield tuples c_i summing to `total` with c_i <= caps[i] (latest slots
    first for better pruning)."""
    if not slots:
        if total == 0:
            yield ()
        return
    hi = min(total, caps[0])
    for take in range(hi, -1, -1):
        for rest in _compositions(total - take, slots[1:], caps[1:]):
            yield (take,) + rest


def solve_exact(prob: OPGProblem, node_limit: int = 2_000_000
                ) -> Optional[OPGSolution]:
    g = prob.graph
    n = prob.n_ops
    weights = sorted(g.weights.values(), key=lambda w: w.consumer)
    S = prob.chunk_bytes

    best: Dict[str, object] = {"obj": math.inf, "sol": None}
    nodes = {"n": 0}

    cap = list(prob.capacity)
    res = [0] * (n + 1)

    def place_range(l, iw, b, sign):
        for t in range(l, iw + 1):
            res[t] += sign * b

    def rec(i: int, preload_bytes: int, dist: int,
            x: Dict[Tuple[str, int], int], z: Dict[str, int], pre: set):
        if nodes["n"] > node_limit:
            return
        nodes["n"] += 1
        obj_so_far = prob.lam * preload_bytes / max(S, 1) + (1 - prob.lam) * dist
        if obj_so_far >= best["obj"]:
            return
        if i == len(weights):
            sol = OPGSolution(preload=set(pre), x=dict(x), z=dict(z),
                              status="OPTIMAL")
            best["obj"] = obj_so_far
            best["sol"] = sol
            return
        w = weights[i]
        tw = prob.chunks_of(w.name)
        # option A: stream — enumerate compositions over ops < i_w
        if w.consumer > 0:
            slots = list(range(w.consumer - 1, -1, -1))
            slot_caps = []
            for l in slots:
                mem_free = prob.m_peak - max(res[l:w.consumer + 1])
                slot_caps.append(max(0, min(cap[l], mem_free // S)))
            for comp in _compositions(tw, slots, slot_caps):
                zs = [l for l, c in zip(slots, comp) if c > 0]
                if not zs:
                    continue
                zw = min(zs)
                ok = True
                for l, c in zip(slots, comp):
                    if c == 0:
                        continue
                    if cap[l] < c or \
                       prob.m_peak - max(res[l:w.consumer + 1]) < c * S:
                        ok = False
                        break
                    cap[l] -= c
                    place_range(l, w.consumer, c * S, +1)
                    x[(w.name, l)] = c
                if ok:
                    z[w.name] = zw
                    rec(i + 1, preload_bytes, dist + (w.consumer - zw), x, z, pre)
                    del z[w.name]
                # rollback (also for partially-applied failed comps)
                for l, c in zip(slots, comp):
                    if c and (w.name, l) in x:
                        cap[l] += c
                        place_range(l, w.consumer, c * S, -1)
                        del x[(w.name, l)]
                if nodes["n"] > node_limit:
                    return
        # option B: preload
        pre.add(w.name)
        rec(i + 1, preload_bytes + w.bytes, dist, x, z, pre)
        pre.discard(w.name)

    rec(0, 0, 0, {}, {}, set())
    return best["sol"]
