"""OPG — Overlap Plan Generation problem (paper §3.1).

Decision variables:
  W              preload set (weights loaded+transformed before execution)
  z_w            earliest op index that loads weight w (streamed weights)
  x_{w,l}        chunks of w transformed at op l  (0..T(w))

Objective:  lambda * |W|_bytes  +  (1 - lambda) * sum_w (i_w - z_w)

Constraints:
  C0  completeness:        sum_l x_{w,l} == T(w)            (streamed w)
  C1  loading distance:    x_{w,l} >= 1  =>  z_w <= l
  C2  peak memory:         residency(l) <= M_peak for all l, where
                           residency counts chunks loaded at l' <= l for
                           weights not yet consumed (i_w >= l) — the
                           "in-flight across UM+TM" reading of the paper
  C3  load capacity:       sum_w x_{w,l} <= C_l
  C4  fallback tiers (solver-side): soft thresholding -> incremental
      preloading -> greedy heuristic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.graph import ModelGraph


@dataclass
class OPGProblem:
    graph: ModelGraph
    chunk_bytes: int                     # S
    m_peak: int                          # bytes
    capacity: List[int]                  # C_l in CHUNKS per op index
    lam: float = 0.9                     # lambda: preload weight in objective
    mu: float = 1.0                      # distance penalty unit (fusion scoring)
    force_preload: tuple = ()            # weights pinned into W (first ops)

    def chunks_of(self, wname: str) -> int:
        return max(1, math.ceil(self.graph.weights[wname].bytes /
                                self.chunk_bytes))

    @property
    def n_ops(self) -> int:
        return len(self.graph.ops)


@dataclass
class OPGSolution:
    preload: set = field(default_factory=set)     # W
    x: Dict[tuple, int] = field(default_factory=dict)   # (wname, l) -> chunks
    z: Dict[str, int] = field(default_factory=dict)     # wname -> earliest l
    status: str = "UNSOLVED"              # OPTIMAL | FEASIBLE | HEURISTIC
    solve_s: float = 0.0
    fallbacks_used: tuple = ()

    def loads_at(self, l: int) -> List[tuple]:
        return [(w, n) for (w, ll), n in self.x.items() if ll == l and n > 0]

    def objective(self, prob: OPGProblem) -> float:
        pre_bytes = sum(prob.graph.weights[w].bytes for w in self.preload)
        dist = sum(prob.graph.weights[w].consumer - z
                   for w, z in self.z.items() if w not in self.preload)
        return prob.lam * pre_bytes / max(prob.chunk_bytes, 1) \
            + (1 - prob.lam) * dist


def residency_profile(prob: OPGProblem, sol: OPGSolution) -> List[int]:
    """Bytes resident (streamed, not-yet-consumed chunks) after each op."""
    n = prob.n_ops
    res = [0] * (n + 1)
    for (w, l), cnt in sol.x.items():
        if cnt <= 0 or w in sol.preload:
            continue
        iw = prob.graph.weights[w].consumer
        b = cnt * prob.chunk_bytes
        for t in range(l, iw + 1):
            res[t] += b
    return res[: n]


def check_constraints(prob: OPGProblem, sol: OPGSolution) -> List[str]:
    """Return list of violated constraint descriptions (empty = feasible)."""
    g = prob.graph
    errs = []
    for wname, w in g.weights.items():
        if wname in sol.preload:
            continue
        tw = prob.chunks_of(wname)
        placed = sum(cnt for (wn, l), cnt in sol.x.items() if wn == wname)
        if placed != tw:
            errs.append(f"C0 {wname}: placed {placed} != T(w) {tw}")
        zs = [l for (wn, l), cnt in sol.x.items() if wn == wname and cnt > 0]
        if zs:
            if wname not in sol.z or sol.z[wname] > min(zs):
                errs.append(f"C1 {wname}: z={sol.z.get(wname)} > min load {min(zs)}")
            if max(zs) >= w.consumer:
                errs.append(f"C1b {wname}: load at/after consumer {w.consumer}")
    # C2 residency
    res = residency_profile(prob, sol)
    for l, r in enumerate(res):
        if r > prob.m_peak:
            errs.append(f"C2 op{l}: residency {r} > M_peak {prob.m_peak}")
            break
    # C3 capacity
    per_l: Dict[int, int] = {}
    for (wn, l), cnt in sol.x.items():
        if wn in sol.preload:
            continue
        per_l[l] = per_l.get(l, 0) + cnt
    for l, tot in per_l.items():
        if tot > prob.capacity[l]:
            errs.append(f"C3 op{l}: {tot} chunks > C_l {prob.capacity[l]}")
    # first-op weights must be preloaded (no earlier op exists)
    for wname, w in g.weights.items():
        if w.consumer == 0 and wname not in sol.preload:
            errs.append(f"W {wname}: consumer is op 0, must preload")
    return errs
