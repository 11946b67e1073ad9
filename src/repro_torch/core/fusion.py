"""Adaptive fusion for OPG (paper §4.3).

Fusing k ops collapses k load slots into one with
C_fused ~= min(C_1..C_k); over-fusing starves the solver of schedulable
capacity and forces weights into preload. When that happens we rank fused
nodes by  Penalty(v) = lambda*|W_new| + mu*sum(dz)  and split
reusable+elemental fusions (hierarchical fusions are never split), then
re-solve — the paper's (1) identify, (2) split-feasibility, (3) iterative
refinement loop.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

from repro_torch.core import capacity as cap_mod
from repro_torch.core.graph import HIERARCHICAL, ModelGraph, Op, WeightRef
from repro_torch.core.opg import OPGProblem, OPGSolution
from repro_torch.core import solver as solver_mod

# default fusion patterns: consecutive kinds merged into one kernel
FUSABLE_TAILS = {"add", "activation", "gate", "rope", "elementwise"}
FUSION_SEEDS = {"matmul", "conv"}
HIER_SEEDS = {"softmax", "layernorm", "rmsnorm", "attention", "ssd"}


def fuse_graph(graph: ModelGraph, *, max_group: int = 4,
               fuse_hierarchical: bool = True) -> ModelGraph:
    """Greedy forward fusion: a matmul/conv absorbs following elemental ops;
    norms absorb the preceding residual add (hierarchical fusions)."""
    out = ModelGraph(graph.name + "+fused")
    i = 0
    ops = graph.ops
    while i < len(ops):
        op = ops[i]
        group = [op]
        j = i + 1
        if op.kind in FUSION_SEEDS:
            while (j < len(ops) and len(group) < max_group
                   and ops[j].kind in FUSABLE_TAILS and not ops[j].weights):
                group.append(ops[j])
                j += 1
        elif fuse_hierarchical and op.kind in HIER_SEEDS:
            while (j < len(ops) and len(group) < 2
                   and ops[j].kind in {"add"} and not ops[j].weights):
                group.append(ops[j])
                j += 1
        new_idx = len(out.ops)
        fused = Op(
            index=new_idx,
            name=group[0].name if len(group) == 1 else
            "+".join(o.name.split(".")[-1] for o in group),
            kind=group[0].kind,
            flops=sum(o.flops for o in group),
            act_bytes=sum(o.act_bytes for o in group),
            weights=tuple(w for o in group for w in o.weights),
            fused_from=tuple((o.kind, o.flops, o.act_bytes) for o in group),
            layer=group[0].layer,
        )
        out.ops.append(fused)
        for o in group:
            for wn in o.weights:
                wr = graph.weights[wn]
                out.weights[wn] = WeightRef(wn, wr.bytes, new_idx)
        i = j
    out.validate()
    return out


def split_op(graph: ModelGraph, op_index: int) -> Optional[ModelGraph]:
    """Split a fused node back into (seed, tail) subkernels. Returns the new
    graph, or None if the node is unsplittable (single op / hierarchical)."""
    op = graph.ops[op_index]
    if len(op.fused_from) < 2 or op.op_class == HIERARCHICAL:
        return None
    out = ModelGraph(graph.name)
    mapping = {}
    for o in graph.ops:
        if o.index == op_index:
            seed_kind, seed_fl, seed_ab = op.fused_from[0]
            tail = op.fused_from[1:]
            i0 = len(out.ops)
            out.ops.append(Op(i0, op.name + ".seed", seed_kind, flops=seed_fl,
                              act_bytes=seed_ab, weights=op.weights,
                              fused_from=(op.fused_from[0],), layer=op.layer))
            out.ops.append(Op(i0 + 1, op.name + ".tail", tail[0][0],
                              flops=sum(t[1] for t in tail),
                              act_bytes=sum(t[2] for t in tail),
                              fused_from=tail, layer=op.layer))
            mapping[o.index] = i0
        else:
            ni = len(out.ops)
            out.ops.append(replace(o, index=ni))
            mapping[o.index] = ni
    for wn, wr in graph.weights.items():
        out.weights[wn] = WeightRef(wn, wr.bytes, mapping[wr.consumer])
    out.validate()
    return out


def fused_capacities(graph: ModelGraph, chunk_bytes: int,
                     hw: Optional[cap_mod.HWSpec] = None,
                     model=None, thresholds=None) -> List[int]:
    """C_l with the paper's fused rule: C_fused = min over members."""
    hw = hw or cap_mod.HWSpec()
    out = []
    for op in graph.ops:
        members = op.fused_from or ((op.kind, op.flops, op.act_bytes),)
        caps = []
        for kind, fl, ab in members:
            mem_op = Op(op.index, op.name, kind, flops=fl, act_bytes=ab)
            if model is not None:
                caps.append(cap_mod.model_capacity_bytes(mem_op, model, hw,
                                                         thresholds))
            else:
                caps.append(cap_mod.analytic_capacity_bytes(mem_op, hw,
                                                            thresholds))
        out.append(min(caps) // max(chunk_bytes, 1))
    return out


def penalty(prob: OPGProblem, sol: OPGSolution, op: Op) -> float:
    """Penalty(v_fused) = lam*|W_new| + mu*sum(i_w - z_w) over v's weights."""
    pre_bytes = sum(prob.graph.weights[w].bytes for w in op.weights
                    if w in sol.preload)
    dz = sum(prob.graph.weights[w].consumer - sol.z[w]
             for w in op.weights if w in sol.z and w not in sol.preload)
    return prob.lam * pre_bytes / max(prob.chunk_bytes, 1) + prob.mu * dz


@dataclass
class AdaptiveResult:
    graph: ModelGraph
    problem: OPGProblem
    solution: OPGSolution
    splits: int = 0
    history: tuple = ()


def adaptive_fusion_solve(graph: ModelGraph, *, chunk_bytes: int, m_peak: int,
                          lam: float = 0.9, mu: float = 1.0,
                          hw: Optional[cap_mod.HWSpec] = None,
                          model=None, alpha: float = 0.1,
                          max_splits: int = 64,
                          solver_cfg: Optional[solver_mod.SolverConfig] = None
                          ) -> AdaptiveResult:
    """Fuse -> solve -> (if preloads were forced) split top-penalty fused
    nodes whose split passes the capacity-gain check -> re-solve."""
    hw = hw or cap_mod.HWSpec()
    g = fuse_graph(graph)
    history = []
    splits = 0
    best_forced = None
    stale = 0
    while True:
        caps = fused_capacities(g, chunk_bytes, hw, model)
        prob = OPGProblem(g, chunk_bytes, m_peak, caps, lam=lam, mu=mu)
        sol = solver_mod.solve(prob, solver_cfg)
        forced = [w for w in sol.preload
                  if prob.graph.weights[w].consumer > 0]
        history.append((len(g.ops), len(forced), sol.status))
        if best_forced is None or len(forced) < best_forced:
            best_forced, stale = len(forced), 0
        else:
            stale += 1
        if not forced or splits >= max_splits or stale >= 3:
            return AdaptiveResult(g, prob, sol, splits, tuple(history))
        # rank fused candidates by penalty
        cands = sorted(
            (op for op in g.ops if len(op.fused_from) >= 2
             and op.op_class != HIERARCHICAL),
            key=lambda op: -penalty(prob, sol, op))
        progressed = False
        for op in cands:
            g2 = split_op(g, op.index)
            if g2 is None:
                continue
            # split feasibility: C_v1 + C_v2 >= (1 + alpha) * C_fused
            c_old = fused_capacities(g, chunk_bytes, hw, model)[op.index]
            c2 = fused_capacities(g2, chunk_bytes, hw, model)
            i0 = next(i for i, o in enumerate(g2.ops)
                      if o.name == op.name + ".seed")
            if c2[i0] + c2[i0 + 1] >= (1 + alpha) * max(c_old, 1):
                g = g2
                splits += 1
                progressed = True
                break
        if not progressed:
            return AdaptiveResult(g, prob, sol, splits, tuple(history))
