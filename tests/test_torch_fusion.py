"""The port's adaptive fusion (``core/fusion.py``) and exact OPG solver
(``core/cpsat.py``) against the JAX package's, on the same graphs and
problems: fused graphs, capacities, ``adaptive_fusion_solve`` results and
``solve_exact`` solutions and objectives are equal bit for bit."""
import random
from dataclasses import asdict, replace

import pytest

from repro.configs.gptneo import GPTNEO_S as JAX_GPTNEO_S
from repro.core import capacity as jax_capacity
from repro.core import cpsat as jax_cpsat
from repro.core import fusion as jax_fusion
from repro.core import graph as jax_graph
from repro.core import opg as jax_opg
from repro_torch import core as torch_core
from repro_torch.configs.gptneo import GPTNEO_S
from repro_torch.core import capacity, cpsat, fusion, graph, opg

SIDES = {
    "jax": (jax_graph, jax_capacity, jax_fusion, jax_opg, jax_cpsat,
            JAX_GPTNEO_S),
    "torch": (graph, capacity, fusion, opg, cpsat, GPTNEO_S),
}
HW = dict(peak_flops=5e10, hbm_bw=2e10, stream_bw=1e10)


def _graph_of(case, side):
    """The graphs of tests/test_fusion_capacity.py, built by one side."""
    g_mod, _, _, _, _, cfg = SIDES[side]
    if case == "gptneo-s":
        return g_mod.build_lm_graph(cfg, seq=32, batch=1)
    if case == "gptneo-s-f32":
        return g_mod.build_lm_graph(cfg, seq=128, batch=1, dtype_bytes=4)
    if case == "gptneo-s-2layer":
        return g_mod.build_lm_graph(replace(cfg, num_layers=2), seq=64,
                                    batch=2, dtype_bytes=4)
    g = g_mod.ModelGraph("t")
    if case == "matmul+add":
        g.add_op("a", "matmul", flops=1e12, act_bytes=1e6, weight_bytes=1024)
        g.add_op("b", "add", flops=1e6, act_bytes=1e6)
    elif case == "layernorm+add":
        g.add_op("n", "layernorm", flops=1e6, act_bytes=1e6, weight_bytes=512)
        g.add_op("r", "add", flops=1e5, act_bytes=1e6)
    return g


def _graph(g):
    return (g.name, [asdict(o) for o in g.ops],
            {n: asdict(w) for n, w in g.weights.items()})


def _solution(sol):
    return (sorted(sol.preload), sorted(sol.x.items()), sorted(sol.z.items()),
            sol.status, sol.fallbacks_used)


GRAPHS = ["gptneo-s", "gptneo-s-f32", "gptneo-s-2layer", "matmul+add",
          "layernorm+add"]


def test_core_exports_fusion():
    assert torch_core.adaptive_fusion_solve is fusion.adaptive_fusion_solve
    assert torch_core.fuse_graph is fusion.fuse_graph


@pytest.mark.parametrize("case", GRAPHS)
@pytest.mark.parametrize("kw", [{}, {"max_group": 2},
                                {"fuse_hierarchical": False}])
def test_fused_graphs_splits_and_capacities_equal(case, kw):
    out = {}
    for side, (_, cap_mod, fus, *_rest) in SIDES.items():
        fg = fus.fuse_graph(_graph_of(case, side), **kw)
        splits = [fus.split_op(fg, i) for i in range(len(fg.ops))]
        caps = [fus.fused_capacities(fg, c, cap_mod.HWSpec(**HW))
                for c in (1024, 1 << 20)]
        out[side] = (_graph(fg), [s and _graph(s) for s in splits], caps)
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("case,m_peak_mb,hw", [
    ("gptneo-s-f32", 48, HW), ("gptneo-s-f32", 16, HW),
    ("gptneo-s-f32", 8, HW), ("gptneo-s-2layer", 8, {})])
def test_adaptive_fusion_solve_equal(case, m_peak_mb, hw):
    out = {}
    for side, (_, cap_mod, fus, *_rest) in SIDES.items():
        res = fus.adaptive_fusion_solve(
            _graph_of(case, side), chunk_bytes=1 << 20,
            m_peak=m_peak_mb << 20, hw=cap_mod.HWSpec(**hw))
        out[side] = (_graph(res.graph), _solution(res.solution),
                     res.problem.capacity, res.splits, res.history,
                     res.solution.objective(res.problem))
    assert out["torch"] == out["jax"]


def _problem(seed, side):
    """A seeded OPG problem drawn as tests/test_solver.py draws them
    (chunk 1 KiB, 8-12 ops, weights of 0-4 chunks), built by one
    side."""
    g_mod, _, _, opg_mod, *_rest = SIDES[side]
    rng = random.Random(seed)
    n_ops = rng.randint(8, 12)
    g = g_mod.ModelGraph("prop")
    for i in range(n_ops):
        wb = rng.choice([0, 0, 1, 2, 4]) * 1024
        g.add_op(f"op{i}", rng.choice(["matmul", "add", "layernorm"]),
                 flops=1e6, act_bytes=1e4,
                 weight_bytes=wb or (1024 if i == 0 else None))
    caps = [rng.randint(0, 4) for _ in range(n_ops)]
    return opg_mod.OPGProblem(g, 1024, m_peak=rng.choice([2048, 4096, 8192]),
                              capacity=caps, lam=rng.choice([0.5, 0.9]))


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("node_limit", [50, 50_000])
def test_solve_exact_equal(seed, node_limit):
    out = {}
    for side, (*_x, cp_mod, _cfg) in SIDES.items():
        prob = _problem(seed, side)
        sol = cp_mod.solve_exact(prob, node_limit=node_limit)
        out[side] = None if sol is None else (_solution(sol),
                                              sol.objective(prob))
    assert out["torch"] == out["jax"]
    if node_limit == 50_000:
        assert out["torch"] is not None
