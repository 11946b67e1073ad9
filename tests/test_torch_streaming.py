"""The port's HostModel and executors against the JAX package's, on the
small model of ``tests/test_streaming.py``: the same seed gives the same
weights bit for bit, and the same weights, tokens and plan give results
that agree within atol = rtol = 1e-4 (the two frameworks sum in different
orders; within one framework streaming equals preload to 1e-5)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.configs.gptneo import GPTNEO_S as JAX_GPTNEO_S
from repro.core import OPGProblem as JaxOPGProblem
from repro.core import OverlapPlan as JaxOverlapPlan
from repro.core import capacities as jax_capacities
from repro.core import plan_always_next as jax_plan_always_next
from repro.core import solve as jax_solve
from repro.core.capacity import HWSpec as JaxHWSpec
from repro.core.streaming import HostModel as JaxHostModel
from repro.core.streaming import PreloadExecutor as JaxPreload
from repro.core.streaming import StreamingExecutor as JaxStreaming
from repro_torch.configs.gptneo import GPTNEO_S
from repro_torch.core.plan import OverlapPlan
from repro_torch.core.streaming import (HostModel, PreloadExecutor,
                                        StreamingExecutor, chunk_rows,
                                        quantize_chunk)

SHAPE = dict(num_layers=4, d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
             vocab=1024, name="gptneo-tiny")
CFG = replace(GPTNEO_S, **SHAPE)
JAX_CFG = replace(JAX_GPTNEO_S, **SHAPE)
SEQ = 64
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jm = JaxHostModel.build(JAX_CFG, seq=SEQ, batch=1, seed=0)
    tm = HostModel.build(CFG, seq=SEQ, batch=1, seed=0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, CFG.vocab, (1, SEQ),
                                               dtype=np.int32)
    hw = JaxHWSpec(peak_flops=5e10, hbm_bw=2e10, stream_bw=1e10)
    chunk = 256 << 10
    prob = JaxOPGProblem(jm.graph, chunk, m_peak=8 << 20,
                         capacity=jax_capacities(jm.graph, chunk, hw))
    jplan = JaxOverlapPlan.from_solution(prob, jax_solve(prob))
    return jm, tm, tokens, jplan


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 3])
def test_same_seed_same_weights_bit_for_bit(seed):
    jm = JaxHostModel.build(JAX_CFG, seq=SEQ, seed=seed)
    tm = HostModel.build(CFG, seq=SEQ, seed=seed, device="cpu")
    assert list(tm.host_weights) == list(jm.host_weights)
    for name, w in jm.host_weights.items():
        assert tm.host_weights[name].dtype == w.dtype
        np.testing.assert_array_equal(tm.host_weights[name], w, err_msg=name)
    assert tm.device == torch.device("cpu")


def test_from_host_weights_round_trips(pair):
    jm, tm, tokens, _ = pair
    rt = HostModel.from_host_weights(CFG, jm.host_weights, seq=SEQ,
                                     device="cpu")
    assert rt.host_weights.keys() == jm.host_weights.keys()
    assert all(rt.host_weights[n] is w for n, w in jm.host_weights.items())
    assert [o.name for o in rt.graph.ops] == [o.name for o in tm.graph.ops]
    torch.testing.assert_close(PreloadExecutor(rt).run(tokens).result,
                               PreloadExecutor(tm).run(tokens).result,
                               atol=0, rtol=0)
    with pytest.raises(KeyError, match="missing"):
        HostModel.from_host_weights(
            CFG, {k: v for k, v in jm.host_weights.items()
                  if k != "embed.w"}, seq=SEQ, device="cpu")


def test_preload_matches_reference(pair):
    jm, tm, tokens, _ = pair
    got = PreloadExecutor(tm).run(tokens)
    want = JaxPreload(jm).run(tokens)
    assert tuple(got.result.shape) == tuple(want.result.shape)
    np.testing.assert_allclose(_np(got.result), _np(want.result), **TOL)
    assert got.peak_bytes == want.peak_bytes


@pytest.mark.parametrize("quantize", [False, True])
def test_streaming_matches_reference_under_the_same_plan(pair, quantize):
    jm, tm, tokens, jplan = pair
    plan = OverlapPlan.from_json(jplan.to_json())
    got = StreamingExecutor(tm, plan, quantize_stream=quantize).run(tokens)
    want = JaxStreaming(jm, jplan, quantize_stream=quantize).run(tokens)
    np.testing.assert_allclose(_np(got.result), _np(want.result), **TOL)
    assert len(got.residency) == len(want.residency) == len(tm.graph.ops)
    if not quantize:
        pre = PreloadExecutor(tm).run(tokens)
        np.testing.assert_allclose(_np(got.result), _np(pre.result),
                                   atol=1e-5)


def test_always_next_plan_streams_and_matches(pair):
    jm, tm, tokens, _ = pair
    jplan = jax_plan_always_next(jm.graph, 256 << 10)
    plan = OverlapPlan.from_json(jplan.to_json())
    got = StreamingExecutor(tm, plan).run(tokens)
    np.testing.assert_allclose(
        _np(got.result), _np(JaxStreaming(jm, jplan).run(tokens).result),
        **TOL)
    total = sum(a.nbytes for a in tm.host_weights.values())
    assert got.peak_bytes < total


def test_chunking_and_quantization_match_reference():
    from repro.core.streaming import chunk_rows as jax_chunk_rows
    from repro.core.streaming import quantize_chunk as jax_quantize
    arr = np.random.default_rng(1).standard_normal((37, 64)).astype(
        np.float32)
    for chunk in (1, 1000, 4096, 1 << 20):
        got, want = chunk_rows(arr, chunk), jax_chunk_rows(arr, chunk)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    (q, s), (jq, js) = quantize_chunk(arr), jax_quantize(arr)
    np.testing.assert_array_equal(q, jq)
    assert s == js
