"""The port on the card: its CUDA kernels against their plain versions, the
copy-stream path, and the executors. Every test needs an NVIDIA card
(``cuda`` marker) and skips without one; the file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

MM_SHAPES = [(8, 128, 128), (64, 256, 128), (128, 128, 384), (256, 512, 256),
             (40, 128, 256), (37, 100, 61), (1024, 768, 3072)]
FA_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
             (2, 64, 64, 2, 1, 16), (1, 128, 128, 8, 8, 128),
             (1, 100, 100, 4, 2, 64), (1, 1024, 1024, 12, 12, 64)]
MASKS = [(True, 0), (True, 64), (False, 0)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_streamed_matmul_kernel(dev, m, k, n, dtype):
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    rng = np.random.default_rng(m + k + n)
    a = _normal(rng, (m, k)).to(dev, DTYPES[dtype])
    b = _normal(rng, (k, n), k ** -0.5).to(dev, DTYPES[dtype])
    got = streamed_matmul(a, b)
    torch.cuda.synchronize()
    assert got.dtype == a.dtype
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), ref.matmul_ref(a, b).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", FA_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_kernel(dev, b, sq, sk, hq, hkv, hd, causal, window,
                                dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(sq + hd)
    q, k, v = (_normal(rng, s).to(dev, DTYPES[dtype])
               for s in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def test_matmul_rows_do_not_depend_on_the_batch(dev):
    """A row of C is the same alone or inside a larger M: one K order,
    tiles chosen from N only."""
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    rng = np.random.default_rng(5)
    a = _normal(rng, (300, 768)).to(dev)
    b = _normal(rng, (768, 2048)).to(dev)
    full = streamed_matmul(a, b)
    part = streamed_matmul(a[17:18].clone(), b)
    torch.cuda.synchronize()
    assert torch.equal(full[17:18], part)


def test_dispatch_launches_and_counts(dev):
    rng = np.random.default_rng(0)
    ops.reset_launch_counts()
    a = _normal(rng, (64, 128)).to(dev)
    ops.matmul(a, _normal(rng, (128, 64)).to(dev))
    q = _normal(rng, (1, 64, 2, 64)).to(dev)
    ops.attention(q, q, q)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"streamed_matmul": 1,
                                   "flash_attention": 1}
    assert ops.launch_counts_by_shape() == {
        "streamed_matmul": {(64, 128, 64): 1},
        "flash_attention": {(1, 64, 64, 2, 2, 64, True, 0): 1}}


def test_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    a = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        streamed_matmul(a, a)
    with pytest.raises(TypeError):
        streamed_matmul(a.half(), a.half().t())
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


def test_copy_path_pinned_and_staged(dev):
    from repro_torch.device import HostToDevice, pinned_copy
    arrays = {"w": np.arange(1 << 16, dtype=np.float32).reshape(256, 256),
              "n": np.ones((2, 7), np.float32)}
    pinned = pinned_copy(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(pinned[name], a)
        assert torch.from_numpy(pinned[name]).is_pinned()
    host = pinned["w"]
    staged = np.arange(4096, dtype=np.int8)
    assert not torch.from_numpy(staged).is_pinned()
    h2d = HostToDevice(dev)
    with h2d.copies():
        got = h2d.put(host[64:128])
        got2 = h2d.put(staged)
    h2d.wait(h2d.mark())
    assert torch.equal(got.cpu(), torch.from_numpy(host[64:128]))
    assert torch.equal(got2.cpu(), torch.from_numpy(staged))


def test_executors_on_the_card(dev):
    from repro_torch.configs.gptneo import GPTNEO_S
    from repro_torch.core.plan import plan_always_next
    from repro_torch.core.streaming import (HostModel, PreloadExecutor,
                                            StreamingExecutor)
    cfg = replace(GPTNEO_S, num_layers=2, d_model=256, n_heads=4,
                  n_kv_heads=4, d_ff=1024, vocab=1024, name="gptneo-tiny")
    model = HostModel.build(cfg, seq=128, seed=0, device=dev)
    cpu = HostModel.from_host_weights(cfg, model.host_weights, seq=128,
                                      device="cpu")
    tokens = np.random.default_rng(0).integers(0, 1024, (1, 128),
                                               dtype=np.int32)
    pre = PreloadExecutor(model).run(tokens)
    for quantize in (False, True):
        st = StreamingExecutor(model, plan_always_next(model.graph, 64 << 10),
                               quantize_stream=quantize).run(tokens)
        if not quantize:
            torch.testing.assert_close(st.result, pre.result, atol=1e-5,
                                       rtol=0)
        want = StreamingExecutor(cpu, plan_always_next(cpu.graph, 64 << 10),
                                 quantize_stream=quantize).run(tokens)
        torch.testing.assert_close(st.result.cpu(), want.result, atol=1e-4,
                                   rtol=1e-4)
