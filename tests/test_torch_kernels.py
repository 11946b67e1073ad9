"""The port's kernels against the JAX package's, on the sweeps of
``tests/test_kernels.py``: the plain PyTorch versions (what the CPU runs,
and what the CUDA kernels are held to on the card) against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode, at
that file's tolerances. Inputs are drawn with numpy and handed to both.
The CUDA kernels themselves are tested on the card in
``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops

MM_SHAPES = [(8, 128, 128), (64, 256, 128), (128, 128, 384), (256, 512, 256),
             (40, 128, 256)]
FA_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
             (2, 64, 64, 2, 1, 16), (1, 128, 128, 8, 8, 128)]
MASKS = [(True, 0), (True, 64), (False, 0)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_plain_matches_reference_and_pallas(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + k + n)
    aj, at = _both(_normal(rng, (m, k)), dtype)
    bj, bt = _both(_normal(rng, (k, n)), dtype)
    got = ops.matmul(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == (m, n)
    tol = 1e-3 if dtype == "float32" else 0.3
    np.testing.assert_allclose(_f32(got), _f32(jax_ref.matmul_ref(aj, bj)),
                               atol=tol, rtol=tol)
    pallas = jax_ops.matmul(aj, bj, block_m=64, block_n=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", FA_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_plain_matches_reference_and_pallas(b, sq, sk, hq, hkv, hd,
                                                      causal, window):
    rng = np.random.default_rng(sq + hq * 3 + hd)
    qj, qt = _both(_normal(rng, (b, sq, hq, hd)), "float32")
    kj, kt = _both(_normal(rng, (b, sk, hkv, hd)), "float32")
    vj, vt = _both(_normal(rng, (b, sk, hkv, hd)), "float32")
    got = ops.attention(qt, kt, vt, causal=causal, window=window)
    want = jax_ref.flash_attention_ref(qj, kj, vj, causal=causal,
                                       window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
    pallas = jax_ops.attention(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_kv=64)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_plain_dtypes(dtype):
    rng = np.random.default_rng(3)
    qj, qt = _both(_normal(rng, (1, 128, 4, 64)), dtype)
    kj, kt = _both(_normal(rng, (1, 128, 2, 64)), dtype)
    vj, vt = _both(_normal(rng, (1, 128, 2, 64)), dtype)
    got = ops.attention(qt, kt, vt)
    assert got.dtype == qt.dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got),
                               _f32(jax_ref.flash_attention_ref(qj, kj, vj)),
                               atol=tol)
    np.testing.assert_allclose(
        _f32(got), _f32(jax_ops.attention(qj, kj, vj, block_q=64,
                                          block_kv=64)), atol=tol)
