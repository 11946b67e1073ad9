"""The port's attention (``repro_torch.models.attention``) against the JAX
package's ``repro.models.attention``, on the CPU.

Inputs and parameters are drawn with numpy from a seed and handed to both
packages. On a CPU tensor ``blocked_attention`` runs the kernel's plain
version (``flash_attention_ref``); the JAX function runs its block grid
(modes full, banded and paired at blocks smaller than the sequence, so
each mode's schedule engages). Tolerances:

* f32 inputs and parameters: rtol 1e-4, atol 1e-5 (the f32 order of the
  sums only);
* bf16: both compute in f32 and round to bf16, so a value may land one
  bf16 unit in the last place apart: attention outputs within rtol 2^-7
  (one ulp); projections and decode outputs, which go through one more
  bf16 product, within two ulps (rtol 2^-6) above an atol of 4e-3 for
  values near zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import attention as jax_attn
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
ULP_TOL = dict(rtol=2 ** -7, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -6, atol=4e-3)
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
# reduced configs (d 64, 4 query heads of 16): RoPE with GQA (2 KV heads),
# RoPE with QKV bias and MHA, M-RoPE with bias, a learned position table
# (no rotation), and a 16-position sliding window
CONFIGS = {"yi-6b": ("yi-6b", {}), "qwen1.5-4b": ("qwen1.5-4b", {}),
           "qwen2-vl-72b": ("qwen2-vl-72b", {}),
           "rope-none": ("yi-6b", {"rope": "none"}),
           "window": ("yi-6b", {"sliding_window": 16})}


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return (dataclasses.replace(jax_get_arch(arch).model.reduced(), **kw),
            dataclasses.replace(get_arch(arch).model.reduced(), **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(a, dtype):
    """A numpy f32 array as a JAX array and a port tensor of ``dtype``."""
    j = jnp.asarray(a).astype(JAX_DT[dtype])
    return j, params_from_numpy(np.asarray(j), CPU)


def _attn_params(jcfg, seed, dtype):
    """Random attention weights (std 1/sqrt(fan-in)) and biases, in the
    specs' dtypes (bf16 weights, f32 biases) or all f32."""
    rng = np.random.default_rng(seed)
    jp = {}
    for k, s in jax_attn.attn_specs(jcfg).items():
        a = (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(
            np.float32)
        jp[k] = jnp.asarray(a).astype(jnp.float32 if dtype == "f32"
                                      else s.dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _positions(jcfg, b, s, rng):
    shape = (3, b, s) if jcfg.rope == "mrope" else (b, s)
    pos = rng.integers(0, 64, shape).astype(np.int32)
    return jnp.asarray(pos), torch.from_numpy(pos)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _spec_key(s):
    dtype = str(s.dtype).removeprefix("torch.") \
        if isinstance(s.dtype, torch.dtype) else jnp.dtype(s.dtype).name
    return (tuple(s.shape), dtype, tuple(s.logical), s.init, s.scale)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_attn_and_cache_specs_match_jax(name):
    """Full-width specs, stacked over the layers and per layer."""
    jcfg, tcfg = (dataclasses.replace(get(CONFIGS[name][0]).model,
                                      **CONFIGS[name][1])
                  for get in (jax_get_arch, get_arch))
    for prefix in ((), (jcfg.num_layers,)):
        got = {k: _spec_key(v) for k, v in _flat(
            attention.attn_specs(tcfg, prefix)).items()}
        assert got == {k: _spec_key(v) for k, v in _flat(
            jax_attn.attn_specs(jcfg, prefix)).items()}
        got = {k: _spec_key(v) for k, v in _flat(
            attention.cache_specs(tcfg, 3, 4096, prefix)).items()}
        assert got == {k: _spec_key(v) for k, v in _flat(
            jax_attn.cache_specs(jcfg, 3, 4096, prefix)).items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["yi-6b", "qwen1.5-4b", "qwen2-vl-72b",
                                  "rope-none"])
def test_qkv_project_matches_jax(name, dtype):
    """Projection, the bias cast to the projection's dtype before the add
    (QKV bias configs), and RoPE or M-RoPE at random positions."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _attn_params(jcfg, 1, dtype)
    rng = np.random.default_rng(2)
    jx, tx = _both(rng.standard_normal((2, 12, jcfg.d_model)), dtype)
    jpos, tpos = _positions(jcfg, 2, 12, rng)
    want = jax_attn.qkv_project(jcfg, jp, jx, jpos, jax_mesh())
    got = attention.qkv_project(tcfg, tp, tx, tpos,
                                make_host_mesh(device=CPU))
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == jnp.dtype(w.dtype).name
        np.testing.assert_allclose(_np(g), _np(w), **(
            F32_TOL if dtype == "f32" else BF16_TOL))


# (mode, causal, window, query heads, KV heads, hd, dtype): every mode,
# causal and windowed masks (and one without a mask), GQA groups 1, 2 and
# 8, hd 16 and 128; S = 64 in blocks of 16, so "paired" folds four query
# blocks and "banded" walks a band of the window's width
BLOCKED = [("full", True, 0, 8, 8, 16, "f32"),
           ("full", True, 24, 8, 4, 128, "f32"),
           ("full", False, 0, 8, 1, 16, "f32"),
           ("full", True, 0, 8, 1, 128, "bf16"),
           ("banded", True, 24, 8, 4, 16, "f32"),
           ("banded", True, 16, 8, 1, 128, "f32"),
           ("banded", True, 24, 8, 8, 16, "bf16"),
           ("paired", True, 0, 8, 8, 128, "f32"),
           ("paired", True, 0, 8, 4, 16, "f32"),
           ("paired", True, 0, 8, 1, 16, "f32"),
           ("paired", True, 0, 8, 1, 128, "bf16"),
           ("paired", True, 0, 8, 4, 16, "bf16")]


@pytest.mark.parametrize("mode,causal,window,hq,hkv,hd,dtype", BLOCKED)
def test_blocked_attention_matches_jax(mode, causal, window, hq, hkv, hd,
                                       dtype):
    rng = np.random.default_rng(hq * hkv + hd + window)
    ins = [_both(rng.standard_normal((2, 64, h, hd)), dtype)
           for h in (hq, hkv, hkv)]
    jq, jk, jv = (j for j, _ in ins)
    tq, tk, tv = (t for _, t in ins)
    want = jax_attn.blocked_attention(jq, jk, jv, causal=causal,
                                      window=window, block_q=16,
                                      block_kv=16, mode=mode)
    got = attention.blocked_attention(tq, tk, tv, causal=causal,
                                      window=window)
    assert got.dtype == tq.dtype and tuple(got.shape) == (2, 64, hq, hd)
    tol = F32_TOL if dtype == "f32" else ULP_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # on the CPU it is the kernel's plain version, and the unblocked
    # reference of both packages agrees
    assert torch.equal(got, ref.flash_attention_ref(
        tq, tk, tv, causal=causal, window=window))
    np.testing.assert_allclose(
        _np(attention.full_attention(tq, tk, tv, causal=causal,
                                     window=window)),
        _np(jax_attn.full_attention(jq, jk, jv, causal=causal,
                                    window=window)), **tol)


def test_blocked_attention_counts_no_launch_on_the_cpu():
    """On a CPU tensor, at offset 0 and at an offset given as an int or a
    0-d tensor (which give the same rows), nothing launches."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 16)).astype(
        np.float32))
    ops.reset_launch_counts()
    attention.blocked_attention(q, q[:, :, :2], q[:, :, :2])
    at_int = attention.blocked_attention(q[:, 16:], q, q, q_offset=16)
    at_tensor = attention.blocked_attention(q[:, 16:], q, q,
                                            q_offset=torch.tensor(16))
    assert ops.launch_counts()["flash_attention"] == 0
    assert torch.equal(at_int, at_tensor)


# (config, cache length, per-row positions of 4 steps): RoPE from an empty
# cache; M-RoPE ([3,B] positions); a 16-slot window whose ring wraps
# (positions 14..45); positions past a full 12-slot cache (the clamp to the
# last slot)
DECODE = [("yi-6b", 24, [(0, 5), (1, 6), (2, 7), (3, 8)]),
          ("qwen2-vl-72b", 24, [(3, 9), (4, 10), (5, 11), (6, 12)]),
          ("window", 32, [(14, 30), (15, 31), (16, 40), (29, 45)]),
          ("yi-6b", 12, [(10, 11), (11, 12), (12, 17), (13, 30)])]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,cache_len,steps", DECODE,
                         ids=["rope", "mrope", "window-ring", "clamp"])
def test_decode_attention_matches_jax(name, cache_len, steps, dtype):
    """Four steps on a random cache: the written slot, the valid mask and
    the output, each step from the cache the step before returned. The
    f32 case holds the cache in f32 too (the function computes in the
    cache's dtype), so it checks the arithmetic without bf16 rounding."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _attn_params(jcfg, 3, dtype)
    rng = np.random.default_rng(4)
    specs = jax_attn.cache_specs(jcfg, 2, cache_len)
    assert specs["k"].shape[1] == min(cache_len, jcfg.sliding_window or
                                      cache_len)
    jcache, tcache = {}, {}
    for k, s in specs.items():
        jcache[k], tcache[k] = _both(rng.standard_normal(s.shape), dtype)
    tcache_in = {k: v.clone() for k, v in tcache.items()}
    env, jenv = make_host_mesh(device=CPU), jax_mesh()
    for step in steps:
        p0 = np.array(step, np.int32)
        pos = np.stack([p0, p0 + 1, p0 + 2]) if jcfg.rope == "mrope" else p0
        jx, tx = _both(rng.standard_normal((2, 1, jcfg.d_model)), dtype)
        want, jcache = jax_attn.decode_attention(jcfg, jp, jx, jcache,
                                                 jnp.asarray(pos), jenv)
        got, new = attention.decode_attention(tcfg, tp, tx, tcache,
                                              torch.from_numpy(pos), env)
        assert all(torch.equal(tcache[k], tcache_in[k]) for k in tcache)
        tcache, tcache_in = new, {k: v.clone() for k, v in new.items()}
        assert got.dtype == tx.dtype and tuple(got.shape) == (
            2, 1, jcfg.d_model)
        tol = F32_TOL if dtype == "f32" else BF16_TOL
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        for k in ("k", "v"):
            assert tcache[k].dtype == tx.dtype
            np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]), **(
                F32_TOL if dtype == "f32" else ULP_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["yi-6b", "qwen1.5-4b", "window"])
def test_attention_block_matches_jax(name, dtype):
    """The prefill block (projection, RoPE, attention, out-projection)
    against the JAX package's under its paired schedule, and with ``kv_override`` (cross
    attention: the given K/V, no causal mask)."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _attn_params(jcfg, 5, dtype)
    rng = np.random.default_rng(6)
    jx, tx = _both(rng.standard_normal((2, 32, jcfg.d_model)), dtype)
    jpos, tpos = _positions(jcfg, 2, 32, rng)
    env, jenv = make_host_mesh(device=CPU), jax_mesh()
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    want = jax_attn.attention_block(jcfg, jp, jx, jpos, jenv, block_q=8,
                                    block_kv=8, mode="paired")
    got = attention.attention_block(tcfg, tp, tx, tpos, env)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    kv = [_both(rng.standard_normal((2, 20, jcfg.n_kv_heads,
                                     jcfg.resolved_head_dim)), dtype)
          for _ in range(2)]
    want = jax_attn.attention_block(jcfg, jp, jx, jpos, jenv,
                                    kv_override=tuple(j for j, _ in kv))
    got = attention.attention_block(tcfg, tp, tx, tpos, env,
                                    kv_override=tuple(t for _, t in kv))
    np.testing.assert_allclose(_np(got), _np(want), **tol)
