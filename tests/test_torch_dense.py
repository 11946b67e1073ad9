"""The port's dense model path (``models.model.make_step_bundle`` ->
``transformer.prefill`` / ``decode_step``, and the ``attn_mode="cp"``
bundle) against the JAX package's, on the CPU.

Reduced configs of every kind of dense stack the repo has: Yi-6B (GQA),
Qwen1.5-4B (QKV bias, MHA), Qwen2-VL-72B (M-RoPE over precomputed
``embeds`` and ``positions``), a ``rope="none"`` stack (the learned
``pos_embed`` table), a 16-position sliding window, and a narrow stack at
the attention widths of the full models (hd 128, 8 query heads on 1 KV
head). JAX parameter trees carry across through ``params_from_numpy``.

Tolerances: with every parameter (and the cache) in f32, rtol 1e-4 and
atol 1e-5 (the f32 order of the sums only). With the real bf16 parameters
the two frameworks round some bf16 products one unit in the last place
apart and the residual stream carries it on; over 12 seeds of the reduced
Yi-6B and Qwen1.5-4B prefills that came to 0.03-0.06 max abs and 1.0-1.7%
relative L2 on logits of up to 4, so bf16 logits are held to 0.1 max abs
and 3% relative L2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchConfig as JaxArch
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed import sharding as jax_shd
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import model as jax_model
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import transformer
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 0.1, 0.03
DENSE = ["yi-6b", "qwen1.5-4b", "qwen2-72b", "qwen2-vl-72b", "llama3-405b"]
NARROW = dict(d_model=256, n_heads=8, n_kv_heads=1, head_dim=128, d_ff=512)
CONFIGS = {"yi-6b": ("yi-6b", {}), "qwen1.5-4b": ("qwen1.5-4b", {}),
           "qwen2-vl-72b": ("qwen2-vl-72b", {}),
           "rope-none": ("yi-6b", {"rope": "none"}),
           "window": ("yi-6b", {"sliding_window": 16}),
           "narrow-hd128": ("yi-6b", NARROW)}
SEQ, BATCH, BLOCK = 32, 2, 8


def _cfgs(name):
    arch, kw = CONFIGS[name]
    return (dataclasses.replace(jax_get_arch(arch).model.reduced(), **kw),
            dataclasses.replace(get_arch(arch).model.reduced(), **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, f32: bool):
    got, want = _np(got), _np(want)
    if f32:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


def _jax_params(cfg, seed, f32: bool):
    params = jax_shd.init_params(jax_model.param_specs(cfg),
                                 jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _bundles(jcfg, tcfg, kind, seq, batch, **kw):
    """The JAX bundle at block size ``BLOCK`` (its block grid's schedule,
    which the port does not have) and the port's."""
    jb = jax_model.make_step_bundle(JaxArch(model=jcfg),
                                    JaxShape("x", seq, batch, kind),
                                    jax_mesh(), block_q=BLOCK,
                                    block_kv=BLOCK, **kw)
    tb = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                 ShapeConfig("x", seq, batch, kind),
                                 make_host_mesh(device=CPU), **kw)
    return jb, tb


def _prefill_batch(jcfg, seed, f32: bool):
    """The JAX and port prefill batches: tokens, or for the vision stub
    embeds [B,S,D] and M-RoPE positions [3,B,S] (drawn in [0, 64))."""
    rng = np.random.default_rng(seed)
    if jcfg.frontend == "vision_stub":
        emb = jnp.asarray(rng.standard_normal(
            (BATCH, SEQ, jcfg.d_model)).astype(np.float32)).astype(
                jnp.float32 if f32 else jnp.bfloat16)
        batch = {"embeds": emb, "positions": jnp.asarray(rng.integers(
            0, 64, (3, BATCH, SEQ)).astype(np.int32))}
    else:
        batch = {"tokens": jnp.asarray(rng.integers(
            0, jcfg.vocab, (BATCH, SEQ)).astype(np.int32))}
    return batch, _to_port(batch)


def _spec_key(s):
    dtype = str(s.dtype).removeprefix("torch.") \
        if isinstance(s.dtype, torch.dtype) else jnp.dtype(s.dtype).name
    return (tuple(s.shape), dtype, tuple(s.logical), s.init, s.scale)


def _same_specs(port_tree, jax_tree):
    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}"))
            return out
        return {prefix: _spec_key(tree)}
    assert flat(port_tree) == flat(jax_tree)


@pytest.mark.parametrize("name", DENSE + ["rope-none", "window"])
def test_dense_spec_trees_match_jax(name):
    """Parameters (``pos_embed`` of 8192 rows without RoPE), the stacked
    KV cache (cut to the window under one), prefill and decode inputs."""
    if name in CONFIGS:
        jcfg, tcfg = (dataclasses.replace(get(CONFIGS[name][0]).model,
                                          **CONFIGS[name][1])
                      for get in (jax_get_arch, get_arch))
    else:
        jcfg, tcfg = jax_get_arch(name).model, get_arch(name).model
    _same_specs(tmodel.param_specs(tcfg), jax_model.param_specs(jcfg))
    _same_specs(tmodel.cache_specs(tcfg, 4, 4096),
                jax_model.cache_specs(jcfg, 4, 4096))
    for kind in ("prefill", "decode"):
        _same_specs(tmodel.batch_specs(tcfg, ShapeConfig("x", 64, 3, kind),
                                       train=False),
                    jax_model.batch_specs(jcfg, JaxShape("x", 64, 3, kind),
                                          train=False))
        _same_specs(tmodel.decode_input_specs(tcfg, ShapeConfig(
            "x", 64, 3, kind)), jax_model.decode_input_specs(
                jcfg, JaxShape("x", 64, 3, kind)))
    assert shd.param_count(tmodel.param_specs(tcfg)) == \
        jax_shd.param_count(jax_model.param_specs(jcfg))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_matches_jax(name, f32):
    """The default ``"paired"`` schedule, at blocks of 8 over 32 positions
    so that the JAX package folds its causal block grid."""
    jcfg, tcfg = _cfgs(name)
    jb, tb = _bundles(jcfg, tcfg, "prefill", SEQ, BATCH)
    params = _jax_params(jcfg, seed=0, f32=f32)
    jbatch, tbatch = _prefill_batch(jcfg, 1, f32)
    want = jb.fn(params, jbatch)
    tparams = _to_port(params)
    ops.reset_launch_counts()
    got = tb.fn(tparams, tbatch)
    assert ops.launch_counts()["flash_attention"] == 0      # the CPU path
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
    _close(got, want, f32)
    # prefill is the full forward's last position
    full, aux = transformer.forward(
        tcfg, ArchConfig(model=tcfg).run_config("x"),
        make_host_mesh(device=CPU), tparams, tbatch.get("tokens"),
        embeds=tbatch.get("embeds"), positions=tbatch.get("positions"))
    assert tuple(full.shape) == (BATCH, SEQ, jcfg.vocab)
    assert {k: float(v) for k, v in aux.items()} == {"lb_loss": 0.0,
                                                     "z_loss": 0.0}
    np.testing.assert_allclose(_np(full[:, -1:]), _np(got), **F32_TOL)


def _cache(jcfg, batch, cache_len, rng, f32: bool):
    """A random cache for both packages (f32 under f32 parameters, so the
    f32 case has no bf16 rounding; else the specs' bf16)."""
    specs = jax_model.cache_specs(jcfg, batch, cache_len)
    jc = {k: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32))
          .astype(jnp.float32 if f32 else s.dtype) for k, s in specs.items()}
    return jc, _to_port(jc)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_step_matches_jax(name, f32):
    """Three steps at per-row positions from a random cache of 20 slots
    (16 under the window, whose ring wraps), ``pos`` [3,B] under M-RoPE;
    logits and the stacked caches the steps return."""
    jcfg, tcfg = _cfgs(name)
    jb, tb = _bundles(jcfg, tcfg, "decode", 20, BATCH)
    jstep = jax.jit(jb.fn)              # one trace for the three steps
    params = _jax_params(jcfg, seed=1, f32=f32)
    rng = np.random.default_rng(2)
    jcache, tcache = _cache(jcfg, BATCH, 20, rng, f32)
    tparams = _to_port(params)
    for step in range(3):
        toks = rng.integers(0, jcfg.vocab, (BATCH, 1), dtype=np.int32)
        p0 = np.array([5 + 7 * step, 11 + 6 * step], np.int32)
        pos = np.stack([p0, p0 + 2, p0 + 3]) if jcfg.rope == "mrope" else p0
        want, jcache = jstep(params, jcache, jnp.asarray(toks),
                             jnp.asarray(pos))
        got, tcache = tb.fn(tparams, tcache, torch.from_numpy(toks),
                            torch.from_numpy(pos))
        assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
        _close(got, want, f32)
    for k in ("k", "v"):
        assert tuple(tcache[k].shape) == tuple(jcache[k].shape)
        _close(tcache[k], jcache[k], f32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["yi-6b", "window", "narrow-hd128"])
def test_decode_from_zero_cache_matches_prefill(name, f32):
    """Step-by-step decode from the zero cache ends at the prefill's last
    logits (the window's ring of 16 slots wraps twice over 40 tokens), and
    picks the same next token. In f32 (parameters and cache) the two
    differ in the f32 order of the sums only; in bf16 decode rounds the
    softmax weights to bf16 before PV where prefill keeps them f32."""
    _, tcfg = _cfgs(name)
    seq = 40
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, BATCH,
                                                    "prefill"), env)
    dec = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, BATCH,
                                                    "decode"), env)
    gen = torch.Generator().manual_seed(3)
    params, cache, _, _ = tmodel.init_inputs(dec, gen, CPU)
    if f32:
        params, cache = (shd.tree_map(lambda t: t.float(), tree)
                         for tree in (params, cache))
    assert tuple(cache["k"].shape) == (
        tcfg.num_layers, BATCH, min(seq, tcfg.sliding_window or seq),
        tcfg.n_kv_heads, tcfg.resolved_head_dim)
    toks = torch.randint(0, tcfg.vocab, (BATCH, seq), generator=gen,
                         dtype=torch.int32)
    want = pre.fn(params, {"tokens": toks})
    for t in range(seq):
        got, cache = dec.fn(params, cache, toks[:, t:t + 1],
                            torch.full((BATCH,), t, dtype=torch.int32))
    _close(got, want, f32)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["yi-6b", "qwen1.5-4b", "rope-none",
                                  "window"])
def test_cp_bundle_matches_jax(name, f32):
    """``attn_mode="cp"`` against the JAX package's ``cp_prefill`` on its
    1 x 1 host mesh (its own layer loop, gathers and ``shard_map``), and
    bit for bit the port's ordinary prefill (one model shard)."""
    jcfg, tcfg = _cfgs(name)
    jb, tb = _bundles(jcfg, tcfg, "prefill", SEQ, BATCH, attn_mode="cp")
    params = _jax_params(jcfg, seed=4, f32=f32)
    jbatch, tbatch = _prefill_batch(jcfg, 5, f32)
    want = jb.fn(params, jbatch)
    tparams = _to_port(params)
    got = tb.fn(tparams, tbatch)
    assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
    _close(got, want, f32)
    _, plain = _bundles(jcfg, tcfg, "prefill", SEQ, BATCH)
    assert torch.equal(got, plain.fn(tparams, tbatch))


def test_cp_bundle_keeps_mrope_on_the_ordinary_prefill():
    """M-RoPE configs take the ordinary prefill under ``"cp"`` (the JAX
    package's rule): the same logits as the default schedule."""
    jcfg, tcfg = _cfgs("qwen2-vl-72b")
    _, cp = _bundles(jcfg, tcfg, "prefill", SEQ, BATCH, attn_mode="cp")
    _, plain = _bundles(jcfg, tcfg, "prefill", SEQ, BATCH)
    tparams = _to_port(_jax_params(jcfg, seed=6, f32=False))
    _, tbatch = _prefill_batch(jcfg, 7, False)
    assert torch.equal(cp.fn(tparams, tbatch), plain.fn(tparams, tbatch))


@pytest.mark.parametrize("attn_mode", ["ring", "blocked", ""])
def test_make_step_bundle_refuses_an_unknown_attn_mode(attn_mode):
    _, tcfg = _cfgs("yi-6b")
    with pytest.raises(ValueError, match="attn_mode"):
        tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                ShapeConfig("p", SEQ, BATCH, "prefill"),
                                make_host_mesh(device=CPU),
                                attn_mode=attn_mode)


def test_init_inputs_draws_positions_in_zero_one():
    """The vision stub's prefill batch: bf16 embeds and int32 positions
    [3,B,S] in [0, 2), as the JAX package draws its integers."""
    _, tcfg = _cfgs("qwen2-vl-72b")
    bundle = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                     ShapeConfig("p", 16, 2, "prefill"),
                                     make_host_mesh(device=CPU))
    _, batch = tmodel.init_inputs(bundle, torch.Generator().manual_seed(0),
                                  CPU)
    assert sorted(batch) == ["embeds", "positions"]
    assert batch["embeds"].dtype == torch.bfloat16
    assert batch["positions"].dtype == torch.int32
    assert tuple(batch["positions"].shape) == (3, 2, 16)
    assert set(batch["positions"].unique().tolist()) <= {0, 1}
