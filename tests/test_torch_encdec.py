"""The port's enc-dec model path (Whisper: ``models.model.make_step_bundle``
-> ``encdec.prefill`` / ``decode_step``) against the JAX package's bundles,
on the CPU.

The config is the reduced Whisper-small: 2 encoder layers over 32 stub
frames, 4 decoder layers, d_model 64, 4 heads of 16 (MHA), LayerNorm, GELU,
a plain FFN, QKV bias and tied embeddings. A decoder prompt of 24 tokens
makes cross-attention's queries (24) and keys (32) differ in length. JAX
parameter trees carry across through ``params_from_numpy``; the JAX
bundles are built once per module.

Tolerances: with every parameter (and the cache) in f32, rtol 1e-4 and
atol 1e-5 (the f32 order of the sums only). With the real bf16 parameters
the two frameworks round some bf16 products one ulp apart and the residual
streams carry it on: over seeds 0-7 of these cases the logits (up to about
1.9) came within 0.0195 max abs and 1.02% relative L2 in prefill and
0.0205 and 1.07% over the decode steps, so bf16 logits are held to 0.1 max
abs and 3% relative L2, the bound of the dense model tests.
"""
from unittest import mock

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
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models import model as jax_model
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, encdec
from repro_torch.models import model as tmodel
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-small"
CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 0.1, 0.03
SEQ, BATCH, DECODE_STEPS = 24, 2, 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _close(got, want, f32: bool):
    got, want = _np(got), _np(want)
    if f32:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


def _jax_params(jcfg, seed, f32: bool):
    params = jax_shd.init_params(jax_model.param_specs(jcfg),
                                 jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _frames(jcfg, seed, f32: bool):
    """Stub frame embeddings [BATCH, T_enc, D] for JAX and the port."""
    rng = np.random.default_rng(seed)
    frames = jnp.asarray(rng.standard_normal(
        (BATCH, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)).astype(
            jnp.float32 if f32 else jnp.bfloat16)
    return frames, _to_port(frames)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_get_arch(ARCH).model.reduced(),
            get_arch(ARCH).model.reduced())


@pytest.fixture(scope="module")
def bundles(cfgs):
    """The JAX (jitted) and port bundles of the reduced config: prefill at
    BATCH x SEQ, decode over SEQ slots."""
    jcfg, tcfg = cfgs
    out = {}
    for kind in ("prefill", "decode"):
        jb = jax_model.make_step_bundle(JaxArch(model=jcfg),
                                        JaxShape("x", SEQ, BATCH, kind),
                                        jax_mesh())
        tb = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                     ShapeConfig("x", SEQ, BATCH, kind),
                                     make_host_mesh(device=CPU))
        out[kind] = (jax.jit(jb.fn), tb)
    return out


def _jax_cross_cache(jcfg, params, frames, dtype):
    """``cross_k``/``cross_v`` [L,B,T_enc,nkv,hd] of the JAX package: each
    decoder layer's cross-attention K/V projection of the encoder output
    (the reference has no function that fills them)."""
    env = jax_mesh()
    enc = jax_encdec.encode(jcfg, JaxArch(model=jcfg).run_config("x"), env,
                            params, frames)
    pos = jnp.broadcast_to(jnp.arange(enc.shape[1])[None], enc.shape[:2])
    ks, vs = [], []
    for i in range(jcfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["decoder"]["cross_attn"])
        _, k, v = jax_attn.qkv_project(jcfg, p, enc, pos, env)
        ks.append(k)
        vs.append(v)
    return enc, jnp.stack(ks).astype(dtype), jnp.stack(vs).astype(dtype)


def _port_cross_cache(tcfg, params, frames, dtype):
    """The same through the port's ``encode`` and ``qkv_project``."""
    env = make_host_mesh(device=CPU)
    enc = encdec.encode(tcfg, ArchConfig(model=tcfg).run_config("x"), env,
                        params, frames)
    pos = torch.arange(enc.shape[1])[None].expand(enc.shape[:2])
    ks, vs = [], []
    for i in range(tcfg.num_layers):
        p = shd.tree_map(lambda t: t[i], params["decoder"]["cross_attn"])
        _, k, v = attention.qkv_project(tcfg, p, enc, pos, env)
        ks.append(k)
        vs.append(v)
    return enc, torch.stack(ks).to(dtype), torch.stack(vs).to(dtype)


def _spec_key(s):
    dtype = str(s.dtype).removeprefix("torch.") \
        if isinstance(s.dtype, torch.dtype) else jnp.dtype(s.dtype).name
    return (tuple(s.shape), dtype, tuple(s.logical), s.init, s.scale)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: _spec_key(tree)}


@pytest.mark.parametrize("batch,length", [(3, 448), (1, 32), (8, 1500)])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_encdec_spec_trees_match_jax(reduced, batch, length):
    """Parameters (``encoder``/``decoder`` stacks, ``dec_pos``), the decode
    cache (stacked self K/V, ``cross_k``/``cross_v``), decode inputs and the
    prefill batch (``frames`` and ``tokens``), leaf for leaf."""
    jcfg, tcfg = jax_get_arch(ARCH).model, get_arch(ARCH).model
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert _flat(tmodel.param_specs(tcfg)) == \
        _flat(jax_model.param_specs(jcfg))
    assert _flat(tmodel.cache_specs(tcfg, batch, length)) == \
        _flat(jax_model.cache_specs(jcfg, batch, length))
    for kind in ("prefill", "decode"):
        shape = ShapeConfig("x", length, batch, kind)
        jshape = JaxShape("x", length, batch, kind)
        assert _flat(tmodel.batch_specs(tcfg, shape, train=False)) == \
            _flat(jax_model.batch_specs(jcfg, jshape, train=False))
    assert _flat(tmodel.decode_input_specs(tcfg, shape)) == \
        _flat(jax_model.decode_input_specs(jcfg, jshape))
    assert shd.param_count(tmodel.param_specs(tcfg)) == \
        jax_shd.param_count(jax_model.param_specs(jcfg))
    assert encdec.MAX_DEC_POS == jax_encdec.MAX_DEC_POS


@pytest.mark.parametrize("batch,prompt", [(8, 448), (1, 448), (4, 224)])
def test_full_whisper_bundles_have_the_full_shapes(batch, prompt):
    """``make_step_bundle`` on the full Whisper-small (the card's phase
    runs 8 x 448, the released model's cap): 12 + 12 layers of 768 (12
    heads of 64), 1500 stub frames, a cross cache of
    [12, batch, 1500, 12, 64]; specs only, nothing is allocated."""
    arch = get_arch(ARCH)
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(
        arch, ShapeConfig("p", prompt, batch, "prefill"), env)
    dec = tmodel.make_step_bundle(
        arch, ShapeConfig("d", prompt, batch, "decode"), env)
    specs, inputs = pre.arg_specs
    assert specs["encoder"]["attn"]["wq"].shape == (12, 768, 768)
    assert specs["decoder"]["cross_attn"]["wk"].shape == (12, 768, 768)
    assert specs["decoder"]["mlp"]["wi"].shape == (12, 768, 3072)
    assert "wg" not in specs["decoder"]["mlp"]
    assert inputs["frames"].shape == (batch, 1500, 768)
    assert inputs["tokens"].shape == (batch, prompt)
    cache = dec.arg_specs[1]
    assert cache["self"]["k"].shape == (12, batch, prompt, 12, 64)
    assert cache["cross_k"].shape == cache["cross_v"].shape == \
        (12, batch, 1500, 12, 64)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_prefill_matches_jax(cfgs, bundles, f32):
    jcfg, _ = cfgs
    jfn, tb = bundles["prefill"]
    params = _jax_params(jcfg, seed=0, f32=f32)
    jframes, tframes = _frames(jcfg, 1, f32)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32)
    want = jfn(params, {"frames": jframes, "tokens": jnp.asarray(toks)})
    got = tb.fn(_to_port(params), {"frames": tframes,
                                   "tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
    _close(got, want, f32)


def test_encoder_and_cross_cache_match_jax(cfgs):
    """The encoder's output and each decoder layer's cross K/V of it (f32
    parameters)."""
    jcfg, tcfg = cfgs
    params = _jax_params(jcfg, seed=3, f32=True)
    jframes, tframes = _frames(jcfg, 4, True)
    want = _jax_cross_cache(jcfg, params, jframes, jnp.float32)
    got = _port_cross_cache(tcfg, _to_port(params), tframes, torch.float32)
    assert tuple(got[1].shape) == (jcfg.num_layers, BATCH, jcfg.encoder_seq,
                                   jcfg.n_kv_heads, jcfg.resolved_head_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32_TOL)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_decode_from_zero_self_cache_matches_jax(cfgs, bundles, f32):
    """``DECODE_STEPS`` steps from the zero self cache over the JAX
    package's cross cache (f32 under f32 parameters), each step's logits
    against the JAX decode's, then the self cache of the last step; the
    cross K/V pass through unchanged."""
    jcfg, _ = cfgs
    jstep, tb = bundles["decode"]
    params = _jax_params(jcfg, seed=5, f32=f32)
    dtype = jnp.float32 if f32 else jnp.bfloat16
    jframes, _ = _frames(jcfg, 6, f32)
    _, ck, cv = _jax_cross_cache(jcfg, params, jframes, dtype)
    specs = jax_model.cache_specs(jcfg, BATCH, SEQ)["self"]
    jcache = {"self": {k: jnp.zeros(s.shape, dtype) for k, s in specs.items()},
              "cross_k": ck, "cross_v": cv}
    tcache, tparams = _to_port(jcache), _to_port(params)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, (BATCH, DECODE_STEPS), dtype=np.int32)
    for t in range(DECODE_STEPS):
        pos = np.full((BATCH,), t, np.int32)
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.asarray(pos))
        got, tcache = tb.fn(tparams, tcache,
                            torch.from_numpy(toks[:, t:t + 1]),
                            torch.from_numpy(pos))
        assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
        _close(got, want, f32)
    for k in ("k", "v"):
        _close(tcache["self"][k], jcache["self"][k], f32)
    for k in ("cross_k", "cross_v"):
        np.testing.assert_array_equal(_np(tcache[k]), _np(jcache[k]))


@pytest.mark.parametrize("batch,seq", [(2, 20), (1, 9), (3, 33)])
def test_decode_from_zero_cache_matches_prefill(cfgs, batch, seq):
    """Step-by-step decode from the zero self cache, over the cross cache
    the port's encoder fills, ends at the prefill's last logits (f32
    parameters, frames and cache; the two differ in the f32 order of the
    sums only) and picks the same next token, with prompts shorter and
    longer than the 32 frames."""
    _, tcfg = cfgs
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, batch,
                                                    "prefill"), env)
    dec = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, batch,
                                                    "decode"), env)
    gen = torch.Generator().manual_seed(8)
    params, cache, _, _ = tmodel.init_inputs(dec, gen, CPU)
    params, cache = (shd.tree_map(lambda t: t.float(), tree)
                     for tree in (params, cache))
    frames = torch.randn((batch, tcfg.encoder_seq, tcfg.d_model),
                         generator=gen)
    toks = torch.randint(0, tcfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    want = pre.fn(params, {"frames": frames, "tokens": toks})
    _, cache["cross_k"], cache["cross_v"] = _port_cross_cache(
        tcfg, params, frames, torch.float32)
    for t in range(seq):
        got, cache = dec.fn(params, cache, toks[:, t:t + 1],
                            torch.full((batch,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("seq", [24, 32, 40])
def test_each_attention_reaches_the_kernel_entry(cfgs, seq):
    """A prefill hands every attention to ``ops.attention``, the wrapper
    that launches ``flash_attention`` on the card: per encoder layer one
    bidirectional call over the frames, per decoder layer one causal
    self-attention over the prompt and one cross-attention (queries over
    the prompt, keys over the frames), at prompts shorter than, as long
    as and longer than the frames; a decode step makes none."""
    _, tcfg = cfgs
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    calls = []
    attention_op = ops.attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return attention_op(q, k, v, **kw)
    t_enc = tcfg.encoder_seq
    with mock.patch.object(ops, "attention", counted):
        for kind in ("prefill", "decode"):
            b = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, 1, kind),
                                        env)
            args = tmodel.init_inputs(b, torch.Generator().manual_seed(0),
                                      CPU)
            calls.clear()
            out = b.fn(*args)
            if kind == "prefill":
                assert sorted(calls) == sorted(
                    [(t_enc, t_enc, False)] * tcfg.encoder_layers
                    + [(seq, seq, True)] * tcfg.num_layers
                    + [(seq, t_enc, False)] * tcfg.num_layers)
            else:
                out = out[0]
                assert calls == []
            assert bool(torch.isfinite(out).all())


def test_params_from_numpy_carries_the_encoder_and_decoder_trees(cfgs):
    """A JAX enc-dec parameter tree crosses leaf for leaf: dtypes kept,
    bf16 bits equal."""
    jcfg, _ = cfgs
    params = jax.tree.map(np.asarray, _jax_params(jcfg, seed=9, f32=False))
    tparams = params_from_numpy(params, CPU)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(tparams)[0])
    assert sorted(tparams) == sorted(params)
    assert len(got) == len(want)
    for path, a in want:
        t = got[path]
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
