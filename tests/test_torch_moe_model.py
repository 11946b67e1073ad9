"""The port's MoE model path (``models.model.make_step_bundle`` ->
``transformer.prefill`` / ``decode_step`` -> ``moe.apply_moe``) against the
JAX package's bundles, on the CPU.

Configs: reduced Qwen3-30B-A3B and Mixtral-8x22B (its sliding window of
32 under 48 positions), a dense stack (Qwen1.5-4B, QKV bias) whose ``moe``
config makes every FFN an MoE block, and a narrow MoE stack at the full
models' attention widths (hd 128, 8 query heads on 1 KV head) with 16
experts, top-4. JAX parameter trees carry across through
``params_from_numpy``.

Tolerances: with every parameter (and the cache) in f32, rtol 1e-4 and
atol 1e-5, and the routes of every layer equal. With the real bf16
parameters the two frameworks round some bf16 products one ulp apart
(attention, the norms, the expert products), and where a token's k-th and
(k+1)-th router weights are that close, the two route it to different
experts: over 12 seeds of the reduced Qwen3 prefill (2 x 48) 86-100% of
a layer's routes agreed, and where some differed the last logits moved by
up to 1.18. So the bf16 cases record the JAX package's routes, hold the
port's to at least 80% agreement over all layers, then run the port with
the JAX routes (its own router weights at those ids) and hold the logits
to 0.1 max abs and 3% relative L2, the bound of
``tests/test_torch_dense.py``: over those 12 seeds, with the routes forced,
they came within 0.039 and 1.1%.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchConfig as JaxArch
from repro.configs.base import MoEConfig as JaxMoE
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed import sharding as jax_shd
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, MoEConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe, transformer
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 0.1, 0.03
MIN_ROUTE_AGREEMENT = 0.8
NARROW = dict(d_model=256, n_heads=8, n_kv_heads=1, head_dim=128, d_ff=512)
CONFIGS = {
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, None),
    "mixtral-window": ("mixtral-8x22b", {}, None),
    "moe-in-dense": ("qwen1.5-4b", {}, dict(n_experts=4, top_k=2, d_ff=64)),
    "narrow-hd128": ("qwen3-moe-30b-a3b", NARROW,
                     dict(n_experts=16, top_k=4, d_ff=128)),
}
SEQ, BATCH, DECODE_STEPS = 48, 2, 10


def _cfgs(name):
    arch, kw, routing = CONFIGS[name]
    out = []
    for get, moe_cls in ((jax_get_arch, JaxMoE), (get_arch, MoEConfig)):
        cfg = dataclasses.replace(get(arch).model.reduced(), **kw)
        if routing is not None:
            cfg = dataclasses.replace(cfg, moe=moe_cls(**routing))
        out.append(cfg)
    return tuple(out)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_params(jcfg, seed, f32: bool):
    params = jax_shd.init_params(jax_model.param_specs(jcfg),
                                 jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _bundles(jcfg, tcfg, kind, seq, batch):
    jb = jax_model.make_step_bundle(JaxArch(model=jcfg),
                                    JaxShape("x", seq, batch, kind),
                                    jax_mesh())
    tb = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                 ShapeConfig("x", seq, batch, kind),
                                 make_host_mesh(device=CPU))
    return jb, tb


def _recording_jax_router(routes: list):
    """The JAX ``_router``, also appending each call's ids to ``routes``
    (in call order: layer by layer, step by step) from inside the traced
    layer loop."""
    router = jax_moe._router

    def recorded(cfg, p, x2d):
        out = router(cfg, p, x2d)
        jax.debug.callback(lambda ids: routes.append(np.asarray(ids)),
                           out[1], ordered=True)
        return out
    return recorded


def _recording_port_router(routes: list, forced: list = None):
    """The port's ``_router``, appending its own ids to ``routes``; with
    ``forced`` (the JAX package's ids, in call order, taken from the front)
    it routes by those ids instead, with its own weights at them."""
    router = moe._router

    def recorded(cfg, p, x2d):
        w, ids, aux = router(cfg, p, x2d)
        routes.append(ids.numpy())
        if forced is None:
            return w, ids, aux
        ids = torch.tensor(forced.pop(0), dtype=torch.long)
        probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
        w = torch.gather(probs, 1, ids)
        return w / w.sum(-1, keepdim=True), ids, aux
    return recorded


def _check(got, want, got_routes, want_routes, f32: bool):
    assert len(got_routes) == len(want_routes)
    same = [np.mean(g == w) for g, w in zip(got_routes, want_routes)]
    got, want = _np(got), _np(want)
    if f32:
        assert min(same) == 1.0
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    assert np.mean(same) >= MIN_ROUTE_AGREEMENT
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_matches_jax(name, f32):
    jcfg, tcfg = _cfgs(name)
    jb, tb = _bundles(jcfg, tcfg, "prefill", SEQ, BATCH)
    params = _jax_params(jcfg, seed=0, f32=f32)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32)
    jroutes, troutes = [], []
    with mock.patch.object(jax_moe, "_router", _recording_jax_router(jroutes)):
        want = jb.fn(params, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    assert len(jroutes) == jcfg.num_layers
    tparams = _to_port(params)
    forced = None if f32 else list(jroutes)
    with mock.patch.object(moe, "_router",
                           _recording_port_router(troutes, forced)):
        got = tb.fn(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
    _check(got, want, troutes, jroutes, f32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_losses_match_jax(name):
    """``forward`` returns the logits and ``lb_loss``/``z_loss`` summed over
    the layers, as the JAX ``forward`` does (f32 parameters)."""
    jcfg, tcfg = _cfgs(name)
    params = _jax_params(jcfg, seed=2, f32=True)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32)
    want, jaux = jax_transformer.forward(
        jcfg, JaxArch(model=jcfg).run_config("x"), jax_mesh(), params,
        jnp.asarray(toks))
    got, taux = transformer.forward(
        tcfg, ArchConfig(model=tcfg).run_config("x"),
        make_host_mesh(device=CPU), _to_port(params), torch.from_numpy(toks))
    assert tuple(got.shape) == (BATCH, SEQ, jcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert sorted(taux) == ["lb_loss", "z_loss"]
    for k in taux:
        assert float(taux[k]) > 0.0
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_from_zero_cache_matches_jax(name, f32):
    """``DECODE_STEPS`` steps from the zero cache of 48 slots (f32 under
    f32 parameters), each step's logits against the JAX decode's."""
    jcfg, tcfg = _cfgs(name)
    jb, tb = _bundles(jcfg, tcfg, "decode", SEQ, BATCH)
    jstep = jax.jit(jb.fn)
    params = _jax_params(jcfg, seed=4, f32=f32)
    specs = jax_model.cache_specs(jcfg, BATCH, SEQ)
    jcache = {k: jnp.zeros(s.shape, jnp.float32 if f32 else s.dtype)
              for k, s in specs.items()}
    tcache = _to_port(jcache)
    tparams = _to_port(params)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab, (BATCH, DECODE_STEPS), dtype=np.int32)
    jroutes, troutes, forced = [], [], []
    with mock.patch.object(jax_moe, "_router",
                           _recording_jax_router(jroutes)), \
            mock.patch.object(moe, "_router", _recording_port_router(
                troutes, None if f32 else forced)):
        for t in range(DECODE_STEPS):
            pos = np.full((BATCH,), t, np.int32)
            jroutes.clear()
            troutes.clear()
            want, jcache = jstep(params, jcache,
                                 jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(pos))
            jax.effects_barrier()
            assert len(jroutes) == jcfg.num_layers
            forced.extend(jroutes)
            got, tcache = tb.fn(tparams, tcache,
                                torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
            assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
            _check(got, want, troutes, jroutes, f32)


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


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "mixtral-8x22b",
                                  "moe-in-dense", "narrow-hd128"])
def test_moe_spec_trees_match_jax(name):
    """The full configs' and the test configs' parameters (a ``moe``
    subtree in place of ``mlp``), KV cache and decode inputs, leaf for
    leaf."""
    if name in CONFIGS:
        jcfg, tcfg = _cfgs(name)
    else:
        jcfg, tcfg = jax_get_arch(name).model, get_arch(name).model
    tspecs = tmodel.param_specs(tcfg)
    assert "moe" in tspecs["blocks"] and "mlp" not in tspecs["blocks"]
    assert _flat(tspecs) == _flat(jax_model.param_specs(jcfg))
    assert _flat(tmodel.cache_specs(tcfg, 4, 4096)) == \
        _flat(jax_model.cache_specs(jcfg, 4, 4096))
    shape = ShapeConfig("x", 64, 3, "decode")
    assert _flat(tmodel.decode_input_specs(tcfg, shape)) == _flat(
        jax_model.decode_input_specs(jcfg, JaxShape("x", 64, 3, "decode")))
    assert shd.param_count(tspecs) == \
        jax_shd.param_count(jax_model.param_specs(jcfg))


def test_full_qwen3_bundles_have_the_full_shapes():
    """``make_step_bundle`` on the full Qwen3-30B-A3B: 48 stacked layers of
    128 experts, 30.5B parameters (61.1 GB in bf16), a decode cache of
    [48, B, S, 4, 128]; specs only, nothing is allocated."""
    arch = get_arch("qwen3-moe-30b-a3b")
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(arch, ShapeConfig("p", 4096, 2, "prefill"),
                                  env)
    dec = tmodel.make_step_bundle(arch, ShapeConfig("d", 4096, 8, "decode"),
                                  env)
    blocks = pre.arg_specs[0]["blocks"]["moe"]
    assert blocks["wi"].shape == (48, 128, 2048, 768)
    assert blocks["wo"].shape == (48, 128, 768, 2048)
    assert blocks["router"].shape == (48, 2048, 128)
    assert blocks["router"].dtype == torch.float32
    assert round(shd.param_count(pre.arg_specs[0]) / 1e9, 1) == 30.5
    assert round(shd.param_bytes(pre.arg_specs[0]) / 1e9, 1) == 61.1
    assert dec.arg_specs[1]["k"].shape == (48, 8, 4096, 4, 128)


def test_params_from_numpy_carries_a_moe_tree():
    """A JAX MoE parameter tree crosses leaf for leaf: dtypes kept, bf16
    bits equal."""
    jcfg, _ = _cfgs("qwen3-moe")
    params = _jax_params(jcfg, seed=6, f32=False)
    tparams = _to_port(params)
    want = jax.tree.map(np.asarray, params)["blocks"]["moe"]
    got = tparams["blocks"]["moe"]
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == a.dtype.name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                got[k].view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(got[k].numpy(), a)


@pytest.mark.parametrize("name", ["qwen3-moe", "narrow-hd128"])
def test_decode_from_zero_cache_matches_prefill(name):
    """At ``capacity_factor = E / k`` the prefill drops nothing, so decode
    (one token a row, never dropping) step by step from the zero cache
    ends at the prefill's last logits (f32 parameters and cache; the two
    differ in the order of the f32 sums only)."""
    _, tcfg = _cfgs(name)
    m = tcfg.moe
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    seq = 24
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, BATCH,
                                                    "prefill"), env)
    dec = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, BATCH,
                                                    "decode"), env)
    gen = torch.Generator().manual_seed(7)
    params, cache, _, _ = tmodel.init_inputs(dec, gen, CPU)
    params, cache = (shd.tree_map(lambda t: t.float(), tree)
                     for tree in (params, cache))
    toks = torch.randint(0, tcfg.vocab, (BATCH, seq), generator=gen,
                         dtype=torch.int32)
    dropped = []
    apply = moe.apply_moe

    def counted(*a, **kw):
        y, aux = apply(*a, **kw)
        dropped.append(float(aux["dropped_frac"]))
        return y, aux
    with mock.patch.object(moe, "apply_moe", counted):
        want = pre.fn(params, {"tokens": toks})
        for t in range(seq):
            got, cache = dec.fn(params, cache, toks[:, t:t + 1],
                                torch.full((BATCH,), t, dtype=torch.int32))
    assert dropped == [0.0] * (tcfg.num_layers * (seq + 1))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
