"""The port's hybrid model path (Jamba: ``models.model.make_step_bundle`` ->
``transformer.prefill`` / ``decode_step`` over the per-layer ``layers``
tree) against the JAX package's bundles, on the CPU.

The config is the reduced Jamba-v0.1-52B, which keeps one whole 8-layer
period: attention at index 4, Mamba-2 mixers elsewhere, an MoE FFN (8
experts, top-2, capacity factor 1.25, so a prefill of 2 x 48 drops some
assignments) on the odd layers, no positions. JAX parameter trees carry
across through ``params_from_numpy``; the JAX bundles are built once per
module.

Tolerances: with every parameter (and the cache) in f32, rtol 1e-4 and
atol 1e-5, and the routes of every MoE layer equal. With the real bf16
parameters the two frameworks round some bf16 products one ulp apart, and
a near-tied route can flip between them (see tests/test_torch_moe_model.py),
so the bf16 cases record the JAX routes, hold the port's to at least 80%
agreement and run the port with the JAX routes. The bf16 Mamba-2 mixers
carry more rounding than attention alone: over seeds 0-7 of these cases
the logits (up to about 4) came within 0.086 max abs and 2.6% relative L2
in prefill, 0.139 and 3.5% over the decode steps, and each framework's
bf16 prefill is as far from the f32 run of the same weights as the two
are from each other (0.04-0.09 max abs, 1.4-2.9%, seeds 0-2). So bf16
logits are held to 0.25 max abs and 6% relative L2.
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
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed import sharding as jax_shd
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as tmodel
from repro_torch.models import moe, ssm, transformer
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "jamba-v0.1-52b"
CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 0.25, 0.06
MIN_ROUTE_AGREEMENT = 0.8
SEQ, BATCH, DECODE_STEPS = 48, 2, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _jax_params(jcfg, seed, f32: bool):
    params = jax_shd.init_params(jax_model.param_specs(jcfg),
                                 jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


@pytest.fixture(scope="module")
def cfgs():
    return (jax_get_arch(ARCH).model.reduced(),
            get_arch(ARCH).model.reduced())


@pytest.fixture(scope="module")
def bundles(cfgs):
    """The JAX and port bundles of the reduced config: prefill at
    BATCH x SEQ, decode over SEQ slots. Each test jits a new function
    around the JAX step (jit caches by function), so that its trace takes
    that test's recording router."""
    jcfg, tcfg = cfgs
    out = {}
    for kind in ("prefill", "decode"):
        jb = jax_model.make_step_bundle(JaxArch(model=jcfg),
                                        JaxShape("x", SEQ, BATCH, kind),
                                        jax_mesh())
        tb = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                     ShapeConfig("x", SEQ, BATCH, kind),
                                     make_host_mesh(device=CPU))
        out[kind] = (jb.fn, tb)
    return out


def _recording_jax_router(routes: list):
    """The JAX ``_router``, also appending each call's ids to ``routes`` in
    call order (layer by layer, step by step)."""
    router = jax_moe._router

    def recorded(cfg, p, x2d):
        out = router(cfg, p, x2d)
        jax.debug.callback(lambda ids: routes.append(np.asarray(ids)),
                           out[1], ordered=True)
        return out
    return recorded


def _recording_port_router(routes: list, forced: list = None):
    """The port's ``_router``, appending its own ids to ``routes``; with
    ``forced`` (the JAX ids, in call order, taken from the front) it routes
    by those ids, with its own weights at them."""
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


def test_reduced_layout_keeps_one_period(cfgs):
    """Attention at index 4 of the 8-layer period, MoE on the odd layers,
    Mamba-2 elsewhere; no position table."""
    _, tcfg = cfgs
    assert tcfg.num_layers == 8 and tcfg.attn_every == 8
    assert tcfg.layer_kinds() == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [tcfg.layer_is_moe(i) for i in range(8)] == [False, True] * 4
    specs = tmodel.param_specs(tcfg)
    assert "pos_embed" not in specs and "blocks" not in specs
    assert sorted(specs["layers"], key=int) == [str(i) for i in range(8)]
    assert "attn" in specs["layers"]["4"] and "ssm" in specs["layers"]["5"]
    assert "moe" in specs["layers"]["3"] and "mlp" in specs["layers"]["2"]


@pytest.mark.parametrize("layers", [8, 16, 24, 32])
def test_layout_at_each_depth(cfgs, layers):
    """Whole periods of the reduced config: attention at index 4 of each
    period of 8, MoE on the odd layers, a ``layers`` entry of each kind;
    the per-layer cache holds a KV cache on the attention layers and an
    SSM state on the others."""
    _, tcfg = cfgs
    tcfg = dataclasses.replace(tcfg, num_layers=layers)
    attn = [i for i in range(layers) if i % 8 == 4]
    assert [i for i, k in enumerate(tcfg.layer_kinds()) if k == "attn"] \
        == attn
    specs = tmodel.param_specs(tcfg)["layers"]
    cache = tmodel.cache_specs(tcfg, 2, 64)
    assert sorted(specs, key=int) == sorted(cache, key=int) == \
        [str(i) for i in range(layers)]
    for i in range(layers):
        layer = specs[str(i)]
        assert ("attn" in layer) == (i in attn) != ("ssm" in layer)
        assert ("moe" in layer) == (i % 2 == 1) != ("mlp" in layer)
        assert sorted(cache[str(i)]) == (["k", "v"] if i in attn
                                         else ["conv", "ssd"])


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


@pytest.mark.parametrize("batch,length", [(3, 4096), (1, 32), (8, 448)])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_hybrid_spec_trees_match_jax(reduced, batch, length):
    """Parameters (the per-layer ``layers`` tree), the per-layer decode
    cache (a KV cache on the attention layer, an SSM state elsewhere),
    decode inputs and the prefill batch, leaf for leaf."""
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


@pytest.mark.parametrize("layers,billions,gigabytes", [
    (8, 13.27, 26.5), (16, 26.00, 52.0), (24, 38.73, 77.5),
    (32, 51.46, 102.9)])
def test_param_count_at_each_cut(layers, billions, gigabytes):
    """The parameters of the full-width config cut to whole periods, as
    ``ModelConfig.param_count`` counts them: 16 layers (52.0 GB in bf16)
    fit the 80 GB card with room for a prefill; 24 (77.5 GB) leave none,
    32 (102.9 GB) do not fit."""
    cfg = dataclasses.replace(get_arch(ARCH).model, num_layers=layers)
    specs = tmodel.param_specs(cfg)
    assert round(shd.param_count(specs) / 1e9, 2) == billions == \
        round(cfg.param_count() / 1e9, 2)
    assert round(shd.param_bytes(specs) / 1e9, 1) == gigabytes


def test_full_jamba_and_its_16_layer_cut():
    """The full config is 51.46B parameters (102.9 GB in bf16), more than
    an 80 GB card holds; its first two periods (16 layers, 14 Mamba-2 and
    2 attention layers) are 26.00B (52.0 GB), the depth the card runs.
    Specs only, nothing is allocated."""
    cfg = get_arch(ARCH).model
    specs = tmodel.param_specs(cfg)
    assert round(shd.param_count(specs) / 1e9, 2) == 51.46 == \
        round(cfg.param_count() / 1e9, 2)
    assert round(shd.param_bytes(specs) / 1e9, 1) == 102.9
    cut = dataclasses.replace(cfg, num_layers=16)
    cut_specs = tmodel.param_specs(cut)
    assert round(shd.param_count(cut_specs) / 1e9, 2) == 26.00
    assert round(shd.param_bytes(cut_specs) / 1e9, 1) == 52.0
    assert cut.layer_kinds().count("ssm") == 14
    assert cut.layer_kinds().count("attn") == 2
    moe_layer = cut_specs["layers"]["1"]["moe"]
    assert moe_layer["wi"].shape == (16, 4096, 14336)
    cache = tmodel.cache_specs(cut, 8, 4096)
    assert cache["4"]["k"].shape == (8, 4096, 8, 128)
    assert cache["0"]["ssd"].shape == (8, 128, 16, 64)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_prefill_matches_jax(cfgs, bundles, f32):
    jcfg, _ = cfgs
    jb, tb = bundles["prefill"]
    jfn = jax.jit(lambda *a: jb(*a))
    params = _jax_params(jcfg, seed=0, f32=f32)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32)
    jroutes, troutes = [], []
    with mock.patch.object(jax_moe, "_router", _recording_jax_router(jroutes)):
        want = jfn(params, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    assert len(jroutes) == 4                      # the odd layers
    forced = None if f32 else list(jroutes)
    with mock.patch.object(moe, "_router",
                           _recording_port_router(troutes, forced)):
        got = tb.fn(_to_port(params), {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
    _check(got, want, troutes, jroutes, f32)


def test_forward_logits_and_losses_match_jax(cfgs):
    """``forward`` over the unrolled layers: all positions' logits and the
    MoE layers' ``lb_loss``/``z_loss`` summed, as the JAX ``forward`` (f32
    parameters); some assignments drop at capacity factor 1.25."""
    jcfg, tcfg = cfgs
    params = _jax_params(jcfg, seed=2, f32=True)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32)
    want, jaux = jax.jit(lambda p, t: jax_transformer.forward(
        jcfg, JaxArch(model=jcfg).run_config("x"), jax_mesh(), p, t))(
        params, jnp.asarray(toks))
    dropped = []
    apply = moe.apply_moe

    def counted(*a, **kw):
        y, aux = apply(*a, **kw)
        dropped.append(float(aux["dropped_frac"]))
        return y, aux
    with mock.patch.object(moe, "apply_moe", counted):
        got, taux = transformer.forward(
            tcfg, ArchConfig(model=tcfg).run_config("x"),
            make_host_mesh(device=CPU), _to_port(params),
            torch.from_numpy(toks))
    assert len(dropped) == 4 and max(dropped) > 0.0
    assert tuple(got.shape) == (BATCH, SEQ, jcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    for k in ("lb_loss", "z_loss"):
        assert float(taux[k]) > 0.0
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_decode_from_zero_cache_matches_jax(cfgs, bundles, f32):
    """``DECODE_STEPS`` steps from the zero per-layer cache (f32 under f32
    parameters), each step's logits against the JAX decode's, then every
    layer's cache (KV or SSM state) the last step returned."""
    jcfg, _ = cfgs
    jb, tb = bundles["decode"]
    jstep = jax.jit(lambda *a: jb(*a))
    params = _jax_params(jcfg, seed=4, f32=f32)
    specs = jax_model.cache_specs(jcfg, BATCH, SEQ)
    jcache = jax.tree.map(
        lambda s: jnp.zeros(s.shape, jnp.float32 if f32 else s.dtype),
        specs, is_leaf=jax_shd.is_spec)
    tcache, tparams = _to_port(jcache), _to_port(params)
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
            assert len(jroutes) == 4
            forced.extend(jroutes)
            got, tcache = tb.fn(tparams, tcache,
                                torch.from_numpy(toks[:, t:t + 1]),
                                torch.from_numpy(pos))
            assert tuple(got.shape) == (BATCH, 1, jcfg.vocab)
            _check(got, want, troutes, jroutes, f32)
    assert sorted(tcache) == sorted(jcache) == sorted(map(str, range(8)))
    if f32:
        for i, layer in jcache.items():
            for k, a in layer.items():
                np.testing.assert_allclose(_np(tcache[i][k]), _np(a),
                                           **F32_TOL)


@pytest.mark.parametrize("batch,seq", [(2, 40), (1, 17), (3, 33)])
def test_decode_from_zero_cache_matches_prefill(cfgs, batch, seq):
    """At ``capacity_factor = E / k`` the prefill drops nothing, so decode
    (the SSM recurrence and the KV cache step by step) from the zero cache
    ends at the prefill's last logits (f32 parameters and cache; the two
    differ in the order of the f32 sums only), at lengths that are and
    are not a multiple of the SSD chunk (16)."""
    _, tcfg = cfgs
    m = tcfg.moe
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, batch,
                                                    "prefill"), env)
    dec = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, batch,
                                                    "decode"), env)
    gen = torch.Generator().manual_seed(7)
    params, cache, _, _ = tmodel.init_inputs(dec, gen, CPU)
    params, cache = (shd.tree_map(lambda t: t.float(), tree)
                     for tree in (params, cache))
    toks = torch.randint(0, tcfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    want = pre.fn(params, {"tokens": toks})
    for t in range(seq):
        got, cache = dec.fn(params, cache, toks[:, t:t + 1],
                            torch.full((batch,), t, dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("layers", [8, 16, 24, 32])
def test_each_mixer_reaches_its_kernel_entry(cfgs, layers):
    """A prefill runs one SSD scan a Mamba-2 layer and one attention
    through ``ops.attention`` an attention layer (at 16 layers, the card's
    cut, the 14 ``ssd_scan`` and 2 ``flash_attention`` launches; on the
    CPU the scan is ``ssm.ssd_chunked``, what the kernel replaces); a
    decode step runs neither."""
    _, tcfg = cfgs
    tcfg = dataclasses.replace(tcfg, num_layers=layers)
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    calls = []
    ssd, attention = ssm.ssd_chunked, ops.attention

    def counted(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run
    with mock.patch.object(ssm, "ssd_chunked", counted("ssd", ssd)), \
            mock.patch.object(ops, "attention",
                              counted("attention", attention)):
        for kind in ("prefill", "decode"):
            b = tmodel.make_step_bundle(arch, ShapeConfig("x", 32, 1, kind),
                                        env)
            args = tmodel.init_inputs(b, torch.Generator().manual_seed(0),
                                      CPU)
            calls.clear()
            if kind == "prefill":
                out = b.fn(*args)
                assert sorted(calls) == ["attention"] * (layers // 8) + \
                    ["ssd"] * (layers * 7 // 8)
            else:
                out, cache = b.fn(*args)
                assert calls == []
                assert sorted(cache, key=int) == \
                    [str(i) for i in range(layers)]
            assert bool(torch.isfinite(out).all())


def test_params_from_numpy_carries_the_layers_tree(cfgs):
    """A JAX hybrid parameter tree crosses leaf for leaf under its string
    layer keys: dtypes kept, bf16 bits equal."""
    jcfg, _ = cfgs
    params = jax.tree.map(np.asarray, _jax_params(jcfg, seed=6, f32=False))
    tparams = params_from_numpy(params, CPU)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        tparams)[0])
    assert sorted(tparams["layers"]) == sorted(params["layers"])
    assert len(got) == len(want)
    for path, a in want:
        t = got[path]
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
