"""The port's model path (Mamba-2 prefill and decode) and its SSD and pack
kernels' plain versions against the JAX package, on the CPU.

Inputs are drawn with numpy (or JAX's own parameter init) and handed to
both packages; JAX parameter trees carry across through
``params_from_numpy``. Tolerances: the SSD forms agree within atol 1e-4
(f32, summation order only); the model path within rtol 1e-4 (atol 1e-5)
with every parameter cast to f32; with the real bf16 parameters, the two
frameworks round some bf16 products and sums differently by one unit in
the last place, which the residual stream carries on, so logits agree
within atol 4e-2 (a few bf16 ulps at their magnitude, about 1.5). Layout
packing is bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchConfig as JaxArch
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed import sharding as jax_shd
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers, ssm, transformer
from repro_torch.models import model as tmodel
from repro_torch.models.model import params_from_numpy

# (b, s, h, p, n, chunk): tests/test_kernels.py's sweep, its model-form
# length, and one whose chunk halves (96 % 64 -> 32)
SSD_SHAPES = [(2, 128, 3, 16, 8, 32), (1, 64, 2, 32, 16, 64),
              (1, 256, 4, 8, 4, 16), (2, 96, 2, 16, 8, 32),
              (1, 96, 2, 16, 8, 64)]
PACK_CASES = [(64, 256, "float32"), (70, 300, "float32"),
              (128, 384, "bfloat16"), (8, 128, "float32"),
              (33, 129, "bfloat16")]
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 4e-2
CPU = "cpu"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(t):
    return t.view(torch.int16 if t.dtype.itemsize == 2 else torch.int32)


def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, bb, cc, d


def _cfgs(reduced: bool):
    j = jax_get_arch("mamba2-130m").model
    t = get_arch("mamba2-130m").model
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def _jax_params(cfg, seed, f32: bool):
    specs = jax_model.param_specs(cfg)
    params = jax_shd.init_params(specs, jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _close(got, want, f32: bool):
    if f32:
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_ref_matches_jax_ref(b, s, h, p, n, chunk):
    ins = _ssd_inputs(b, s, h, p, n, seed=s + h)
    got = ref.ssd_ref(*map(torch.from_numpy, ins))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, p)
    np.testing.assert_allclose(_np(got), _np(jax_ref.ssd_ref(
        *map(jnp.asarray, ins))), atol=1e-4, rtol=0)
    # the CPU dispatch of ops.ssd is this plain version
    assert torch.equal(ops.ssd(*map(torch.from_numpy, ins), chunk=chunk), got)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_jax_chunked_and_pallas(b, s, h, p, n, chunk):
    ins = _ssd_inputs(b, s, h, p, n, seed=s + h)
    y, state = ssm.ssd_chunked(*map(torch.from_numpy, ins), chunk)
    jy, jstate = jax_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    np.testing.assert_allclose(_np(y), _np(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(state), _np(jstate), atol=1e-4, rtol=0)
    pallas = jax_ops.ssd(*map(jnp.asarray, ins), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(pallas), atol=1e-4, rtol=0)
    # and the two forms of one semantics agree with each other
    np.testing.assert_allclose(_np(y), _np(ref.ssd_ref(
        *map(torch.from_numpy, ins))), atol=1e-4, rtol=0)


@pytest.mark.parametrize("r,c,dtype", PACK_CASES)
def test_pack_matches_jax_pallas_bit_exact(r, c, dtype):
    w = np.random.default_rng(r + c).standard_normal((r, c)) \
        .astype(np.float32)
    wj = jnp.asarray(w).astype(JAX_DT[dtype])
    wt = torch.from_numpy(w).to(TORCH_DT[dtype])
    got = ops.pack(wt)
    assert got.dtype == wt.dtype
    assert tuple(got.shape[2:]) == ops.native_tile(wt.dtype) == \
        jax_ops.native_tile(JAX_DT[dtype])
    assert torch.equal(_bits(got), _bits(_to_port(jax_ops.pack(wj))))
    assert torch.equal(_bits(ops.unpack(got, (r, c))), _bits(wt))
    explicit = ref.layout_pack_ref(wt, (4, 32))
    assert torch.equal(_bits(explicit),
                       _bits(_to_port(jax_ref.layout_pack_ref(wj, (4, 32)))))


# the shapes of the CUDA pack's path boundaries (row padding on the vector
# path, column padding, runs that are not whole or are short runs of
# 16-byte vectors, 1-byte elements), with their tiles
PACK_PATH_CASES = [(70, 256, "float32", (8, 128)),
                   (33, 129, "float32", (8, 128)),
                   (33, 129, "bfloat16", (16, 128)),
                   (64, 96, "float32", (8, 64)),
                   (48, 96, "float32", (5, 12)),
                   (40, 96, "float32", (5, 6)),
                   (40, 256, "uint8", (8, 128)),
                   (40, 256, "int16", (16, 128))]


@pytest.mark.parametrize("r,c,dtype,tile", PACK_PATH_CASES)
def test_pack_ref_matches_jax_at_path_boundaries(r, c, dtype, tile):
    """The plain version the CUDA kernel is held to, bit for bit, against
    the Pallas kernel (interpret mode) and the JAX reference at each
    boundary case's shape and tile."""
    from repro.kernels.layout_pack import layout_pack as jax_layout_pack
    rng = np.random.default_rng(r * c)
    if dtype in ("float32", "bfloat16"):
        w = rng.standard_normal((r, c)).astype(np.float32)
        wj = jnp.asarray(w).astype(JAX_DT[dtype])
        wt = torch.from_numpy(w).to(TORCH_DT[dtype])
    else:
        info = np.iinfo(dtype)
        w = rng.integers(info.min, info.max, (r, c), dtype=dtype,
                         endpoint=True)
        wj, wt = jnp.asarray(w), torch.from_numpy(w)
    got = ref.layout_pack_ref(wt, tile)
    assert got.dtype == wt.dtype
    raw = got.view(torch.uint8).numpy()
    for want in (jax_layout_pack(wj, tile=tile, interpret=True),
                 jax_ref.layout_pack_ref(wj, tile)):
        want = np.asarray(want)
        assert want.shape == tuple(got.shape)
        np.testing.assert_array_equal(raw, want.view(np.uint8))
    assert torch.equal(ref.layout_unpack_ref(got, (r, c)), wt)


# ---------------------------------------------------------------------------
# spec trees and parameters
# ---------------------------------------------------------------------------

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


def _same_specs(port_tree, jax_tree):
    got = {k: _spec_key(v) for k, v in _flat(port_tree).items()}
    want = {k: _spec_key(v) for k, v in _flat(jax_tree).items()}
    assert got == want


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_spec_trees_match_jax(reduced):
    jcfg, tcfg = _cfgs(reduced)
    _same_specs(tmodel.param_specs(tcfg), jax_model.param_specs(jcfg))
    _same_specs(tmodel.cache_specs(tcfg, 3, 64),
                jax_model.cache_specs(jcfg, 3, 64))
    for kind in ("prefill", "decode"):
        jshape, tshape = JaxShape("x", 64, 3, kind), ShapeConfig("x", 64, 3,
                                                                 kind)
        _same_specs(tmodel.batch_specs(tcfg, tshape, train=False),
                    jax_model.batch_specs(jcfg, jshape, train=False))
        _same_specs(tmodel.decode_input_specs(tcfg, tshape),
                    jax_model.decode_input_specs(jcfg, jshape))
    assert shd.param_count(tmodel.param_specs(tcfg)) == \
        jax_shd.param_count(jax_model.param_specs(jcfg))
    assert shd.param_bytes(tmodel.param_specs(tcfg)) == \
        jax_shd.param_bytes(jax_model.param_specs(jcfg))


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_batch_specs_match_jax_for_every_arch(name):
    """The input specs of every frontend (tokens, vision embeds with M-RoPE
    positions, audio frames), for serving and training shapes."""
    for train in (False, True):
        _same_specs(tmodel.batch_specs(get_arch(name).model,
                                       ShapeConfig("x", 64, 3, "train"),
                                       train=train),
                    jax_model.batch_specs(JAX_ARCHS[name].model,
                                          JaxShape("x", 64, 3, "train"),
                                          train=train))


@pytest.mark.parametrize("init", ["zeros", "ones", "ssm_a", "arange"])
def test_deterministic_inits_match_jax(init):
    spec = shd.ParamSpec((3, 5), torch.float32, init=init)
    jspec = jax_shd.ParamSpec((3, 5), jnp.float32, init=init)
    got = shd.init_params({"w": spec}, torch.Generator().manual_seed(0), CPU)
    want = jax_shd.init_params({"w": jspec}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(_np(got["w"]), _np(want["w"]), rtol=1e-6)


def test_normal_init_scales_by_fan_in_and_follows_the_generator():
    spec = {"w": shd.ParamSpec((400, 300), torch.bfloat16, scale=2.0)}
    a = shd.init_params(spec, torch.Generator().manual_seed(3), CPU)["w"]
    b = shd.init_params(spec, torch.Generator().manual_seed(3), CPU)["w"]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert abs(a.float().std().item() - 2.0 / 400 ** 0.5) < 2e-3


def test_params_from_numpy_keeps_dtypes_and_bits():
    jcfg, _ = _cfgs(reduced=True)
    params = _jax_params(jcfg, seed=0, f32=False)
    port = _to_port(params)
    for path, leaf in _flat(params).items():
        got = _flat(port)[path]
        assert str(got.dtype).removeprefix("torch.") == leaf.dtype.name
        np.testing.assert_array_equal(_np(got), _np(leaf))


def test_init_inputs_draws_tokens_in_zero_one():
    _, tcfg = _cfgs(reduced=True)
    bundle = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                     ShapeConfig("p", 32, 2, "prefill"),
                                     make_host_mesh(device=CPU))
    params, batch = tmodel.init_inputs(bundle, torch.Generator()
                                       .manual_seed(0), CPU)
    assert batch["tokens"].dtype == torch.int32
    assert set(batch["tokens"].unique().tolist()) <= {0, 1}
    assert params["blocks"]["ssm"]["in_proj"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", False)])
def test_norm_and_mlp_match_jax(norm, act, glu):
    jcfg, tcfg = (dataclasses.replace(c, norm=norm, act=act, glu=glu)
                  for c in _cfgs(reduced=True))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    p = {k: rng.standard_normal(s.shape).astype(np.float32)
         for k, s in jax_layers.norm_specs(jcfg).items()}
    _close(layers.apply_norm(tcfg, params_from_numpy(p, CPU),
                             torch.from_numpy(x)),
           jax_layers.apply_norm(jcfg, p, jnp.asarray(x)), f32=True)
    m = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
         for k, s in jax_layers.mlp_specs(jcfg).items()}
    assert sorted(m) == sorted(layers.mlp_specs(tcfg))
    _close(layers.apply_mlp(tcfg, params_from_numpy(m, CPU),
                            torch.from_numpy(x), make_host_mesh(device=CPU)),
           jax_layers.apply_mlp(jcfg, m, jnp.asarray(x), jax_mesh()),
           f32=True)


def test_rotary_and_sinusoid_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 6)).astype(np.int32)
    pos3 = rng.integers(0, 50, (3, 2, 6)).astype(np.int32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(layers.apply_rope(xt, torch.from_numpy(pos), 1e4),
           jax_layers.apply_rope(xj, jnp.asarray(pos), 1e4), f32=True)
    _close(layers.apply_mrope(xt, torch.from_numpy(pos3), 1e6),
           jax_layers.apply_mrope(xj, jnp.asarray(pos3), 1e6), f32=True)
    _close(layers.sinusoid_positions(10, 16),
           jax_layers.sinusoid_positions(10, 16), f32=True)


# ---------------------------------------------------------------------------
# the SSM mixer and the model path
# ---------------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_apply_ssm_matches_jax(f32):
    jcfg, tcfg = _cfgs(reduced=True)
    p = _layer0(_jax_params(jcfg, seed=1, f32=f32)["blocks"]["ssm"])
    dt = jnp.float32 if f32 else jnp.bfloat16
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)).astype(dt)
    want = jax_ssm.apply_ssm(jcfg, p, x, jax_mesh())
    got = ssm.apply_ssm(tcfg, _to_port(p), _to_port(x),
                        make_host_mesh(device=CPU))
    assert got.dtype == _to_port(want).dtype
    _close(got, want, f32)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_decode_ssm_matches_jax(f32):
    """A non-zero state whose conv history is not bf16-representable: the
    decode step rounds it to the input's dtype before the conv."""
    jcfg, tcfg = _cfgs(reduced=True)
    p = _layer0(_jax_params(jcfg, seed=2, f32=f32)["blocks"]["ssm"])
    rng = np.random.default_rng(4)
    dt = jnp.float32 if f32 else jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((3, 1, jcfg.d_model))
                    .astype(np.float32)).astype(dt)
    state = {k: rng.standard_normal(s.shape).astype(np.float32)
             for k, s in jax_ssm.ssm_state_specs(jcfg, 3).items()}
    want, wstate = jax_ssm.decode_ssm(jcfg, p, x, state, jax_mesh())
    got, gstate = ssm.decode_ssm(tcfg, _to_port(p), _to_port(x),
                                 params_from_numpy(state, CPU),
                                 make_host_mesh(device=CPU))
    _close(got, want, f32)
    for k in ("ssd", "conv"):
        assert gstate[k].dtype == torch.float32
        np.testing.assert_allclose(_np(gstate[k]), _np(wstate[k]),
                                   **F32_TOL)


def _bundles(jcfg, tcfg, kind, seq, batch):
    jb = jax_model.make_step_bundle(JaxArch(model=jcfg),
                                    JaxShape("x", seq, batch, kind),
                                    jax_mesh())
    tb = tmodel.make_step_bundle(ArchConfig(model=tcfg),
                                 ShapeConfig("x", seq, batch, kind),
                                 make_host_mesh(device=CPU))
    return jb, tb


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_prefill_matches_jax(f32):
    jcfg, tcfg = _cfgs(reduced=True)
    jb, tb = _bundles(jcfg, tcfg, "prefill", 48, 2)
    params = _jax_params(jcfg, seed=0, f32=f32)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 48),
                                             dtype=np.int32)
    want = jb.fn(params, {"tokens": jnp.asarray(toks)})
    tparams = _to_port(params)
    got = tb.fn(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, 256)
    _close(got, want, f32)
    # prefill is the full forward's last position
    full, aux = transformer.forward(
        tcfg, ArchConfig(model=tcfg).run_config("x"),
        make_host_mesh(device=CPU), tparams, torch.from_numpy(toks))
    assert tuple(full.shape) == (2, 48, 256)
    assert {k: float(v) for k, v in aux.items()} == {"lb_loss": 0.0,
                                                     "z_loss": 0.0}
    _close(full[:, -1:], got, f32=True)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_decode_step_matches_jax(f32):
    jcfg, tcfg = _cfgs(reduced=True)
    jb, tb = _bundles(jcfg, tcfg, "decode", 64, 2)
    params = _jax_params(jcfg, seed=1, f32=f32)
    rng = np.random.default_rng(6)
    cache = {k: (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
             for k, s in jax_model.cache_specs(jcfg, 2, 64).items()}
    tparams, tcache = _to_port(params), params_from_numpy(cache, CPU)
    jcache = jax.tree.map(jnp.asarray, cache)
    for step in range(3):
        toks = rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)
        pos = np.full((2,), step, np.int32)
        want, jcache = jb.fn(params, jcache, jnp.asarray(toks),
                             jnp.asarray(pos))
        got, tcache = tb.fn(tparams, tcache, torch.from_numpy(toks),
                            torch.from_numpy(pos))
        _close(got, want, f32)
    for k in ("ssd", "conv"):
        np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                   **(F32_TOL if f32 else
                                      dict(atol=BF16_ATOL, rtol=0)))


def test_prefill_full_width_two_layers_matches_jax():
    """Mamba-2-130M at full width (d 768, 24 heads of 64, d_state 128,
    chunk 256, vocab 50280), cut to 2 layers, seq 512, batch 1, with the
    real bf16 parameters."""
    jcfg, tcfg = (dataclasses.replace(c, num_layers=2)
                  for c in _cfgs(reduced=False))
    jb, tb = _bundles(jcfg, tcfg, "prefill", 512, 1)
    params = _jax_params(jcfg, seed=0, f32=False)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (1, 512),
                                             dtype=np.int32)
    want = jb.fn(params, {"tokens": jnp.asarray(toks)})
    got = tb.fn(_to_port(params), {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (1, 1, 50280)
    assert bool(torch.isfinite(got).all())
    _close(got, want, f32=False)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_decode_from_zero_cache_matches_prefill(f32):
    """Step-by-step decode (the sequential recurrence) ends at the
    prefill's last logits (the chunked scan), within the stated
    tolerance, and picks the same next token."""
    _, tcfg = _cfgs(reduced=True)
    seq, batch = 40, 2
    arch = ArchConfig(model=tcfg)
    env = make_host_mesh(device=CPU)
    pre = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, batch,
                                                    "prefill"), env)
    dec = tmodel.make_step_bundle(arch, ShapeConfig("x", seq, batch,
                                                    "decode"), env)
    gen = torch.Generator().manual_seed(8)
    params, cache, _, _ = tmodel.init_inputs(dec, gen, CPU)
    if f32:
        params = shd.tree_map(lambda t: t.float(), params)
    toks = torch.randint(0, tcfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    want = pre.fn(params, {"tokens": toks})
    for t in range(seq):
        got, cache = dec.fn(params, cache, toks[:, t:t + 1],
                            torch.full((batch,), t, dtype=torch.int32))
    _close(got, want, f32)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("what", ["train", "hybrid", "encdec"])
def test_unported_paths_raise(what):
    """The paths of later slices raise, naming the roadmap."""
    env = make_host_mesh(device=CPU)
    names = {"hybrid": "jamba-v0.1-52b", "encdec": "whisper-small",
             "train": "mamba2-130m"}
    cfg = get_arch(names[what]).model.reduced()
    arch = ArchConfig(model=cfg)
    kind = "train" if what == "train" else "prefill"
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmodel.make_step_bundle(arch, ShapeConfig("x", 32, 1, kind), env)


def test_mesh_is_one_device_and_explicit():
    assert make_host_mesh(device=CPU).device == torch.device(CPU)
    with pytest.raises(NotImplementedError, match="mesh slice"):
        make_host_mesh(2, 1, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
