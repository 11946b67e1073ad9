"""The port's training path (``data.pipeline``, ``distributed.compression``,
``training.optimizer``, ``checkpoint.ckpt``, ``transformer.loss_fn``,
``encdec.loss_fn``, ``training.trainer`` and the ``train`` bundle of
``models.model``) against the JAX package's, on the CPU.

Exact: the data stream and the int8 compression bit for bit; checkpoints
restore across the two packages bit for bit. The optimizer on the same
numpy gradients: f32 leaves within 4 f32 ulps (rtol 5e-7 above an atol of
1e-9: the frameworks' pow, cos and sqrt may round one ulp apart and the
update's sums may fuse differently), bf16 leaves and moments within one
bf16 ulp.

Losses and gradients against ``jax.value_and_grad`` on reduced configs
with every parameter (and the stub embeddings) in f32, so the only
difference is the order of f32 sums: loss within rtol 1e-5, each
gradient leaf within a relative L2 of ``GRAD_REL_L2`` (readings up to
6.1e-6 at these sizes). With the real bf16 parameters the frameworks round
bf16 products apart (``tests/test_torch_dense.py``): the loss within 1e-2
relative (readings up to 3.8e-4), each gradient leaf within
``BF16_GRAD_REL_L2`` (readings up to 2.2e-2; Mamba-2's 1.9e-4 and 1.7e-2). A leaf whose gradient is
zero but for rounding (the key bias of attention without rotary
positions: softmax ignores a shift shared by a row's scores) is held to
an absolute floor of ``GRAD_FLOOR`` (f32) or ``BF16_GRAD_FLOOR`` (bf16)
times the largest leaf's gradient norm instead (readings 1.5e-9 and
4.3e-5 against norms near 5).

The train step against ``make_train_step`` from one state carried across
by ``params_from_numpy``, 3 steps at microbatch 1 and 2 (bf16 parameters):
losses and grad norms within 1e-2 relative (readings up to 9.3e-4 and
1.7e-3, Mamba-2's up to 2.2e-3); Adam's first steps move each element by
about lr sign(g), so an element whose gradient is near zero may step the
other way. At least ``PARAM_AGREE`` of the bf16 parameters must agree
within one bf16 ulp (readings 0.968 for Yi-6B, 0.998 for Whisper-small,
0.962 for Mamba-2).

The MoE and hybrid families (reduced Qwen3-30B-A3B, Mixtral-8x22B and
Jamba-v0.1-52B) are held to the same bounds. In f32 their routes agree
and every gradient leaf reads within 9.7e-6. In bf16 the two frameworks
round some products one ulp apart, and where a token's k-th and (k+1)-th
router weights are that close it is routed to another expert
(tests/test_torch_moe_model.py); one flipped route moves a gradient far
more than rounding does (the reduced Qwen3's router gradient by 54%
relative L2 at seed 1). So the bf16 MoE cases record the JAX package's
routes inside its jitted step and run the port by them, with its own
weights at those ids. Each flip is then shown to be a near-tie: with the
upstream layers routed alike, wherever the port's own top-k differs, the
gap between its k-th and (k+1)-th weights must be at most ``FLIP_MARGIN``
(readings up to 5.6e-4 for Qwen3 and 3.1e-3 for Jamba from one state,
1.3e-3 and 3.4e-3 in a train step's first step; the later steps' flips
also follow the parameters' own differences and are not held). With the
routes forced, Qwen3's and Mixtral's leaves read up to 2.1e-2 and the
train steps pass the bounds above. Jamba's bf16 Mamba-2 mixers round
more (``tests/test_torch_hybrid.py`` holds its bf16 logits to twice the
dense bound): its leaves read up to 6.7e-2 (the layer-0 ``d_skip``),
while the port's own bf16 gradients are about as far from its f32
gradients of the same weights (median leaf 4.1%, against 3.9% from the
JAX package's), so its leaves are held to ``HYBRID_BF16_GRAD_REL_L2``,
twice the dense bound.
"""
import contextlib
import dataclasses
import functools
import os
import tempfile
from collections import Counter
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JaxRun
from repro.configs.base import ShapeConfig as JaxShape
from repro.data import pipeline as jax_pipe
from repro.distributed import compression as jax_comp
from repro.distributed import sharding as jax_shd
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import encdec as jax_encdec
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.training import optimizer as jax_opt
from repro.training import trainer as jax_trainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.data import pipeline
from repro_torch.distributed import compression
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import encdec, moe, transformer
from repro_torch.models import model as tmodel
from repro_torch.models.model import params_from_numpy
from repro_torch.training import optimizer, trainer
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GRAD_REL_L2, GRAD_FLOOR = 1e-4, 1e-6
BF16_GRAD_REL_L2, BF16_GRAD_FLOOR = 0.05, 1e-4
PARAM_AGREE = 0.9
SEQ, BATCH = 16, 4
MOE_MODELS = ["qwen3-moe-30b-a3b", "mixtral-8x22b", "jamba-v0.1-52b"]
MODELS = ["yi-6b", "qwen2-vl-72b", "mamba2-130m", "whisper-small",
          *MOE_MODELS]
TRAINED = ["yi-6b", "whisper-small", "mamba2-130m", *MOE_MODELS]
# the largest gap between a token's k-th and (k+1)-th router weights (the
# port's) where the port's own top-k differs from the JAX package's routes
# under bf16 parameters
FLIP_MARGIN = 5e-3
# Jamba's bf16 gradient leaves (the module docstring)
HYBRID_BF16_GRAD_REL_L2 = 0.1


# --- helpers -----------------------------------------------------------------

def _flat(tree, prefix=""):
    """{path: float32 numpy array} of a JAX or port tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree).astype(np.float32)}


def _bits(tree):
    """{path: numpy array in the stored dtype (bf16 as uint16)}."""
    out = {}
    for path, a in _flat_raw(tree).items():
        if isinstance(a, torch.Tensor):
            a = a.detach()
            a = a.view(torch.int16).numpy().view(np.uint16) \
                if a.dtype == torch.bfloat16 else a.numpy()
        else:
            a = np.asarray(a)
            if a.dtype == ml_dtypes.bfloat16:
                a = a.view(np.uint16)
        out[path] = a
    return out


def _flat_raw(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_raw(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _rel(got, want) -> float:
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (n if n > 0 else 1.0))


def _grads_close(tgrads, jgrads, rel, floor):
    """Each leaf within ``rel`` relative L2, or within ``floor`` times the
    largest leaf's norm where the gradient is zero but for rounding."""
    jflat, tflat = _flat(jgrads), _flat(tgrads)
    assert jflat.keys() == tflat.keys()
    scale = max(np.linalg.norm(w) for w in jflat.values())
    for k, w in jflat.items():
        assert tflat[k].shape == w.shape, k
        err = np.linalg.norm(tflat[k] - w)
        assert err <= rel * np.linalg.norm(w) + floor * scale, \
            (k, _rel(tflat[k], w))


def _cfgs(name):
    return jax_get_arch(name).model.reduced(), get_arch(name).model.reduced()


def _batch_np(cfg, seed, batch=BATCH, seq=SEQ):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    targets = np.roll(toks, -1, axis=1).astype(np.int32)
    targets[rng.random(targets.shape) < 0.1] = -1
    out = {"targets": targets}
    if cfg.frontend == "vision_stub":
        out["embeds"] = (rng.standard_normal((batch, seq, cfg.d_model))
                         * 0.5).astype(ml_dtypes.bfloat16)
        pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (batch, seq))
        out["positions"] = np.stack([pos, pos // 2, pos % 4]).astype(np.int32)
    elif cfg.frontend == "audio_stub":
        out["frames"] = (rng.standard_normal((batch, cfg.encoder_seq,
                                              cfg.d_model)) * 0.5
                         ).astype(ml_dtypes.bfloat16)
        out["tokens"] = toks
    else:
        out["tokens"] = toks
    return out


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if np.issubdtype(np.asarray(a).dtype, np.floating)
                        or np.asarray(a).dtype == ml_dtypes.bfloat16
                        else np.asarray(a), tree)


def _jax_params(cfg, seed):
    return jax.tree.map(np.asarray, jax_shd.init_params(
        jax_model.param_specs(cfg), jax.random.PRNGKey(seed)))


# --- the routes of the bf16 MoE cases ----------------------------------------

def _calls_per_pass(cfg, remat) -> int:
    """How often a loss's value and gradient call each MoE layer's router:
    twice in a stacked family under remat (the forward, then its
    recompute in the backward), else once."""
    return 2 if cfg.family != "hybrid" and remat != "none" else 1


@contextlib.contextmanager
def _jax_routes(routes: list):
    """While open (at a step's first trace), the JAX ``_router`` also
    appends each call's ids to ``routes`` from inside the jitted step, in
    call order."""
    router = jax_moe._router

    def recorded(cfg, p, x2d):
        out = router(cfg, p, x2d)
        jax.debug.callback(lambda ids: routes.append(np.asarray(ids)),
                           out[1], ordered=True)
        return out
    with mock.patch.object(jax_moe, "_router", recorded):
        yield
    jax.effects_barrier()


def _forward_routes(routes: list, cfg, remat) -> list:
    """The JAX calls' ids -> one list per forward pass of the MoE layers'
    ids in layer order (each pass's first call of a layer)."""
    n = sum(map(cfg.layer_is_moe, range(cfg.num_layers)))
    per = n * _calls_per_pass(cfg, remat)
    assert routes and len(routes) % per == 0, (len(routes), per)
    return [routes[i:i + n] for i in range(0, len(routes), per)]


@contextlib.contextmanager
def _port_routed_by(passes: list, cfg, remat, margins: list):
    """While open, the port's ``_router`` routes by the JAX ids of
    ``passes`` (in the order the port runs its forward passes), with its
    own weights at those ids and its load-balance loss over them. Where
    its own top-k differs from them, the gap between its own k-th and
    (k+1)-th weights of that token goes to ``margins``: with the upstream
    layers routed alike, each such flip is a near-tie of its own."""
    router = moe._router
    per = _calls_per_pass(cfg, remat)
    layer_of, calls = {}, Counter()

    def routed(cfg_, p, x2d):
        m = cfg_.moe
        w, ids, aux = router(cfg_, p, x2d)
        key = p["router"].data_ptr()             # one view a layer
        layer = layer_of.setdefault(key, len(layer_of))
        want = torch.tensor(passes[calls[key] // per][layer]).long()
        probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
        if calls[key] % per == 0:
            with torch.no_grad():
                top = torch.sort(probs, dim=-1, descending=True)[0]
                differ = (torch.sort(ids, -1)[0]
                          != torch.sort(want, -1)[0]).any(-1)
                margins.extend((top[:, m.top_k - 1] - top[:, m.top_k])
                               [differ].tolist())
        calls[key] += 1
        w = torch.gather(probs, 1, want)
        ce = torch.mean(torch.nn.functional.one_hot(
            want[:, 0], m.n_experts).float(), dim=0)
        aux = dict(aux, lb_loss=m.n_experts * torch.sum(
            torch.mean(probs, dim=0) * ce))
        return w / torch.sum(w, dim=-1, keepdim=True), want, aux
    with mock.patch.object(moe, "_router", routed):
        yield
    assert set(calls.values()) == {len(passes) * per}, calls


def _loss_and_grads(name, seed, f32, remat="full"):
    """Both packages' loss, metrics and gradients, and the router margins
    of the routes the port took from the JAX package (bf16 MoE cases)."""
    jcfg, tcfg = _cfgs(name)
    jrun, trun = JaxRun(remat=remat), RunConfig(remat=remat)
    params = _jax_params(jcfg, seed)
    batch = _batch_np(jcfg, seed + 100)
    if f32:
        params, batch = _f32(params), _f32(batch)
    forced = not f32 and jcfg.moe is not None
    jroutes, margins = [], []
    jloss_fn = functools.partial(
        jax_encdec.loss_fn if jcfg.family == "encdec"
        else jax_transformer.loss_fn, jcfg, jrun, jax_mesh())
    with _jax_routes(jroutes) if forced else contextlib.nullcontext():
        (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            jloss_fn, has_aux=True))(params, batch)
    tparams = params_from_numpy(params, CPU)
    tbatch = params_from_numpy(batch, CPU)
    tloss_fn = trainer.model_loss_fn(tcfg, trun, make_host_mesh(device=CPU))
    routed = _port_routed_by(_forward_routes(jroutes, tcfg, remat), tcfg,
                             remat, margins) if forced \
        else contextlib.nullcontext()
    with routed:
        (ttotal, tmetrics), tgrads = trainer.value_and_grad(
            tloss_fn, tparams, tbatch)
    return ((float(jtotal), jmetrics, jgrads),
            (float(ttotal), tmetrics, tgrads), margins)


# --- the data stream ---------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=256, seq_len=16, global_batch=4),
    dict(vocab=64000, seq_len=32, global_batch=8, seed=3),
    dict(vocab=51865, seq_len=8, global_batch=6, host_index=1, host_count=3,
         pad_frac=0.2)], ids=["small", "yi-vocab", "hosts"])
def test_stream_batches_bit_for_bit_and_resume(kw):
    jstream = jax_pipe.SyntheticLMStream(jax_pipe.DataConfig(**kw))
    tstream = pipeline.SyntheticLMStream(pipeline.DataConfig(**kw))
    ji, ti = iter(jstream), iter(tstream)
    for _ in range(3):
        a, b = next(ji), next(ti)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    snap = tstream.checkpoint()
    assert snap == jstream.checkpoint() == {"step": 3}
    resumed = pipeline.SyntheticLMStream(pipeline.DataConfig(**kw))
    resumed.restore(snap)
    a, b = next(ji), next(iter(resumed))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    rj = jstream.reshard(0, 2 if kw["global_batch"] % 2 == 0 else 1)
    rt = resumed.reshard(0, 2 if kw["global_batch"] % 2 == 0 else 1)
    a, b = next(iter(rj)), next(iter(rt))
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_prefetch_iterator_and_make_stream():
    cfg = dict(vocab=128, seq_len=8, global_batch=2, prefetch=3)
    tit = pipeline.make_stream(pipeline.DataConfig(**cfg))
    jit_ = jax_pipe.make_stream(jax_pipe.DataConfig(**cfg))
    try:
        for _ in range(5):
            a, b = next(jit_), next(tit)
            assert all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        tit.close()
        jit_.close()


# --- int8 gradient compression -----------------------------------------------

@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_dequantize_bit_for_bit(scale):
    rng = np.random.default_rng(int(scale * 7) + 1)
    x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
    x[0, :4] = [0.5 * scale, -0.5 * scale, 0.0, scale]
    jq, js = jax_comp.quantize(jnp.asarray(x))
    tq, ts = compression.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.float32(js) == np.float32(ts.item())
    assert np.array_equal(np.asarray(jax_comp.dequantize(jq, js)),
                          compression.dequantize(tq, ts).numpy())


def test_compress_tree_with_error_feedback_bit_for_bit():
    rng = np.random.default_rng(0)
    jres = tres = None
    for step in range(3):
        grads = {"w": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
                 "b": {"x": rng.standard_normal(5).astype(np.float32),
                       "h": rng.standard_normal((4, 4)).astype(
                           ml_dtypes.bfloat16)}}
        jout, jres = jax_comp.compress_tree(jax.tree.map(jnp.asarray, grads),
                                            jres)
        tout, tres = compression.compress_tree(
            params_from_numpy(grads, CPU), tres)
        for jtree, ttree in ((jout, tout), (jres, tres)):
            got = _bits(ttree)
            for k, a in _bits(jax.tree.map(np.asarray, jtree)).items():
                assert a.dtype == got[k].dtype, (step, k)
                assert np.array_equal(a, got[k]), (step, k)
    assert compression.make_grad_transform(
        compression.CompressionConfig(enabled=False)) is None
    t = compression.make_grad_transform(compression.CompressionConfig(
        error_feedback=False))
    out, res = t(params_from_numpy({"g": np.ones(3, np.float32)}, CPU),
                 tres)
    assert torch.equal(out["g"], torch.ones(3))


# --- AdamW -------------------------------------------------------------------

def _close_leaf(got: torch.Tensor, want, what):
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        g = got.float().numpy()
        w = want.astype(np.float32)
        assert np.all(np.abs(g - w) <= 2 ** -8 * np.abs(w) + 1e-30), what
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=1e-9,
                                   err_msg=what)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10000, 20000])
def test_schedule_matches(step):
    cfg = optimizer.OptConfig()
    want = float(jax_opt.schedule(jax_opt.OptConfig(), jnp.int32(step)))
    got = optimizer.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got.item(), want, rtol=5e-7)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_on_the_same_grads(moments, clip):
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((16, 8)).astype(ml_dtypes.bfloat16),
              "s": {"scale": rng.standard_normal(8).astype(np.float32),
                    "m2": rng.standard_normal((3, 5)).astype(np.float32)}}
    jcfg = jax_opt.OptConfig(moment_dtype=moments, clip_norm=clip, warmup=2,
                             total_steps=6)
    tcfg = optimizer.OptConfig(moment_dtype=moments, clip_norm=clip,
                               warmup=2, total_steps=6)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax_opt.init_opt_state(jp, jcfg)
    tp = params_from_numpy(params, CPU)
    tstate = optimizer.init_opt_state(tp, tcfg)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.3)
                             .astype(a.dtype), params)
        jp, jstate, jm = jax_opt.adamw_update(
            jp, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        tp, tstate, tm = optimizer.adamw_update(
            tp, params_from_numpy(grads, CPU), tstate, tcfg)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=5e-7)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=5e-7)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for tree_t, tree_j in ((tp, jp), (tstate["m"], jstate["m"]),
                               (tstate["v"], jstate["v"])):
            jflat = _flat_raw(jax.tree.map(np.asarray, tree_j))
            for path, leaf in _flat_raw(tree_t).items():
                assert leaf.dtype == params_from_numpy(
                    {"x": jflat[path]}, CPU)["x"].dtype
                _close_leaf(leaf, jflat[path], (step, path))


def test_adamw_update_in_slices_changes_no_bit(monkeypatch):
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((9, 40)).astype(np.float32),
              "v": rng.standard_normal(100).astype(np.float32)}
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), params)
    cfg = optimizer.OptConfig(warmup=1)
    outs = []
    for slice_elems in (1 << 26, 64):
        monkeypatch.setattr(optimizer, "UPDATE_SLICE", slice_elems)
        tp = params_from_numpy(params, CPU)
        state = optimizer.init_opt_state(tp, cfg)
        for _ in range(2):
            tp, state, _ = optimizer.adamw_update(
                tp, params_from_numpy(grads, CPU), state, cfg)
        outs.append(_bits({"p": tp, "m": state["m"], "v": state["v"]}))
    assert all(np.array_equal(outs[0][k], outs[1][k]) for k in outs[0])


# --- checkpoints -------------------------------------------------------------

def _state_np(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(
        ml_dtypes.bfloat16), "b": rng.standard_normal(6).astype(np.float32)},
        "opt": {"m": {"w": np.zeros((4, 6), np.float32)},
                "step": np.array(7, np.int32)},
        "list": [np.arange(3, dtype=np.int32)]}


def test_checkpoint_written_by_the_port_restores_in_jax():
    state = _state_np(0)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 5, params_from_numpy(state, CPU), extra={"step": 5})
        tree, extra = jax_ckpt.restore(d)
        assert extra == {"step": 5} and jax_ckpt.latest_step(d) == 5
    got = _bits(tree)
    for k, a in _bits(state).items():
        assert np.array_equal(a, got[k]), k
    assert tree["params"]["w"].dtype == ml_dtypes.bfloat16


def test_checkpoint_written_by_jax_restores_in_the_port():
    state = _state_np(1)
    with tempfile.TemporaryDirectory() as d:
        jax_ckpt.save(d, 9, state, extra={"data_step": 11})
        tree, extra = ckpt.restore(d, device=CPU)
    assert extra == {"data_step": 11}
    assert tree["params"]["w"].dtype == torch.bfloat16
    assert tree["opt"]["step"].dtype == torch.int32
    got = _bits(tree)
    for k, a in _bits(state).items():
        assert np.array_equal(a, got[k]), k


def test_checkpoint_gc_latest_and_async_snapshot():
    with tempfile.TemporaryDirectory() as d:
        t = {"x": torch.zeros(4)}
        saver = ckpt.AsyncCheckpointer(d, keep=2)
        for step in range(1, 5):
            t["x"].fill_(step)
            saver.submit(step, t, extra={"step": step})
            saver.wait_idle()
            t["x"].fill_(-1.0)      # an in-place update after the submit
            saver._t.join(timeout=0.05)
        saver.close()
        assert ckpt.latest_step(d) == 4
        kept = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        assert len(kept) <= 2
        tree, extra = ckpt.restore(d, device=CPU)
        assert extra == {"step": 4}
        assert torch.equal(tree["x"], torch.full((4,), 4.0))
        with pytest.raises(FileNotFoundError):
            ckpt.restore(os.path.join(d, "none"), device=CPU)


# --- losses and gradients ----------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_loss_and_grads_match_jax_in_f32(name):
    (jl, jm, jg), (tl, tm, tg), _ = _loss_and_grads(name, 0, f32=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    _grads_close(tg, jg, GRAD_REL_L2, GRAD_FLOOR)


@pytest.mark.parametrize("name", TRAINED)
def test_loss_and_grads_match_jax_in_bf16(name):
    (jl, _, jg), (tl, _, tg), margins = _loss_and_grads(name, 1, f32=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert max(margins, default=0.0) <= FLIP_MARGIN, margins
    hybrid = _cfgs(name)[1].family == "hybrid"
    _grads_close(tg, jg, HYBRID_BF16_GRAD_REL_L2 if hybrid
                 else BF16_GRAD_REL_L2, BF16_GRAD_FLOOR)
    assert tg["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", TRAINED)
def test_remat_changes_no_value(name):
    """none, full and block give the same loss and gradients bit for bit
    (the recomputation repeats the same operations)."""
    outs = []
    _, tcfg = _cfgs(name)
    params = params_from_numpy(_jax_params(_cfgs(name)[0], 2), CPU)
    batch = params_from_numpy(_batch_np(tcfg, 3), CPU)
    for remat in transformer.REMAT_MODES:
        fn = trainer.model_loss_fn(tcfg, RunConfig(remat=remat),
                                   make_host_mesh(device=CPU))
        (total, _), grads = trainer.value_and_grad(fn, params, batch)
        outs.append((total, _bits(grads)))
    for total, grads in outs[1:]:
        assert torch.equal(total, outs[0][0])
        assert all(np.array_equal(a, grads[k]) for k, a in outs[0][1].items())
    with pytest.raises(ValueError, match="remat"):
        transformer.remat_call("some", lambda x: x, torch.ones(1))


# --- the train step ----------------------------------------------------------

def _train_bundles(name, micro):
    jarch, tarch = jax_get_arch(name), get_arch(name)
    jarch = dataclasses.replace(jarch, model=jarch.model.reduced(),
                                run_overrides={"t": JaxRun(microbatch=micro)})
    tarch = dataclasses.replace(tarch, model=tarch.model.reduced(),
                                run_overrides={"t": RunConfig(
                                    microbatch=micro)})
    jopt = jax_opt.OptConfig(warmup=2, total_steps=6)
    topt = optimizer.OptConfig(warmup=2, total_steps=6)
    jb = jax_model.make_step_bundle(jarch, JaxShape("t", SEQ, BATCH, "train"),
                                    jax_mesh(), opt_cfg=jopt)
    tb = tmodel.make_step_bundle(tarch, ShapeConfig("t", SEQ, BATCH, "train"),
                                 make_host_mesh(device=CPU), opt_cfg=topt)
    return jarch.model, jb, tb


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("name", TRAINED)
def test_train_step_matches_jax_for_three_steps(name, micro):
    cfg, jb, tb = _train_bundles(name, micro)
    assert tb.donate == (0, 1)
    params = _jax_params(cfg, 5)
    jstate = jax.tree.map(np.asarray, jax_opt.init_opt_state(
        params, jax_opt.OptConfig()))
    tparams = params_from_numpy(params, CPU)
    tstate = params_from_numpy(jstate, CPU)
    # on the mesh's replicated sharding, as the step returns them, so the
    # jitted step compiles once
    replicated = jax.sharding.NamedSharding(jax_mesh().mesh,
                                            jax.sharding.PartitionSpec())
    jparams, jstate = jax.device_put((params, jstate), replicated)
    jstep = jax.jit(jb.fn)
    forced, remat = cfg.moe is not None, RunConfig().remat
    jroutes, margins = [], []
    for step in range(3):
        batch = _batch_np(cfg, 10 + step)
        seen = len(jroutes)
        with _jax_routes(jroutes) if forced else contextlib.nullcontext():
            jparams, jstate, jm = jstep(jparams, jstate, batch)
        # the first step starts from one state: a flip there is a near-tie
        # of rounding; later ones also follow the parameters' differences
        routed = _port_routed_by(_forward_routes(jroutes[seen:], cfg, remat),
                                 cfg, remat, margins if step == 0 else []) \
            if forced else contextlib.nullcontext()
        with routed:
            tparams, tstate, tm = tb.fn(tparams, tstate,
                                        params_from_numpy(batch, CPU))
        assert set(tm) == set(jm)
        for k in ("loss", "total_loss", "grad_norm"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-2,
                                       err_msg=(step, k))
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=5e-7)
        assert tm["tokens"].item() == float(jm["tokens"])
    assert max(margins, default=0.0) <= FLIP_MARGIN, margins
    jflat, tflat = _flat(jax.tree.map(np.asarray, jparams)), _flat(tparams)
    agree = total = 0
    for k, w in jflat.items():
        g = tflat[k]
        agree += int(np.sum(np.abs(g - w) <= 2 ** -8 * np.abs(w) + 1e-6))
        total += w.size
    assert agree / total >= PARAM_AGREE, agree / total


def test_train_step_with_int8_compression_matches_jax():
    cfg, jb, tb = _train_bundles("yi-6b", 2)
    jarch = dataclasses.replace(jax_get_arch("yi-6b"), model=cfg,
                                run_overrides={"t": JaxRun(microbatch=2)})
    env = jax_mesh()
    jfn = jax_trainer.make_train_step(
        cfg, jarch.run_config("t"), env, jax_opt.OptConfig(warmup=2),
        grad_transform=lambda g: jax_comp.compress_tree(g)[0])
    tfn = trainer.make_train_step(
        get_arch("yi-6b").model.reduced(),
        RunConfig(microbatch=2), make_host_mesh(device=CPU),
        optimizer.OptConfig(warmup=2),
        grad_transform=lambda g: compression.compress_tree(g)[0])
    params = _jax_params(cfg, 6)
    jstate = jax.tree.map(np.asarray, jax_opt.init_opt_state(
        params, jax_opt.OptConfig()))
    batch = _batch_np(cfg, 20)
    _, _, jm = jax.jit(jfn)(jax.tree.map(jnp.asarray, params), jstate, batch)
    _, _, tm = tfn(params_from_numpy(params, CPU),
                   params_from_numpy(jstate, CPU),
                   params_from_numpy(batch, CPU))
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-2)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["yi-6b", "qwen2-vl-72b", "whisper-small",
                                  "mamba2-130m", *MOE_MODELS])
def test_train_bundle_specs_match_jax(name, moments):
    """The train bundle's inputs: parameters, the optimizer state (moments
    in the configured dtype, an int32 step) and the batch with targets."""
    jcfg, tcfg = _cfgs(name)
    jb = jax_model.make_step_bundle(
        dataclasses.replace(jax_get_arch(name), model=jcfg),
        JaxShape("t", SEQ, BATCH, "train"), jax_mesh(),
        opt_cfg=jax_opt.OptConfig(moment_dtype=moments))
    tb = tmodel.make_step_bundle(
        dataclasses.replace(get_arch(name), model=tcfg),
        ShapeConfig("t", SEQ, BATCH, "train"), make_host_mesh(device=CPU),
        opt_cfg=optimizer.OptConfig(moment_dtype=moments))
    assert tb.donate == jb.donate == (0, 1)
    for got, want in zip(tb.arg_specs, jb.arg_specs):
        got = {k: (s.shape, str(s.dtype).split(".")[-1], s.logical, s.init)
               for k, s in _flat_raw(got).items()}
        want = {k: (s.shape, np.dtype(s.dtype).name, s.logical, s.init)
                for k, s in _flat_raw(want).items()}
        assert got == want


def test_split_microbatches_cuts_mrope_positions_on_their_batch_axis():
    batch = {"embeds": torch.arange(4 * 3 * 2).reshape(4, 3, 2),
             "positions": torch.arange(3 * 4 * 3).reshape(3, 4, 3),
             "targets": torch.arange(12).reshape(4, 3)}
    parts = trainer._split_microbatches(batch, 2)
    jparts = jax_trainer._split_microbatches(
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 2)
    for i, part in enumerate(parts):
        for k, v in part.items():
            assert np.array_equal(v.numpy(), np.asarray(jparts[k][i]))
    assert parts[0]["positions"].shape == (3, 2, 3)


@pytest.mark.parametrize("name", MOE_MODELS)
def test_moe_and_hybrid_train_on_the_cpu(name):
    """The MoE and hybrid train bundles build as the dense ones do, with
    the run config's moment dtype (bf16 in Mixtral's and Jamba's
    ``train_4k``), and a step moves the parameters and reports the MoE
    losses summed over the layers."""
    arch = get_arch(name)
    arch = dataclasses.replace(arch, model=arch.model.reduced())
    run = arch.run_config("train_4k")
    tb = tmodel.make_step_bundle(arch, ShapeConfig("train_4k", SEQ, BATCH,
                                                   "train"),
                                 make_host_mesh(device=CPU))
    want = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        run.opt_moment_dtype]
    assert {s.dtype for s in shd.tree_leaves(tb.arg_specs[1]["m"])} == {want}
    params = params_from_numpy(_jax_params(_cfgs(name)[0], 8), CPU)
    state = optimizer.init_opt_state(params, optimizer.OptConfig(
        moment_dtype=run.opt_moment_dtype))
    before = {k: v.clone() for k, v in _flat_raw(params).items()}
    params, state, m = tb.fn(params, state, params_from_numpy(
        _batch_np(arch.model, 31), CPU))
    assert all(torch.isfinite(v) for v in m.values())
    assert float(m["lb_loss"]) > 0.0 and float(m["z_loss"]) > 0.0
    assert int(state["step"]) == 1
    assert {v.dtype for v in shd.tree_leaves(state["m"])} == {want}
    moved = [k for k, v in _flat_raw(params).items()
             if not torch.equal(before[k], v)]
    assert any("/moe/" in k for k in moved) and len(moved) > len(before) // 2


def test_ssm_trains_on_the_cpu():
    cfg, jb, tb = _train_bundles("mamba2-130m", 2)
    params = params_from_numpy(_jax_params(cfg, 7), CPU)
    state = optimizer.init_opt_state(params, optimizer.OptConfig())
    before = {k: v.clone() for k, v in _flat_raw(params).items()}
    params, state, m = tb.fn(params, state, params_from_numpy(
        _batch_np(cfg, 30), CPU))
    assert torch.isfinite(m["loss"]) and int(state["step"]) == 1
    assert any(not torch.equal(before[k], v)
               for k, v in _flat_raw(params).items())
