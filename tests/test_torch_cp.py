"""Context-parallel prefill and attention at a query offset: the port
against the JAX package, on the CPU.

* ``models.attention.blocked_attention`` at a query offset (a chunk of 16
  queries at offsets 0, 16 and 48 of a 64-long sequence, against the K/V
  of the whole sequence), causal with and without a window of 24, f32 and
  bf16, against the JAX ``blocked_attention(q_offset=...)`` and against
  the matching rows of the JAX Pallas ``flash_attention`` on the whole
  sequence in interpret mode. Tolerances: f32 rtol 1e-4 / atol 1e-5 (the
  order of the f32 sums only); bf16 one unit in the last place (rtol
  2^-7), as ``tests/test_torch_attention.py`` holds attention outputs.
* ``models.context_parallel.cp_prefill`` at 1, 2 and 4 sequence shards
  against the JAX ``cp_prefill`` on a 1 x 1 host mesh in this process, and
  at 2 and 4 shards against the JAX ``cp_prefill`` on 1 x 2 and 1 x 4 host
  meshes, which run in one subprocess with four host devices (JAX fixes
  its device count when it starts). Tolerances as
  ``tests/test_torch_dense.py``: f32 rtol 1e-4 / atol 1e-5; with bf16
  parameters 0.1 max abs and 3% relative L2 on the logits.
* ``chip_smoke.shape_work``, the work a kernel's bound is taken from,
  counts the (query, key) pairs a key's masks and offset leave visible:
  a brute-force count over the mask, exactly.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import RunConfig as JaxRun
from repro.distributed import sharding as jax_shd
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models.context_parallel import cp_prefill as jax_cp_prefill
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention
from repro_torch.models import model as tmodel
from repro_torch.models.context_parallel import cp_prefill
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
ULP_TOL = dict(rtol=2 ** -7, atol=1e-6)
BF16_ATOL, BF16_REL_L2 = 0.1, 0.03
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
S, CHUNK = 64, 16
# reduced Yi-6B (GQA, RoPE), and the same with a 16-position window
CONFIGS = {"yi-6b": {}, "window": {"sliding_window": 16}}
SEQ, BATCH, SEED = 32, 2, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(dtype):
    """q, k, v of the whole sequence ([2, 64, 4 or 2 heads, 16]), as JAX
    arrays and port tensors of ``dtype``."""
    rng = np.random.default_rng(11)
    out = []
    for heads in (4, 2, 2):
        j = jnp.asarray(rng.standard_normal((2, S, heads, 16)).astype(
            np.float32)).astype(JAX_DT[dtype])
        out.append((j, params_from_numpy(np.asarray(j), CPU)))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("offset", [0, 16, 48])
def test_blocked_attention_at_an_offset_matches_jax_and_pallas_rows(
        offset, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(dtype)
    rows = slice(offset, offset + CHUNK)
    ops.reset_launch_counts()
    got = attention.blocked_attention(tq[:, rows], tk, tv, causal=True,
                                      window=window, q_offset=offset)
    assert ops.launch_counts()["flash_attention"] == 0
    assert got.dtype == tq.dtype and tuple(got.shape) == (2, CHUNK, 4, 16)
    tol = F32_TOL if dtype == "f32" else ULP_TOL
    want = jax_attn.blocked_attention(jq[:, rows], jk, jv, causal=True,
                                      window=window, block_q=8, block_kv=8,
                                      mode="full", q_offset=offset)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    whole = pallas_flash(jq, jk, jv, causal=True, window=window, block_q=16,
                         block_kv=16, interpret=True)
    np.testing.assert_allclose(_np(got), _np(whole[:, rows]), **tol)


def _cfgs(name):
    return (dataclasses.replace(jax_get_arch("yi-6b").model.reduced(),
                                **CONFIGS[name]),
            dataclasses.replace(get_arch("yi-6b").model.reduced(),
                                **CONFIGS[name]))


def _jax_inputs(jcfg, f32: bool):
    """The JAX parameters (from ``SEED``; all f32 or the specs' bf16) and
    tokens [BATCH, SEQ]."""
    params = jax_shd.init_params(jax_model.param_specs(jcfg),
                                 jax.random.PRNGKey(SEED))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(SEED + 1)
    toks = jnp.asarray(rng.integers(0, jcfg.vocab, (BATCH, SEQ)).astype(
        np.int32))
    return params, toks


def _close(got, want, f32: bool):
    got, want = _np(got), _np(want)
    if f32:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


# the JAX cp_prefill on 1 x 2 and 1 x 4 host meshes, for every config and
# dtype, in a process with four host devices; logits written to a JSON
_SUBPROCESS = textwrap.dedent("""
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.configs.base import RunConfig
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.models import model
    from repro.models.context_parallel import cp_prefill
    configs, seed, batch, seq, out = json.loads(sys.argv[1])
    assert jax.device_count() == 4, jax.devices()
    res = {}
    for name, kw in configs.items():
        cfg = dataclasses.replace(get_arch("yi-6b").model.reduced(), **kw)
        for dt in ("f32", "bf16"):
            params = shd.init_params(model.param_specs(cfg),
                                     jax.random.PRNGKey(seed))
            if dt == "f32":
                params = jax.tree.map(lambda a: a.astype(jnp.float32),
                                      params)
            rng = np.random.default_rng(seed + 1)
            toks = jnp.asarray(rng.integers(0, cfg.vocab, (batch, seq))
                               .astype(np.int32))
            for n in (2, 4):
                logits = cp_prefill(cfg, RunConfig(), make_host_mesh(1, n),
                                    params, toks, block_q=8, block_kv=8)
                res[f"{name}/{dt}/{n}"] = np.asarray(
                    logits, np.float32).tolist()
    with open(out, "w") as f:
        json.dump(res, f)
""")


@pytest.fixture(scope="module")
def jax_meshes(tmp_path_factory):
    """{"config/dtype/shards": logits} of the JAX cp_prefill on 1 x 2 and
    1 x 4 host meshes."""
    out = tmp_path_factory.mktemp("cp") / "logits.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([CONFIGS, SEED, BATCH, SEQ, str(out)])
    run = subprocess.run([sys.executable, "-c", _SUBPROCESS, arg], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    return {k: np.asarray(v, np.float32)
            for k, v in json.loads(out.read_text()).items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cp_prefill_matches_jax_at_every_shard_count(name, dtype,
                                                     jax_meshes):
    f32 = dtype == "f32"
    jcfg, tcfg = _cfgs(name)
    params, toks = _jax_inputs(jcfg, f32)
    want = jax_cp_prefill(jcfg, JaxRun(), jax_mesh(), params, toks,
                          block_q=8, block_kv=8)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    ttoks = params_from_numpy(np.asarray(toks), CPU)
    env = make_host_mesh(device=CPU)
    run = ArchConfig(model=tcfg).run_config("x")
    for n in (1, 2, 4):
        got = cp_prefill(tcfg, run, env, tparams, ttoks, seq_shards=n)
        assert tuple(got.shape) == (BATCH, 1, tcfg.vocab), n
        _close(got, want, f32)
        if n > 1:
            _close(got, jax_meshes[f"{name}/{dtype}/{n}"], f32)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_bundle_takes_its_shards_and_matches_the_ordinary_prefill(n):
    """``make_step_bundle(attn_mode="cp", seq_shards=n)`` runs
    ``cp_prefill`` over n shards: in f32 its logits match the ordinary
    prefill (the same function, the projections over other row blocks)."""
    jcfg, tcfg = _cfgs("window")
    params, toks = _jax_inputs(jcfg, True)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    batch = {"tokens": params_from_numpy(np.asarray(toks), CPU)}
    env = make_host_mesh(device=CPU)
    arch, shape = ArchConfig(model=tcfg), ShapeConfig("x", SEQ, BATCH,
                                                      "prefill")
    cp = tmodel.make_step_bundle(arch, shape, env, attn_mode="cp",
                                 seq_shards=n)
    plain = tmodel.make_step_bundle(arch, shape, env)
    _close(cp.fn(tparams, batch), plain.fn(tparams, batch), True)


def test_cp_prefill_refuses_what_it_does_not_cover():
    _, tcfg = _cfgs("yi-6b")
    env = make_host_mesh(device=CPU)
    run = ArchConfig(model=tcfg).run_config("x")
    toks = torch.zeros((1, 30), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not divide"):
        cp_prefill(tcfg, run, env, {}, toks, seq_shards=4)
    mamba = get_arch("mamba2-130m").model.reduced()
    with pytest.raises(ValueError, match="dense family"):
        cp_prefill(mamba, run, env, {}, toks, seq_shards=1)


@pytest.mark.parametrize("sq,sk,off", [(64, 64, 0), (16, 64, 48),
                                       (100, 300, 200), (40, 100, 0),
                                       (64, 256, 192), (7, 9, 5)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 24)])
def test_smoke_bound_counts_the_visible_pairs(sq, sk, off, causal, window):
    """``chip_smoke.shape_work`` of a ``flash_attention`` key counts the
    (query, key) pairs its masks leave visible, with the query offset and
    the window: a brute-force count over the mask."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    qpos = np.arange(sq)[:, None] + off
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    pairs = int(mask.sum())
    assert chip_smoke.visible_pairs(sq, sk, causal, window, off) == pairs
    key = (2, sq, sk, 4, 2, 16, causal, window, off, torch.bfloat16)
    flops, nbytes = chip_smoke.shape_work("flash_attention", key)
    assert flops == 4.0 * 16 * pairs * 4 * 2
    assert nbytes == 2.0 * 2 * 16 * (2 * sq * 4 + 2 * sk * 2)
