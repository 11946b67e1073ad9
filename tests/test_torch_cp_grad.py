"""The gradient of attention at a query offset and of context-parallel
prefill: the port against the JAX package, on the CPU.

* The gradient of ``models.attention.blocked_attention`` at a query
  offset (a chunk of 16 queries at offsets 0, 16 and 48 of a 64-long
  sequence, against the K/V of the whole sequence), causal with and
  without a window of 24, f32 and bf16, for a seeded output gradient,
  against ``jax.vjp`` of the JAX ``blocked_attention(q_offset=...)`` on
  the same numpy inputs. ``kernels.flash_attention_bwd.plain`` (what the
  card holds the backward kernel to) is held to the same ``jax.vjp`` on
  the inputs widened to f32. Tolerances: f32 rtol 1e-4 / atol 1e-5 (the
  order of the f32 sums only); bf16 two units in the last place (rtol
  2^-6, atol 1e-3): both frameworks compute in f32 and round the
  gradient once to bf16, after sums in other orders.
* The gradient, with respect to every parameter, of a fixed seeded
  projection of the last-position logits of ``cp_prefill`` (reduced
  Yi-6B, f32) at 1, 2 and 4 sequence shards, against ``jax.grad`` of the
  JAX ``cp_prefill`` on a 1 x 1 host mesh in this process and on 1 x 2
  and 1 x 4 host meshes, which run in one subprocess with four host
  devices (JAX fixes its device count when it starts). The parameters
  carry across by ``params_from_numpy``. Tolerance: each leaf rtol 1e-4 /
  atol 1e-5 of its largest element (f32 sums in other orders).
* ``chip_smoke.cp_grad_layers``, which sizes the smoke's cut for the
  gradient through ``cp_prefill`` on ``meta``: the saved bytes it counts
  grow linearly with the layers, and it picks the most that fit.
"""
import dataclasses
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
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models.context_parallel import cp_prefill as jax_cp_prefill
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention
from repro_torch.models.context_parallel import cp_prefill
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -6, atol=1e-3)
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
S, CHUNK = 64, 16
SEQ, BATCH, SEED = 32, 2, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(offset, dtype):
    """The chunk's q [2, 16, 4, 16], k and v of the whole sequence [2, 64,
    2, 16] and the output gradient [2, 16, 4, 16], seeded numpy arrays
    rounded to ``dtype``, as f32 numpy."""
    rng = np.random.default_rng(21 + offset)
    shapes = ((2, CHUNK, 4, 16), (2, S, 2, 16), (2, S, 2, 16),
              (2, CHUNK, 4, 16))
    return [np.array(jnp.asarray(rng.standard_normal(s).astype(
        np.float32)).astype(JAX_DT[dtype]).astype(jnp.float32))
        for s in shapes]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("offset", [0, 16, 48])
def test_blocked_attention_gradient_at_an_offset_matches_jax_vjp(
        offset, window, dtype):
    q, k, v, do = _inputs(offset, dtype)

    @jax.jit
    def jax_vjp(q_, k_, v_, do_):
        return jax.vjp(lambda *a: jax_attn.blocked_attention(
            *a, causal=True, window=window, block_q=8, block_kv=8,
            mode="full", q_offset=offset), q_, k_, v_)[1](do_)
    want = jax_vjp(*(jnp.asarray(a).astype(JAX_DT[dtype])
                     for a in (q, k, v, do)))

    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_()
                  for a in (q, k, v))
    ops.reset_launch_counts()
    out = attention.blocked_attention(tq, tk, tv, causal=True, window=window,
                                      q_offset=offset)
    out.backward(torch.from_numpy(do).to(tdt))
    assert sum(ops.launch_counts().values()) == 0
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(w), **tol)

    # the card's reference for the backward kernel, in f32 on the same
    # (rounded) values
    want32 = jax_vjp(*(jnp.asarray(a) for a in (q, k, v, do)))
    got32 = fab.plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                      torch.from_numpy(do).to(tdt), causal=True,
                      window=window, q_offset=offset)
    for got, w in zip(got32, want32):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(w), **F32_TOL)


def _cfgs():
    return (jax_get_arch("yi-6b").model.reduced(),
            get_arch("yi-6b").model.reduced())


def _jax_inputs(jcfg):
    """The JAX parameters (from ``SEED``, f32), tokens [BATCH, SEQ] and the
    projection of the last-position logits [vocab]."""
    params = jax_shd.init_params(jax_model.param_specs(jcfg),
                                 jax.random.PRNGKey(SEED))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(SEED + 1)
    toks = jnp.asarray(rng.integers(0, jcfg.vocab, (BATCH, SEQ)).astype(
        np.int32))
    proj = jnp.asarray(rng.standard_normal(jcfg.vocab).astype(np.float32))
    return params, toks, proj


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# jax.grad of the JAX cp_prefill's projected logits on 1 x 2 and 1 x 4
# host meshes, in a process with four host devices; every leaf written to
# an npz under "shards/path"
_SUBPROCESS = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.configs.base import RunConfig
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.models import model
    from repro.models.context_parallel import cp_prefill
    seed, batch, seq, out = json.loads(sys.argv[1])
    assert jax.device_count() == 4, jax.devices()
    cfg = get_arch("yi-6b").model.reduced()
    params = shd.init_params(model.param_specs(cfg), jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(seed + 1)
    toks = jnp.asarray(rng.integers(0, cfg.vocab, (batch, seq))
                       .astype(np.int32))
    proj = jnp.asarray(rng.standard_normal(cfg.vocab).astype(np.float32))
    res = {}
    for n in (2, 4):
        mesh = make_host_mesh(1, n)
        def loss(p):
            logits = cp_prefill(cfg, RunConfig(), mesh, p, toks, block_q=8,
                                block_kv=8)
            return jnp.sum(logits[:, -1, :] * proj)
        grads = jax.jit(jax.grad(loss))(params)
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            res[f"{n}/{name}"] = np.asarray(leaf, np.float32)
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def jax_mesh_grads(tmp_path_factory):
    """{"shards/path": gradient} of the JAX cp_prefill on 1 x 2 and 1 x 4
    host meshes."""
    out = tmp_path_factory.mktemp("cp_grad") / "grads.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    arg = f"[{SEED}, {BATCH}, {SEQ}, \"{out}\"]"
    run = subprocess.run([sys.executable, "-c", _SUBPROCESS, arg], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _port_grads(tcfg, params, toks, proj, n):
    """{path: gradient} of the port's cp_prefill at ``n`` shards."""
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), CPU)
    leaves = shd.tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_()
    env = make_host_mesh(device=CPU)
    run = ArchConfig(model=tcfg).run_config("x")
    logits = cp_prefill(tcfg, run, env, tparams,
                        params_from_numpy(np.asarray(toks), CPU),
                        seq_shards=n)
    assert tuple(logits.shape) == (BATCH, 1, tcfg.vocab)
    loss = (logits[:, -1, :] * torch.from_numpy(np.asarray(proj))).sum()
    loss.backward()
    return {k: v.grad for k, v in _flat(tparams).items()}


def _leaves_close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[name] is not None, (what, name)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(_np(got[name]), w, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] * max(scale, 1.0),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_cp_prefill_gradient_matches_jax_grad(n, jax_mesh_grads):
    jcfg, tcfg = _cfgs()
    params, toks, proj = _jax_inputs(jcfg)
    got = _port_grads(tcfg, params, toks, proj, n)
    assert all(torch.isfinite(g).all() for g in got.values())
    if n == 1:
        def loss(p):
            logits = jax_cp_prefill(jcfg, JaxRun(), jax_mesh(), p, toks,
                                    block_q=8, block_kv=8)
            return jnp.sum(logits[:, -1, :] * proj)
        want = _flat(jax.jit(jax.grad(loss))(params))
    else:
        want = {k.split("/", 1)[1]: v for k, v in jax_mesh_grads.items()
                if k.startswith(f"{n}/")}
    _leaves_close(got, want, f"cp_prefill gradient at {n} shards")


def test_smoke_sizes_the_cp_gradient_cut_on_meta():
    """``chip_smoke.cp_grad_layers`` sizes phase 7f(d)'s cut from the bytes
    autograd keeps for the backward of the cp prefill traced on ``meta``
    (``cp_grad_bytes``), which grow by the same amount with every layer,
    as the sizing assumes; it picks the most layers whose bytes, with two
    sets of parameter gradients, fit the budget."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    arch = dataclasses.replace(get_arch("yi-6b"), model=_cfgs()[1])
    counts = [chip_smoke.cp_grad_bytes(arch, n, BATCH, SEQ, 4)
              for n in (1, 2, 3)]
    (s1, p1), (s2, p2), (s3, p3) = counts
    assert s3 - s2 == s2 - s1 > 0 and p3 - p2 == p2 - p1 > 0

    def need(n):
        return s1 + (n - 1) * (s2 - s1) + 2 * (p1 + (n - 1) * (p2 - p1))
    card = (need(3) + need(4)) / 2 / chip_smoke.CP_GRAD_CARD_SHARE
    layers, got_need, budget = chip_smoke.cp_grad_layers(
        arch, BATCH, SEQ, 4, held=0, card=card)
    assert (layers, got_need) == (3, need(3)) and need(4) > budget
