"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

Inputs are drawn with numpy from a seed (parameters with the JAX
package's own init) and carried into both packages. What is held exactly:
``capacity``; the router's expert ids, the top-k order of an exact tie (a
zero input row) included; the dispatch's slot map ``idx``, its gates and
its kept count; the gathered ``[E, C, d]`` rows. The router's weights are
held to rtol 1e-5 (atol 1e-7): XLA and PyTorch compute the f32 product and
``exp`` with different orders and polynomials, so the two differ by a few
f32 ulps (2e-7 measured), and the losses likewise to rtol 1e-5. The
combine's f32 sum is held to 1e-6 (the port adds a token's terms in the
reference's slot order and agrees bit for bit on these inputs).

``apply_moe`` is held against the JAX ``apply_moe`` (under ``jax.jit``) on
its 1 x 1 host mesh (which takes its ``shard_map`` branch in gather mode)
over a ``(b, s, E, k)`` grid with k up to 3 and E up to 16, at the
config's capacity factor of 1.25, so some cases drop assignments; the
same assignments are kept. With f32 parameters: rtol 1e-4,
atol 1e-5. With the bf16 parameters and a bf16 input, the two round some
bf16 products one ulp apart: over 12 seeds of the grid, in both modes, the
outputs (up to 3.4) came within 0.03125 max abs and 0.53% relative L2,
so they are held to 0.0625 and 1%.

The last tests are the port's own counterparts of ``tests/test_moe.py``:
gather equals dense at a capacity that drops nothing, dropped tokens pass
through as zero, and no token crosses its batch row.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.distributed import sharding as jax_shd
from repro.launch.mesh import make_host_mesh as jax_mesh
from repro.models import moe as jax_moe
from repro_torch.configs import get_arch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models.model import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
F32_TOL = dict(rtol=1e-4, atol=1e-5)
ROUTER_TOL = dict(rtol=1e-5, atol=1e-7)
BF16_ATOL, BF16_REL_L2 = 0.0625, 0.01
GRID = [(1, 8, 4, 1), (2, 16, 8, 2), (3, 8, 16, 3), (2, 32, 16, 2),
        (4, 16, 8, 3), (2, 64, 16, 3)]


def _cfgs(n_experts=8, top_k=2, cf=1.25):
    """The reduced Mixtral config (d 64, expert width 128, SiLU GLU) of
    both packages with the given routing."""
    return tuple(dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, n_experts=n_experts, top_k=top_k, capacity_factor=cf))
        for c in (jax_get_arch("mixtral-8x22b").model.reduced(),
                  get_arch("mixtral-8x22b").model.reduced()))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _params(jcfg, seed, f32: bool):
    """The JAX MoE parameters (f32-cast on request) and the port's copy."""
    params = jax_shd.init_params(jax_moe.moe_specs(jcfg),
                                 jax.random.PRNGKey(seed))
    if f32:
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return params, params_from_numpy(jax.tree.map(np.asarray, params), CPU)


def _x(shape, seed, dtype):
    """A normal input in ``dtype`` for JAX and the same bits for the port."""
    jx = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                     .astype(np.float32)).astype(dtype)
    return jx, params_from_numpy(np.asarray(jx), CPU)


def _routes(rng, b, s, e, k, skew: bool):
    """Distinct expert ids per token [b, s, k] and weights; ``skew`` sends
    every token to expert 0 first, so expert 0 overflows its capacity."""
    ids = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)])
                    for _ in range(b)]).astype(np.int32)
    if skew:
        ids = np.stack([np.stack([np.r_[0, rng.permutation(e - 1)[:k - 1]
                                        + 1] for _ in range(s)])
                        for _ in range(b)]).astype(np.int32)
    w = rng.random((b, s, k)).astype(np.float32)
    return ids, w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("cf", [1e-6, 0.5, 1.0, 1.25, 8.0])
def test_capacity_matches_jax(cf):
    for tokens in (1, 7, 8, 100, 256, 4096):
        for e in (4, 8, 16, 128):
            for k in (1, 2, 3, 8):
                assert moe.capacity(tokens, e, k, cf) == \
                    jax_moe.capacity(tokens, e, k, cf)


@pytest.mark.parametrize("t,e,k", [(40, 8, 2), (64, 16, 3), (33, 128, 8)])
def test_router_matches_jax(t, e, k):
    """Ids exactly (a zero row is an exact tie: the lower ids first), the
    weights and the losses to a few f32 ulps."""
    jcfg, tcfg = _cfgs(e, k)
    rng = np.random.default_rng(t + e)
    x = rng.standard_normal((t, jcfg.d_model)).astype(np.float32)
    x[3] = 0.0
    router = (rng.standard_normal((jcfg.d_model, e)) / 8).astype(np.float32)
    jw, jids, jaux = jax_moe._router(jcfg, {"router": jnp.asarray(router)},
                                     jnp.asarray(x))
    tw, tids, taux = moe._router(tcfg, {"router": torch.from_numpy(router)},
                                 torch.from_numpy(x))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert tids[3].tolist() == list(range(k))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **ROUTER_TOL)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5)


@pytest.mark.parametrize("skew", [False, True], ids=["spread", "skewed"])
@pytest.mark.parametrize("cf", [8.0, 1.0], ids=["high", "dropping"])
@pytest.mark.parametrize("b,s,e,k", [(2, 20, 16, 3), (3, 64, 8, 2)])
def test_dispatch_and_combine_match_jax(b, s, e, k, cf, skew):
    """The slot map, gates, kept count and gathered rows exactly, each
    batch row as the JAX ``_dispatch_group`` under ``vmap``; then the
    combine of the same expert outputs in f32."""
    jcfg, tcfg = _cfgs(e, k, cf)
    d = jcfg.d_model
    c = moe.capacity(s, e, k, cf)
    rng = np.random.default_rng(b * s + e)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    ids, w = _routes(rng, b, s, e, k, skew)
    jxe, jidx, jgate, jkept = jax.vmap(
        lambda xr, wr, ir: jax_moe._dispatch_group(jcfg.moe, s, c, d, xr, wr,
                                                   ir))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(ids))
    txe, tidx, tgate, tkept = moe._dispatch_group(
        tcfg.moe, s, c, d, torch.from_numpy(x), torch.from_numpy(w),
        torch.from_numpy(ids).long())
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(
        txe.view(e, b, c, d).transpose(0, 1).numpy(), np.asarray(jxe))
    if cf == 1.0 and skew:
        assert int(tkept.sum()) < b * s * k            # this case drops
    ye = rng.standard_normal((b, e, c, d)).astype(np.float32)
    want = jax.vmap(lambda yr, ir, gr: jax_moe._combine_group(
        jcfg.moe, s, c, d, yr, ir, gr))(jnp.asarray(ye), jidx, jgate)
    got = moe._combine_group(
        tcfg.moe, s, c, d,
        _with_zero_row(torch.from_numpy(ye).transpose(0, 1)), tidx, tgate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _with_zero_row(ye):
    """Expert outputs [E, B*C, d] as the combine reads them: [E*B*C, d] and
    one zero row after."""
    rows = ye.reshape(-1, ye.shape[-1])
    return torch.cat([rows, rows.new_zeros(1, rows.shape[1])])


@pytest.mark.parametrize("mode", ["gather", "dense"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,e,k", GRID)
def test_apply_moe_matches_jax(b, s, e, k, f32, mode):
    jcfg, tcfg = _cfgs(e, k)
    params, tparams = _params(jcfg, seed=b + s + e + k, f32=f32)
    jx, tx = _x((b, s, jcfg.d_model), b * s,
                jnp.float32 if f32 else jnp.bfloat16)
    want, jaux = jax.jit(lambda p, x: jax_moe.apply_moe(
        jcfg, p, x, jax_mesh(), mode=mode))(params, jx)
    got, taux = moe.apply_moe(tcfg, tparams, tx, make_host_mesh(device=CPU),
                              mode=mode)
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, s, jcfg.d_model)
    assert sorted(taux) == sorted(jaux)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5)
    if mode == "gather":      # the same assignments kept (jit rounds the
        n = b * s * k         # f32 share 1 - kept / n its own way)
        assert round((1 - float(taux["dropped_frac"])) * n) == \
            round((1 - float(jaux["dropped_frac"])) * n)
    got, want = _np(got), _np(want)
    if f32:
        np.testing.assert_allclose(got, want, **F32_TOL)
        return
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    assert np.linalg.norm(got - want) <= BF16_REL_L2 * np.linalg.norm(want)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,e,k", [(1, 8, 4, 1), (2, 16, 8, 2),
                                     (3, 8, 8, 3), (4, 16, 4, 2),
                                     (2, 32, 16, 3)])
def test_gather_matches_dense_at_high_capacity(b, s, e, k, f32):
    """At ``capacity_factor = E / k`` every expert has a slot for every
    token, nothing drops, and gather computes what dense does: in f32 up to
    the order of the sums, in bf16 within tests/test_moe.py's 0.06."""
    jcfg, tcfg = _cfgs(e, k, cf=e / k)
    _, tparams = _params(jcfg, seed=0, f32=f32)
    _, x = _x((b, s, tcfg.d_model), b * 100 + s,
              jnp.float32 if f32 else jnp.bfloat16)
    env = make_host_mesh(device=CPU)
    yg, aux = moe.apply_moe(tcfg, tparams, x, env, mode="gather")
    yd, _ = moe.apply_moe(tcfg, tparams, x, env, mode="dense")
    assert float(aux["dropped_frac"]) == 0.0
    np.testing.assert_allclose(_np(yg), _np(yd),
                               **(F32_TOL if f32 else dict(atol=0.06)))


def test_dropped_tokens_pass_through_as_zero():
    """At capacity factor ~0 (8 slots an expert) most assignments drop;
    a token that lost all its slots comes out as zero."""
    jcfg, tcfg = _cfgs(cf=1e-6)
    _, tparams = _params(jcfg, seed=0, f32=False)
    _, x = _x((2, 256, tcfg.d_model), 1, jnp.bfloat16)
    y, aux = moe.apply_moe(tcfg, tparams, x, make_host_mesh(device=CPU))
    assert float(aux["dropped_frac"]) > 0.4
    assert bool(torch.isfinite(y.float()).all())
    zero_rows = (y == 0).all(-1)
    assert 0 < int(zero_rows.sum()) < 512


def test_group_isolation():
    """Changing batch row 1's tokens changes nothing in row 0's outputs."""
    jcfg, tcfg = _cfgs()
    _, tparams = _params(jcfg, seed=0, f32=False)
    _, x1 = _x((2, 16, tcfg.d_model), 2, jnp.bfloat16)
    x2 = x1.clone()
    x2[1] = _x((16, tcfg.d_model), 3, jnp.bfloat16)[1]
    env = make_host_mesh(device=CPU)
    y1, _ = moe.apply_moe(tcfg, tparams, x1, env)
    y2, _ = moe.apply_moe(tcfg, tparams, x2, env)
    assert torch.equal(y1[0], y2[0])
    assert not torch.equal(y1[1], y2[1])


def test_moe_specs_match_jax():
    for name in ("qwen3-moe-30b-a3b", "mixtral-8x22b"):
        jcfg, tcfg = jax_get_arch(name).model, get_arch(name).model
        for prefix in ((), (tcfg.num_layers,)):
            tspecs = moe.moe_specs(tcfg, prefix)
            jspecs = jax_moe.moe_specs(jcfg, prefix)
            assert sorted(tspecs) == sorted(jspecs)
            for k, s in tspecs.items():
                j = jspecs[k]
                assert (s.shape, str(s.dtype).removeprefix("torch."),
                        s.logical, s.init, s.scale) == \
                    (j.shape, jnp.dtype(j.dtype).name, j.logical, j.init,
                     j.scale)


def test_apply_moe_refuses_an_unknown_mode():
    jcfg, tcfg = _cfgs()
    _, tparams = _params(jcfg, seed=0, f32=True)
    with pytest.raises(ValueError, match="mode"):
        moe.apply_moe(tcfg, tparams, torch.zeros(1, 8, tcfg.d_model),
                      make_host_mesh(device=CPU), mode="shardmap")


def _combine_before_the_nan_repair(m, tg, c, d, ye, idx, gate):
    """The combine as it was before a missing slot read a zero row (a
    column with no slot read slot 0's row with a zero gate, and the expert
    outputs came as [E, B*C, d]): the oracle the repaired combine must
    equal bit for bit on finite rows."""
    b, k = idx.shape[0], m.top_k
    stok, sslot = torch.sort(idx, dim=-1, stable=True)
    rank = torch.arange(idx.shape[1]) - moe._first_of_run(stok)
    valid = stok < tg
    dest = torch.where(valid, stok * k + rank, tg * k)
    inv = moe._scatter_kept(tg * k, dest, sslot, 0)
    has = moe._scatter_kept(tg * k, dest, valid, False)
    g = torch.where(has, torch.gather(gate, 1, inv), 0.0).view(b, tg, k, 1)
    rows = (inv // c) * (b * c) + torch.arange(b).view(b, 1) * c + inv % c
    rows = rows.view(b * tg, k).T.contiguous()
    ye2d = ye.reshape(-1, d)
    y = torch.zeros((b, tg, d), dtype=torch.float32)
    for j in range(k):
        y += ye2d.index_select(0, rows[j]).view(b, tg, d) * g[:, :, j]
    return y


# the probe of a non-finite expert row: reduced Mixtral (8 experts, top-2)
# over 1 x 32 tokens at capacity factor 0.25, 8 slots an expert, so that
# 8 of the 64 assignments find no slot
PROBE_B, PROBE_S, PROBE_CF = 1, 32, 0.25


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf],
                         ids=["nan", "inf", "-inf"])
def test_a_non_finite_expert_row_stays_with_its_token(bad):
    """One non-finite element in the output row of expert 0's slot 0 of
    batch row 0: the tokens it reaches, and every output, equal the JAX
    ``apply_moe``'s (which adds a missing slot into a pad row it cuts off),
    f32 parameters."""
    jcfg, tcfg = _cfgs(cf=PROBE_CF)
    params, tparams = _params(jcfg, seed=0, f32=True)
    jx, tx = _x((PROBE_B, PROBE_S, jcfg.d_model), 0, jnp.float32)
    jcombine, tcombine = jax_moe._combine_group, moe._combine_group

    def jax_poisoned(m, tg, c, d, ye_row, idx_row, gate_row):
        return jcombine(m, tg, c, d, ye_row.at[0, 0, 0].set(bad), idx_row,
                        gate_row)

    def port_poisoned(m, tg, c, d, ye_rows, idx, gate):
        ye_rows = ye_rows.clone()
        ye_rows[0, 0] = bad                   # expert 0, batch row 0, slot 0
        return tcombine(m, tg, c, d, ye_rows, idx, gate)
    with mock.patch.object(jax_moe, "_combine_group", jax_poisoned):
        want, jaux = jax.jit(lambda p, x: jax_moe.apply_moe(
            jcfg, p, x, jax_mesh()))(params, jx)
    with mock.patch.object(moe, "_combine_group", port_poisoned):
        got, taux = moe.apply_moe(tcfg, tparams, tx,
                                  make_host_mesh(device=CPU))
    n = PROBE_B * PROBE_S * jcfg.moe.top_k
    kept = round((1 - float(taux["dropped_frac"])) * n)
    assert kept == round((1 - float(jaux["dropped_frac"])) * n) == 56
    got, want = _np(got)[0], _np(want)[0]
    reached = ~np.isfinite(want).all(-1)
    assert reached.sum() == 1             # the token held in that slot
    np.testing.assert_array_equal(~np.isfinite(got).all(-1), reached)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **F32_TOL)


@pytest.mark.parametrize("cf", [1e-6, 0.25, 1.0, 8.0])
@pytest.mark.parametrize("b,s,e,k", [(1, 32, 8, 2), (3, 64, 8, 2),
                                     (2, 40, 16, 3)])
def test_combine_is_bit_equal_to_the_one_before_the_nan_repair(b, s, e, k,
                                                               cf):
    """On finite bf16 expert rows the repaired combine equals the earlier
    one bit for bit, at capacities that drop most, some and no
    assignments."""
    _, tcfg = _cfgs(e, k, cf)
    d = tcfg.d_model
    c = moe.capacity(s, e, k, cf)
    rng = np.random.default_rng(b * s + e + k)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    ids, w = _routes(rng, b, s, e, k, skew=False)
    _, idx, gate, kept = moe._dispatch_group(
        tcfg.moe, s, c, d, x, torch.from_numpy(w),
        torch.from_numpy(ids).long())
    ye = torch.from_numpy(rng.standard_normal((e, b * c, d))
                          .astype(np.float32)).to(torch.bfloat16)
    got = moe._combine_group(tcfg.moe, s, c, d, _with_zero_row(ye), idx, gate)
    want = _combine_before_the_nan_repair(tcfg.moe, s, c, d, ye, idx, gate)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if cf < 1.0:
        assert int(kept.sum()) < b * s * k


# --- the gather path's gradients -------------------------------------------

def _tracked(tparams, tx):
    """The port's parameters and input as leaves that autograd tracks."""
    return ({k: v.detach().clone().requires_grad_() for k, v in
             tparams.items()}, tx.detach().clone().requires_grad_())


@pytest.mark.parametrize("cf", [1e-6, 1.0, 8.0], ids=["most", "some", "none"])
def test_gather_gradients_match_jax_vjp(cf):
    """The gather path's gradients (x, router, wi, wg, wo) against
    ``jax.vjp`` of the JAX ``apply_moe`` on its host mesh, f32 parameters,
    under one random output cotangent and the loss weights of the aux
    losses (0.01 and 0.001, as ``loss_fn``): 2 x 64 tokens, 8 experts,
    top-2, at capacity factors that drop most (8 slots an expert), some
    and none of the assignments."""
    jcfg, tcfg = _cfgs(cf=cf)
    params, tparams = _params(jcfg, seed=3, f32=True)
    jx, tx = _x((2, 64, jcfg.d_model), 4, jnp.float32)
    dy = np.random.default_rng(5).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    aux_ct = {"lb_loss": np.float32(0.01), "z_loss": np.float32(0.001),
              "dropped_frac": np.float32(0.0)}

    def vjp(p, x):
        (y, aux), back = jax.vjp(
            lambda p_, x_: jax_moe.apply_moe(jcfg, p_, x_, jax_mesh()), p, x)
        return aux, back((jnp.asarray(dy), aux_ct))
    jaux, (jgp, jgx) = jax.jit(vjp)(params, jx)
    tparams, tx = _tracked(tparams, tx)
    y, taux = moe.apply_moe(tcfg, tparams, tx, make_host_mesh(device=CPU))
    (torch.sum(y * torch.from_numpy(dy)) + 0.01 * taux["lb_loss"]
     + 0.001 * taux["z_loss"]).backward()
    n = 2 * 64 * jcfg.moe.top_k
    kept = round((1 - float(taux["dropped_frac"])) * n)
    assert kept == round((1 - float(jaux["dropped_frac"])) * n)
    assert (kept <= n // 2) if cf < 1.0 else (n // 2 < kept < n) \
        if cf == 1.0 else kept == n
    for k, g in jgp.items():
        np.testing.assert_allclose(tparams[k].grad.numpy(), np.asarray(g),
                                   err_msg=k, **F32_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **F32_TOL)


@pytest.mark.parametrize("cf", [1e-6, 1.0, 8.0], ids=["most", "some", "none"])
def test_dispatch_backward_is_the_slot_ordered_sum(cf):
    """The dispatch's gradient of each token is its slots' gradient rows
    added in ascending slot order in bf16, the reference's ``.at[idx].add``
    order, bit for bit: here against that sum written out slot by slot
    (3 x 40 bf16 tokens, 16 experts, top-3); the pad row's is dropped."""
    b, s, e, k = 3, 40, 16, 3
    _, tcfg = _cfgs(e, k, cf)
    d = tcfg.d_model
    c = moe.capacity(s, e, k, cf)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_()
    ids, w = _routes(rng, b, s, e, k, skew=False)
    xe, idx, _, kept = moe._dispatch_group(
        tcfg.moe, s, c, d, x, torch.from_numpy(w),
        torch.from_numpy(ids).long())
    dxe = torch.from_numpy(rng.standard_normal(xe.shape).astype(np.float32)
                           ).to(torch.bfloat16)
    xe.backward(dxe)
    want = torch.zeros((b, s, d), dtype=torch.bfloat16)
    rows = dxe.view(e, b, c, d)
    for slot in range(e * c):                  # ascending slot order
        for row in range(b):
            tok = int(idx[row, slot])
            if tok < s:
                want[row, tok] = want[row, tok] + rows[slot // c, row,
                                                       slot % c]
    assert torch.equal(x.grad.view(torch.int16), want.view(torch.int16))
    assert (int(kept.sum()) < b * s * k) == (cf < 8.0)


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
def test_a_non_finite_expert_row_leaves_the_other_gradients_finite(bad):
    """Under grad, the probe of ``test_a_non_finite_expert_row_stays_with_
    its_token``: one non-finite element in expert 0's first slot row of
    the output (so in the gate gradient of that slot), and one in the
    same slot's row of the dispatch's incoming gradient. Only the token in
    that slot gets a non-finite input gradient; the tokens that lost an
    assignment, whose missing columns read the zero row, stay finite; the
    gradients equal ``jax.vjp`` of the JAX ``apply_moe`` with the output
    row poisoned the same way."""
    jcfg, tcfg = _cfgs(cf=PROBE_CF)
    params, tparams = _params(jcfg, seed=0, f32=True)
    jx, tx = _x((PROBE_B, PROBE_S, jcfg.d_model), 0, jnp.float32)
    dy = np.random.default_rng(1).standard_normal(
        (PROBE_B, PROBE_S, jcfg.d_model)).astype(np.float32)
    jcombine, tcombine, tdispatch = (jax_moe._combine_group,
                                     moe._combine_group, moe._dispatch_group)
    held = []

    def jax_poisoned(m, tg, c, d, ye_row, idx_row, gate_row):
        return jcombine(m, tg, c, d, ye_row.at[0, 0, 0].set(bad), idx_row,
                        gate_row)

    def port_poisoned(m, tg, c, d, ye_rows, idx, gate):
        ye_rows = ye_rows.clone()
        ye_rows[0, 0] = bad                   # expert 0, batch row 0, slot 0
        held.append(int(idx[0, 0]))
        return tcombine(m, tg, c, d, ye_rows, idx, gate)

    def poison(g):
        g = g.clone()
        g[0, 0] = bad                         # expert 0, batch row 0, slot 0
        return g

    def grad_poisoned(*a):
        xe, *rest = tdispatch(*a)
        if poison_grad:
            xe.register_hook(poison)
        return (xe, *rest)

    def vjp(p, x):
        (y, aux), back = jax.vjp(
            lambda p_, x_: jax_moe.apply_moe(jcfg, p_, x_, jax_mesh()), p, x)
        return back((jnp.asarray(dy), {k: jnp.zeros_like(v)
                                       for k, v in aux.items()}))
    with mock.patch.object(jax_moe, "_combine_group", jax_poisoned):
        jgp, jgx = jax.jit(vjp)(params, jx)
    grads = []
    for poison_grad in (False, True):
        tp, x = _tracked(tparams, tx)
        with mock.patch.object(moe, "_combine_group", port_poisoned), \
                mock.patch.object(moe, "_dispatch_group", grad_poisoned):
            y, _ = moe.apply_moe(tcfg, tp, x, make_host_mesh(device=CPU))
        torch.sum(y * torch.from_numpy(dy)).backward()
        grads.append((tp, x.grad.numpy()[0]))
    token = held[0]
    for tp, gx in grads:
        bad_rows = ~np.isfinite(gx).all(-1)
        assert bad_rows[token] and bad_rows.sum() == 1
    (tp, gx), (_, gx2) = grads
    np.testing.assert_array_equal(np.isnan(gx), np.isnan(np.asarray(jgx)[0]))
    np.testing.assert_allclose(gx, np.asarray(jgx)[0], equal_nan=True,
                               **F32_TOL)
    for k, g in jgp.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(g),
                                   equal_nan=True, err_msg=k, **F32_TOL)
    np.testing.assert_array_equal(np.delete(gx2, token, 0),
                                  np.delete(gx, token, 0))
