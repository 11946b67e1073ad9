"""Mixture-of-Experts: token-choice top-k routing with a per-expert capacity
and gather dispatch.

The JAX package's ``repro.models.moe`` with its names, shapes and dtype
flow. Two modes of ``apply_moe``:

* ``"gather"``, the model path: each batch row's assignments are sorted by
  expert, cut to a static capacity C = ``capacity(S, E, k, cf)`` slots an
  expert, gathered into one ``[E, B*C, d]`` tensor and run through three
  grouped products (``torch.bmm``, bf16 on bf16 weights). Dispatch and
  combine are group-local: no token crosses its batch row, as in the JAX
  package's per-row ``vmap``.
* ``"dense"``, the exact reference of the tests: every expert over every
  token, weighted by the top-k-masked router weights.

On its one-device host mesh the JAX package takes its ``shard_map``
branch, which computes the same function as its plain gather branch (its
``psum``/``pmean`` run over axes of size one); the port has the one gather
path. None of this is a Pallas kernel there, so none is a hand-written
kernel here: the products are the library's, as the JAX package leaves
its einsums to XLA.

Three places where PyTorch differs from jnp, handled here:

* ``jax.lax.top_k`` puts the lower expert first on equal weights (a zero
  input row gives an exact tie); ``torch.topk`` promises no order, so the
  router takes a stable descending sort cut to k.
* ``.at[slot].set(..., mode="drop")`` drops out-of-range slots where
  ``scatter_`` would raise: a dropped assignment is scattered into one
  extra column that is then cut off, so no slot is read back from the
  device.
* ``.at[idx].add`` sums a token's k contributions in slot order, which is
  ascending expert order. ``index_add_`` on CUDA adds with atomics, whose
  order changes from run to run. The combine inverts the slot map to
  ``[B, S, k]`` and adds the k terms in ascending slot order, so two runs
  agree bit for bit and the f32 sum order is the reference's. Where the
  reference adds a missing slot into a pad row of its output, the combine
  reads a zero row after the expert outputs, so a non-finite expert row
  stays with its own token.

Training differentiates the gather path through two
``torch.autograd.Function``s, whose forwards are the serving ops
themselves, so a step routes and sums as a prefill does:

* ``_Dispatch`` gathers the token rows; its backward adds each token's up
  to k slot gradients in ascending slot order, k gathers into zeros (the
  reference's ``.at[idx].add``), and drops the pad row's. Autograd's own
  backward of ``index_select`` is ``index_add_``, which adds a token's
  slots with atomics on CUDA.
* ``_Combine`` reads the expert outputs and their zero row; its backward
  gives each slot row the one gated gradient of the token column that
  reads it (a copy to unique rows) and each gate a row dot product, and
  drops the zero row's and a missing column's.

``bmm(..., out=)`` into the buffer with the zero row is taken only where
autograd records nothing (serving); under grad the expert outputs come
from a plain ``bmm`` and are copied above the zero row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import MeshEnv, ParamSpec
from repro_torch.models.layers import activation

MODES = ("gather", "dense")


def moe_specs(cfg: ModelConfig, prefix_layers: tuple = ()) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.n_experts
    lyr = tuple("layers" for _ in prefix_layers)
    dt = torch.bfloat16
    out = {
        "router": ParamSpec((*prefix_layers, d, e), torch.float32,
                            lyr + ("embed", None)),
        "wi": ParamSpec((*prefix_layers, e, d, f), dt,
                        lyr + (None, "fsdp_row", "expert_ff")),
        "wo": ParamSpec((*prefix_layers, e, f, d), dt,
                        lyr + (None, "expert_ff", "fsdp_row")),
    }
    if cfg.glu:
        out["wg"] = ParamSpec((*prefix_layers, e, d, f), dt,
                              lyr + (None, "fsdp_row", "expert_ff"))
    return out


def capacity(tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    """Slots an expert per group: ceil(tokens k cf / E), rounded up to a
    multiple of 8, at least 8."""
    c = int(math.ceil(tokens * top_k * cf / n_experts))
    return max(8, int(math.ceil(c / 8)) * 8)


def _router(cfg: ModelConfig, p: dict, x2d: torch.Tensor):
    """x2d: [T, d] -> (weights [T,k] f32, ids [T,k] int64, aux losses)."""
    m = cfg.moe
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m.top_k], ids[:, :m.top_k]
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # load-balance aux (Switch-style) + router z-loss
    me = torch.mean(probs, dim=0)                                 # [E]
    ce = torch.mean(F.one_hot(ids[:, 0], m.n_experts).float(), dim=0)
    lb_loss = m.n_experts * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return w, ids, {"lb_loss": lb_loss, "z_loss": z_loss}


def _records_grad(*tensors) -> bool:
    """Whether autograd records a gradient through an op on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _first_of_run(sorted_rows: torch.Tensor) -> torch.Tensor:
    """Per row of a sorted [B, n] tensor, the index of each element's first
    equal element (``searchsorted(..., side="left")`` of the row on
    itself)."""
    return torch.searchsorted(sorted_rows, sorted_rows, side="left")


def _scatter_kept(n: int, dest: torch.Tensor, src: torch.Tensor,
                  fill) -> torch.Tensor:
    """A [B, n] tensor of ``fill`` with ``src`` scattered to ``dest`` [B, m]
    along each row; ``dest == n`` drops the element (the JAX
    ``mode="drop"``)."""
    out = torch.full((dest.shape[0], n + 1), fill, dtype=src.dtype,
                     device=dest.device)
    return out.scatter_(1, dest, src)[:, :n]


def _token_slots(k: int, tg: int, idx: torch.Tensor):
    """The slot map inverted: idx [B, E*C] (the token in each slot, ``tg``
    for an empty one) -> (``inv`` [B, tg*k], each token's slots in
    ascending order, ``has`` [B, tg*k], which of those k exist)."""
    # sort the slot map by token (stable); the rank among the token's
    # slots gives its column in [tg, k]
    stok, sslot = torch.sort(idx, dim=-1, stable=True)
    rank = torch.arange(idx.shape[1], device=idx.device) - _first_of_run(stok)
    valid = stok < tg
    dest = torch.where(valid, stok * k + rank, tg * k)
    return (_scatter_kept(tg * k, dest, sslot, 0),
            _scatter_kept(tg * k, dest, valid, False))


def _slot_rows(c: int, inv: torch.Tensor) -> torch.Tensor:
    """Slots ``inv`` [B, n] of each batch row -> their rows in the
    expert-major [E*B*C] layout of ``_dispatch_group``."""
    b = inv.shape[0]
    return (inv // c) * (b * c) + \
        torch.arange(b, device=inv.device).view(b, 1) * c + inv % c


def _gather_tokens(x: torch.Tensor, idx: torch.Tensor, c: int):
    """x [B, tg, d] -> xe [E, B*C, d], slot ``e*C + j`` of batch row ``b``
    at row ``b*C + j`` of expert ``e`` (the pad row for an empty slot)."""
    b, tg, d = x.shape
    e = idx.shape[1] // c
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    rows = idx.view(b, e, c).transpose(0, 1) + \
        (torch.arange(b, device=x.device) * (tg + 1)).view(1, b, 1)
    xe = x_pad.reshape(b * (tg + 1), d).index_select(0, rows.reshape(-1))
    return xe.view(e, b * c, d)


class _Dispatch(torch.autograd.Function):
    """``_gather_tokens`` with its backward in slot order."""

    @staticmethod
    def forward(ctx, x, idx, c: int, k: int):
        ctx.save_for_backward(idx)
        ctx.c, ctx.k, ctx.x_shape = c, k, x.shape
        return _gather_tokens(x, idx, c)

    @staticmethod
    def backward(ctx, dxe):
        (idx,) = ctx.saved_tensors
        b, tg, d = ctx.x_shape
        inv, has = _token_slots(ctx.k, tg, idx)
        rows = _slot_rows(ctx.c, inv).view(b * tg, ctx.k).T
        has = has.reshape(b * tg, ctx.k).T
        safe = torch.where(has, rows, 0)
        src = dxe.reshape(-1, d)
        dx = torch.zeros((b * tg, d), dtype=dxe.dtype, device=dxe.device)
        for j in range(ctx.k):
            # a missing slot adds nothing: where, not a product with 0, so
            # a non-finite row of another token stays out
            dx += torch.where(has[j, :, None], src.index_select(0, safe[j]),
                              0)
        return dx.view(b, tg, d), None, None, None


def _dispatch_group(m, tg: int, c: int, d: int, x: torch.Tensor,
                    w: torch.Tensor, ids: torch.Tensor):
    """Group-local capacity dispatch of each batch row.

    x: [B, tg, d]; w, ids: [B, tg, k]. Returns ``xe`` [E, B*C, d], expert
    by expert (row ``b*C + j`` of expert ``e`` is slot ``e*C + j`` of batch
    row ``b``), and, as the JAX package lays them out a row, ``idx`` [B, E*C]
    (the token in each slot, ``tg`` for an empty slot), ``gate`` [B, E*C]
    f32 and ``kept`` [B], the assignments that found a slot."""
    b, k, e = x.shape[0], m.top_k, m.n_experts
    n = tg * k
    se, order = torch.sort(ids.reshape(b, n), dim=-1, stable=True)
    stok = order // k                          # assignment -> its token
    sw = torch.gather(w.reshape(b, n), 1, order)
    pos = torch.arange(n, device=x.device) - _first_of_run(se)
    keep = pos < c
    slot = torch.where(keep, se * c + pos, e * c)
    idx = _scatter_kept(e * c, slot, stok, tg)
    gate = _scatter_kept(e * c, slot, sw.float(), 0.0)
    xe = _Dispatch.apply(x, idx, c, k) if _records_grad(x) \
        else _gather_tokens(x, idx, c)
    return xe, idx, gate, keep.sum(dim=-1)


def _expert_ffn(cfg: ModelConfig, p: dict, xe: torch.Tensor,
                out: torch.Tensor = None) -> torch.Tensor:
    """xe: [E, R, d] -> [E, R, d] through each expert's FFN, in the dtype
    jnp's promotion gives (bf16 on bf16 weights), into ``out`` if given."""
    dt = torch.promote_types(xe.dtype, p["wi"].dtype)
    xe = xe.to(dt)
    h = torch.bmm(xe, p["wi"].to(dt))
    if cfg.glu:
        g = torch.bmm(xe, p["wg"].to(dt))
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    return torch.bmm(h, p["wo"].to(dt), out=out)


def _combine_rows(ye_rows: torch.Tensor, gate: torch.Tensor,
                  idx: torch.Tensor, k: int, tg: int, c: int):
    """The combine: y [B, tg, d] f32 and what its backward reads (the gates
    ``g`` [B, tg, k, 1], the rows ``rows`` [k, B*tg] each token column
    reads, the slot map's inverse ``inv`` and ``has``)."""
    b, d = idx.shape[0], ye_rows.shape[1]
    inv, has = _token_slots(k, tg, idx)
    g = torch.gather(gate, 1, inv).view(b, tg, k, 1)
    # a column with no slot reads the zero row, so it adds 0 and a
    # non-finite expert row reaches no other token (0 x NaN is NaN; the
    # JAX package adds a missing slot into a pad row that it cuts off)
    rows = torch.where(has, _slot_rows(c, inv), ye_rows.shape[0] - 1)
    rows = rows.view(b * tg, k).T.contiguous()            # [k, B*tg]
    y = torch.zeros((b, tg, d), dtype=torch.float32, device=ye_rows.device)
    for j in range(k):
        # bf16 rows times the f32 gate: one f32 product, exact widening
        y += ye_rows.index_select(0, rows[j]).view(b, tg, d) * g[:, :, j]
    return y, (g, rows, inv, has)


class _Combine(torch.autograd.Function):
    """``_combine_rows`` with its backward to unique rows."""

    @staticmethod
    def forward(ctx, ye_rows, gate, idx, k: int, tg: int, c: int):
        y, saved = _combine_rows(ye_rows, gate, idx, k, tg, c)
        ctx.save_for_backward(ye_rows, *saved)
        ctx.slots = idx.shape[1]
        return y

    @staticmethod
    def backward(ctx, dy):
        ye_rows, g, rows, inv, has = ctx.saved_tensors
        b, tg, k, _ = g.shape
        dy = dy.reshape(b * tg, -1)
        g = g.view(b * tg, k)
        d_rows = torch.zeros_like(ye_rows)
        d_g = torch.empty((b * tg, k), dtype=torch.float32, device=dy.device)
        for j in range(k):
            # each slot row is read by at most one column: a copy to unique
            # rows (the missing columns all land on the zero row, cleared
            # below), rounded to the rows' dtype as autograd's product does
            d_rows.index_copy_(0, rows[j], (dy * g[:, j:j + 1]).to(
                d_rows.dtype))
            d_g[:, j] = torch.sum(dy * ye_rows.index_select(0, rows[j]),
                                  dim=-1)
        d_rows[-1].zero_()
        # each column's gate gradient to its slot; a missing column's to a
        # column that is cut off
        dest = torch.where(has, inv, ctx.slots)
        d_gate = _scatter_kept(ctx.slots, dest, d_g.view(b, tg * k), 0.0)
        return d_rows, d_gate, None, None, None, None


def _combine_group(m, tg: int, c: int, d: int, ye_rows: torch.Tensor,
                   idx: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """ye_rows [E*B*C + 1, d]: the expert outputs in ``_dispatch_group``'s
    layout, expert by expert, then one zero row; idx/gate [B, E*C] -> y
    [B, tg, d] f32: each token's gated expert outputs, added to zeros in
    ascending slot order without atomics, one slot column at a time (no
    [B, tg, k, d] temporary)."""
    if _records_grad(ye_rows, gate):
        return _Combine.apply(ye_rows, gate, idx, m.top_k, tg, c)
    return _combine_rows(ye_rows, gate, idx, m.top_k, tg, c)[0]


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, env: MeshEnv,
              mode: str = "gather"):
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, aux): ``lb_loss`` and
    ``z_loss``, and in gather mode ``dropped_frac``, the share of
    assignments that found no slot."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    w, ids, aux = _router(cfg, p, x2d)

    if mode == "dense":
        mask = torch.zeros((t, m.n_experts), dtype=torch.float32,
                           device=x.device).scatter_(1, ids, w)
        ye = _expert_ffn(cfg, p, x2d.expand(m.n_experts, t, d))
        y = torch.einsum("etd,te->td", ye.float(), mask)
        return y.reshape(b, s, d).to(x.dtype), aux

    c = capacity(s, m.n_experts, m.top_k, m.capacity_factor)
    xe, idx, gate, kept = _dispatch_group(
        m, s, c, d, x, w.view(b, s, m.top_k), ids.view(b, s, m.top_k))
    # the expert outputs and one zero row after them, for the combine
    rows = b * c * m.n_experts
    if _records_grad(x, *p.values()):
        # autograd takes no out=: the products, then a copy above the row
        ye = _expert_ffn(cfg, p, xe).view(rows, d)
        ye_rows = torch.cat([ye, ye.new_zeros(1, d)])
    else:
        ye_rows = torch.empty((rows + 1, d), device=x.device, dtype=
                              torch.promote_types(xe.dtype, p["wo"].dtype))
        ye_rows[rows:].zero_()
        _expert_ffn(cfg, p, xe,
                    out=ye_rows[:rows].view(m.n_experts, b * c, d))
    y = _combine_group(m, s, c, d, ye_rows, idx, gate)
    aux["dropped_frac"] = 1.0 - torch.sum(kept) / (t * m.top_k)
    return y.to(x.dtype), aux


__all__ = ["MODES", "moe_specs", "capacity", "apply_moe"]
