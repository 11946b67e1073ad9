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
  agree bit for bit and the f32 sum order is the reference's.
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
    x_pad = torch.cat([x, x.new_zeros(b, 1, d)], dim=1)
    rows = idx.view(b, e, c).transpose(0, 1) + \
        (torch.arange(b, device=x.device) * (tg + 1)).view(1, b, 1)
    xe = x_pad.reshape(b * (tg + 1), d).index_select(0, rows.reshape(-1))
    return xe.view(e, b * c, d), idx, gate, keep.sum(dim=-1)


def _expert_ffn(cfg: ModelConfig, p: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe: [E, R, d] -> [E, R, d] through each expert's FFN, in the dtype
    jnp's promotion gives (bf16 on bf16 weights)."""
    dt = torch.promote_types(xe.dtype, p["wi"].dtype)
    xe = xe.to(dt)
    h = torch.bmm(xe, p["wi"].to(dt))
    if cfg.glu:
        g = torch.bmm(xe, p["wg"].to(dt))
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    return torch.bmm(h, p["wo"].to(dt))


def _combine_group(m, tg: int, c: int, d: int, ye: torch.Tensor,
                   idx: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """ye [E, B*C, d] (``_dispatch_group``'s layout), idx/gate [B, E*C] ->
    y [B, tg, d] f32: each token's gated expert outputs, added to zeros in
    ascending slot order without atomics, one slot column at a time (no
    [B, tg, k, d] temporary)."""
    b, k = idx.shape[0], m.top_k
    # each token's slots, ascending: sort the slot map by token (stable);
    # the rank among the token's slots gives its column in [tg, k]
    stok, sslot = torch.sort(idx, dim=-1, stable=True)
    rank = torch.arange(idx.shape[1], device=idx.device) - _first_of_run(stok)
    valid = stok < tg
    dest = torch.where(valid, stok * k + rank, tg * k)
    inv = _scatter_kept(tg * k, dest, sslot, 0)           # [B, tg*k] slots
    has = _scatter_kept(tg * k, dest, valid, False)
    # a column with no slot reads slot 0 with a zero gate: it adds 0 for a
    # finite row
    g = torch.where(has, torch.gather(gate, 1, inv), 0.0).view(b, tg, k, 1)
    rows = (inv // c) * (b * c) + \
        torch.arange(b, device=idx.device).view(b, 1) * c + inv % c
    rows = rows.view(b * tg, k).T.contiguous()            # [k, B*tg]
    ye2d = ye.reshape(-1, d)
    y = torch.zeros((b, tg, d), dtype=torch.float32, device=ye.device)
    for j in range(k):
        # bf16 rows times the f32 gate: one f32 product, exact widening
        y += ye2d.index_select(0, rows[j]).view(b, tg, d) * g[:, :, j]
    return y


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
    ye = _expert_ffn(cfg, p, xe)
    y = _combine_group(m, s, c, d, ye, idx, gate)
    aux["dropped_frac"] = 1.0 - torch.sum(kept) / (t * m.top_k)
    return y.to(x.dtype), aux


__all__ = ["MODES", "moe_specs", "capacity", "apply_moe"]
