"""ssd_scan_bwd: dx, ddt, da, db, dc and dd of ``ssd_scan`` given dy.

The CUDA source is ``csrc/ssd_scan_bwd.cu`` (nine launches a call, f32
in and out, the dense products on the tensor cores as 3xTF32, no
atomics; its header states each term of the gradient, what bounds it and
how the work is split). It replaces no
Pallas kernel: the JAX package differentiates ``models/ssm.ssd_chunked``
with ``jax.value_and_grad``. ``ssd_scan_bwd`` launches it on CUDA tensors
from what the forward kernel left in its workspace; ``plain`` is autograd
of ``ssd_scan.passes`` in f32, which ``chip_smoke.py`` holds the kernel
against; ``backward_passes`` states the kernel's own decomposition in
plain PyTorch, for the tests.

Save or recompute: ``SSDScan.forward`` saves L [B,H,S], exp(L_Q)
[B,H,nc], S_in [B,H,nc,N,P] and C B^T [B,nc,Q64,Q64], which the forward
kernel computes anyway (about 60 MB a layer at 2 x 4096 for Mamba-2,
held only while the layer's backward is pending: under remat one layer's
at a time), and its output y (which the gated norm's product saves
too). Recomputing them would repeat three of the forward's four launches
in every backward.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import (MAX_N, MAX_P, MAX_Q, TILE,
                                          chunk_len, chunk_outputs,
                                          chunk_states, passes,
                                          state_passing)

_ARGTYPES = [ctypes.c_void_p] * 26 + [ctypes.c_int] * 8 + \
    [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
# the sums over heads (dG and the head terms of dC and dB) run in this
# many groups of heads at most, each group's part summed in group order
# (the .cu refuses more)
GROUPS = 8

# launches since the last reset, by the forward's key (B, S, H, P, N, Q);
# one call is nine CUDA launches
launches: Counter = Counter()


def head_group(h: int) -> int:
    """Heads of a group: ceil(H / GROUPS), so that the sums over heads run
    on GROUPS times the blocks at any H (8 groups of 3 heads at Mamba-2's
    24, of 16 at Jamba's 128; 25 heads make 7 groups of 4)."""
    return -(-h // GROUPS)


def _group_sum(t, hg: int):
    """t [B,H,...] summed over heads within each group of ``hg`` heads,
    then the groups' parts in order: the kernel's order of the sum over
    H."""
    parts = [t[:, h0:h0 + hg].sum(1) for h0 in range(0, t.shape[1], hg)]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


# ---- the plain versions ---------------------------------------------------

def plain(dy, x, dt, a, b, c, d_skip, *, chunk: int = 256):
    """(dx, ddt, da, db, dc, dd) in f32: autograd of ``ssd_scan.passes``
    on the inputs widened to f32, for the output gradient ``dy``."""
    with torch.enable_grad():
        ins = tuple(t.detach().float().requires_grad_()
                    for t in (x, dt, a, b, c, d_skip))
        y, _ = passes(*ins, chunk=chunk)
        return torch.autograd.grad(y, ins, dy.float())


def reverse_state_passing(decay, e):
    """The reverse of pass 2. decay [B,H,nc], E [B,H,nc,N,P] (each chunk's
    sum of exp(L_i) C_i (x) dy_i). Walks the chunks from the last:
    dS[c] = running; running = exp(L_Q^c) running + E_c, from zero (the
    final state is no output). Returns dS [B,H,nc,N,P], the gradient of
    the state leaving each chunk."""
    run = torch.zeros_like(e[:, :, 0])
    out = [None] * e.shape[2]
    for ci in reversed(range(e.shape[2])):
        out[ci] = run
        run = decay[:, :, ci, None, None] * run + e[:, :, ci]
    return torch.stack(out, dim=2)


def backward_passes(dy, x, dt, a, b, c, d_skip, *, chunk: int = 256):
    """The kernel's decomposition in plain PyTorch, f32. Per (batch, head,
    chunk of Q), L = cumsum(dt a), M_ij = C_i.B_j exp(L_i - L_j) dt_j
    (j <= i), w_j = exp(L_Q - L_j) dt_j:

    1. E_c = sum_i exp(L_i) C_i (x) dy_i, per chunk in parallel;
    2. dS by ``reverse_state_passing``;
    3. per head, over a chunk's columns j: u_j = B_j dS_c and v_j =
       sum_{i>=j} C_i.B_j exp(L_i - L_j) dy_i; dx_j = dt_j v_j + w_j u_j
       + d dy_j, K_j = v_j . x_j and T_j = exp(L_Q - L_j) u_j . x_j (the
       direct dt_j terms of M and of the state update);
    4. dG_ij = sum_h exp(L_i - L_j) dt_j (dy_i . x_j), summed within
       each group of ``head_group(H)`` heads, then the groups' parts in
       order;
    5. the head terms sum_h exp(L_i) S_in dy_i (of dc) and sum_h w_j dS_c
       x_j (of db), summed the same way; dc_i = that + sum_{j<=i} dG_ij
       B_j and db_j = that + sum_{i>=j} dG_ij C_i;
    6. dL_i = dy_i . (y_i - d x_i) - dt_i (K_i + T_i), plus exp(L_Q)
       <S_in, dS_c> + sum_j dt_j T_j at i = Q - 1; d(dt a) is its reverse
       cumsum in the chunk; ddt = a d(dt a) + K + T, da = sum dt d(dt a)
       and dd = sum dy . x over batch and steps.

    Returns (dx [B,S,H,P], ddt [B,S,H], da [H], db [B,S,N], dc [B,S,N],
    dd [H])."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    lcum, decay, dstate = chunk_states(x, dt, a, b, chunk)
    s_in, _ = state_passing(decay, dstate)
    y = chunk_outputs(x, dt, b, c, d_skip, lcum, s_in)
    nc, q = lcum.shape[2], lcum.shape[3]
    xr = x.float().reshape(bsz, nc, q, h, p)
    dyr = dy.float().reshape(bsz, nc, q, h, p)
    yr = y.reshape(bsz, nc, q, h, p)
    br = b.float().reshape(bsz, nc, q, n)
    cr = c.float().reshape(bsz, nc, q, n)
    dth = dt.float().reshape(bsz, nc, q, h).permute(0, 3, 1, 2)  # [B,H,nc,Q]
    d_skip = d_skip.float()
    # 1-2. the states' gradients
    e = torch.einsum("bcin,bhci,bcihp->bhcnp", cr, torch.exp(lcum), dyr)
    dstate = reverse_state_passing(decay, e)
    # 3. per head over the columns
    g = torch.einsum("bcin,bcjn->bcij", cr, br)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldiff = lcum[..., :, None] - lcum[..., None, :]             # [B,H,nc,i,j]
    decay_ij = torch.exp(torch.where(tri, ldiff,
                                     torch.full_like(ldiff, -1e30)))
    v = torch.einsum("bcij,bhcij,bcihp->bcjhp", g, decay_ij, dyr)
    u = torch.einsum("bcjn,bhcnp->bcjhp", br, dstate)
    wl = torch.exp(lcum[..., -1:] - lcum).permute(0, 2, 3, 1)   # [B,nc,Q,H]
    dtc = dth.permute(0, 2, 3, 1)                               # [B,nc,Q,H]
    dx = dtc[..., None] * v + (wl * dtc)[..., None] * u + \
        d_skip[:, None] * dyr
    kc = (v * xr).sum(-1)
    tq = wl * (u * xr).sum(-1)
    # 4. dG over the heads, by groups
    hg = head_group(h)
    pr = torch.einsum("bcihp,bcjhp->bhcij", dyr, xr)
    dg = _group_sum(decay_ij * dth[..., None, :] * pr, hg)      # [B,nc,i,j]
    # 5. db and dc: the head terms by groups, then dG against b and c
    dc = _group_sum(torch.einsum("bhci,bcihp,bhcnp->bhcin", torch.exp(lcum),
                                 dyr, s_in), hg) \
        + torch.einsum("bcij,bcjn->bcin", dg, br)
    db = _group_sum(torch.einsum("bcjh,bcjhp,bhcnp->bhcjn", wl * dtc, xr,
                                 dstate), hg) \
        + torch.einsum("bcij,bcin->bcjn", dg, cr)
    # 6. dL, its reverse cumsum, and the per-head sums
    dl = (dyr * (yr - d_skip[:, None] * xr)).sum(-1) - dtc * (kc + tq)
    last = decay.permute(0, 2, 1) * (s_in * dstate).sum((-2, -1)) \
        .permute(0, 2, 1) + (dtc * tq).sum(2)                  # [B,nc,H]
    dl = torch.cat([dl[:, :, :-1], dl[:, :, -1:] + last[:, :, None]], 2)
    dl = torch.flip(torch.cumsum(torch.flip(dl, (2,)), 2), (2,))
    ddt = a.float() * dl + kc + tq
    da = (dtc * dl).sum((0, 1, 2))
    dd = (dyr * xr).sum((0, 1, 2, 4))
    return (dx.reshape(bsz, s, h, p), ddt.reshape(bsz, s, h), da,
            db.reshape(bsz, s, n), dc.reshape(bsz, s, n), dd)


# ---- the CUDA kernel ------------------------------------------------------

def workspace(bsz, s, h, p, n, q, device):
    """The kernel's f32 workspace at the forward's key: dS [B,H,nc,N,P],
    dG [B,nc,Q64,Q64], the groups' parts of dG [B,nc,G,pairs,64,64] (the
    chunk's causal 64 x 64 tiles) and of the head terms of dc and db
    [B,nc,2,G,Q64,N], K + T and dL but for its last-row terms [B,H,S],
    the chunks' parts of da and dd [B,H,nc,2] and the 64-column tiles'
    parts of sum_j dt_j T_j and dd [B,H,nc,Q64/64,2]. At the Mamba-2
    training key (2, 4096, 24, 64, 128, 256) 144.2 MB, 109.1 MB of it the
    group parts (dG's 41.9, dc's and db's 67.1); at Jamba's (2, 4096,
    128, 64, 16, 256) 84.0 MB, 50.5 MB of it the parts. Held only while
    one layer's backward runs."""
    nc, q64 = s // q, -(-q // TILE) * TILE
    groups = -(-h // head_group(h))
    tiles = q64 // TILE
    shapes = ((bsz, h, nc, n, p), (bsz, nc, q64, q64),
              (bsz, nc, groups, tiles * (tiles + 1) // 2, TILE, TILE),
              (bsz, nc, 2, groups, q64, n), (bsz, h, s), (bsz, h, s),
              (bsz, h, nc, 2), (bsz, h, nc, tiles, 2))
    return tuple(torch.empty(shape, dtype=torch.float32, device=device)
                 for shape in shapes)


def _rows16(t):
    """``t`` if its last axis has stride 1, its rows start on 16 bytes and
    hold a multiple of 4 elements (what the kernel's 16-byte copies
    read), else a contiguous copy padded with zeros to that multiple."""
    if t.stride(-1) == 1 and t.shape[-1] % 4 == 0 and \
            t.data_ptr() % 16 == 0 and \
            all(st % 4 == 0 for st in t.stride()[:-1]):
        return t
    cols = -(-t.shape[-1] // 4) * 4
    out = t.new_zeros((*t.shape[:-1], cols))
    out[..., :t.shape[-1]] = t
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.library("ssd_scan_bwd", _ARGTYPES).fm_ssd_scan_bwd


def ssd_scan_bwd(dy, x, dt, a, b, c, d_skip, y, saved, *, chunk: int = 256):
    """Launch the kernel: dy [B,S,H,P] and the forward's inputs (x, dt, a,
    b, c, d_skip, all f32 on one CUDA device, as ``ssd_scan`` takes them:
    x and dt through their strides), its output y and ``saved``, the
    workspace its launch filled (L [B,H,nc,Q], exp(L_Q) [B,H,nc], S_in
    [B,H,nc,N,P], C B^T [B,nc,Q64,Q64]; ``ssd_scan.ssd_scan_saving``).
    Returns (dx [B,S,H,P], ddt [B,S,H], da [H], db [B,S,N], dc [B,S,N],
    dd [H]), f32 and contiguous."""
    ins = (dy, x, dt, a, b, c, d_skip, y)
    if any(t.device.type != "cuda" or t.device != x.device for t in ins):
        raise ValueError("ssd_scan_bwd needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"ssd_scan_bwd takes f32 operands, got "
                        f"{[t.dtype for t in ins]}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dy.shape) != (bsz, s, h, p) or tuple(y.shape) != (bsz, s, h, p) \
            or tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) \
            or tuple(d_skip.shape) != (h,) or tuple(b.shape) != (bsz, s, n) \
            or tuple(c.shape) != (bsz, s, n):
        raise ValueError(f"ssd_scan_bwd shapes dy {tuple(dy.shape)}, x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, d {tuple(d_skip.shape)}, y "
                         f"{tuple(y.shape)}")
    if p % 4 or p > MAX_P or not 0 < n <= MAX_N:
        raise ValueError(f"ssd_scan_bwd takes P a multiple of 4 up to {MAX_P} "
                         f"and N from 1 up to {MAX_N}, got P={p} N={n}")
    f32 = dict(dtype=torch.float32, device=x.device)
    grads = (torch.empty((bsz, s, h, p), **f32),
             torch.empty((bsz, s, h), **f32), torch.empty((h,), **f32),
             torch.empty((bsz, s, n), **f32),
             torch.empty((bsz, s, n), **f32), torch.empty((h,), **f32))
    if x.numel() == 0:       # the forward saved no workspace
        return tuple(t.zero_() for t in grads)
    q = chunk_len(s, chunk)
    if q > MAX_Q:
        raise ValueError(f"ssd_scan_bwd takes chunks up to {MAX_Q}, got {q}")
    nc, q64 = s // q, -(-q // TILE) * TILE
    lcum, dec, s_in, g = saved
    if tuple(lcum.shape) != (bsz, h, nc, q) or tuple(dec.shape) != \
            (bsz, h, nc) or tuple(s_in.shape) != (bsz, h, nc, n, p) or \
            tuple(g.shape) != (bsz, nc, q64, q64):
        raise ValueError(f"ssd_scan_bwd: the forward's workspace L "
                         f"{tuple(lcum.shape)}, exp(L_Q) {tuple(dec.shape)}, "
                         f"S_in {tuple(s_in.shape)}, C B^T {tuple(g.shape)} "
                         f"is not of chunk {q}")
    ws = workspace(bsz, s, h, p, n, q, x.device)
    x, b, c, dy = (_rows16(t) for t in (x, b, c, dy.contiguous()))
    y, a, d_skip = (t.contiguous() for t in (y, a, d_skip))
    lcum, dec, s_in, g = (t.contiguous() for t in saved)
    err = _entry()(
        *(t.data_ptr() for t in (x, dt, a, b, c, d_skip, dy, y, lcum, dec,
                                 s_in, g, *grads, *ws)),
        bsz, s, h, p, n, q, q64, head_group(h), *x.stride()[:3],
        *dt.stride(), *b.stride()[:2], *c.stride()[:2],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan_bwd", err)
    launches[(bsz, s, h, p, n, q)] += 1
    return grads


__all__ = ["ssd_scan_bwd", "plain", "backward_passes",
           "reverse_state_passing", "head_group", "workspace", "launches"]
