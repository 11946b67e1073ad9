"""ssd_scan_bwd: dx, ddt, da, db, dc and dd of ``ssd_scan`` given dy.

The CUDA source is ``csrc/ssd_scan_bwd.cu`` (seven launches a call, f32
on the FMA units, no atomics; its header states each term of the
gradient, what bounds it and how the work is split). It replaces no
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

_ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + \
    [ctypes.c_longlong] * 10 + [ctypes.c_void_p]

# launches since the last reset, by the forward's key (B, S, H, P, N, Q);
# one call is seven CUDA launches
launches: Counter = Counter()


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
    4. dG_ij = sum_h exp(L_i - L_j) dt_j (dy_i . x_j) over the heads;
    5. dc_i = sum_h exp(L_i) S_in dy_i + sum_{j<=i} dG_ij B_j and db_j =
       sum_h w_j dS_c x_j + sum_{i>=j} dG_ij C_i;
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
    # 4. dG over the heads
    pr = torch.einsum("bcihp,bcjhp->bhcij", dyr, xr)
    dg = (decay_ij * dth[..., None, :] * pr).sum(1)             # [B,nc,i,j]
    # 5. db and dc
    dc = torch.einsum("bhci,bcihp,bhcnp->bcin", torch.exp(lcum), dyr, s_in) \
        + torch.einsum("bcij,bcjn->bcin", dg, br)
    db = torch.einsum("bcjh,bcjhp,bhcnp->bcjn", wl * dtc, xr, dstate) \
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
    ws = (torch.empty((bsz, h, nc, n, p), **f32),
          torch.empty((bsz, nc, q64, q64), **f32),
          torch.empty((bsz, h, s), **f32), torch.empty((bsz, h, s), **f32),
          torch.empty((bsz, h, nc, 2), **f32))
    # the last axis of x, b and c is read with stride 1
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    dy, y, a, d_skip = (t.contiguous() for t in (dy, y, a, d_skip))
    lcum, dec, s_in, g = (t.contiguous() for t in saved)
    err = _entry()(
        *(t.data_ptr() for t in (x, dt, a, b, c, d_skip, dy, y, lcum, dec,
                                 s_in, g, *grads, *ws)),
        bsz, s, h, p, n, q, q64, *x.stride()[:3], *dt.stride(),
        *b.stride()[:2], *c.stride()[:2],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan_bwd", err)
    launches[(bsz, s, h, p, n, q)] += 1
    return grads


__all__ = ["ssd_scan_bwd", "plain", "backward_passes",
           "reverse_state_passing", "launches"]
