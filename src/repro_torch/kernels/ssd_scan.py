"""ssd_scan: the Mamba-2 SSD chunked scan, y [B,S,H,P] in f32.

The CUDA kernel is ``csrc/ssd_scan.cu`` (its header says what it replaces,
what bounds it and how): a chunk-parallel scan in three passes, chunk
states, state passing and chunk outputs, four CUDA launches a call.
``ssd_scan`` launches them on CUDA tensors in the layouts of the JAX
kernel, reading ``x`` and ``dt`` through their strides, and counts one
launch a call. ``SSDScan`` puts it under autograd, with the
``ssd_scan_bwd`` kernel as its backward. ``plain`` is the sequential
recurrence in plain PyTorch, which the CPU path of ``ops.ssd`` runs and
``chip_smoke.py`` holds the kernel against; ``chunk_states``,
``state_passing`` and ``chunk_outputs`` state the kernel's three passes in
plain PyTorch (``passes`` runs them in turn), for the tests and for the
per-pass check on the card.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + \
    [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
MAX_P, MAX_N, MAX_Q = 64, 128, 256
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use
# rows of the .cu's C B^T and output tiles, by which the C B^T workspace is
# sized (the .cu refuses any other size)
TILE = 64

# kernel launches since the last reset, by (B, S, H, P, N, Q)
launches: Counter = Counter()


def chunk_len(s: int, chunk: int) -> int:
    """The chunk the scan uses: ``min(chunk, s)``, halved until it divides
    ``s`` (as ``repro/kernels/ssd_scan.py`` and ``models/ssm.py`` do)."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


# ---- the kernel's passes in plain PyTorch --------------------------------

def chunk_states(x, dt, a, b, chunk: int):
    """Pass 1. Per (batch, head, chunk of Q): L = cumsum(dt a) within the
    chunk, exp(L_Q), and the chunk's own state dS = sum_j exp(L_Q - L_j)
    dt_j B_j (x) X_j. Returns L [B,H,nc,Q], exp(L_Q) [B,H,nc] and dS
    [B,H,nc,N,P], all f32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    xr = x.float().reshape(bsz, nc, q, h, p)
    dtr = dt.float().reshape(bsz, nc, q, h)
    br = b.float().reshape(bsz, nc, q, n)
    lcum = torch.cumsum(dtr * a, dim=2)                   # [B,nc,Q,H]
    l_last = lcum[:, :, -1:, :]
    w = torch.exp(l_last - lcum) * dtr                    # [B,nc,Q,H]
    ds = torch.einsum("bcjn,bcjh,bcjhp->bhcnp", br, w, xr)
    return (lcum.permute(0, 3, 1, 2), torch.exp(l_last[:, :, 0, :])
            .permute(0, 2, 1), ds)


def state_passing(decay, ds):
    """Pass 2, the only sequential one. decay [B,H,nc], dS [B,H,nc,N,P].
    Walks the chunks: S_in[c] = running; running = exp(L_Q^c) running +
    dS_c. Returns S_in [B,H,nc,N,P] and the final state [B,H,N,P]."""
    run = torch.zeros_like(ds[:, :, 0])
    s_in = []
    for ci in range(ds.shape[2]):
        s_in.append(run)
        run = decay[:, :, ci, None, None] * run + ds[:, :, ci]
    return torch.stack(s_in, dim=2), run


def chunk_outputs(x, dt, b, c, d_skip, lcum, s_in):
    """Pass 3. Per (batch, chunk): G = C B^T once for all heads; per head
    y = (G o exp(L_i - L_j) [j <= i] o dt_j) X + exp(L_i) C . S_in + d x,
    the j > i exponents masked before exp. lcum [B,H,nc,Q] and s_in
    [B,H,nc,N,P] from passes 1 and 2. Returns y [B,S,H,P] f32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc, q = lcum.shape[2], lcum.shape[3]
    xr = x.float().reshape(bsz, nc, q, h, p)
    dtr = dt.float().reshape(bsz, nc, q, h)
    br = b.float().reshape(bsz, nc, q, n)
    cr = c.float().reshape(bsz, nc, q, n)
    g = torch.einsum("bcin,bcjn->bcij", cr, br)           # [B,nc,Q,Q]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ldiff = lcum[..., :, None] - lcum[..., None, :]       # [B,H,nc,Q,Q]
    decay = torch.exp(torch.where(tri, ldiff, torch.full_like(ldiff, -1e30)))
    m = g[:, None] * decay * dtr.permute(0, 3, 1, 2)[..., None, :]
    y = torch.einsum("bhcij,bcjhp->bcihp", m, xr)
    y = y + torch.einsum("bcin,bhcnp->bcihp", cr, s_in) * \
        torch.exp(lcum).permute(0, 2, 3, 1)[..., None]
    y = y.reshape(bsz, s, h, p)
    return y + x.float() * d_skip[None, None, :, None]


def passes(x, dt, a, b, c, d_skip, *, chunk: int = 256):
    """The kernel's decomposition in plain PyTorch: chunk states, state
    passing, chunk outputs. Returns (y [B,S,H,P], final state [B,H,N,P])
    as ``models.ssm.ssd_chunked`` does."""
    lcum, decay, ds = chunk_states(x, dt, a, b, chunk)
    s_in, final = state_passing(decay, ds)
    return chunk_outputs(x, dt, b, c, d_skip, lcum, s_in), final


# ---- the CUDA kernel ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library, built and loaded at first use, with its shared
    memory query typed."""
    lib = _build.library("ssd_scan", _ARGTYPES)
    lib.fm_ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fm_ssd_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_scan_saving(x, dt, a, b, c, d_skip, *, chunk: int = 256):
    """``ssd_scan`` (check, launch, count), also returning the f32
    workspace its passes filled, which the backward reads: (y, (L
    [B,H,nc,Q], exp(L_Q) [B,H,nc], S_in [B,H,nc,N,P] after the state pass,
    C B^T transposed [B,nc,Q64,Q64])); None for it when y is empty."""
    ins = (x, dt, a, b, c, d_skip)
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError("ssd_scan needs every operand on one CUDA device, "
                         f"got {[str(t.device) for t in ins]}")
    if any(t.dtype != torch.float32 for t in ins):
        raise TypeError(f"ssd_scan takes f32 operands, got "
                        f"{[t.dtype for t in ins]}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan x must be [B,S,H,P], got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) or \
            tuple(d_skip.shape) != (h,) or tuple(b.shape) != (bsz, s, n) or \
            tuple(c.shape) != (bsz, s, n):
        raise ValueError(f"ssd_scan shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, d "
                         f"{tuple(d_skip.shape)}")
    if p % 4 or p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan takes P a multiple of 4 up to {MAX_P} "
                         f"and N up to {MAX_N}, got P={p} N={n}")
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, None
    q = chunk_len(s, chunk)
    if q > MAX_Q:
        raise ValueError(f"ssd_scan takes chunks up to {MAX_Q}, got {q}")
    lib = _lib()
    if lib.fm_ssd_scan_smem_bytes(n, p, q) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {q} at N={n}, P={p} needs "
                         f"{lib.fm_ssd_scan_smem_bytes(n, p, q)} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    nc, q64 = s // q, -(-q // TILE) * TILE
    f32 = dict(dtype=torch.float32, device=x.device)
    lw, dec = torch.empty((bsz, h, s), **f32), torch.empty((bsz, h, nc), **f32)
    st = torch.empty((bsz, h, nc, n, p), **f32)
    g = torch.empty((bsz, nc, q64, q64), **f32)
    # the last axis of x, b and c is read with stride 1
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    a, d_skip = a.contiguous(), d_skip.contiguous()
    err = lib.fm_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), lw.data_ptr(),
        dec.data_ptr(), st.data_ptr(), g.data_ptr(), bsz, s, h, p, n, q, q64,
        *x.stride()[:3], *dt.stride(), *b.stride()[:2], *c.stride()[:2],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", err)
    launches[(bsz, s, h, p, n, q)] += 1
    return y, (lw.view(bsz, h, nc, q), dec, st, g)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """Launch the kernel: x [B,S,H,P], dt [B,S,H], a/d_skip [H], b/c
    [B,S,N], all f32 on one CUDA device; P a multiple of 4 up to
    ``MAX_P``, N up to ``MAX_N``, the chunk (``chunk_len``) up to
    ``MAX_Q``. dt may take either sign: where dt a does within a chunk
    (L = cumsum(dt a) is not monotone there), the output pass forms the
    decay exp(L_i - L_j) element by element instead of factoring it.
    Returns y [B,S,H,P] f32, contiguous."""
    return ssd_scan_saving(x, dt, a, b, c, d_skip, chunk=chunk)[0]


def ssd_scan_with_passes(x, dt, a, b, c, d_skip, *, chunk: int = 256):
    """``ssd_scan`` (one launch counted), also returning what its first
    passes left in the workspace, to hold each pass against its plain
    version: y, L [B,H,nc,Q], S_in [B,H,nc,N,P] (after the state pass) and
    C B^T [B,nc,Q,Q] (where j <= i; the rest of the tile is unused)."""
    y, (lcum, _, s_in, g) = ssd_scan_saving(x, dt, a, b, c, d_skip,
                                            chunk=chunk)
    q = lcum.shape[-1]
    return y, lcum, s_in, g[:, :, :q, :q].transpose(2, 3)


class SSDScan(torch.autograd.Function):
    """The kernel under autograd: the forward launches ``ssd_scan`` and
    saves its inputs, its output and its workspace; the backward launches
    the ``ssd_scan_bwd`` kernel on them (no plain version on the card;
    the CPU's ``plain`` keeps its autograd)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk: int):
        y, saved = ssd_scan_saving(x, dt, a, b, c, d_skip, chunk=chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c, d_skip, y, *(saved or ()))
        return y

    @staticmethod
    def backward(ctx, dy):
        # an empty y saved no workspace; the backward returns zeros then
        from repro_torch.kernels.ssd_scan_bwd import ssd_scan_bwd
        x, dt, a, b, c, d_skip, y, *saved = ctx.saved_tensors
        return (*ssd_scan_bwd(dy, x, dt, a, b, c, d_skip, y, saved,
                              chunk=ctx.chunk), None)


def ssd_scan_with_grad(x, dt, a, b, c, d_skip, *, chunk: int = 256):
    """``ssd_scan`` under autograd: the forward and the backward each
    launch their kernel."""
    return SSDScan.apply(x, dt, a, b, c, d_skip, int(chunk))


__all__ = ["ssd_scan", "ssd_scan_with_passes", "ssd_scan_saving",
           "ssd_scan_with_grad",
           "SSDScan", "plain", "chunk_len",
           "chunk_states", "state_passing", "chunk_outputs", "passes",
           "MAX_P", "MAX_N", "MAX_Q"]
