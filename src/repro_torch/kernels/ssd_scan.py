"""ssd_scan: the Mamba-2 SSD chunked scan, y [B,S,H,P] in f32.

The CUDA kernel is ``csrc/ssd_scan.cu`` (its header says what it replaces,
what bounds it and how). ``ssd_scan`` launches it on CUDA tensors in the
layouts of the JAX kernel, reading ``x`` and ``dt`` through their strides;
``plain`` is the sequential recurrence in plain PyTorch, which the CPU path
of ``ops.ssd`` runs and ``chip_smoke.py`` holds the kernel against.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
    [ctypes.c_longlong] * 10 + [ctypes.c_void_p]
MAX_P, MAX_N = 64, 128
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use

# kernel launches since the last reset, by (B, S, H, P, N, Q)
launches: Counter = Counter()


def chunk_len(s: int, chunk: int) -> int:
    """The chunk the scan uses: ``min(chunk, s)``, halved until it divides
    ``s`` (as ``repro/kernels/ssd_scan.py`` and ``models/ssm.py`` do)."""
    q = min(chunk, s)
    while s % q:
        q //= 2
    return q


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
             chunk: int = 256) -> torch.Tensor:
    """Launch the kernel: x [B,S,H,P], dt [B,S,H], a/d_skip [H], b/c
    [B,S,N], all f32 on one CUDA device; P a multiple of 4 up to
    ``MAX_P``, N up to ``MAX_N``. Returns y [B,S,H,P] f32, contiguous."""
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
        return y
    q = chunk_len(s, chunk)
    lib = _build.library("ssd_scan", _ARGTYPES)
    smem = lib.fm_ssd_scan_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    if smem(n, p, q) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk {q} at N={n}, P={p} needs "
                         f"{smem(n, p, q)} bytes of shared memory, more than "
                         f"{SMEM_LIMIT}")
    # the last axis of x, b and c is read with stride 1
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    a, d_skip = a.contiguous(), d_skip.contiguous()
    err = lib.fm_ssd_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), y.data_ptr(), bsz, s, h, p, n, q,
        *x.stride()[:3], *dt.stride(), *b.stride()[:2], *c.stride()[:2],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("ssd_scan", err)
    launches[(bsz, s, h, p, n, q)] += 1
    return y


__all__ = ["ssd_scan", "plain", "chunk_len", "MAX_P", "MAX_N"]
