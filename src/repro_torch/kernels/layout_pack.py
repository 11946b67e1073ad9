"""layout_pack: repack a weight [R, C] into tiles [R/tr, C/tc, tr, tc],
zero-padded to tile multiples.

The CUDA kernel is ``csrc/layout_pack.cu`` (its header says what it
replaces, what bounds it and how). ``layout_pack`` launches it on a CUDA
tensor; ``plain`` is the same relayout in plain PyTorch, which the CPU path
of ``ops.pack`` runs and ``chip_smoke.py`` holds the kernel against, bit
for bit. The default tile is the JAX package's ``native_tile``.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import layout_pack_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

# kernel launches since the last reset, by (R, C, tr, tc, dtype)
launches: Counter = Counter()


def native_tile(dtype: torch.dtype) -> Tuple[int, int]:
    """(16, 128) for 2-byte types, (8, 128) for the rest, as the JAX
    package's ``native_tile`` (the TPU's native tiles)."""
    return (16, 128) if dtype.itemsize == 2 else (8, 128)


def layout_pack(w: torch.Tensor,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch the kernel: ``w`` [R, C] on a CUDA device, any dtype of 1, 2,
    4 or 8 bytes. Returns [ceil(R/tr), ceil(C/tc), tr, tc] in w's dtype."""
    if w.device.type != "cuda":
        raise ValueError(f"layout_pack needs a CUDA tensor, got {w.device}")
    if w.dim() != 2:
        raise ValueError(f"layout_pack takes [R, C], got {tuple(w.shape)}")
    if w.dtype.itemsize not in (1, 2, 4, 8):
        raise TypeError(f"layout_pack takes 1, 2, 4 or 8-byte elements, "
                        f"got {w.dtype}")
    tr, tc = tile or native_tile(w.dtype)
    if tr <= 0 or tc <= 0:
        raise ValueError(f"layout_pack tile {tile}")
    r, c = w.shape
    out = torch.empty((-(-r // tr), -(-c // tc), tr, tc), dtype=w.dtype,
                      device=w.device)
    if out.numel() == 0:
        return out
    w = w.contiguous()
    lib = _build.library("layout_pack", _ARGTYPES)
    err = lib.fm_layout_pack(w.data_ptr(), out.data_ptr(), r, c, tr, tc,
                             w.dtype.itemsize,
                             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check("layout_pack", err)
    launches[(r, c, tr, tc, w.dtype)] += 1
    return out


__all__ = ["layout_pack", "plain", "native_tile"]
