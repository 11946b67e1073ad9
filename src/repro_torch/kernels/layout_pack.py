"""layout_pack: repack a weight [R, C] into tiles [R/tr, C/tc, tr, tc],
zero-padded to tile multiples.

The CUDA kernel is ``csrc/layout_pack.cu`` (its header says what it
replaces, what bounds it and how). ``layout_pack`` launches it on a CUDA
tensor, on the path and grid ``pack_plan`` gives; ``plain`` is the same
relayout in plain PyTorch, which the CPU path of ``ops.pack`` runs and
``chip_smoke.py`` holds the kernel against, bit for bit. The default tile
is the JAX package's ``native_tile``.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import layout_pack_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

# the kernel's block size and how much a thread or warp walks, as in
# csrc/layout_pack.cu
THREADS = 256
UNROLL = 4            # vectors a thread loads before it stores (vector walk)
RUNS_A_WARP = 4       # runs a warp walks (warp walk)
THREAD_RUNS = (8, 16, 32, 64)   # runs, in vectors, with a thread per vector

# kernel launches since the last reset, by (R, C, tr, tc, dtype)
launches: Counter = Counter()


class PackPlan(NamedTuple):
    path: str        # "vector" (16-byte copies) or "general" (elements)
    walk: str        # "thread" (a thread per vector of a run) or "warp"
    unit_bytes: int  # 16 on the vector path, the element size otherwise
    run: int         # units in a run (one tile row, tc elements)
    units: int       # units the grid writes: the whole padded output
    blocks: int
    threads: int


def pack_plan(r: int, c: int, tr: int, tc: int, itemsize: int, w_addr: int,
              out_addr: int) -> PackPlan:
    """The path and grid of one pack of [r, c] into (tr, tc) tiles of
    ``itemsize``-byte elements from ``w_addr`` to ``out_addr``.

    The vector path applies exactly when the tiles divide the columns, a
    tile row is a whole number of 16-byte vectors and both addresses are
    16-byte aligned; it never depends on ``r``. Each thread gets
    ``UNROLL`` vectors (or each warp ``RUNS_A_WARP`` runs), so the grid
    runs in many waves."""
    vector = (c % tc == 0 and tc * itemsize % 16 == 0 and w_addr % 16 == 0
              and out_addr % 16 == 0)
    runs = -(-r // tr) * tr * -(-c // tc)
    unit = 16 if vector else itemsize
    run = tc * itemsize // 16 if vector else tc
    if vector and run in THREAD_RUNS:
        walk, per_block = "thread", THREADS * UNROLL // run
    else:
        walk, per_block = "warp", THREADS // 32 * RUNS_A_WARP
    return PackPlan("vector" if vector else "general", walk, unit, run,
                    runs * run, -(-runs // per_block), THREADS)


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
    plan = pack_plan(r, c, tr, tc, w.dtype.itemsize, w.data_ptr(),
                     out.data_ptr())
    lib = _build.library("layout_pack", _ARGTYPES)
    err = lib.fm_layout_pack(w.data_ptr(), out.data_ptr(), r, c, tr, tc,
                             w.dtype.itemsize, int(plan.path == "vector"),
                             plan.blocks, plan.threads,
                             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check("layout_pack", err)
    launches[(r, c, tr, tc, w.dtype)] += 1
    return out


__all__ = ["layout_pack", "pack_plan", "PackPlan", "plain", "native_tile"]
