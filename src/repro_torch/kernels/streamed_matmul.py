"""streamed_matmul: C[M,N] = A[M,K] @ B[K,N] with f32 accumulation.

The CUDA kernel is ``csrc/streamed_matmul.cu`` (its header says what it
replaces, what bounds it and how). ``streamed_matmul`` launches it on
CUDA tensors; ``plain`` is the same function in plain PyTorch, which the
CPU path runs and ``chip_smoke.py`` holds the kernel against.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, by (M, K, N)
launches: Counter = Counter()


def tile_for(n: int) -> int:
    """Tile of C per block from N alone (1 = 128 x 128, 0 = 64 x 64): wide
    outputs get large tiles, narrow ones enough blocks to fill the SMs
    (on an H100 the large tile is faster from N = 2048 up, the small one
    at N = 768). Never from M, so a row's result does not depend on its
    batch."""
    return 1 if n >= 2048 else 0


def streamed_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``a`` [M,K] and ``b`` [K,N] on one CUDA device,
    both f32 or both bf16. Returns C [M,N] in ``a``'s dtype."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"streamed_matmul needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"streamed_matmul shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"streamed_matmul takes f32 or bf16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _build.library("streamed_matmul", _ARGTYPES)
    err = lib.fm_streamed_matmul(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, _DTYPES[a.dtype],
        tile_for(n),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("streamed_matmul", err)
    launches[(m, k, n)] += 1
    return c


__all__ = ["streamed_matmul", "plain", "tile_for"]
