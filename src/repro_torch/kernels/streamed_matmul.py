"""streamed_matmul: C[M,N] = A[M,K] @ B[K,N] with f32 accumulation.

The CUDA kernel is ``csrc/streamed_matmul.cu`` (its header says what it
replaces, what bounds it and how). ``streamed_matmul`` launches it on
CUDA tensors; ``plain`` is the same function in plain PyTorch, which the
CPU path runs and ``chip_smoke.py`` holds the kernel against.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import matmul_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p] * 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLITS = (1, 2, 4, 8)    # splits of K the plan chooses from
SPLIT_MIN_K = 384        # the least K a split is given
SMS = 132                # streaming multiprocessors of an H100 SXM
PLAN_ROWS = 1024         # the batch the plan fills waves for: one prompt
# the 128 x 128 C tile a block of the .cu computes, by which the plan counts
# blocks; were it to drift from the .cu, the plan would lose speed, never a
# bit of C (the .cu takes any split of at least one)
PLAN_BLOCK = 128

# kernel launches since the last reset, by (M, K, N)
launches: Counter = Counter()


@functools.lru_cache(maxsize=None)
def tile_for(n: int, k: int) -> int:
    """The kernel's plan for C = A[M,K] @ B[K,N]: the number of ranges K is
    split into, from N and K alone (the tile is the .cu's own).

    The split is the one in ``SPLITS`` (each range at least ``SPLIT_MIN_K``
    deep) whose blocks fill the 132 SMs in the most nearly whole waves for
    a 1024-row batch, the fewest splits on a tie: the wide outputs of the
    serving path (N >= 2048) take none, N = 3072 at K = 768 takes 2,
    N = 768 takes 2 at K = 768 and 8 at K = 3072. Each range's partial sums
    are added in split order by a second kernel.

    Never from M: each row of C is then one fixed sequence of FMAs and
    additions, whatever the number of rows that share the launch, so a
    padded batch de-batches into exactly the rows of solo runs."""
    blocks = math.ceil(PLAN_ROWS / PLAN_BLOCK) * math.ceil(n / PLAN_BLOCK)
    best, best_fill = 1, 0.0
    for s in SPLITS:
        if s > 1 and k < s * SPLIT_MIN_K:
            break
        fill = blocks * s / (math.ceil(blocks * s / SMS) * SMS)
        if fill > best_fill + 1e-9:
            best, best_fill = s, fill
    return best


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    return _build.library("streamed_matmul", _ARGTYPES).fm_streamed_matmul


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
    splits = tile_for(n, k)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=a.device) \
        if splits > 1 else None
    err = _entry()(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, _DTYPES[a.dtype],
        splits, None if ws is None else ws.data_ptr(),
        torch._C._cuda_getCurrentRawStream(a.device.index))
    _build.check("streamed_matmul", err)
    launches[(m, k, n)] += 1
    return c


__all__ = ["streamed_matmul", "plain", "tile_for", "SPLITS"]
