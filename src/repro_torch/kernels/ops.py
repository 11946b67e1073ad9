"""Dispatch to the kernels by the device of the tensors they are given.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. There is no
fallback from one to the other. Each kernel module counts its launches
(``launch_counts``), so a run can show that it went through the kernels.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import streamed_matmul as _mm

KERNELS = {"streamed_matmul": _mm, "flash_attention": _fa}


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, f32 accumulation, in A's dtype."""
    if a.device.type == "cpu":
        return ref.matmul_ref(a, b)
    return _mm.streamed_matmul(a, b)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd]."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def launch_counts() -> Dict[str, int]:
    return {name: sum(mod.launches.values()) for name, mod in KERNELS.items()}


def launch_counts_by_shape() -> Dict[str, Counter]:
    """Launches per kernel, by the shape key its wrapper counts under:
    (M, K, N) for ``streamed_matmul``, (B, Sq, Sk, Hq, Hkv, hd, causal,
    window) for ``flash_attention``."""
    return {name: Counter(mod.launches) for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches.clear()


__all__ = ["matmul", "attention", "launch_counts", "launch_counts_by_shape",
           "reset_launch_counts", "KERNELS", "ref"]
