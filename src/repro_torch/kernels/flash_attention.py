"""flash_attention: fused online-softmax attention, causal and/or sliding
window, with GQA (kv head = q head // group).

The CUDA kernel is ``csrc/flash_attention.cu`` (its header says what it
replaces, what bounds it and how). ``flash_attention`` launches it on
CUDA tensors in the ``[B, S, H, hd]`` layout of the JAX kernel; ``plain``
is the same function in plain PyTorch, which the CPU path runs and
``chip_smoke.py`` holds the kernel against.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches since the last reset, by (B, Sq, Sk, Hq, Hkv, hd, causal,
# window)
launches: Counter = Counter()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel: q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] on one CUDA
    device, one dtype (f32 or bf16), Hq a multiple of Hkv, hd in
    ``HEAD_DIMS``. Returns [B,Sq,Hq,hd] in q's dtype."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes Hq a multiple of Hkv and hd "
                         f"in {HEAD_DIMS}, got Hq={hq} Hkv={hkv} hd={hd}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = _build.library("flash_attention", _ARGTYPES)
    err = lib.fm_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, hq,
        hkv, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err)
    launches[(b, sq, sk, hq, hkv, hd, bool(causal), int(window))] += 1
    return o


__all__ = ["flash_attention", "plain", "HEAD_DIMS"]
