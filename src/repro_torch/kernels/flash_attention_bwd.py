"""flash_attention_bwd: dq, dk and dv of ``flash_attention`` from the
forward's output and its rows' log-sum-exp.

The CUDA source is ``csrc/flash_attention_bwd.cu`` (three launches: D =
rowsum(dO * O), then a dK/dV kernel over key tiles and a dQ kernel over
query tiles, no atomics; bf16 on the tensor cores, f32 on the FMA
units), at the forward's query offset. It replaces no Pallas kernel: the JAX package
differentiates plain jnp attention with ``jax.value_and_grad``; the
source's header says what bounds the kernel and what its design does.
``flash_attention_bwd`` launches it on CUDA tensors; ``plain`` is autograd
through ``kernels.ref.flash_attention_ref`` in f32, which the CPU path
differentiates and ``chip_smoke.py`` holds the kernel against.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

# launches since the last reset, by the forward's key (B, Sq, Sk, Hq, Hkv,
# hd, causal, window, q_offset, dtype); one call is three CUDA launches
launches: Counter = Counter()


@functools.lru_cache(maxsize=None)
def _entry():
    return _build.library("flash_attention_bwd",
                          _ARGTYPES).fm_flash_attention_bwd


def _ready(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary."""
    return x if x.is_contiguous() and x.data_ptr() % 16 == 0 \
        else x.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """Launch the kernel: q, o, do [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] in one
    dtype (f32 or bf16) on one CUDA device, lse f32 [B,Hq,Sq] from
    ``flash_attention.forward_with_lse`` at the same ``q_offset`` (>= 0:
    query row i at position i + q_offset in the masks). Returns (dq, dk,
    dv) in q's dtype; a key that no query sees gets zeros."""
    tensors = (q, k, v, o, lse, do)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention_bwd needs every input on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            o.shape != q.shape or do.shape != q.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention_bwd shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"o {tuple(o.shape)}, do {tuple(do.shape)}")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd takes Hq a multiple of Hkv "
                         f"and hd in {HEAD_DIMS}, got Hq={hq} Hkv={hkv} "
                         f"hd={hd}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, do)):
        raise TypeError("flash_attention_bwd takes f32 or bf16 of one dtype, "
                        f"got {[t.dtype for t in (q, k, v, o, do)]}")
    if lse.dtype != torch.float32 or lse.shape != (b, hq, sq):
        raise ValueError(f"lse must be f32 {(b, hq, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_attention_bwd takes an int q_offset >= 0, "
                         f"got {q_offset!r}")
    q, k, v, o, lse, do = (_ready(t) for t in tensors)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty_like(lse)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, hd,
        int(bool(causal)), int(window), q_offset, 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], torch._C._cuda_getCurrentRawStream(q.device.index))
    _build.check("flash_attention_bwd", err)
    launches[(b, sq, sk, hq, hkv, hd, bool(causal), int(window), q_offset,
              q.dtype)] += 1
    return dq, dk, dv


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          do: torch.Tensor, *, causal: bool = True, window: int = 0,
          q_offset: int = 0):
    """(dq, dk, dv) in f32: autograd through ``flash_attention_ref`` on q, k
    and v widened to f32, at ``q_offset``, for the output gradient
    ``do``. A row that sees no key has a uniform softmax over every key
    here (the finite mask), so its gradient reaches dk and dv, where the
    kernel gives it none."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                                  q_offset=q_offset)
        return torch.autograd.grad(out, (qf, kf, vf), do.float())


__all__ = ["flash_attention_bwd", "plain", "launches", "HEAD_DIMS"]
