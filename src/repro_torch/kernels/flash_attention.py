"""flash_attention: fused online-softmax attention, causal and/or sliding
window, with GQA (kv head = q head // group).

The CUDA source is ``csrc/flash_attention.cu``, two kernels behind one
entry point, both replacing the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``:

* f32 (the serving path): IEEE f32 on the FMA units, bound by their
  operations; ``cp.async`` rings and register tiles keep them fed.
* bf16 (the dense model path): both products on the tensor cores
  (``wgmma``, bf16 operands in 128-byte swizzled shared memory, f32
  accumulators), bound by their operations. P is carried as two bf16
  terms, hi + lo, so P V keeps f32 precision as in the Pallas kernel.

The header of the source says what bounds each and what its design does.
``flash_attention`` launches the kernel of q's dtype on CUDA tensors in
the ``[B, S, H, hd]`` layout of the JAX kernel; ``plain`` is the same
function in plain PyTorch, which the CPU path runs and ``chip_smoke.py``
holds the kernel against. ``FlashAttention.apply`` is the differentiable
call: its forward launches the kernel with the rows' log-sum-exp kept
(``forward_with_lse``), its backward launches ``flash_attention_bwd``,
both at the call's query offset. Under ``torch.utils.checkpoint`` the
recomputed forward launches again and keeps its own log-sum-exp.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.ref import flash_attention_ref as plain

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches since the last reset, by (B, Sq, Sk, Hq, Hkv, hd, causal,
# window, q_offset, dtype)
launches: Counter = Counter()


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded at first use."""
    return _build.library("flash_attention", _ARGTYPES).fm_flash_attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel: q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] on one CUDA
    device, one dtype (f32 or bf16), Hq a multiple of Hkv, hd in
    ``HEAD_DIMS``. Query row i is at position i + ``q_offset`` (>= 0) in
    the causal and window masks. Returns [B,Sq,Hq,hd] in q's dtype."""
    return _launch(q, k, v, causal, window, q_offset, with_lse=False)[0]


def forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     q_offset: int = 0):
    """``flash_attention`` that also returns each row's log-sum-exp of the
    scaled and masked scores, f32 [B,Hq,Sq], as the backward takes it."""
    return _launch(q, k, v, causal, window, q_offset, with_lse=True)


def _launch(q, k, v, causal, window, q_offset, *, with_lse):
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
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_attention takes an int q_offset >= 0, got "
                         f"{q_offset!r}")
    # contiguous, starting on a 16-byte boundary (the kernel's copies)
    q, k, v = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.numel() == 0:
        return o, lse
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if lse is None else lse.data_ptr(), b, sq, sk, hq, hkv, hd,
        int(bool(causal)), int(window), q_offset, 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype], torch._C._cuda_getCurrentRawStream(q.device.index))
    _build.check("flash_attention", err)
    launches[(b, sq, sk, hq, hkv, hd, bool(causal), int(window), q_offset,
              q.dtype)] += 1
    return o, lse


class FlashAttention(torch.autograd.Function):
    """The kernel with its gradient: forward ``forward_with_lse``,
    backward ``flash_attention_bwd`` (dq, dk, dv in the inputs' dtype),
    both at ``q_offset``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int = 0):
        o, lse = forward_with_lse(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


__all__ = ["flash_attention", "forward_with_lse", "FlashAttention", "plain",
           "HEAD_DIMS"]
