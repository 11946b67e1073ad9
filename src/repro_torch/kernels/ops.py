"""Dispatch to the kernels by the device of the tensors they are given.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version, and so does a
``meta`` tensor, on which it computes nothing (the dry run counts the
FLOPs of a step that way, ``launch/dryrun.py``). There is no fallback from
one to the other. Each kernel module counts its launches
(``launch_counts``), so a run can show that it went through the kernels.

Where autograd needs a gradient (grad mode on and an input that requires
one), ``attention`` on CUDA goes through ``FlashAttention``, whose
backward is the ``flash_attention_bwd`` kernel, and ``ssd`` through
``SSDScan``, whose backward is the ``ssd_scan_bwd`` kernel. The plain
versions on the CPU are differentiated by autograd.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import layout_pack as _pack
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssd_scan_bwd as _ssdb
from repro_torch.kernels import streamed_matmul as _mm
from repro_torch.kernels.layout_pack import native_tile

KERNELS = {"streamed_matmul": _mm, "flash_attention": _fa,
           "flash_attention_bwd": _fab, "ssd_scan": _ssd,
           "ssd_scan_bwd": _ssdb, "layout_pack": _pack}


# devices whose tensors take the plain versions
_PLAIN_DEVICES = ("cpu", "meta")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B, f32 accumulation, in A's dtype."""
    if a.device.type in _PLAIN_DEVICES:
        return ref.matmul_ref(a, b)
    return _mm.streamed_matmul(a, b)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd]; query row i at
    position i + ``q_offset`` in the masks."""
    if q.device.type in _PLAIN_DEVICES:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    if _needs_grad(q, k, v):
        return _fa.FlashAttention.apply(q, k, v, bool(causal), int(window),
                                        q_offset)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, d_skip: torch.Tensor, *,
        chunk: int = 256) -> torch.Tensor:
    """Mamba-2 SSD scan. x [B,S,H,P], dt [B,S,H], a/d_skip [H], b/c
    [B,S,N] -> y [B,S,H,P] f32. The plain version is the sequential
    recurrence, which needs no chunk."""
    if x.device.type in _PLAIN_DEVICES:
        return ref.ssd_ref(x, dt, a, b, c, d_skip)
    if _needs_grad(x, dt, a, b, c, d_skip):
        return _ssd.ssd_scan_with_grad(x, dt, a, b, c, d_skip, chunk=chunk)
    return _ssd.ssd_scan(x, dt, a, b, c, d_skip, chunk=chunk)


def pack(w: torch.Tensor, *, tile=None) -> torch.Tensor:
    """[R, C] -> [R/tr, C/tc, tr, tc], zero-padded; ``native_tile`` of
    w's dtype by default."""
    if w.device.type in _PLAIN_DEVICES:
        return ref.layout_pack_ref(w, tile or native_tile(w.dtype))
    return _pack.layout_pack(w, tile)


unpack = ref.layout_unpack_ref


def launch_counts() -> Dict[str, int]:
    return {name: sum(mod.launches.values()) for name, mod in KERNELS.items()}


def launch_counts_by_shape() -> Dict[str, Counter]:
    """Launches per kernel, by the shape key its wrapper counts under:
    (M, K, N) for ``streamed_matmul``, (B, Sq, Sk, Hq, Hkv, hd, causal,
    window, q_offset, dtype) for ``flash_attention`` and
    ``flash_attention_bwd`` (the backward under its forward's key),
    (B, S, H, P, N, Q) for ``ssd_scan`` and ``ssd_scan_bwd`` and (R, C,
    tr, tc, dtype) for ``layout_pack``. The dtype keeps an f32 launch
    apart from a bf16 one of the same shape."""
    return {name: Counter(mod.launches) for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches.clear()


__all__ = ["matmul", "attention", "ssd", "pack", "unpack", "native_tile",
           "launch_counts", "launch_counts_by_shape", "reset_launch_counts",
           "KERNELS", "ref"]
