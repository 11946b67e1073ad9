"""Plain PyTorch versions of the kernels: their semantics, the CPU path, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.

They mirror ``repro/kernels/ref.py`` (``matmul_ref``,
``flash_attention_ref``) op for op.
"""
from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with f32 accumulation, in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k/v: [B,Sk,Hkv,hd] (fewer kv heads -> GQA repeat).
    Returns [B,Sq,Hq,hd] in q's dtype."""
    sq, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    sk, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    s = torch.einsum("bqhd,bphd->bhqp", q.float(), k.float()) / math.sqrt(hd)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqp,bphd->bqhd", p, v.float())
    return out.to(q.dtype)
