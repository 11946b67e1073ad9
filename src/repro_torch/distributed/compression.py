"""Gradient compression for the data-parallel all-reduce: per-tensor int8
quantization with error feedback (residual carried between steps).

The JAX package's ``repro.distributed.compression`` on one device, where
it is pure quantize/dequantize (its int32 all-reduce under ``shard_map``
waits for the mesh slice, ``ROADMAP.md``). Applied as a ``grad_transform``
in ``training.trainer.make_train_step``. ``torch.round`` rounds half to
even as ``jnp.round`` does, so f32 outputs match bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    error_feedback: bool = True
    dtype: str = "int8"


def quantize(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization -> (q int8, scale f32)."""
    absmax = torch.max(torch.abs(x)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, residual=None):
    """Quantize a gradient tree; returns (dequantized grads in each leaf's
    dtype, new f32 residual), both with the tree's structure.

    With error feedback the quantization error is added back into the next
    step's gradients, making the scheme unbiased over time.
    """
    leaves = tree_leaves(grads)
    res = tree_leaves(residual) if residual is not None \
        else [torch.zeros_like(g, dtype=torch.float32) for g in leaves]
    out, new_res = [], []
    for g, r in zip(leaves, res):
        gf = g.to(torch.float32) + r
        deq = dequantize(*quantize(gf))
        out.append(deq.to(g.dtype))
        new_res.append(gf - deq)
    return tree_unflatten(grads, out), tree_unflatten(grads, new_res)


def make_grad_transform(cfg: CompressionConfig):
    """The ``grad_transform`` of ``make_train_step``, or None when
    compression is off. It returns (grads, residual), as the JAX
    package's does."""
    if not cfg.enabled:
        return None

    def transform(grads, residual=None):
        return compress_tree(grads, residual if cfg.error_feedback else None)

    return transform


__all__ = ["CompressionConfig", "quantize", "dequantize", "compress_tree",
           "make_grad_transform"]
