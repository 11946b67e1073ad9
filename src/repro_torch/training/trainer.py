"""The train step: gradient accumulation over microbatches, the optional
gradient transform (int8 compression, ``distributed/compression.py``),
global-norm clip and AdamW.

The JAX package's ``repro.training.trainer``. Its ``jax.value_and_grad``
is ``torch.autograd.grad`` over the parameters, which come out in each
parameter's dtype as there; its ``lax.scan`` over the microbatches is a
loop that adds each microbatch's gradients into ``grad_accum_dtype``
accumulators in place, then divides by their number. On the card each
attention's gradient is the ``flash_attention_bwd`` kernel
(``kernels.ops.attention``) and each SSD scan's the ``ssd_scan_bwd``
kernel (``kernels.ops.ssd``); a CPU run differentiates the plain
versions.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (MeshEnv, tree_leaves, tree_map,
                                              tree_unflatten)
from repro_torch.models import encdec, transformer
from repro_torch.training.optimizer import OptConfig, adamw_update

_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_loss_fn(cfg: ModelConfig, run: RunConfig, env: MeshEnv) -> Callable:
    if cfg.family == "encdec":
        return functools.partial(encdec.loss_fn, cfg, run, env)
    return functools.partial(transformer.loss_fn, cfg, run, env)


def _split_microbatches(batch: dict, k: int) -> list:
    """``k`` microbatches of ``batch``: each tensor cut along its batch
    axis, the M-RoPE ``positions`` [3, B, S] along axis 1 (the JAX
    package's test, a leading axis of 3 on a tensor of 2 or more axes
    whose second divides by k)."""
    def split(x):
        if x.dim() >= 2 and x.shape[0] == 3 and x.shape[1] % k == 0:
            return list(torch.chunk(x, k, dim=1))
        return list(torch.chunk(x, k, dim=0))
    parts = {name: split(x) for name, x in batch.items()}
    return [{name: p[i] for name, p in parts.items()} for i in range(k)]


def _batch_size(batch: dict) -> int:
    """The leading size of the batch's first leaf in the JAX package's
    (sorted) key order."""
    return batch[sorted(batch)[0]].shape[0]


def value_and_grad(loss_fn: Callable, params, batch):
    """((total loss, metrics), grads) of ``loss_fn(params, batch)``, as
    ``jax.value_and_grad(loss_fn, has_aux=True)``: the gradient of every
    floating leaf in its own dtype (zeros where the loss does not reach
    it), everything detached."""
    with torch.enable_grad():
        tracked = [p.detach().requires_grad_(p.is_floating_point())
                   for p in tree_leaves(params)]
        total, metrics = loss_fn(tree_unflatten(params, tracked), batch)
        wanted = [t for t in tracked if t.requires_grad]
        got = iter(torch.autograd.grad(total, wanted, allow_unused=True))
    grads = []
    for t in tracked:
        g = next(got) if t.requires_grad else None
        grads.append(torch.zeros_like(t) if g is None else g)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, run: RunConfig, env: MeshEnv,
                    opt_cfg: OptConfig,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``loss``, ``total_loss``, ``tokens``, ``grad_norm``, ``lr``
    (and ``lb_loss``, ``z_loss`` for the decoder-only families) as 0-d f32
    tensors, each averaged over the microbatches. The parameters and the
    optimizer state are updated in place."""
    loss_fn = model_loss_fn(cfg, run, env)

    def train_step(params, opt_state, batch):
        gb = _batch_size(batch)
        micro = run.microbatch or gb
        k = max(1, gb // micro)
        if k > 1:
            acc_dt = _ACCUM[run.grad_accum_dtype]
            acc, losses, metricss = None, [], []
            for mb in _split_microbatches(batch, k):
                (loss, metrics), grads = value_and_grad(loss_fn, params, mb)
                if acc is None:
                    acc = tree_map(lambda g: g.to(acc_dt, copy=True), grads)
                else:
                    tree_map(lambda a, g: a.add_(g), acc, grads)
                del grads
                losses.append(loss)
                metricss.append(metrics)
            grads = tree_map(lambda g: g.div_(k).to(torch.float32), acc)
            del acc
            loss = torch.mean(torch.stack(losses))
            metrics = {name: torch.mean(torch.stack([m[name]
                                                     for m in metricss]))
                       for name in metricss[0]}
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)

        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return params, opt_state, metrics

    return train_step


__all__ = ["model_loss_fn", "value_and_grad", "make_train_step"]
