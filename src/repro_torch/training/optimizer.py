"""AdamW with a configurable moment dtype (bf16 moments for the giant
configs), global-norm clipping and a linear-warmup cosine schedule.

The JAX package's ``repro.training.optimizer`` with the same arithmetic in
f32: each leaf's gradient, moments and parameter are upcast to f32, decay
applies where ``p.ndim > 1``, and the results are cast back. The update is
in place (the train step donates the parameters and the state, as the JAX
bundle's ``donate=(0, 1)``), under ``torch.no_grad()``, leaf by leaf in
``sorted_leaves`` order and, within a leaf, in slices of at most
``UPDATE_SLICE`` elements along its first axis, so the f32 temporaries
never exceed one slice's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import (ParamSpec, spec_map,
                                              tree_leaves, tree_map)

# elements of one leaf updated at a time (the update is elementwise, so
# slicing changes no value)
UPDATE_SLICE = 1 << 26

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"


def moment_dtype(cfg: OptConfig) -> torch.dtype:
    if cfg.moment_dtype not in _DTYPES:
        raise ValueError(f"moment_dtype {cfg.moment_dtype!r} is not one of "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[cfg.moment_dtype]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), in f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def opt_state_specs(param_specs_tree, cfg: OptConfig) -> dict:
    dt = moment_dtype(cfg)

    def moment(s: ParamSpec):
        return ParamSpec(s.shape, dt, s.logical, init="zeros")

    return {
        "m": spec_map(moment, param_specs_tree),
        "v": spec_map(moment, param_specs_tree),
        "step": ParamSpec((), torch.int32, (), init="zeros"),
    }


def init_opt_state(params, cfg: OptConfig) -> dict:
    dt = moment_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def sorted_leaves(tree) -> list:
    """The leaves of ``tree`` with every dict's keys in sorted order: the
    order of ``jax.tree.leaves``, in which the JAX package zips the
    parameters with their gradients and moments."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = None
    for leaf in sorted_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    """One AdamW step: writes the new parameters and moments into
    ``params`` and ``state`` and returns (params, new state, metrics
    ``grad_norm`` and ``lr``). The trees are zipped leaf by leaf in
    ``sorted_leaves`` order, as the JAX package zips them, so ``grads``
    may carry more leaves than the parameters (a ``grad_transform`` that
    returns (grads, residual)): the update takes the first ones and the
    norm counts all."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    dt = moment_dtype(cfg)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + torch.square(g) * (1 - cfg.b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        if p.dim() > 1:
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for p, g, m, v in zip(sorted_leaves(params), sorted_leaves(grads),
                          sorted_leaves(state["m"]),
                          sorted_leaves(state["v"])):
        if m.dtype != dt or v.dtype != dt:
            raise TypeError(f"moments of {m.dtype}/{v.dtype}, the config "
                            f"says {dt}")
        if p.dim() == 0 or p.numel() <= UPDATE_SLICE:
            upd(p, g, m, v)
            continue
        rows = max(1, UPDATE_SLICE // (p.numel() // p.shape[0]))
        for r in range(0, p.shape[0], rows):
            upd(p[r:r + rows], g[r:r + rows], m[r:r + rows], v[r:r + rows])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics


__all__ = ["OptConfig", "UPDATE_SLICE", "moment_dtype", "schedule",
           "sorted_leaves",
           "opt_state_specs", "init_opt_state", "global_norm",
           "adamw_update"]
