"""Parameter specs: ``ParamSpec`` trees -> shapes, init and byte counts.

Every parameter is declared once as a ``ParamSpec`` carrying its shape,
dtype, initializer and *logical* axis names, as in the JAX package. The
logical names are kept so the spec trees of the two packages match leaf for
leaf; on one device they map to nothing, and ``MeshEnv.constrain`` returns
its input as the JAX one does on a mesh of size 1. The multi-device rules,
``shard_map`` and the dry-run's shape structs wait for the mesh slice
(``ROADMAP.md`` §1, "Mesh and analysis").

Trees are nested dicts (lists and tuples too) with specs or tensors at the
leaves; ``spec_map`` and ``tree_map`` walk them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: Any = torch.bfloat16
    logical: tuple = ()
    init: str = "normal"        # normal | zeros | ones | ssm_a | arange
    scale: float = 1.0          # stddev multiplier for "normal"

    def __post_init__(self):
        if len(self.logical) not in (0, len(self.shape)):
            raise ValueError(f"logical {self.logical} vs shape {self.shape}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its dict/list/tuple structure. A node for which
    ``is_leaf`` is true counts as a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Callable = None) -> list:
    """The leaves of ``tree`` in ``tree_map``'s order (dict insertion
    order; the JAX package's trees sort keys, so compare by path)."""
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def spec_map(fn: Callable, tree):
    return tree_map(fn, tree, is_leaf=is_spec)


@dataclass(frozen=True)
class MeshEnv:
    """The device one run computes on. The sharding constraints of the JAX
    model code are no-ops here, as they are there on a mesh of size 1."""
    device: torch.device

    def constrain(self, x, *logical):
        return x

    def constrain_compute(self, x, *logical):
        return x


def single_device_env(device: DeviceLike = None) -> MeshEnv:
    """``cuda:0`` by default (raises without a card); ``"cpu"`` on request."""
    return MeshEnv(resolve_device(device))


def _init_one(s: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init == "ssm_a":
        # mamba A_log init: log of uniform [1, 16]
        v = torch.log(torch.linspace(1.0, 16.0, s.shape[-1],
                                     dtype=torch.float32, device=device))
        return v.expand(s.shape).to(s.dtype).contiguous()
    if s.init == "arange":
        v = torch.arange(1, s.shape[-1] + 1, dtype=torch.float32,
                         device=device)
        return v.expand(s.shape).to(s.dtype).contiguous()
    if s.init != "normal":
        raise ValueError(f"unknown init {s.init!r}")
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    std = s.scale / math.sqrt(max(1, fan_in))
    v = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (v * std).to(device=device, dtype=s.dtype)


def init_params(specs, generator: torch.Generator,
                device: DeviceLike = None):
    """Materialize real parameters on ``device``: normal draws come from
    ``generator`` (on its own device, then moved), one leaf after another."""
    dev = resolve_device(device)
    return spec_map(lambda s: _init_one(s, generator, dev), specs)


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(specs, is_leaf=is_spec))


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs, is_leaf=is_spec))


__all__ = ["ParamSpec", "is_spec", "spec_map", "tree_map", "tree_leaves",
           "MeshEnv", "single_device_env", "init_params", "param_bytes",
           "param_count"]
