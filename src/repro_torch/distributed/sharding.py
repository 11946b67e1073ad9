"""Parameter specs: ``ParamSpec`` trees -> shapes, init and byte counts.

Every parameter is declared once as a ``ParamSpec`` carrying its shape,
dtype, initializer and *logical* axis names, as in the JAX package. The
logical names are kept so the spec trees of the two packages match leaf for
leaf. ``make_rules`` is that package's table from logical names to mesh
axes, and ``MeshEnv`` resolves names through it over a *described* mesh
(``{"data": 16, "model": 16}``, ``launch.mesh.make_production_mesh``):
``pspec`` gives the partition a tensor would take, as a tuple of mesh
axes, and ``axis_size`` the ways a logical axis is split. Nothing is placed:
a run computes on the env's one device, and ``MeshEnv.constrain`` returns
its input, as the JAX one does on a mesh of size 1.

Trees are nested dicts (lists and tuples too) with specs or tensors at the
leaves; ``spec_map`` and ``tree_map`` walk them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

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


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def spec_map(fn: Callable, tree):
    return tree_map(fn, tree, is_leaf=is_spec)


@dataclass(frozen=True)
class MeshEnv:
    """The device one run computes on, a described mesh (axis name ->
    size; 1 x 1 for a run on one device) and the logical rules over it.
    The sharding constraints of the JAX model code are no-ops here, as they
    are there on a mesh of size 1."""
    device: torch.device
    mesh_shape: dict = field(
        default_factory=lambda: {"data": 1, "model": 1})
    rules: dict = field(default_factory=lambda: make_rules())

    def axis_size(self, name: str) -> int:
        """The ways the logical axis ``name`` is split on the mesh."""
        ax = self.rules.get(name)
        if ax is None:
            return 1
        if isinstance(ax, str):
            ax = (ax,)
        size = 1
        for a in ax:
            size *= self.mesh_shape[a]
        return size

    def pspec(self, logical: Sequence[Optional[str]], shape=None) -> tuple:
        """Resolve logical names to a partition: per dim a mesh axis, a
        tuple of them, or None, trailing Nones dropped (the entries of the
        JAX package's ``PartitionSpec``).

        If ``shape`` is given, any logical axis whose mesh extent does not
        divide the dim size is dropped (replicated): kv_heads=8 on a
        16-way model axis stays whole."""
        parts = []
        used = set()
        for i, name in enumerate(logical):
            ax = self.rules.get(name) if name else None
            if ax is not None:
                axes = (ax,) if isinstance(ax, str) else tuple(ax)
                axes = tuple(a for a in axes if a not in used)
                size = math.prod(self.mesh_shape[a] for a in axes)
                if axes and (shape is None
                             or (shape[i] % size == 0 and shape[i] > 0)):
                    parts.append(axes if len(axes) > 1 else axes[0])
                    used.update(axes)
                else:
                    parts.append(None)
            else:
                parts.append(None)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def constrain(self, x, *logical):
        return x

    def constrain_compute(self, x, *logical):
        return x


# ---------------------------------------------------------------------------
# rule sets
# ---------------------------------------------------------------------------

def make_rules(*, multi_pod: bool = False, fsdp: bool = False,
               seq_shard: bool = True, expert_parallel: bool = False,
               layout: str = "tp") -> dict:
    """Logical-axis rules for LM workloads.

    layout="tp" (default, Megatron-style):
      batch        -> data (and pod)            activations
      seq          -> model between blocks (sequence parallelism)
      kv_seq       -> model (flash-decoding-style sharded KV cache)
      heads/d_ff   -> model (tensor parallelism)
      vocab        -> model (embedding/logits)
      fsdp_row     -> (pod,)data when fsdp (ZeRO-3 storage sharding)

    layout="dp" (pure data parallel + ZeRO-3, for models too small to TP):
      batch + fsdp_row -> ALL axes; no tensor/seq sharding. Weights are
      gathered per layer inside the scan body (constrain_compute).
    """
    data_axes = ("pod", "data") if multi_pod else ("data",)
    if layout == "dp":
        all_axes = data_axes + ("model",)
        return {
            "batch": all_axes, "seq": None, "kv_seq": None,
            "heads": None, "kv_heads": None, "d_ff": None,
            "vocab": all_axes, "experts": None, "expert_ff": None,
            "embed": None, "layers": None, "fsdp_row": all_axes,
            "conv": None, "state": None, "pos": None,
        }
    rules = {
        "batch": data_axes,
        "seq": "model" if seq_shard else None,
        "kv_seq": "model",
        "heads": "model",
        "kv_heads": "model",
        "d_ff": "model",
        "vocab": "model",
        "experts": "model" if expert_parallel else None,
        "expert_ff": None if expert_parallel else "model",
        "embed": None,
        "layers": None,
        "fsdp_row": data_axes if fsdp else None,
        "conv": None,
        "state": None,
        "pos": None,
    }
    return rules


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
           "tree_unflatten",
           "MeshEnv", "make_rules", "single_device_env", "init_params",
           "param_bytes",
           "param_count"]
