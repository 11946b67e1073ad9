"""The device env of a run, and the production meshes as descriptions.

A run computes on one device (``make_host_mesh``, 1 x 1). The JAX
package's production meshes, one pod of 16 x 16 chips and two pods of 2 x
16 x 16, are described here by their axis sizes, with the rules
``make_rules`` gives them: ``make_env(...).pspec`` and ``axis_size`` say
how a tensor would be split there, and ``cp_prefill`` takes its number of
sequence shards from the model axis. Nothing is placed on those meshes.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import (MeshEnv, make_rules,
                                              single_device_env)


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The production mesh's axis sizes: (data 16, model 16), or (pod 2,
    data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_env(*, multi_pod: bool = False, fsdp: bool = False,
             seq_shard: bool = True, layout: str = "tp",
             mesh: dict = None) -> MeshEnv:
    """The env of a described mesh (the production mesh by default) with
    its rules, on the ``meta`` device, where nothing is placed."""
    mesh = dict(mesh) if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod)
    rules = make_rules(multi_pod="pod" in mesh, fsdp=fsdp,
                       seq_shard=seq_shard, layout=layout)
    return MeshEnv(torch.device("meta"), mesh, rules)


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device: DeviceLike = None) -> MeshEnv:
    """The one-device env on ``device`` (``cuda:0`` by default, raising
    without a card; ``"cpu"`` on request)."""
    if n_data * n_model != 1:
        raise NotImplementedError(
            f"a {n_data} x {n_model} host mesh needs {n_data * n_model} "
            f"devices and a run computes on one; make_env describes larger "
            f"meshes without placing anything")
    return single_device_env(device)


__all__ = ["make_production_mesh", "make_env", "make_host_mesh"]
