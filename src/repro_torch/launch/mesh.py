"""The device env of a run. One card for now; the production meshes and the
multi-device rules wait for the mesh slice (``ROADMAP.md`` §1, "Mesh and
analysis")."""
from __future__ import annotations

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import MeshEnv, single_device_env


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device: DeviceLike = None) -> MeshEnv:
    """The one-device env on ``device`` (``cuda:0`` by default, raising
    without a card; ``"cpu"`` on request)."""
    if n_data * n_model != 1:
        raise NotImplementedError(
            f"a {n_data} x {n_model} mesh waits for the mesh slice of the "
            f"port (ROADMAP.md §1, \"Mesh and analysis\"); only 1 x 1 runs "
            f"today")
    return single_device_env(device)


__all__ = ["make_host_mesh"]
