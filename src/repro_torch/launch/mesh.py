"""Production meshes, as ``torch.distributed`` DeviceMeshes.

The port's copy of the JAX package's ``launch/mesh.py``.  Defined as
functions (never module-level constants), so importing this module
touches no device or process-group state: both need an initialised
default process group whose world holds the mesh's ranks (one process a
device; the dry-run's is the ``fake`` backend's world of 256 or 512
ranks in one process).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _device_type(device_type: str | None) -> str:
    """CUDA unless the caller names another device type."""
    return device_type or "cuda"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods)."""
    from torch.distributed.tensor import DeviceMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if dist.get_world_size() != n:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} mesh needs a "
                           f"world of {n} ranks, the process group has "
                           f"{dist.get_world_size()}")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(model: int = 1, data: int = 1,
                   device_type: str | None = None):
    """A small (data, model) mesh over the world's first ranks
    (tests/examples); shrinks to what the world holds, as the
    reference's does with the local devices."""
    from torch.distributed.tensor import DeviceMesh
    n = dist.get_world_size()
    model = min(model, n)
    data = max(min(data, n // model), 1)
    return DeviceMesh(_device_type(device_type),
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))
