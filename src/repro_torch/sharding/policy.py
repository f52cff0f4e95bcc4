"""Process layout of the port's distributed stream engine.

The JAX package drives every shard from one process over a device mesh.
The port runs SPMD on ``torch.distributed``: one process per device,
every process running the same program on the same request stream.
:func:`stream_mesh` lays the world out as a ``(data, model)`` grid —
rank ``r`` is data replica ``r // n_model``, model shard
``r % n_model`` — and opens the process groups the collectives run on:
the rank's ``model`` group (the shards of its replica: routing and the
flag word's max) and its ``data`` group (the replicas of its shard:
query rows split over it).  The rest of the JAX package's
``sharding/policy.py`` is the LM stack's rule table and is not here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..core.device import default_device


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """One rank's view of the ``(data, model)`` grid."""
    n_model: int
    n_data: int
    shard: int                 # this rank's model index
    data_index: int            # this rank's data index
    device: torch.device
    model_group: object        # process group over this replica's shards
    data_group: object         # process group over this shard's replicas
    world_group: object        # every rank of the grid
    backend: str

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.shard


def stream_mesh(n_model: int, n_data: int = 1, device=None) -> StreamMesh:
    """The ``(data, model)`` grid over the initialised default process
    group, whose world must be exactly ``n_model * n_data`` ranks.

    ``device`` None means CUDA: each rank takes GPU ``rank % count`` and
    the groups run on NCCL (raises without a GPU or without NCCL).
    ``device="cpu"`` runs the groups on gloo over CPU tensors.  Every
    rank must call this with the same arguments (group creation is a
    collective)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "stream_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) on every rank first")
    need = n_model * n_data
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != need:
        raise RuntimeError(
            f"stream_mesh({n_data}x{n_model}) needs a world of {need} "
            f"ranks, one per device; the process group has {world}")
    device = default_device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("stream_mesh on CUDA needs NCCL, and this "
                               "torch build has none")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"stream_mesh runs on cuda or cpu, not {device}")
    d_idx, shard = divmod(rank, n_model)
    model_group = data_group = None
    # every rank creates every group, in the same order
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)],
                           backend=backend)
        if d == d_idx:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)],
                           backend=backend)
        if m == shard:
            data_group = g
    world_group = dist.new_group(list(range(need)), backend=backend)
    return StreamMesh(n_model=n_model, n_data=n_data, shard=shard,
                      data_index=d_idx, device=device,
                      model_group=model_group, data_group=data_group,
                      world_group=world_group, backend=backend)
