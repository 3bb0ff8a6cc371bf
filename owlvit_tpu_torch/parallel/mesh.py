"""The ("data", "model") mesh on torch.distributed (counterpart of
owlvit_tpu/parallel/mesh.py: `create_mesh`).

The JAX package is single-controller: one process sees every device and
XLA inserts the collectives. The port runs one process per rank (torchrun
or torch.multiprocessing) and calls its collectives explicitly, over the
two process groups of a DeviceMesh with the JAX axis names:

  "data"  - data parallelism: each rank takes B / dp rows of the batch, and
            the trainable gradients are averaged over the group
  "model" - tensor parallelism over attention heads and the MLP hidden dim
            (parallel/sharding.py, models/layers.py)

"model" varies fastest: rank = data_rank * model + model_rank, as
np.reshape(devices, (data, model)) lays the JAX mesh out.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")

# the backend each device type takes unless the caller names one
DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def world_size() -> int:
    """Ranks in the default process group (1 when there is none)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def create_mesh(data: Optional[int] = None, model: int = 1, *,
                device_type: str = "cuda", backend: Optional[str] = None,
                device: Optional[torch.device] = None) -> DeviceMesh:
    """Build a ("data", "model") DeviceMesh over every rank. Default: all
    ranks on "data".

    The default process group is the caller's when it exists (torchrun's
    `init_process_group`, a test's file rendezvous); `backend`, if given,
    must be its backend. Without one, a mesh of one rank makes its own
    group on an in-process store; a larger mesh needs the caller's group.
    The backend is `nccl` on CUDA and `gloo` on the CPU unless the caller
    names one (gloo takes CUDA tensors too, for ranks that share one card:
    NCCL refuses two ranks on a device). Nothing switches it by itself.

    device (CUDA): the rank's card; cuda:LOCAL_RANK when not given (0 when
    LOCAL_RANK is unset), made the current device before any group uses it.
    """
    if device_type not in DEFAULT_BACKEND:
        raise ValueError(f"device_type must be cuda or cpu, got {device_type!r}")
    n = world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device_type == "cuda":
        if device is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                             f"not the {backend!r} asked for")
    else:
        dist.init_process_group(backend or DEFAULT_BACKEND[device_type],
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def coords(mesh, axis: str) -> tuple:
    """(this rank's index along `axis`, the axis's size)."""
    return mesh.get_local_rank(axis), mesh.size(AXES.index(axis))
