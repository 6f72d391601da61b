"""Device meshes over an initialised process group (the JAX package's
``repro.launch.mesh``, as ``torch.distributed.device_mesh.DeviceMesh``).

One rank is one device. Every function here needs a process group that
the caller has set up (``torch.distributed.init_process_group`` with its
backend, rank, world size and store or address) whose world size is the
mesh's size, and raises otherwise: none of them sets up a group. The mesh
is on ``"cuda"`` unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_mesh", "make_production_mesh", "make_local_mesh",
           "POD_SHAPE", "MULTIPOD_SHAPE"]

POD_SHAPE: Tuple[int, ...] = (16, 16)            # one pod: 256 devices
MULTIPOD_SHAPE: Tuple[int, ...] = (2, 16, 16)    # 2 pods = 512 devices


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group's ranks, in rank order."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes "
                         f"{tuple(axes)} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {tuple(shape)} mesh over {tuple(axes)} needs an "
            f"initialised process group: call "
            f"torch.distributed.init_process_group first")
    size = math.prod(shape)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"a {tuple(shape)} mesh holds {size} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_local_mesh(data: Optional[int] = None, model: int = 1, *,
                    device_type: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the process group;
    ``data`` defaults to the world size over ``model``."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialised process "
                           "group: call torch.distributed.init_process_group"
                           " first")
    if data is None:
        data = dist.get_world_size() // model
    return make_mesh((data, model), ("data", "model"),
                     device_type=device_type)
