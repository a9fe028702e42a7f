"""Production mesh construction (``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  ``make_production_mesh`` describes the reference's 16 x 16
(or 2 x 16 x 16) layout with no process group, as the reference builds it
from placeholder host devices; ``make_live_mesh`` builds a mesh over the
initialised process group, which the sharded paths run on."""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 chips (data, model).
    Multi-pod: 2 x 16 x 16 = 512 chips (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_live_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh over the initialised default process group, whose world size
    must be the product of ``shape``; ranks fill it in row-major order.  On
    an NCCL group the mesh's device is the card, else the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"world size {dist.get_world_size()} is not the mesh's "
                         f"{math.prod(shape)} ({tuple(shape)})")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))
    return Mesh(tuple(axis_names), tuple(shape), dm)


def mesh_dp_size(mesh: Mesh) -> int:
    return mesh.dp_size()
