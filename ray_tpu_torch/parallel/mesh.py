"""Device mesh construction for the data / fsdp / seq / expert / tensor /
stage axes (port of ray_tpu/parallel/mesh.py).

The reference's mesh is a jax Mesh over the devices of one program.  Here
it is a torch DeviceMesh over the ranks of the default process group,
which the caller initialises (`torch.distributed.init_process_group`, its
address, world size and rank given explicitly): one rank per device.
Axis order (outer -> inner) is the reference's: ("stage", "data", "fsdp",
"seq", "expert", "tensor").
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch._device import resolve_device

AXES = ("stage", "data", "fsdp", "seq", "expert", "tensor")


@dataclass
class MeshConfig:
    """Sizes per axis; -1 means "absorb all remaining devices"."""

    data: int = -1
    fsdp: int = 1
    seq: int = 1
    expert: int = 1
    tensor: int = 1
    stage: int = 1

    def resolve(self, n_devices: int) -> tuple[int, ...]:
        sizes = [self.stage, self.data, self.fsdp, self.seq, self.expert,
                 self.tensor]
        fixed = 1
        wild = None
        for i, s in enumerate(sizes):
            if s == -1:
                if wild is not None:
                    raise ValueError("only one mesh axis may be -1")
                wild = i
            else:
                fixed *= s
        if wild is not None:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wild] = n_devices // fixed
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, sizes))} != {n_devices} devices")
        return tuple(sizes)


def mesh_shape_for(n_devices: int, config: MeshConfig | None = None):
    return (config or MeshConfig()).resolve(n_devices)


def create_mesh(config: MeshConfig | None = None,
                device_type: str | None = None) -> DeviceMesh:
    """The framework mesh over the default process group's ranks, rank r
    at position r of the row-major mesh.  `device_type` is "cuda" unless
    the caller asks for "cpu" (CUDA missing raises, as every entry point
    does); the group must already be initialised.

    Axes of size 1 are left out of the DeviceMesh ("data" stays when every
    axis is 1): DTensor's sharding propagation enumerates placements over
    every mesh dim, so each extra dim multiplies its cost, while a size-1
    axis shards nothing.  The sharding rules prune axes the mesh lacks, as
    the reference's do."""
    device = resolve_device(device_type, "create_mesh")
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group with its address, world "
            "size and rank)")
    shape = mesh_shape_for(dist.get_world_size(), config)
    kept = [(a, n) for a, n in zip(AXES, shape) if n > 1] or [("data", 1)]
    return init_device_mesh(device.type, tuple(n for _, n in kept),
                            mesh_dim_names=tuple(a for a, _ in kept))


def local_mesh(device_type: str | None = None) -> DeviceMesh:
    """Mesh over every rank of the default group: data 1 on one rank,
    fsdp over all of them otherwise (the reference's test split)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return create_mesh(MeshConfig(data=1), device_type)
    return create_mesh(MeshConfig(data=1, fsdp=n), device_type)
