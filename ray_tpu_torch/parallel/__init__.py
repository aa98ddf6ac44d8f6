"""Parallelism layer (port of ray_tpu/parallel): the device mesh over the
default process group's ranks, the logical-axis sharding rules as DTensor
placements, ring attention over the "seq" axis (ring.py) and the GPipe
pipeline over the "stage" axis (pipeline.py)."""
from ray_tpu_torch.parallel.mesh import (MeshConfig, create_mesh, local_mesh,
                                         mesh_shape_for)
from ray_tpu_torch.parallel.sharding import (LOGICAL_RULES, logical_sharding,
                                             logical_spec, shard_params,
                                             with_sharding_constraint)

__all__ = [
    "MeshConfig", "create_mesh", "local_mesh", "mesh_shape_for",
    "LOGICAL_RULES", "logical_spec", "logical_sharding", "shard_params",
    "with_sharding_constraint",
]
