"""Logical-axis sharding rules as DTensor placements (port of
ray_tpu/parallel/sharding.py).

The reference declares every parallelism as a layout: logical array axes
map to mesh axes through LOGICAL_RULES and GSPMD inserts the collectives.
The port keeps the rules table and turns a logical-axes tuple into DTensor
placements on a torch DeviceMesh (parallel/mesh.py): `Shard(i)` on each
mesh dim that tensor dim i maps to, `Replicate()` on the others.  DTensor's
op propagation then inserts the collectives (all-gathers of fsdp-sharded
parameters, reductions of tensor-parallel partial sums), as GSPMD does.

A tensor dim that maps to two mesh axes ("batch" -> ("data", "fsdp"))
splits over the first named axis outermost, as a PartitionSpec entry does;
DTensor splits in mesh-dim order, so the rules name their axes in that
order (checked in `logical_placements`).

There is no trace context: the mesh of a DTensor is its own
(`DTensor.device_mesh`), and `with_sharding_constraint` leaves plain
tensors alone.
"""
from __future__ import annotations

import collections

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

# logical axis -> mesh axes (None = replicated); the reference's table.
LOGICAL_RULES: dict[str, tuple | str | None] = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "vocab": "tensor",
    "expert": "expert",
    "layers": None,
}

# A layout: the mesh and one placement per mesh dim (the counterpart of a
# NamedSharding).
NamedSharding = collections.namedtuple("NamedSharding", "mesh placements")


def logical_spec(logical_axes: tuple[str | None, ...],
                 rules: dict | None = None) -> tuple:
    """Per tensor dim, the mesh axes it shards over (None, an axis name or
    a tuple of names): the reference's PartitionSpec entries.  A mesh axis
    already used by an earlier dim is dropped."""
    rules = rules or LOGICAL_RULES
    spec = []
    used: set[str] = set()
    for name in logical_axes:
        if name is None:
            spec.append(None)
            continue
        mesh_axes = rules.get(name)
        if mesh_axes is None:
            spec.append(None)
        elif isinstance(mesh_axes, str):
            spec.append(None if mesh_axes in used else mesh_axes)
            used.add(mesh_axes)
        else:
            avail = tuple(a for a in mesh_axes if a not in used)
            used.update(avail)
            spec.append(avail if avail else None)
    return tuple(spec)


def _prune(mesh: DeviceMesh, entry):
    """Remove axes the mesh does not have (one rules table serves meshes
    with fewer axes)."""
    names = mesh.mesh_dim_names or ()
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in names else None
    kept = tuple(a for a in entry if a in names)
    return kept if kept else None


def logical_placements(mesh: DeviceMesh,
                       logical_axes: tuple[str | None, ...],
                       rules: dict | None = None) -> tuple:
    """DTensor placements for a tensor with these logical axes."""
    names = list(mesh.mesh_dim_names or ())
    placements = [Replicate()] * mesh.ndim
    for i, entry in enumerate(logical_spec(logical_axes, rules)):
        entry = _prune(mesh, entry)
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(
                f"tensor dim {i} splits over {axes}, which is not the mesh "
                f"order {tuple(names)}: DTensor splits outermost first in "
                "mesh order")
        for d in dims:
            placements[d] = Shard(i)
    return tuple(placements)


def logical_sharding(mesh: DeviceMesh, logical_axes: tuple[str | None, ...],
                     rules: dict | None = None) -> NamedSharding:
    return NamedSharding(mesh, logical_placements(mesh, logical_axes, rules))


def tree_map(fn, tree, *rest):
    """fn over the leaves of a nested dict and of the trees shaped like
    it in `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def param_shardings(axes_tree, mesh: DeviceMesh, rules: dict | None = None):
    """A NamedSharding per leaf of a logical-axes tree."""
    return tree_map(lambda ax: logical_sharding(mesh, ax, rules), axes_tree)


def shard_params(params, axes_tree, mesh: DeviceMesh,
                 rules: dict | None = None):
    """Lay a tree of full tensors out by its logical-axes tree
    (`distribute_tensor` per leaf; every rank passes the same values)."""
    return tree_map(
        lambda t, sh: distribute_tensor(t, sh.mesh, sh.placements),
        params, param_shardings(axes_tree, mesh, rules))


def logical_axis_size(logical: str, mesh: DeviceMesh | None = None,
                      rules: dict | None = None) -> int:
    """Product of the mesh-axis sizes a logical axis maps to (1 without a
    mesh, or where it is effectively unsharded)."""
    if mesh is None:
        return 1
    entry = (rules or LOGICAL_RULES).get(logical)
    if entry is None:
        return 1
    names = list(mesh.mesh_dim_names or ())
    size = 1
    for a in ((entry,) if isinstance(entry, str) else entry):
        if a in names:
            size *= mesh.size(names.index(a))
    return size


def mesh_axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Size of a named mesh axis; 1 where the mesh lacks it (create_mesh
    leaves size-1 axes out) or there is no mesh."""
    names = list(mesh.mesh_dim_names or ()) if mesh is not None else []
    return mesh.size(names.index(axis)) if axis in names else 1


def mesh_of(x) -> DeviceMesh | None:
    """The mesh a DTensor lives on; None for a plain tensor."""
    return x.device_mesh if isinstance(x, DTensor) else None


def replicate_like(t: torch.Tensor, ref):
    """`t`, replicated on `ref`'s mesh when `ref` is a DTensor (constant
    tables the model builds beside sharded activations); else `t`."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def with_sharding_constraint(x, logical_axes: tuple[str | None, ...],
                             mesh: DeviceMesh | None = None,
                             rules: dict | None = None):
    """Lay an intermediate DTensor out by logical axes (a redistribute,
    which reduces a partial sum or gathers a shard as needed); a plain
    tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    mesh = mesh or x.device_mesh
    placements = logical_placements(mesh, logical_axes, rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)
