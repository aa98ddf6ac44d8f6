"""Pipeline parallelism: GPipe microbatching over the mesh's "stage" axis
(port of ray_tpu/parallel/pipeline.py).

Stages are the ranks of the stage axis.  Each holds its block of the
stacked stage parameters (Shard(0) on the stage dim), runs one microbatch
a step, and hands its activation to the next stage (`comm.ring_shift`,
the reference's ppermute; differentiable).  The schedule is the
reference's: n_micro + n_stages - 1 steps, stage 0 feeding itself from
the microbatch queue and zeros once it is drained, every stage computing
every step (the bubble steps compute on zeros and their results are never
read).  The last stage's outputs reach every stage through an all-reduce
of the masked outputs (`comm.reduce_out`); the microbatches' gradient is
summed over the stages (`comm.copy_in`), as shard_map's transpose does
for its replicated input.

The other mesh axes stay as layouts: inside a stage the parameters and
activations are DTensors on the mesh without the stage axis, so fsdp,
tensor and data compose with the pipeline as DTensor propagation, the
way GSPMD composes them in the reference.

Usage:
    fn(stage_params, x) -> y          # one stage's computation
    out = pipeline_apply(fn, stacked_params, microbatches, mesh)
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.comm import (copy_in, keep_in_graph, reduce_out,
                                         ring_shift)
from ray_tpu_torch.parallel.sharding import (NamedSharding, logical_sharding,
                                             tree_map)


def _drop_dim(placements, dim: int) -> tuple:
    """Placements without mesh dim `dim`, each Shard moved down by one
    tensor dim (the caller drops the leading tensor dim as well)."""
    out = []
    for i, p in enumerate(placements):
        if i == dim:
            continue
        out.append(Shard(p.dim - 1) if isinstance(p, Shard) else p)
    return tuple(out)


def _from_local(t, mesh, placements, shape) -> DTensor:
    """A DTensor of global `shape` (contiguous) from this rank's shard."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def pipeline_apply(stage_fn: Callable, stage_params, microbatches,
                   mesh: DeviceMesh, axis: str = "stage"):
    """Run microbatches through all pipeline stages (GPipe schedule).

    stage_fn(params_for_one_stage, x [mb, ...]) -> y [mb, ...], the same
    shape (stages preserve the activation's shape, as a decoder trunk
    does).  `stage_params` is a dict tree of [n_stages, ...] leaves:
    DTensors with Shard(0) on `axis` (each rank holds its stage's block),
    or plain tensors holding every stage.  `microbatches` [n_micro, mb,
    ...] is a DTensor replicated over `axis`, or a plain tensor, the same
    on every rank.  Returns [n_micro, mb, ...] outputs after the last
    stage, laid out like `microbatches`, on every rank."""
    names = list(mesh.mesh_dim_names or ())
    dim = names.index(axis)
    n_stages = mesh.size(dim)
    stage_idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_micro = microbatches.shape[0]
    steps = n_micro + n_stages - 1
    inner = tuple(n for n in names if n != axis)
    sub = mesh[inner] if inner else None     # the mesh inside one stage

    def stage_leaf(p):
        if not isinstance(p, DTensor):
            return p[stage_idx]
        if p.placements[dim] != Shard(0):
            raise ValueError(f"stage params must be Shard(0) on {axis!r}, "
                             f"got {tuple(p.placements)}")
        local = p.to_local()[0]
        if sub is None:
            return local
        return _from_local(local, sub, _drop_dim(p.placements, dim),
                           p.shape[1:])

    params = tree_map(stage_leaf, stage_params)

    if isinstance(microbatches, DTensor):
        if microbatches.placements[dim] != Replicate():
            raise ValueError(f"microbatches must be replicated over "
                             f"{axis!r}, got {tuple(microbatches.placements)}")
        mb_local = microbatches.to_local()
        act_place = _drop_dim(microbatches.placements, dim)
    else:
        mb_local, act_place = microbatches, ()

    def wrap(t):
        if sub is None or not isinstance(microbatches, DTensor):
            return t
        return _from_local(t, sub, act_place, microbatches.shape[1:])

    def unwrap(y):
        if not isinstance(y, DTensor):
            return y
        if tuple(y.placements) != act_place:
            y = y.redistribute(sub, act_place)
        return y.to_local()

    mb_local = copy_in(mb_local, group)
    # A tensor, not a Python branch: stage 0 keeps what the ring brought
    # in the graph (zero gradient), so every rank runs every shift's
    # backward, as every rank ran its forward.
    first = torch.tensor(stage_idx == 0, device=mb_local.device)
    state = torch.zeros_like(mb_local[0])
    outs = []
    for t in range(steps):
        fed = mb_local[t] if t < n_micro else torch.zeros_like(state)
        state = torch.where(first, fed, state)
        y = unwrap(stage_fn(params, wrap(state)))
        if stage_idx == n_stages - 1 and t >= n_stages - 1:
            outs.append(y)          # microbatch t - (n_stages - 1)
        # Shift activations to the next stage; the last step's shift
        # would carry nothing anyone reads.
        if t < steps - 1:
            state = ring_shift(y, group)
    outputs = torch.stack(outs) if outs else torch.zeros_like(mb_local)
    # Only the last stage's outputs depend on its work locally; an earlier
    # stage's last activation joins the graph at a zero gradient, so its
    # backward runs the stage's chain (the real gradients arrive through
    # the shifts' backward).
    outputs = reduce_out(keep_in_graph(outputs, y), group)
    if not isinstance(microbatches, DTensor):
        return outputs
    return _from_local(outputs, mesh, microbatches.placements,
                       microbatches.shape)


def stack_stage_params(per_stage_params: list):
    """[tree, ...] per stage -> one tree with leading [n_stages, ...]."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def stage_sharding(mesh: DeviceMesh, axis: str = "stage") -> NamedSharding:
    """The layout placing a leading stage dim on the mesh axis."""
    return logical_sharding(mesh, ("stage",), rules={"stage": axis})
