"""Per-train-worker session helpers (port of the device-facing part of
ray_tpu/train/session.py).

`host_broadcast(tree, src_rank)` is the counterpart of the reference's
`session.host_broadcast` (:208): every rank calls it with a tree of the
same structure, leaf shapes and dtypes right after building or restoring
its initial state, and gets back rank `src_rank`'s values, so a rank that
joined the gang starts from the others' state instead of a checkpoint.

The reference flattens a jax pytree and broadcasts leaf by leaf over its
host collective group.  Here the tree is nested dicts, lists and tuples
whose leaves are torch tensors, numpy arrays or scalars; the leaves are
packed into one flat tensor per dtype (dtypes in the order they first
appear), each broadcast once over the default process group (on the
current CUDA device under NCCL, on the host under gloo), and unpacked into
the same structure: tensors come back as tensors on their own device,
numpy arrays and scalars as numpy arrays (as the reference returns them).
When no group is initialised, or its world size is 1, the result is a
copy of the tree, never an alias of the caller's leaves.

Not ported, deliberately: the reference's check of the session's stop
event (a survivor parked at an elastic epoch barrier raises
StopIteration) and its `train.rank_join` failpoint.  Both live in the
reference's session object inside a runtime train worker, which the port
does not have.
"""
from __future__ import annotations

import numpy as np
import torch


def flatten(tree, leaves: list):
    """Append `tree`'s leaves to `leaves` in a fixed order (dict keys
    sorted, as jax's tree_flatten orders them; None is no leaf) and return
    a structure to rebuild from.  host_broadcast and
    collective.broadcast_pytree pack in this order."""
    if isinstance(tree, dict):
        return {k: flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(flatten(x, leaves) for x in tree)
    if tree is None:
        return None
    leaves.append(tree)
    return len(leaves) - 1


def unflatten(spec, leaves: list):
    if isinstance(spec, dict):
        return {k: unflatten(v, leaves) for k, v in spec.items()}
    if isinstance(spec, (list, tuple)):
        return type(spec)(unflatten(x, leaves) for x in spec)
    return None if spec is None else leaves[spec]


def _copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(np.asarray(x), copy=True)


def host_broadcast(tree, src_rank: int = 0):
    """`tree` with rank `src_rank`'s leaf values on every rank of the
    default process group (a copy of `tree` when there is no group of more
    than one rank)."""
    import torch.distributed as dist

    leaves: list = []
    spec = flatten(tree, leaves)
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return unflatten(spec, [_copy(x) for x in leaves])
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    tensors = [x.detach() if isinstance(x, torch.Tensor)
               else torch.from_numpy(np.array(np.asarray(x)))
               for x in leaves]
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: list = [None] * len(leaves)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1).to(comm) for i in idx])
        dist.broadcast(flat, src=src_rank)
        offset = 0
        for i in idx:
            t = tensors[i]
            part = flat[offset:offset + t.numel()].view(t.shape)
            offset += t.numel()
            if isinstance(leaves[i], torch.Tensor):
                out[i] = part.to(t.device, copy=True)
            else:
                out[i] = part.cpu().numpy().copy()
    return unflatten(spec, out)
