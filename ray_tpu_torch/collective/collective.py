"""The packed pytree broadcast (port of `broadcast_pytree` and
`broadcast_pytree_async` in ray_tpu/collective/collective.py).

A llama param tree is a dozen to hundreds of leaves; one broadcast per
leaf would pay the group's hop latency per leaf, so every rank packs the
leaves into one contiguous uint8 buffer and the group moves that once.
The leaves go in `train/session.py` `flatten`'s order (dict keys sorted,
lists in order, None no leaf), which is jax's `tree_flatten` order: a JAX
learner's buffer and the port's hold the same bytes in the same places,
so either side can send to the other.

The transport is the runtime's: `runtime.broadcast_async(payload,
src_rank, group_name)` over a group the members joined with
`runtime.init_collective_group`.  The reference's ring and tree
schedules and its rendezvous actor are the runtime's business and stay
behind the seam (`serve/runtime.py`: `LocalRuntime` in one process, a
binding to a cluster elsewhere).

The source rank gets its own tree back.  Every other rank passes a tree
of the same structure, leaf shapes and dtypes (torch tensors or numpy
arrays, of which only shape and dtype are read: `torch.empty` will do)
and gets CPU torch tensors viewed from the received buffer, since numpy
has no bf16.  A byte count that differs from the template's raises
instead of mis-slicing.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ray_tpu_torch.serve.runtime import ServeRuntime
from ray_tpu_torch.train.session import flatten, unflatten


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    dt = np.dtype(x.dtype)
    if dt.name == "bfloat16":             # ml_dtypes' bf16 (a JAX leaf)
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(x.shape, dtype=np.int64)) * np.dtype(x.dtype).itemsize


def _as_bytes(x) -> torch.Tensor:
    """A leaf's bytes as a flat uint8 tensor on the leaf's device."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x)
        return torch.from_numpy(a.reshape(-1).view(np.uint8))
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def pack(leaves: list) -> np.ndarray:
    """The leaves' bytes, concatenated in order, as one numpy uint8 array
    (one device-to-host copy when the leaves are on one CUDA device)."""
    parts = [_as_bytes(x) for x in leaves]
    cuda = [p.device for p in parts if p.device.type == "cuda"]
    if cuda:
        flat = torch.cat([p.to(cuda[0]) for p in parts]).cpu()
    else:
        flat = torch.cat(parts) if parts \
            else torch.empty(0, dtype=torch.uint8)
    return flat.numpy()


def unpack(flat, template: list) -> list:
    """CPU torch tensors with the template leaves' shapes and dtypes,
    viewed from `flat` (numpy or a uint8 tensor) in order."""
    if isinstance(flat, torch.Tensor):
        buf = flat.reshape(-1).view(torch.uint8)
    else:
        a = np.asarray(flat).reshape(-1).view(np.uint8)
        with warnings.catch_warnings():
            # A payload from a shared object store is read-only; the
            # views are only read (the engine copies them at its swap).
            warnings.filterwarnings("ignore", message=".*not writable.*")
            buf = torch.from_numpy(a)
    out, off = [], 0
    for x in template:
        n = _nbytes(x)
        dtype = _torch_dtype(x)
        part = buf[off:off + n]
        if off % dtype.itemsize:
            part = part.clone()           # a dtype view needs alignment
        out.append(part.view(dtype).reshape(tuple(x.shape)))
        off += n
    return out


class _Unpacked:
    """Waitable of broadcast_pytree_async: the tree, unpacked on the
    waiter's thread at the first wait."""

    _UNSET = object()

    def __init__(self, inner, fn):
        self._inner, self._fn = inner, fn
        self._out = _Unpacked._UNSET

    def wait(self, timeout: float | None = None):
        if self._out is _Unpacked._UNSET:
            self._out = self._fn(self._inner.wait(timeout))
        return self._out


def broadcast_pytree(tree, src_rank: int = 0, group_name: str = "default",
                     *, runtime: ServeRuntime | None = None,
                     timeout: float | None = None):
    """`tree` with rank `src_rank`'s leaf values, on every rank of
    `group_name` (see the module docstring)."""
    return broadcast_pytree_async(tree, src_rank, group_name,
                                  runtime=runtime).wait(timeout)


def broadcast_pytree_async(tree, src_rank: int = 0,
                           group_name: str = "default", *,
                           runtime: ServeRuntime | None = None):
    """Start the packed broadcast; returns a waitable whose
    `.wait(timeout)` gives the tree.  The source packs before this
    returns, so it may change its tree at once."""
    rt = runtime or ServeRuntime()
    is_src = rt.get_rank(group_name) == src_rank
    leaves: list = []
    spec = flatten(tree, leaves)
    total = sum(_nbytes(x) for x in leaves)
    payload = pack(leaves) if is_src else None
    work = rt.broadcast_async(payload, src_rank, group_name)

    def finish(flat):
        if is_src:
            return tree
        got = np.asarray(flat).nbytes if not isinstance(flat, torch.Tensor) \
            else flat.numel() * flat.element_size()
        if got != total:
            raise RuntimeError(
                f"broadcast_pytree: received {got} bytes but "
                f"this rank's template tree holds {total} — src and "
                "receiver param trees have drifted (different model "
                "config / stale template?)")
        return unflatten(spec, unpack(flat, leaves))

    return _Unpacked(work, finish)
