"""The device feed: numpy batches -> tensors on the card (port of
ray_tpu/data/iterator.py `DataIterator.iter_jax_batches`, :121-148).

`iter_device_batches(np_batches, ...)` takes any iterator of numpy dict
batches, such as the reference's `DataIterator.iter_batches(
batch_format="numpy")`, and yields dicts of tensors on `device` (CUDA
unless the caller asks for the CPU).  On CUDA each batch is cast by
`dtypes`, copied into pinned host memory, and sent to the card by a
non-blocking copy on a side stream; the copies of the next `prefetch - 1`
batches are issued before a batch is yielded, so the host-to-device
transfer overlaps the consumer's step, as the reference's `device_put` of
batch N+1 before it yields batch N does.  The consumer's stream waits on
the copy's event (a device-side wait, no host sync), and each tensor is
recorded on that stream so the allocator keeps it until the step is done
with it.  On the CPU the batches become CPU tensors and nothing is pinned.

The reference's host-side `iter_torch_batches` (:150) is not device code
and stays the reference's.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def _host(value, dtype) -> torch.Tensor:
    """One column as a contiguous CPU tensor, cast by `dtype` (a numpy or
    torch dtype, or None)."""
    if dtype is not None and not isinstance(dtype, torch.dtype):
        value = np.asarray(value).astype(dtype)
    t = torch.from_numpy(np.ascontiguousarray(value))
    return t.to(dtype) if isinstance(dtype, torch.dtype) else t


def iter_device_batches(np_batches: Iterable[dict], *, device=None,
                        dtypes: dict | None = None,
                        prefetch: int = 2) -> Iterator[dict]:
    """Yield each numpy dict batch of `np_batches` as tensors on `device`,
    in order, cast by `dtypes` ({column: numpy or torch dtype}), with up
    to `prefetch` host-to-device copies in flight on CUDA."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    device = resolve_device(device, "iter_device_batches")
    dtypes = dtypes or {}
    if device.type != "cuda":
        for batch in np_batches:
            yield {k: _host(v, dtypes.get(k)).to(device)
                   for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    pending: collections.deque = collections.deque()

    def ready():
        batch, done = pending.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in batch.values():
            t.record_stream(consumer)
        return batch

    for batch in np_batches:
        host = {k: _host(v, dtypes.get(k)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(side):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        pending.append((dev, done))
        if len(pending) >= prefetch:
            yield ready()
    while pending:
        yield ready()
