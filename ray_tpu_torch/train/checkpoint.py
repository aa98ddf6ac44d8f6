"""Checkpoint: a directory handle + tensor-tree (de)serialization (port of
ray_tpu/train/checkpoint.py).

A tree is nested dicts (string keys), lists and tuples whose leaves are
tensors, numpy arrays or plain Python values.  `from_pytree` writes one
`state.pt`: `torch.save` of {"leaves": {key path: tensor}, "structure":
the tree with each array leaf replaced by its key path}, read back with
`torch.load(weights_only=True)`.  numpy leaves come back as numpy; tensor
leaves as CPU tensors, or placed like the `target` tree's leaves
(device, dtype).  The reference writes orbax (or npz) instead; numpy
cannot hold bf16, and the port has no orbax.

Async writes (`from_pytree_async`) run on one background writer thread
per process.  Tensors are mutable, where the reference's jax arrays are
not, so the tree is SNAPSHOT before the call returns: CUDA leaves are
cloned on their device behind an event the writer waits on, CPU leaves
and numpy arrays are copied.  The caller may update the leaves in place
as soon as the call returns.  The write lands under a temporary name and
is renamed into place, so a directory never holds half a state.pt.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.train.config import CheckpointConfig

STATE_FILE = "state.pt"

# ---------------------------------------------------------- async writer
# One background writer thread per process: the loop hands a snapshot of
# its tree to `from_pytree_async` and keeps computing while serialization
# and the write run here; the write is forced complete by
# Checkpoint.wait(), by CheckpointManager.register(), by pickling the
# handle (it never crosses a process boundary half-written), and by
# flush_pending_writes().
_writer_lock = threading.Lock()
_writer_pool = None
# STRONG refs to in-flight write futures: a handle dropped without ever
# reaching a flush point must still be waited out, and a FAILED write
# must still surface, at the next flush.  Successful futures self-remove
# on completion; failed ones stay until a flush observes (and raises)
# them.
_inflight_futs: set = set()


def _writer():
    global _writer_pool
    with _writer_lock:
        if _writer_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            _writer_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="raytpu-ckpt-writer")
        return _writer_pool


def _track(fut) -> None:
    _inflight_futs.add(fut)

    def _done(f):
        if not f.cancelled() and f.exception() is None:
            _inflight_futs.discard(f)
    fut.add_done_callback(_done)


def flush_pending_writes(timeout: float | None = None) -> int:
    """Block until every in-flight async checkpoint write in this process
    has completed; re-raises the first failure; returns how many were
    pending."""
    pending = list(_inflight_futs)
    first_err = None
    for fut in pending:
        try:
            fut.result(timeout)
        except Exception as e:  # noqa: BLE001 - re-raised below
            first_err = first_err or e
        # Observed (success or failure): drop it either way so a failed
        # write doesn't poison every later run in this process.
        _inflight_futs.discard(fut)
    if first_err is not None:
        raise first_err
    return len(pending)


# ------------------------------------------------------------- the tree
def _flatten(tree: Any, path: str = "") -> tuple[Any, dict]:
    """(structure, {key path: array leaf}); the structure holds only
    containers, strings and plain values, so weights_only loads it."""
    if isinstance(tree, dict):
        keys = list(tree)
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"checkpoint tree {path or '/'}: dict keys "
                            f"must be strings, got {keys}")
        leaves, kids = {}, []
        for k in keys:
            s, sub = _flatten(tree[k], f"{path}/{k}")
            kids.append(s)
            leaves.update(sub)
        return ("dict", keys, kids), leaves
    if isinstance(tree, (list, tuple)):
        leaves, kids = {}, []
        for i, v in enumerate(tree):
            s, sub = _flatten(v, f"{path}/{i}")
            kids.append(s)
            leaves.update(sub)
        return ("list" if isinstance(tree, list) else "tuple", kids), leaves
    key = path or "/"
    if isinstance(tree, torch.Tensor):
        return ("tensor", key), {key: tree}
    if isinstance(tree, (np.ndarray, np.generic)):
        if tree.dtype == object:
            raise TypeError(f"checkpoint tree {key}: object arrays are "
                            "not supported")
        return ("numpy", key), {key: tree}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return ("value", tree), {}
    raise TypeError(f"checkpoint tree {key}: unsupported leaf "
                    f"{type(tree).__name__}")


def _unflatten(structure, leaves: dict, target: Any = None,
               path: str = "") -> Any:
    kind = structure[0]
    if kind == "dict":
        _, keys, kids = structure
        if target is not None and (not isinstance(target, dict)
                                   or list(target) != list(keys)):
            got = list(target) if isinstance(target, dict) \
                else type(target).__name__
            raise ValueError(f"checkpoint {path or '/'}: keys {keys} do "
                             f"not match the target's {got}")
        return {k: _unflatten(s, leaves,
                              None if target is None else target[k],
                              f"{path}/{k}")
                for k, s in zip(keys, kids)}
    if kind in ("list", "tuple"):
        kids = structure[1]
        if target is not None and (not isinstance(target, (list, tuple))
                                   or len(target) != len(kids)):
            raise ValueError(f"checkpoint {path or '/'}: a {kind} of "
                             f"{len(kids)} does not match the target")
        out = [_unflatten(s, leaves, None if target is None else target[i],
                          f"{path}/{i}") for i, s in enumerate(kids)]
        return out if kind == "list" else tuple(out)
    if kind == "value":
        return structure[1]
    t = leaves[structure[1]]
    if isinstance(target, torch.Tensor):
        if tuple(t.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint {structure[1]}: shape "
                             f"{tuple(t.shape)} != target "
                             f"{tuple(target.shape)}")
        return t.to(device=target.device, dtype=target.dtype)
    return t.numpy() if kind == "numpy" else t


def _host_tensor(x) -> torch.Tensor:
    """A leaf as a CPU tensor that owns exactly its elements (torch.save
    writes a view's whole storage)."""
    if not isinstance(x, torch.Tensor):
        return torch.from_numpy(np.array(x))       # numpy leaf: own copy
    t = x.detach().cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size() \
            or not t.is_contiguous():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _write(d: str, structure, leaves: dict) -> None:
    tmp = os.path.join(d, STATE_FILE + ".tmp")
    torch.save({"structure": structure,
                "leaves": {k: _host_tensor(v) for k, v in leaves.items()}},
               tmp)
    os.replace(tmp, os.path.join(d, STATE_FILE))


def _snapshot(leaves: dict) -> tuple[dict, list]:
    """Copies of the array leaves taken now, and the CUDA events that mark
    when the device copies are done (recorded on each device's current
    stream, behind whatever was queued before)."""
    out, devices = {}, set()
    for k, v in leaves.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            out[k] = v.clone()
            if v.is_cuda:
                devices.add(v.device)
        else:
            out[k] = np.array(v)
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return out, events


class Checkpoint:
    """An immutable directory of checkpoint data."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        # Future of an in-flight background write (from_pytree_async);
        # None once complete.  Never crosses process boundaries — see
        # __reduce__.
        self._pending = None

    def wait(self, timeout: float | None = None) -> "Checkpoint":
        """Block until this checkpoint's background write (if any) has
        finished; re-raises a failed write's exception.  `_pending` clears
        only on a COMPLETED future, so a timed-out wait leaves the handle
        flagged and a failed write keeps re-raising."""
        fut = self._pending
        if fut is not None:
            fut.result(timeout)
            self._pending = None
        return self

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="raytpu-ckpt-")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> dict:
        self.wait()
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    @classmethod
    def from_pytree(cls, tree: Any, path: str | None = None) -> "Checkpoint":
        """Persist a tree of tensors, numpy arrays and plain values (see
        the module docstring for the format)."""
        d = path or tempfile.mkdtemp(prefix="raytpu-ckpt-")
        os.makedirs(d, exist_ok=True)
        structure, leaves = _flatten(tree)
        _write(d, structure, leaves)
        return cls(d)

    @classmethod
    def from_pytree_async(cls, tree: Any,
                          path: str | None = None) -> "Checkpoint":
        """`from_pytree` with serialization and the write on the process's
        background writer thread.  The tree is flattened and snapshot
        before this returns (it fails fast on an unsupported tree), so
        in-place updates of its leaves after the call never reach the
        file.  The snapshot costs one copy of the array leaves on their
        device until the write lands.  Returns the handle at once; the
        write is forced complete by wait(), register(), pickling, and
        flush_pending_writes()."""
        d = path or tempfile.mkdtemp(prefix="raytpu-ckpt-")
        os.makedirs(d, exist_ok=True)
        structure, leaves = _flatten(tree)
        snap, events = _snapshot(leaves)

        def _job() -> None:
            for ev in events:
                ev.synchronize()
            _write(d, structure, snap)

        ckpt = cls(d)
        ckpt._pending = _writer().submit(_job)
        _track(ckpt._pending)
        return ckpt

    def to_pytree(self, target: Any = None) -> Any:
        """Restore the tree.  With `target` (a tree of the same structure)
        each tensor leaf is checked against the target's shape and placed
        on its device in its dtype; without, tensors come back on the
        CPU."""
        self.wait()
        data = torch.load(os.path.join(self.path, STATE_FILE),
                          map_location="cpu", weights_only=True)
        return _unflatten(data["structure"], data["leaves"], target)

    EPHEMERAL_MARKER = ".raytpu-ephemeral"

    @classmethod
    def mark_ephemeral(cls, path: str) -> None:
        """Flag a checkpoint directory as a one-shot handoff: the first
        CheckpointManager.register() that copies it into run storage also
        deletes it."""
        with open(os.path.join(path, cls.EPHEMERAL_MARKER), "w"):
            pass

    def is_ephemeral(self) -> bool:
        return os.path.exists(os.path.join(self.path,
                                           self.EPHEMERAL_MARKER))

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        # A handle must never cross a process boundary with its write
        # still in flight: pickling IS the synchronization point.
        self.wait()
        return (Checkpoint, (self.path,))


class _TrackedCheckpoint:
    def __init__(self, checkpoint: Checkpoint, metrics: dict, index: int):
        self.checkpoint = checkpoint
        self.metrics = metrics
        self.index = index


class CheckpointManager:
    """Registers reported checkpoints into the run's storage dir, keeps the
    best `num_to_keep` by score (ray: train/_internal/checkpoint_manager)."""

    def __init__(self, storage_path: str,
                 config: CheckpointConfig | None = None):
        self.config = config or CheckpointConfig()
        self.storage_path = storage_path
        os.makedirs(storage_path, exist_ok=True)
        self._checkpoints: list[_TrackedCheckpoint] = []
        self._index = 0

    def register(self, checkpoint: Checkpoint, metrics: dict) -> Checkpoint:
        # Async-written checkpoints flush here: the copy below must see a
        # complete directory.
        checkpoint.wait()
        dest = os.path.join(self.storage_path,
                            f"checkpoint_{self._index:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(checkpoint.path, dest)
            marker = os.path.join(dest, Checkpoint.EPHEMERAL_MARKER)
            if os.path.exists(marker):
                # Ephemeral handoff: consume (delete) the producer's temp
                # copy now that storage owns the data.
                os.unlink(marker)
                shutil.rmtree(checkpoint.path, ignore_errors=True)
        tracked = _TrackedCheckpoint(Checkpoint(dest), dict(metrics),
                                     self._index)
        self._index += 1
        self._checkpoints.append(tracked)
        with open(os.path.join(dest, "metrics.json"), "w") as f:
            json.dump({"metrics": metrics, "ts": time.time()}, f)
        self._enforce_limit()
        return tracked.checkpoint

    def _score(self, t: _TrackedCheckpoint) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return t.index          # recency
        v = float(t.metrics.get(attr, float("-inf")))
        return v if self.config.checkpoint_score_order == "max" else -v

    def _enforce_limit(self) -> None:
        k = self.config.num_to_keep
        if k is None or len(self._checkpoints) <= k:
            return
        self._checkpoints.sort(key=self._score)
        while len(self._checkpoints) > k:
            victim = self._checkpoints.pop(0)
            shutil.rmtree(victim.checkpoint.path, ignore_errors=True)

    @property
    def latest_checkpoint(self) -> Checkpoint | None:
        """Most RECENT registration (max over index: _enforce_limit sorts
        the list by score when a score attribute is set)."""
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=lambda t: t.index).checkpoint

    @property
    def best_checkpoint(self) -> Checkpoint | None:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=self._score).checkpoint
