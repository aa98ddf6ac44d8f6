"""Training backends: per-worker process-group setup hooks (port of
ray_tpu/train/backend.py).

The reference's `JaxBackend` brings up the multi-host jax runtime over the
train workers.  Its counterpart here, `ProcessGroupBackend`, forms the
torch default process group over them, as the reference's own gloo
`TorchBackend` (ray_tpu/train/torch.py:60-90) does: NCCL on CUDA with one
device per local rank (`torch.cuda.set_device(local_rank)`), gloo when the
caller asks for the CPU.  A `DeviceMesh` (parallel/mesh.py) and
`sharded_train_step` then run over that group.

The backend sees the worker group only through its `workers` (the
interface of ray_tpu/train/worker_group.py:238-252: each worker's
`run_fn`, `get_address` and `get_node_id` are called as
`worker.<method>.remote(...)`) and resolves what those calls return
through the `get` of a `serve.runtime.ServeRuntime` it is given (a binding
to the runtime lives with the caller; the null `ServeRuntime()` takes
values as they are, which is what an in-process worker group returns).
`init_process_group` blocks until every rank has joined, so every rank's
init is submitted before any is waited on: one `execute_single` after
another would wait at rank 0 for ever.

Rendezvous: `init_method` as given, or `tcp://` on rank 0's
`get_address()`.  A `file://` store serves one group only, so each
formation appends its count to the path (`<path>.1`, `<path>.2`, ...).
Every wait has a timeout: the group's own (`timeout_s`) and the waits on
the workers' calls.

Differences from the reference: the group is formed at every world size,
one included (a DeviceMesh needs the default group even on one rank; the
reference's backends return early there), and an epoch change re-forms it
over the new roster at any size.
"""
from __future__ import annotations

import datetime
import os
import socket

from ray_tpu_torch.serve.runtime import ServeRuntime


class BackendConfig:
    """Declarative backend selector (ray: train/backend.py
    BackendConfig): subclasses name the Backend that implements their
    setup via backend_cls."""

    @property
    def backend_cls(self) -> type:
        return Backend


class Backend:
    def on_start(self, worker_group) -> None:  # noqa: B027
        pass

    def on_shutdown(self, worker_group) -> None:  # noqa: B027
        pass

    def on_training_start(self, worker_group) -> None:  # noqa: B027
        pass

    def on_epoch_start(self, workers: list, epoch: int) -> None:  # noqa: B027
        """Elastic membership change: `workers` is the NEW roster in rank
        order (survivors first, joiners appended).  The backend re-forms
        whatever per-gang runtime it owns at the new world size; the base
        backend owns nothing."""
        pass


def init_rank(init_method: str, world_size: int, rank: int,
              local_rank: int = 0, local_world_size: int = 1,
              device_type: str = "cuda", timeout_s: float = 60.0) -> bool:
    """Runs inside each train worker: leave any group this process is in,
    then join the default process group (NCCL on this rank's local CUDA
    device, or gloo for "cpu").  Exports the torchrun-style variables, as
    the reference's `_torch_pg_init` does."""
    import torch
    import torch.distributed as dist

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world_size),
                       "LOCAL_RANK": str(local_rank),
                       "LOCAL_WORLD_SIZE": str(local_world_size)})
    if dist.is_initialized():
        dist.destroy_process_group()
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def destroy_rank() -> bool:
    """Runs inside each train worker: leave the default group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return True


def local_ranks(node_ids: list) -> tuple[list[int], list[int]]:
    """Each rank's position among the ranks of its node, and its node's
    rank count (the reference's derivation, ray_tpu/train/torch.py:71)."""
    seen: dict = {}
    ranks = []
    for nid in node_ids:
        ranks.append(seen.get(nid, 0))
        seen[nid] = ranks[-1] + 1
    return ranks, [seen[nid] for nid in node_ids]


class ProcessGroupBackend(Backend):
    """The default process group over the worker group's ranks.

    `device`: "cuda" (NCCL, the default) or "cpu" (gloo).  `runtime`: the
    `ServeRuntime` whose `get(refs, timeout)` resolves the workers' calls.
    `init_method`: the rendezvous (default `tcp://` on rank 0's address).
    `timeout_s`: the group's timeout, and the bound of each wait here."""

    def __init__(self, device=None, init_method: str | None = None,
                 runtime: ServeRuntime | None = None,
                 timeout_s: float = 60.0):
        self.device_type = "cuda" if device is None else str(device)
        self.init_method = init_method
        self.runtime = runtime or ServeRuntime()
        self.timeout_s = timeout_s
        self.formations = 0

    def _get(self, refs):
        return self.runtime.get(refs, timeout=self.timeout_s)

    def _rendezvous(self, first) -> str:
        self.formations += 1
        if self.init_method is None:
            ip, port = self._get(first.get_address.remote())
            return f"tcp://{ip}:{port}"
        if self.init_method.startswith("file://"):
            return f"{self.init_method}.{self.formations}"
        return self.init_method

    def _form(self, workers: list) -> None:
        n = len(workers)
        node_ids = self._get([w.get_node_id.remote() for w in workers])
        ranks, sizes = local_ranks(node_ids)
        init_method = self._rendezvous(workers[0])
        # All submitted, then all resolved: each init blocks until every
        # rank has joined.
        self.runtime.get([
            w.run_fn.remote(init_rank, init_method, n, r, ranks[r], sizes[r],
                            self.device_type, self.timeout_s)
            for r, w in enumerate(workers)], timeout=2 * self.timeout_s)

    def on_start(self, worker_group) -> None:
        self._form(worker_group.workers)

    def on_epoch_start(self, workers: list, epoch: int) -> None:
        """Re-form the group over the new roster: each member leaves its
        old group and joins the new one at the new world size (a failure
        raises, and the caller falls back to a full restart)."""
        self._form(workers)

    def on_shutdown(self, worker_group) -> None:
        try:
            self._get([w.run_fn.remote(destroy_rank)
                       for w in worker_group.workers if w is not None])
        except Exception:  # noqa: BLE001 - best effort, as the reference
            pass


# ---------------------------------------------------- in-process stand-in
def free_address() -> tuple[str, int]:
    """(ip, free port) of this host, as a TrainWorker's get_address."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    return socket.gethostbyname(socket.gethostname()), port


class _Method:
    def __init__(self, fn):
        self.remote = fn


class LocalWorker:
    """A train worker in this process: `worker.<method>.remote(...)` runs
    the method here and returns its value."""

    def __init__(self):
        self.run_fn = _Method(lambda fn, *a, **kw: fn(*a, **kw))
        self.get_address = _Method(free_address)
        self.get_node_id = _Method(lambda: "local")


class LocalWorkerGroup:
    """A one-rank worker group in this process, for single-process runs
    and tests: with the null `ServeRuntime` the backend forms a group of
    one over it."""

    def __init__(self):
        self.workers = [LocalWorker()]
        self.num_workers = 1
