"""ray_tpu_torch: the PyTorch + CUDA port of ray_tpu.

The JAX package `ray_tpu` stays the reference.  This package mirrors its
paths (`ray_tpu/ops/paged_attention.py` ->
`ray_tpu_torch/ops/paged_attention.py`), imports torch and numpy only,
and replaces every Pallas kernel on a ported path with a CUDA C++ kernel
for Hopper (`csrc/`, built at first use by `_kernels.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; on
the CPU each kernel wrapper takes its plain PyTorch version.

The core runtime (tasks, actors, objects; `_private/`, `api.py`) is the
reference's on the standard library: `import ray_tpu_torch as rt;
rt.init(); rt.remote; rt.get; rt.put; rt.wait; rt.kill; rt.get_actor;
rt.shutdown`.  Importing the package imports no torch: a plain worker
pays for torch only when a tensor reaches it.  `num_gpus` actors and
tasks run in the per-host device worker; plain workers see no CUDA
device.
"""
from ray_tpu_torch.api import (LOCAL_MODE, SCRIPT_MODE, WORKER_MODE,
                               Language, available_resources, cancel,
                               cluster_resources, get, get_actor,
                               get_gpu_ids, init, is_initialized, kill,
                               method, nodes, put, remote,
                               show_in_dashboard, shutdown, timeline, wait)
from ray_tpu_torch.exceptions import (ActorDiedError, ActorError,
                                      GetTimeoutError, ObjectLostError,
                                      RayTpuError, TaskCancelledError,
                                      TaskError, WorkerCrashedError)
from ray_tpu_torch._private import profiling
from ray_tpu_torch.logging_config import LoggingConfig
from ray_tpu_torch.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.runtime_context import get_runtime_context

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "get",
    "put", "wait", "kill", "cancel", "get_actor", "nodes", "timeline",
    "available_resources", "cluster_resources", "get_runtime_context",
    "profiling", "LoggingConfig", "Language", "get_gpu_ids",
    "show_in_dashboard", "SCRIPT_MODE", "WORKER_MODE", "LOCAL_MODE",
    "ObjectRef", "ObjectRefGenerator",
    "RayTpuError", "TaskError", "ActorError", "ActorDiedError",
    "ObjectLostError", "GetTimeoutError", "TaskCancelledError",
    "WorkerCrashedError",
]
