"""Public core API: init/shutdown, remote, get/put/wait, actors, kill.

Analog of ray: python/ray/_private/worker.py public functions
(init:1227, get:2578, put:2693, wait:2758, remote:3171, get_actor:2904).
Port of ray_tpu/api.py on the port's own runtime (`_private/`): client
mode, compiled DAGs and the C++ API are later slices (ROADMAP.md queue 1)
and raise NotImplementedError.  `get_gpu_ids` plays the reference's
`get_tpu_ids`.
"""
from __future__ import annotations

import atexit
import json
import logging
import subprocess
import sys
import time
from typing import Any, Sequence

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.object_ref import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction

logger = logging.getLogger(__name__)

_head_processes: list[subprocess.Popen] = []
_initialized = False


def _read_json_line(proc: subprocess.Popen, timeout: float = 30.0) -> dict:
    """Read the child's one-line JSON address announcement from stdout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"head process exited with {proc.returncode}")
            time.sleep(0.01)
            continue
        line = line.strip()
        if line.startswith(b"{"):
            return json.loads(line)
    raise TimeoutError("head process did not announce its address")


def _spawn(args: list[str]) -> tuple[subprocess.Popen, dict]:
    import os as _os

    # The head processes (and the workers they spawn) import this
    # package from wherever the driver found it, whatever their cwd.
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    env = dict(_os.environ)
    env["PYTHONPATH"] = _os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(_os.pathsep)
                  if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], stdout=subprocess.PIPE, env=env,
        stderr=subprocess.DEVNULL if not _os.environ.get(
            "RAY_TPU_TORCH_HEAD_LOGS") else None)
    _head_processes.append(proc)
    return proc, _read_json_line(proc)


def init(address: str | None = None,
         resources: dict[str, float] | None = None,
         namespace: str = "default",
         object_store_memory: int | None = None,
         _system_config: dict | None = None,
         log_to_driver: bool = True,
         logging_config: "LoggingConfig | None" = None) -> dict:
    """Start (or connect to) a cluster and attach this process as driver.

    Without `address`, boots a local head: controller + one node agent as
    subprocesses (ray: Node.start_head_processes node.py:1353 spawning
    gcs_server + raylet).  With `address` ("controller host:port"), attaches
    to a running cluster (ray: ray.init(address=...)).
    """
    global _initialized
    if _initialized:
        raise RuntimeError("ray_tpu_torch.init() already called; "
                           "call ray_tpu_torch.shutdown() first")
    import os as _os

    if logging_config is not None:
        # Driver logging now; spawned processes (controller, agents,
        # workers) pick the config up from the environment
        # at their own startup (ray: logging_config.py dictConfig).
        logging_config.apply()
        _os.environ.update(logging_config.env())

    if address is None:
        # Job-submission child drivers attach to the submitting cluster
        # (ray: RAY_ADDRESS honored by ray.init).
        address = _os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
    if address == "auto":
        address = _os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if address is None:
            raise ConnectionError(
                "address='auto' but no running cluster found "
                "(RAY_TPU_TORCH_ADDRESS unset)")
    if address:
        if address.startswith("ray://"):
            raise NotImplementedError(
                "client mode is not ported yet (ROADMAP.md queue 1: "
                "client)")
        if address.startswith("ray-tpu://"):
            address = address[len("ray-tpu://"):]
    config = Config().override(_system_config)
    if object_store_memory:
        config.object_store_memory = object_store_memory

    if address is None:
        # Workers must be able to unpickle functions defined in driver-side
        # modules (e.g. test files, scripts in odd directories): ship the
        # driver's sys.path so by-reference pickles resolve (the local-mode
        # slice of the reference's working_dir runtime env, ray:
        # python/ray/_private/runtime_env/working_dir.py).
        import os as _os

        _os.environ["RAY_TPU_TORCH_DRIVER_SYS_PATH"] = json.dumps(
            [p for p in (q or _os.getcwd() for q in sys.path)
             if _os.path.exists(p)])
        try:
            _, cinfo = _spawn(["ray_tpu_torch._private.controller",
                               "--config-json", config.to_json()])
            controller_addr = cinfo["controller_addr"]
            agent_args = ["ray_tpu_torch._private.node_agent",
                          "--controller", controller_addr,
                          "--config-json", config.to_json()]
            if resources is not None:
                agent_args += ["--resources-json", json.dumps(resources)]
            _, ainfo = _spawn(agent_args)
        except BaseException:
            _stop_heads()
            raise
        agent_addr = ainfo["agent_addr"]
        node_id = ainfo["node_id"]
    else:
        controller_addr = address
        agent_addr, node_id = _pick_agent(controller_addr)

    from ray_tpu_torch._private.worker import CoreWorker, set_global_worker

    core = CoreWorker(mode="driver", controller_addr=controller_addr,
                      agent_addr=agent_addr, config=config,
                      node_id=node_id, job_id=JobID.from_random().hex(),
                      namespace=namespace)
    core.log_to_driver = log_to_driver
    core.start()
    # Fetch pub address + register the job.
    reply, _ = core.call(controller_addr, "ping", {}, timeout=30.0)
    if reply.get("pub_addr"):
        core.connect_events(reply["pub_addr"])
    core.call(controller_addr, "register_job",
              {"job_id": core.job_id, "driver_addr": core.address})
    set_global_worker(core)
    _initialized = True
    atexit.register(shutdown)
    return {"controller_address": controller_addr, "node_id": node_id}


def _pick_agent(controller_addr: str, timeout: float = 30.0) -> tuple[str, str]:
    """Attach to an existing cluster: wait for an alive node and use its agent."""
    import asyncio

    from ray_tpu_torch._private.rpc import RpcClient

    async def _go():
        cli = RpcClient(address=controller_addr)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                reply, _ = await cli.call("list_nodes", {}, timeout=10.0)
                nodes = [n for n in reply["nodes"] if n["state"] == "ALIVE"]
                if nodes:
                    return nodes[0]["agent_addr"], nodes[0]["node_id"]
                await asyncio.sleep(0.2)
            raise TimeoutError("no alive nodes in cluster")
        finally:
            cli.close()

    return asyncio.run(_go())


def shutdown() -> None:
    global _initialized
    from ray_tpu_torch._private import worker as worker_mod

    if worker_mod._global_worker is not None:
        core = worker_mod._global_worker
        try:
            # Mark this job done so cluster harvests (the memory verb's
            # driver fan-out) stop probing a driver that exited cleanly.
            core.call(core.controller_addr, "job_finished",
                      {"job_id": core.job_id}, timeout=5.0)
        except Exception:  # noqa: BLE001
            pass
        try:
            core.shutdown()
        except Exception:  # noqa: BLE001
            pass
    _stop_heads()
    _initialized = False
    atexit.unregister(shutdown)


def _stop_heads() -> None:
    for proc in _head_processes:
        if proc.poll() is None:
            proc.terminate()
    for proc in _head_processes:
        try:
            proc.wait(timeout=3.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.stdout is not None:
            proc.stdout.close()
    _head_processes.clear()


def is_initialized() -> bool:
    return _initialized


def method(*, concurrency_group: str | None = None,
           num_returns: int | str | None = None):
    """@ray_tpu_torch.method: per-method options on an actor class (ray:
    @ray.method) — currently concurrency_group and num_returns."""
    def wrap(fn):
        opts = dict(getattr(fn, "__ray_tpu_method_opts__", {}))
        if concurrency_group is not None:
            opts["concurrency_group"] = concurrency_group
        if num_returns is not None:
            opts["num_returns"] = num_returns
        fn.__ray_tpu_method_opts__ = opts
        return fn

    return wrap


def remote(*args, **kwargs):
    """@ray_tpu_torch.remote decorator for functions and classes
    (ray: worker.py:3171)."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    return decorator


def get(refs: ObjectRef | Sequence[ObjectRef],
        *, timeout: float | None = None) -> Any:
    from ray_tpu_torch._private.worker import global_worker

    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get takes ObjectRefs, got {type(r)}")
    values = global_worker().get_objects(ref_list, timeout)
    return values[0] if single else values


def put(value: Any) -> ObjectRef:
    from ray_tpu_torch._private.worker import global_worker

    if isinstance(value, ObjectRef):
        raise TypeError("calling put() on an ObjectRef is not allowed")
    return global_worker().put_object(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: float | None = None,
         fetch_local: bool = True) -> tuple[list[ObjectRef], list[ObjectRef]]:
    from ray_tpu_torch._private.worker import global_worker

    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return global_worker().wait(refs, num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    from ray_tpu_torch._private.worker import global_worker

    global_worker().kill_actor(actor.actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    from ray_tpu_torch._private.worker import global_worker

    global_worker().cancel_task(ref)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(
        core.controller_addr, "get_actor_by_name",
        {"name": name, "namespace": namespace or core.namespace},
        timeout=30.0)
    if not reply.get("found"):
        raise ValueError(f"no actor named {name!r}")
    return ActorHandle(reply["actor_id"])


def available_resources() -> dict[str, float]:
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "list_nodes", timeout=30.0)
    out: dict[str, float] = {}
    for n in reply["nodes"]:
        if n["state"] != "ALIVE":
            continue
        for k, v in n["available"].items():
            out[k] = out.get(k, 0.0) + v
    return out


def cluster_resources() -> dict[str, float]:
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "list_nodes", timeout=30.0)
    out: dict[str, float] = {}
    for n in reply["nodes"]:
        if n["state"] != "ALIVE":
            continue
        for k, v in n["resources"].items():
            out[k] = out.get(k, 0.0) + v
    return out


def nodes() -> list[dict]:
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "list_nodes", timeout=30.0)
    return reply["nodes"]


def timeline() -> list[dict]:
    """Task state-transition events (ray: ray timeline → Chrome trace)."""
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "get_task_events",
                         timeout=30.0)
    return reply["events"]


# --------------------------------------------------------------- compat
# Process-mode constants (ray: ray_constants SCRIPT_MODE/WORKER_MODE/
# LOCAL_MODE; same values for drop-in comparisons).
SCRIPT_MODE = 0
WORKER_MODE = 1
LOCAL_MODE = 2


class Language:
    """Frontend languages (ray: Language proto enum).  JAVA is an
    intentional gap (no JVM frontend — README); PYTHON and CPP map to
    the Python API and the native worker API (native/raytpu_torch_api.h)."""
    PYTHON = "PYTHON"
    CPP = "CPP"


def get_gpu_ids() -> list[int]:
    """Ordinals of the CUDA devices visible to this worker (the
    reference's `get_tpu_ids`; its own `get_gpu_ids` always returns []).

    Only the per-host device worker (started with
    RAY_TPU_TORCH_IS_DEVICE_WORKER=1, holding the accelerator lease) sees
    any: `range(torch.cuda.device_count())`, after CUDA_VISIBLE_DEVICES.
    Every other process gets []."""
    import os as _os

    if _os.environ.get("RAY_TPU_TORCH_IS_DEVICE_WORKER") != "1":
        return []
    import torch

    if not torch.cuda.is_available():
        return []
    return list(range(torch.cuda.device_count()))


def show_in_dashboard(message: str, key: str = "",
                      dtype: str = "text") -> None:
    """Attach a status message to this worker, rendered by the dashboard
    (ray: worker.py:2521).  Messages land in controller KV under the
    "dash" namespace keyed by worker+key, so multiple keys coexist and
    re-posting a key overwrites it."""
    if dtype not in ("text", "html"):
        raise ValueError(f"invalid dtype {dtype!r} (text|html)")
    import time as _time

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.runtime_context import get_runtime_context

    core = global_worker()
    ctx = get_runtime_context()
    payload = {"message": message, "dtype": dtype,
               "worker_id": ctx.get_worker_id(),
               "actor_id": ctx.get_actor_id(),
               "task_id": ctx.get_task_id(), "ts": _time.time()}
    core.call(core.controller_addr, "kv_put",
              {"ns": "dash", "key": f"{ctx.get_worker_id()}:{key}"},
              [json.dumps(payload).encode()], timeout=30.0)


def cpp_function(fn_name: str, lib_path: str):
    """Handle on a native function for cross-language invocation (ray:
    ray.cpp_function); a later slice of the port."""
    raise NotImplementedError(
        "the C++ API is not ported yet (ROADMAP.md queue 1: the C++ API)")
