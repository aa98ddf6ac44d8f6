"""Entrypoint for agent-forked worker processes.

Analog of the reference's default_worker.py
(ray: python/ray/_private/workers/default_worker.py): read connection info
from the environment the agent set, start the CoreWorker, serve until told
to exit.
"""
from __future__ import annotations

import logging
import os


def _watch_parent() -> None:
    """Exit when the owning agent dies — workers must never outlive it.
    The agent's pid comes from RAY_TPU_TORCH_AGENT_PID."""
    import threading
    import time

    agent_pid = int(os.environ.get("RAY_TPU_TORCH_AGENT_PID") or 0)

    def _alive() -> bool:
        if agent_pid:
            try:
                os.kill(agent_pid, 0)
                return True
            except ProcessLookupError:
                return False
            except PermissionError:
                return True
        return os.getppid() > 1

    def _loop():
        while True:
            if not _alive():
                os._exit(0)
            time.sleep(1.0)

    threading.Thread(target=_loop, daemon=True, name="parent-watch").start()


def _extend_sys_path() -> None:
    """Append the driver's sys.path (shipped via env at init) so that
    by-reference pickles of driver-module functions resolve here."""
    import json
    import sys

    raw = os.environ.get("RAY_TPU_TORCH_DRIVER_SYS_PATH")
    if not raw:
        return
    for p in json.loads(raw):
        if p not in sys.path:
            sys.path.append(p)


def main() -> None:
    import time as _time
    _boot_t0 = _time.monotonic()
    _trace = os.environ.get("RAY_TPU_TORCH_BOOT_TRACE")

    def _mark(phase: str) -> None:
        if _trace:
            print(f"BOOT {os.getpid()} {phase} "
                  f"{(_time.monotonic() - _boot_t0) * 1000:.1f}ms",
                  flush=True)

    _mark("enter")
    from ray_tpu_torch._private.stack_dump import install as _install_stack

    _install_stack('worker')
    _mark("stack")
    _watch_parent()
    _extend_sys_path()
    _mark("pre")
    # `kill -USR1 <pid>` dumps all thread stacks to stderr — the per-process
    # half of the `ray stack` debugging story (ray: py-spy attach).
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s worker[%(process)d]: %(message)s")
    from ray_tpu_torch.logging_config import configure_process_logging
    configure_process_logging()
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.worker import CoreWorker, set_global_worker

    _mark("imports")
    config = Config().override(None)
    core = CoreWorker(
        mode="worker",
        controller_addr=os.environ["RAY_TPU_TORCH_CONTROLLER_ADDR"],
        agent_addr=os.environ["RAY_TPU_TORCH_AGENT_ADDR"],
        config=config,
        worker_id=os.environ["RAY_TPU_TORCH_WORKER_ID"],
        node_id=os.environ.get("RAY_TPU_TORCH_NODE_ID", ""),
        pub_addr=os.environ.get("RAY_TPU_TORCH_PUB_ADDR", ""),
    )
    # Publish the global BEFORE start(): start() registers with the agent,
    # and a queued lease can push a task that runs user code immediately —
    # user code that calls back into the API (handle.method.remote(),
    # ray_tpu_torch.get) resolves the worker through global_worker().  Setting
    # it after start() left a window where that raised "not initialized"
    # (seen as a flaky test_handle_passing under heavy box load).
    set_global_worker(core)
    _mark("core_init")
    core.start()
    _mark("started")
    try:
        core._shutdown.wait()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
