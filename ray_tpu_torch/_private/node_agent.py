"""Per-host node agent: local scheduler + worker pool.

TPU-native analog of the reference's raylet
(ray: src/ray/raylet/node_manager.h:119).  Owns:
  - the worker-process pool (ray: WorkerPool worker_pool.h:159) — forks
    Python workers, prestarts, reuses them across leases
  - lease-based local task scheduling with spillback to other nodes using
    the controller-synced cluster view (ray: ClusterTaskManager
    cluster_task_manager.cc:44, LocalTaskManager::Spillback
    local_task_manager.cc:674)
  - actor placement on behalf of the controller
  - worker-death detection and fan-out (ray: worker_pool.cc process monitor)

Device adaptation (kept from the TPU reference): every lease whose
demand includes "GPU" resolves to this host's singleton *device worker* —
one process owning all local CUDA devices, hosting many actors/tasks as
in-process executors on the legacy default stream.  Plain workers get
CUDA_VISIBLE_DEVICES="" and never create a CUDA context.  The agent itself
never imports torch: it counts the /dev/nvidia<N> nodes it may open.

Every worker is a cold interpreter spawn: the reference's warm zygote and
its runtime-env workers (venvs) are a later slice of the port (ROADMAP.md
queue 1).
"""
from __future__ import annotations

import asyncio
import contextlib
import itertools
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field


from ray_tpu_torch._private import failpoints
from ray_tpu_torch._private import memledger
from ray_tpu_torch._private import scheduler as sched
from ray_tpu_torch._private import spans
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.rpc import (ClientPool, RpcServer, Subscriber,
                                       process_modules)

logger = logging.getLogger(__name__)


def detect_labels() -> dict[str, str]:
    """Auto-label the node with its accelerator count (ray: accelerator
    labels)."""
    n = _gpu_count()
    return {"ray_tpu_torch.io/gpu-count": str(int(n))} if n else {}


def _gpu_count() -> float:
    """CUDA devices this host gives its processes, without a CUDA
    context: RAY_TPU_TORCH_GPUS if set; else the entries of
    CUDA_VISIBLE_DEVICES if set; else the /dev/nvidia<N> nodes this
    process may open (a container can hold nodes of cards it may not
    use, which is also how nvidia-smi and NVML leave them out)."""
    env = os.environ.get("RAY_TPU_TORCH_GPUS")
    if env is not None:
        return float(env)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        return float(len([d for d in visible.split(",") if d.strip()]))
    if not os.path.isdir("/dev"):
        return 0.0
    n = 0
    for d in os.listdir("/dev"):
        if not (d.startswith("nvidia") and d[6:].isdigit()):
            continue
        try:
            os.close(os.open(os.path.join("/dev", d), os.O_RDWR))
        except OSError:
            continue
        n += 1
    return float(n)


def _mem_total() -> float | None:
    """Host memory in bytes, from /proc/meminfo."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    return None


def detect_resources() -> dict[str, float]:
    """Best-effort host resource detection (ray: python/ray/_private/
    accelerators/nvidia_gpu.py; the reference counts /dev/accel* TPU
    chips)."""
    res: dict[str, float] = {"CPU": float(os.cpu_count() or 1)}
    n = _gpu_count()
    if n > 0:
        res["GPU"] = n
    mem = _mem_total()
    if mem is not None:
        res["memory"] = mem
    return res


@dataclass
class WorkerHandle:
    worker_id: str
    proc: subprocess.Popen | None
    addr: str | None = None
    # starting | idle | leased | actor | stopping (evicted, awaiting
    # reaper) | dead
    state: str = "starting"
    lease_id: str | None = None
    submitter: str | None = None   # rpc addr of current lease holder
    is_device_worker: bool = False
    actor_ids: set[str] = field(default_factory=set)
    # actor_id -> lease header whose resources it holds
    actor_leases: dict = field(default_factory=dict)
    started_at: float = field(default_factory=time.monotonic)
    oom_killed: bool = False


@dataclass
class PendingLease:
    header: dict
    fut: asyncio.Future


class NodeAgent:
    def __init__(self, config: Config, controller_addr: str,
                 resources: dict[str, float] | None = None,
                 host: str = "127.0.0.1",
                 node_id: str | None = None,
                 env: dict[str, str] | None = None,
                 labels: dict[str, str] | None = None):
        self.config = config
        self.controller_addr = controller_addr
        self.node_id = node_id or NodeID.from_random().hex()
        self.host = host
        self.resources = dict(resources) if resources else detect_resources()
        self.labels = {**detect_labels(), **(labels or {}),
                       "ray_tpu_torch.io/node-id": self.node_id}
        self.available = dict(self.resources)
        self.server = RpcServer(host=host)
        self.clients = ClientPool()
        self.workers: dict[str, WorkerHandle] = {}
        self._worker_env = dict(env or {})
        self._starting: dict[str, asyncio.Future] = {}
        self._pending: list[PendingLease] = []
        # Strong refs for in-flight pending-grant tasks (see
        # _try_grant_pending).
        self._grant_tasks: set = set()
        self._lease_seq = itertools.count()
        self.cluster_view: sched.View = {}
        # lease_id -> (worker_id, lease header) for task leases
        self._leases: dict[str, tuple[str, dict]] = {}
        self._bg: list[asyncio.Task] = []
        self._device_worker_id: str | None = None
        # Bounds concurrent ACTOR-placement forks (see Config
        # .max_concurrent_worker_spawns): an actor burst must queue its
        # worker spawns — N simultaneous interpreter forks on a small
        # host all miss their startup timeouts.  Plain-task spawns stay
        # bounded by max_workers_per_node instead; putting this wait on
        # the task-lease hot path measurably regressed it.
        self._actor_spawn_sem = asyncio.Semaphore(
            max(1, config.max_concurrent_worker_spawns))
        # Single-flight device-worker spawn: a bulk wave carrying several
        # GPU actors must not race N concurrent singleton spawns.
        self._device_spawn_lock = asyncio.Lock()
        self._closed = False
        self.store = None  # node store runner, attached in start()
        # Leak sentinel (memory ledger): latest scan + cumulative flag
        # counters.  The reaper scans BEFORE sweep_dead, so every pin
        # the sweep reclaims was flagged first — the totals never miss
        # a leak the cluster healed on its own.
        self._leak_last: dict | None = None
        self._leak_totals = {"scans": 0, "orphan_pins_flagged": 0,
                             "orphan_pin_bytes_flagged": 0,
                             "creating_dead_creator_flagged": 0}
        import tempfile

        self._log_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"session_{self.node_id[:8]}_{os.getpid()}", "logs")
        # log file path -> bytes already forwarded
        self._log_offsets: dict[str, int] = {}

    # ---------------------------------------------------------------- setup
    async def start(self) -> None:
        self.server.register_all(self)
        self.server.start()
        from ray_tpu_torch._private.object_store import StoreRunner

        self.store = StoreRunner(self.node_id, self.config)
        self.store.register_handlers(self.server, self.clients)
        reply, _ = await self.clients.get(self.controller_addr).call(
            "register_node",
            {"node_id": self.node_id, "agent_addr": self.server.address,
             "resources": self.resources, "labels": self.labels},
            timeout=30.0)
        self.pub_addr = reply["pub_addr"]
        self.subscriber = Subscriber(address=self.pub_addr)
        self.subscriber.subscribe("resources", self._on_resource_view)
        self.subscriber.subscribe("node", self._on_node_event)
        loop = asyncio.get_running_loop()
        self._bg.append(loop.create_task(self._heartbeat_loop()))
        self._bg.append(loop.create_task(self._reaper_loop()))
        self._bg.append(loop.create_task(self._memory_monitor_loop()))
        self._bg.append(loop.create_task(self._log_tail_loop()))
        for _ in range(self.config.prestart_workers):
            self._spawn_worker()
        logger.info("agent %s up at %s resources=%s",
                    self.node_id[:12], self.server.address, self.resources)

    def close(self) -> None:
        self._closed = True
        for t in self._bg:
            t.cancel()
        for w in self.workers.values():
            if w.proc and w.proc.poll() is None:
                w.proc.terminate()
        if self.store:
            self.store.close()
        self.server.close()
        self.clients.close()

    async def _heartbeat_loop(self) -> None:
        while not self._closed:
            # Failpoint window: the liveness signal itself (drop = this
            # beat never reaches the controller; enough dropped beats and
            # the node is declared dead while its work still runs).  An
            # injected `error` loses this one beat too — it must never
            # escape and kill the loop, or the node could NEVER rejoin
            # after the site is cleared.
            if failpoints.ACTIVE:
                try:
                    dropped = await failpoints.fire_async("agent.heartbeat")
                except Exception:  # noqa: BLE001 - injected
                    logger.warning("agent.heartbeat failpoint: injected "
                                   "error -> beat skipped")
                    dropped = True
                if dropped:
                    await asyncio.sleep(self.config.heartbeat_period_s)
                    continue
            try:
                reply, _ = await self.clients.get(self.controller_addr).call(
                    "heartbeat",
                    {"node_id": self.node_id, "available": self.available,
                     "load": len(self._pending)},
                    timeout=self.config.node_death_timeout_s)
                if not reply.get("ok"):
                    await self.clients.get(self.controller_addr).call(
                        "register_node",
                        {"node_id": self.node_id,
                         "agent_addr": self.server.address,
                         "resources": self.resources}, timeout=30.0)
            except Exception:  # noqa: BLE001
                pass
            await asyncio.sleep(self.config.heartbeat_period_s)

    async def _on_resource_view(self, _topic: str, payload: dict) -> None:
        self.cluster_view = payload["view"]

    async def _on_node_event(self, _topic: str, payload: dict) -> None:
        addr = payload.get("agent_addr")
        if payload.get("event") == "dead":
            self.cluster_view.pop(payload["node_id"], None)
            if addr and addr != self.server.address:
                # Fail in-flight calls to the dead agent NOW instead of
                # waiting out their RPC timeouts.
                self.clients.drop(addr)

    # ---------------------------------------------------------- worker pool
    def _spawn_worker(self, device_worker: bool = False) -> WorkerHandle:
        from ray_tpu_torch._private.ids import WorkerID

        worker_id = WorkerID.from_random().hex()
        env = {**os.environ, **self._worker_env,
               "RAY_TPU_TORCH_WORKER_ID": worker_id,
               "RAY_TPU_TORCH_NODE_ID": self.node_id,
               "RAY_TPU_TORCH_AGENT_ADDR": self.server.address,
               "RAY_TPU_TORCH_CONTROLLER_ADDR": self.controller_addr,
               "RAY_TPU_TORCH_PUB_ADDR": self.pub_addr,
               "RAY_TPU_TORCH_IS_DEVICE_WORKER": "1" if device_worker else "0"}
        if not device_worker:
            # Plain workers never see a CUDA device (ray: CUDA_VISIBLE_
            # DEVICES isolation in worker_pool; the reference sets
            # JAX_PLATFORMS=cpu).
            env["CUDA_VISIBLE_DEVICES"] = ""
        # Workers watch the agent's liveness (worker_main._watch_parent).
        env["RAY_TPU_TORCH_AGENT_PID"] = str(os.getpid())
        stdout_path = stderr_path = None
        if not os.environ.get("RAY_TPU_TORCH_WORKER_LOGS"):
            # Per-worker log files; the agent tails them and forwards new
            # lines to drivers (ray: worker logs in the session dir +
            # log_monitor.py streaming driver-bound logs via GCS pubsub).
            os.makedirs(self._log_dir, exist_ok=True)
            stdout_path = os.path.join(
                self._log_dir, f"worker-{worker_id[:12]}.out")
            stderr_path = os.path.join(
                self._log_dir, f"worker-{worker_id[:12]}.err")
        if stdout_path is not None:
            stdout = open(stdout_path, "ab")
            stderr = open(stderr_path, "ab")
        else:
            stdout = stderr = None      # inherit (debugging)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, stdout=stdout, stderr=stderr)
        if stdout is not None:
            stdout.close()
            stderr.close()
        handle = WorkerHandle(worker_id=worker_id, proc=proc,
                              is_device_worker=device_worker)
        self.workers[worker_id] = handle
        self._starting[worker_id] = asyncio.get_running_loop().create_future()
        return handle

    async def rpc_register_worker(self, h: dict, _b: list) -> dict:
        w = self.workers.get(h["worker_id"])
        if w is None:
            return {"ok": False}
        w.addr = h["addr"]
        if w.state == "starting":
            w.state = "idle"
        fut = self._starting.pop(h["worker_id"], None)
        if fut and not fut.done():
            fut.set_result(w)
        self._try_grant_pending()
        return {"ok": True}

    async def _get_idle_worker(self, ignore_cap: bool = False,
                               spawn_sem: "asyncio.Semaphore | None" = None,
                               ) -> WorkerHandle | None:
        def idle_match() -> WorkerHandle | None:
            for w in self.workers.values():
                if w.state == "idle" and not w.is_device_worker:
                    return w
            return None

        w = idle_match()
        if w is not None:
            return w
        n_alive = sum(1 for w in self.workers.values() if w.state != "dead")
        if not ignore_cap and \
                n_alive >= self.config.max_workers_per_node:
            # The cap bounds the PLAIN-task pool (fork storms on small
            # hosts).  Actor placements pass ignore_cap: each actor is a
            # dedicated process and the node's RESOURCES are its
            # admission control — a hard worker cap would strand
            # resource-feasible actors in PENDING forever (e.g. many
            # fractional-CPU actors).
            return None
        if spawn_sem is None:
            return await self._spawn_and_wait()
        # Only the FORK is gated (idle scans above need no permit): an
        # actor burst queues its spawns 4-wide instead of stampeding N
        # interpreters at once, which makes every fork miss its timeout.
        async with spawn_sem:
            # A spawn that completed while we queued may have freed an
            # idle worker — take it instead of forking another.
            w = idle_match()
            if w is not None:
                return w
            return await self._spawn_and_wait()

    async def _spawn_and_wait(self) -> WorkerHandle | None:
        w = self._spawn_worker()
        fut = self._starting.get(w.worker_id)
        if fut is not None:
            try:
                await asyncio.wait_for(asyncio.shield(fut), timeout=60.0)
            except asyncio.TimeoutError:
                return None
        return w if w.state == "idle" else None

    async def _get_device_worker(self) -> WorkerHandle | None:
        """The singleton process owning this host's CUDA devices.  Single-
        flight: concurrent requests (a bulk wave of GPU actors) must
        share one spawn, never race N singletons."""
        async with self._device_spawn_lock:
            if self._device_worker_id:
                w = self.workers.get(self._device_worker_id)
                if w and w.state != "dead":
                    if w.state == "starting":
                        fut = self._starting.get(w.worker_id)
                        if fut:
                            await asyncio.wait_for(asyncio.shield(fut),
                                                   timeout=120.0)
                    return w
            w = self._spawn_worker(device_worker=True)
            self._device_worker_id = w.worker_id
            fut = self._starting.get(w.worker_id)
            if fut:
                try:
                    await asyncio.wait_for(asyncio.shield(fut), timeout=120.0)
                except asyncio.TimeoutError:
                    return None
            return w if w.state != "dead" else None

    async def _reaper_loop(self) -> None:
        """Detect dead worker processes; fail leases/actors accordingly."""
        last_sweep = 0.0
        last_probe = 0.0
        while not self._closed:
            await asyncio.sleep(0.2)
            for w in list(self.workers.values()):
                if w.state != "dead" and w.proc and w.proc.poll() is not None:
                    await self._on_worker_dead(w)
            nowp = time.monotonic()
            if nowp - last_probe >= 5.0:
                last_probe = nowp
                await self._probe_lease_submitters()
            # Reclaim arena pins held by crash-killed readers (any process
            # that mmap'd the store and died without releasing; the
            # reference's plasma does this on client-socket close).
            now = time.monotonic()
            if now - last_sweep >= 5.0 and self.store is not None:
                last_sweep = now
                # Leak sentinel BEFORE the sweep: pins the sweep is
                # about to reclaim get flagged (span + counters) first,
                # so a self-healed leak still leaves an alarm trail.
                # NOT gated on memledger.ENABLED: the kill switch gates
                # annotations only — a gated scan would freeze
                # _leak_last at its last (possibly dirty) snapshot and
                # alarm forever after a live flip.
                try:
                    self._leak_scan()
                except Exception:  # noqa: BLE001
                    pass
                sweep = getattr(self.store.backend, "sweep_dead", None)
                if sweep is not None:
                    try:
                        sweep()
                    except Exception:  # noqa: BLE001
                        pass
                try:
                    # Deletes refused while a reader pinned the object are
                    # retried once the pin (possibly crash-swept above) is
                    # gone.
                    self.store.retry_deletes()
                except Exception:  # noqa: BLE001
                    pass

    async def _probe_lease_submitters(self) -> None:
        """Reap leases whose SUBMITTER (driver/worker) died without
        returning them — the transport never surfaces peer death, so a crashed or
        terminated client (e.g. a client-proxy host driver) would
        otherwise hold its leased workers' resources forever (ray: the
        raylet returns workers when the owner's connection drops;
        leases here are connectionless, so liveness is probed).  Three
        consecutive failed pings (~15s) reap."""
        from ray_tpu_torch._private.rpc import probe_dead_peers

        by_submitter: dict[str, list[WorkerHandle]] = {}
        for w in self.workers.values():
            if w.state == "leased" and w.submitter:
                by_submitter.setdefault(w.submitter, []).append(w)
        if not hasattr(self, "_submitter_fails"):
            self._submitter_fails: dict[str, int] = {}

        async def _reap(addr: str, workers: list) -> None:
            logger.warning(
                "lease submitter %s unreachable; reaping %d lease(s)",
                addr, len(workers))
            for w in workers:
                if w.state == "leased" and w.submitter == addr:
                    self._release_lease_resources(w)
                    if not w.is_device_worker:
                        w.state = "idle"
            self._try_grant_pending()

        await probe_dead_peers(self.clients, by_submitter,
                               self._submitter_fails, _reap)

    async def _log_tail_loop(self) -> None:
        """Tail worker log files; forward new lines to the controller,
        which rebroadcasts them on the "logs" topic for drivers
        (ray: log_monitor.py → GCS pubsub → driver console)."""
        while not self._closed:
            await asyncio.sleep(0.5)
            try:
                lines = self._collect_new_log_lines()
            except Exception:  # noqa: BLE001
                continue
            if not lines:
                continue
            try:
                await self.clients.get(self.controller_addr).notify(
                    "push_logs", {"node_id": self.node_id[:12],
                                  "lines": lines})
            except Exception:  # noqa: BLE001
                pass

    def _collect_new_log_lines(self, max_lines: int = 200) -> list:
        lines: list = []
        if not os.path.isdir(self._log_dir):
            return lines
        for fname in sorted(os.listdir(self._log_dir)):
            path = os.path.join(self._log_dir, fname)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._log_offsets.get(path, 0)
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    chunk = f.read(min(size - off, 256 * 1024))
            except OSError:
                continue
            # Forward only complete lines; partial tails wait for more.
            cut = chunk.rfind(b"\n")
            if cut < 0:
                if len(chunk) >= 256 * 1024:
                    # One giant unterminated line would stall this file
                    # forever (the newline sits beyond the read cap):
                    # forward it truncated and move on.
                    cut = len(chunk) - 1
                else:
                    continue
            src = fname.rsplit(".", 1)[0]
            # Keep each line's newline so `consumed` counts every byte —
            # an off-by-one here leaks phantom blank lines next poll.
            batch = chunk[:cut + 1].splitlines(keepends=True)
            # Advance the offset ONLY past lines actually forwarded; a
            # burst beyond the cap is picked up next poll, not dropped.
            consumed = 0
            for ln in batch[:max_lines]:
                lines.append(
                    [src, ln.rstrip(b"\r\n").decode("utf-8",
                                                    "replace")[:2000]])
                consumed += len(ln)
            self._log_offsets[path] = off + consumed
        return lines

    def _prune_worker_logs(self, worker_id: str) -> None:
        """Forward a dead worker's remaining lines on the next poll, then
        drop its files + offsets (churned workers must not accumulate)."""
        prefix = f"worker-{worker_id[:12]}"

        def _cleanup():
            for suffix in (".out", ".err"):
                path = os.path.join(self._log_dir, prefix + suffix)
                self._log_offsets.pop(path, None)
                try:
                    os.unlink(path)
                except OSError:
                    pass
        # 2s grace: two tail polls pick up the crash output first.
        asyncio.get_running_loop().call_later(2.0, _cleanup)

    async def _memory_monitor_loop(self) -> None:
        """Kill a worker when host/cgroup memory crosses the threshold
        (ray: MemoryMonitor memory_monitor.h:52 + retriable-FIFO policy)."""
        from ray_tpu_torch._private.memory_monitor import (MemoryMonitor,
                                                     pick_oom_victim)

        mon = MemoryMonitor(self.config.memory_usage_threshold)
        while not self._closed:
            await asyncio.sleep(self.config.memory_monitor_period_s)
            try:
                if not mon.should_kill():
                    continue
                victim = pick_oom_victim(list(self.workers.values()))
                if victim is None or not victim.proc:
                    continue
                logger.warning(
                    "memory above %.0f%%: OOM-killing worker %s (%s)",
                    self.config.memory_usage_threshold * 100,
                    victim.worker_id[:12], victim.state)
                victim.oom_killed = True
                victim.proc.kill()
            except Exception:  # noqa: BLE001
                pass

    async def _on_worker_dead(self, w: WorkerHandle) -> None:
        if w.proc is not None and w.proc.returncode == -signal.SIGKILL:
            # A SIGKILLed worker while a one-shot crash failpoint is
            # armed in THIS agent: presume the worker fired it, and
            # scrub it from our env before the replacement (spawned
            # with {**os.environ}) inherits it and crashes too.
            failpoints.on_child_sigkill()
        prev_state = w.state
        # Capture BEFORE _release_lease_resources nulls them — the
        # worker_died notify below must name the lease and reach the
        # submitter, or the submitter only learns of the death from the
        # (slower, controller-relayed) dead-address broadcast.
        dead_lease_id = w.lease_id
        dead_submitter = w.submitter
        w.state = "dead"
        fut = self._starting.pop(w.worker_id, None)
        if fut and not fut.done():
            fut.set_result(w)
        if w.worker_id == self._device_worker_id:
            self._device_worker_id = None
        if w.lease_id:
            self._release_lease_resources(w)
        for lease_h in w.actor_leases.values():
            self._release(lease_h)
        w.actor_leases.clear()
        for actor_id in list(w.actor_ids):
            try:
                await self.clients.get(self.controller_addr).call(
                    "report_actor_death",
                    {"actor_id": actor_id,
                     "cause": ("OOM-killed by the node memory monitor"
                               if w.oom_killed else
                               f"worker process {w.worker_id[:12]} exited "
                               f"(code {w.proc.returncode if w.proc else '?'})")},
                    timeout=10.0)
            except Exception:  # noqa: BLE001
                pass
        if prev_state == "leased" and dead_submitter:
            try:
                await self.clients.get(dead_submitter).notify(
                    "worker_died", {"worker_addr": w.addr,
                                    "lease_id": dead_lease_id,
                                    "oom": w.oom_killed})
            except Exception:  # noqa: BLE001
                pass
        # Cluster-wide dead-address broadcast: borrowers resolving objects
        # through this (owner) address must fail fast, not hang on a client
        # connection that silently reconnects forever (ray: WORKER_FAILURE
        # pubsub gating gets the same way).
        if w.addr:
            try:
                await self.clients.get(self.controller_addr).notify(
                    "report_worker_death", {"addr": w.addr})
            except Exception:  # noqa: BLE001
                pass
        self.workers.pop(w.worker_id, None)
        self._prune_worker_logs(w.worker_id)
        self._try_grant_pending()

    # -------------------------------------------------------------- leasing
    def _resources_fit(self, h: dict) -> bool:
        return sched.available(self.available, h.get("resources", {}))

    def _acquire(self, h: dict) -> None:
        for k, v in h.get("resources", {}).items():
            self.available[k] = self.available.get(k, 0.0) - v

    def _release(self, h: dict) -> None:
        for k, v in h.get("resources", {}).items():
            self.available[k] = self.available.get(k, 0.0) + v

    def _release_lease_resources(self, w: WorkerHandle) -> None:
        if w.lease_id:
            entry = self._leases.pop(w.lease_id, None)
            if entry:
                self._release(entry[1])
        w.lease_id = None
        w.submitter = None

    async def rpc_request_lease(self, h: dict, _b: list) -> dict:
        """Grant a worker lease, queue, or point at a better node
        (ray: NodeManager::HandleRequestWorkerLease node_manager.cc:1794)."""
        demand = h.get("resources", {})
        affinity = h.get("affinity_node_id")
        soft = h.get("affinity_soft", False)
        label_hard = h.get("label_hard")
        label_soft = h.get("label_soft")
        if label_hard and not sched.labels_match(self.labels, label_hard):
            # This node is excluded by label: route to a matching node
            # (ray: NodeLabelSchedulingStrategy is a filter, never soft).
            view = {nid: v for nid, v in self.cluster_view.items()
                    if nid != self.node_id}
            target = sched.pick_node(view, demand, self.config,
                                     label_hard=label_hard,
                                     label_soft=label_soft)
            if target is not None:
                return {"spill_to": self.cluster_view[target]["agent_addr"]}
            return {"unfeasible": True}
        if affinity and affinity != self.node_id:
            # Route to the pinned node only if it could ever run the task
            # (feasible by totals); it queues locally when merely busy.
            target = self.cluster_view.get(affinity)
            if target is not None and sched.feasible(target["total"], demand):
                return {"spill_to": target["agent_addr"]}
            if not soft:
                return {"unfeasible": True}
            affinity = None    # soft: fall back to normal scheduling
        if affinity == self.node_id and not sched.feasible(self.resources,
                                                           demand):
            # Hard-pinned here but this node can never run it.
            if not soft:
                return {"unfeasible": True}
            affinity = None
        if not sched.feasible(self.resources, demand):
            # Infeasible here: spill to any feasible node (ray: Spillback).
            view = {nid: v for nid, v in self.cluster_view.items()
                    if nid != self.node_id}
            target = sched.pick_node(view, demand, self.config,
                                     label_hard=label_hard,
                                     label_soft=label_soft)
            if target is not None:
                return {"spill_to": self.cluster_view[target]["agent_addr"]}
            return {"unfeasible": True}
        if self._resources_fit(h):
            return await self._grant(h)
        # Consider spillback when another node could run it right now
        # (pack-then-spread keeps locality by preferring the local node).
        view = {nid: v for nid, v in self.cluster_view.items()
                if nid != self.node_id}
        if not affinity:
            target = sched.pick_node(view, demand, self.config,
                                     label_hard=label_hard,
                                     label_soft=label_soft)
            if target is not None and h.get("allow_spill", True):
                return {"spill_to": self.cluster_view[target]["agent_addr"]}
        return await self._park(h)

    async def _park(self, h: dict) -> dict:
        """Queue a lease request until capacity frees — but only for a
        bounded window.  The waiting client times out and re-requests;
        if the agent kept the entry past that, a later grant would fire
        into a future nobody reads: the worker goes "leased", its
        resources stay acquired, and (the submitter being alive) the
        dead-submitter probe never reaps it.  Answer {"retry": True}
        before the client gives up so both sides stay in sync."""
        fut = asyncio.get_running_loop().create_future()
        p = PendingLease(h, fut)
        self._pending.append(p)
        try:
            return await asyncio.wait_for(fut, self.config.lease_park_s)
        except asyncio.TimeoutError:
            with contextlib.suppress(ValueError):
                self._pending.remove(p)
            # set_result may have landed in the same tick the timeout
            # fired (wait_for still raises): the grant sits in a future
            # nobody else reads — roll it back.
            if fut.done() and not fut.cancelled():
                if fut.exception() is None and \
                        fut.result().get("granted"):
                    self._ungrant(fut.result())
            return {"retry": True}

    def _ungrant(self, reply: dict) -> None:
        """Release a lease by id: free its resources and return the
        worker to the pool.  Serves both the normal return_lease path
        and the rollback of a grant whose waiter vanished mid-flight
        (its park timed out while _grant was running) — the two MUST
        stay one code path or the rollback silently diverges."""
        entry = self._leases.pop(reply.get("lease_id"), None)
        if entry:
            worker_id, header = entry
            self._release(header)
            w = self.workers.get(worker_id)
            if w is not None:
                w.lease_id = None
                w.submitter = None
                if not w.is_device_worker and w.state == "leased":
                    w.state = "idle"
        self._try_grant_pending()

    async def _grant(self, h: dict) -> dict:
        # Check + reserve resources BEFORE any await so concurrent lease
        # requests cannot double-book the same capacity while a worker spawns.
        if not self._resources_fit(h):
            return await self._park(h)
        self._acquire(h)
        try:
            # Failpoint window: resources acquired, grant not yet replied
            # (error = the release path must run; crash = the agent dies
            # holding the acquisition — node death frees everything).
            if failpoints.ACTIVE:
                await failpoints.fire_async("agent.lease_grant")
            if h.get("resources", {}).get("GPU", 0) > 0 or h.get("device_worker"):
                w = await self._get_device_worker()
            else:
                w = await self._get_idle_worker()
        except Exception:
            self._release(h)
            raise
        if w is None or w.addr is None:
            self._release(h)
            return await self._park(h)
        lease_id = f"{self.node_id}-{next(self._lease_seq)}"
        if not w.is_device_worker:
            w.state = "leased"
        w.lease_id = lease_id
        w.submitter = h.get("submitter")
        self._leases[lease_id] = (w.worker_id, h)
        return {"granted": True, "worker_addr": w.addr, "lease_id": lease_id,
                "worker_id": w.worker_id, "node_id": self.node_id}

    async def rpc_return_lease(self, h: dict, _b: list) -> dict:
        self._ungrant(h)
        return {}

    def _try_grant_pending(self) -> None:
        if not self._pending:
            return
        still: list[PendingLease] = []
        for p in self._pending:
            if not p.fut.done() and self._resources_fit(p.header):
                # Hold a strong ref: asyncio keeps only weak refs to
                # tasks, and a grant awaiting a worker spawn could be
                # GC'd mid-flight, silently losing the parked grant.
                t = asyncio.get_running_loop().create_task(
                    self._grant_pending(p))
                self._grant_tasks.add(t)
                t.add_done_callback(self._grant_tasks.discard)
            elif not p.fut.done():
                still.append(p)
        self._pending = still

    async def _grant_pending(self, p: PendingLease) -> None:
        try:
            reply = await self._grant(p.header)
        except Exception as e:  # noqa: BLE001
            if not p.fut.done():
                p.fut.set_exception(e)
            return
        if p.fut.done():
            # The waiter's park expired (wait_for cancelled the future)
            # while _grant ran: nobody will read this reply.  Undo the
            # grant or the worker stays leased-to-nobody forever.
            if reply.get("granted"):
                self._ungrant(reply)
            return
        p.fut.set_result(reply)

    # --------------------------------------------------------------- actors
    def _admit_actor(self, h: dict) -> tuple[dict | None, dict | None]:
        """Synchronous admission (the _grant discipline extended to N):
        feasibility check + resource acquisition with NO awaits in
        between, so a wave's admissions can never double-book capacity.
        Returns (lease_header, None) on admit, (None, refusal) otherwise
        — a refusal WITHOUT "error" is retriable (the controller re-picks
        a node); "error" is terminal."""
        demand = dict(h.get("resources", {}))
        lease_h = {"resources": demand, "submitter": None}
        if not sched.feasible(self.resources, demand):
            return None, {"ok": False, "error": "infeasible"}
        if not self._resources_fit(lease_h):
            return None, {"ok": False}
        self._acquire(lease_h)
        return lease_h, None

    async def _place_actor(self, h: dict, blobs: list,
                           lease_h: dict) -> dict:
        """Acquire a worker for one ADMITTED actor and start it there
        (resources already held via lease_h; released on any failure)."""
        demand = lease_h["resources"]
        t0 = time.time()
        w = None
        try:
            if demand.get("GPU", 0) > 0:
                w = await self._get_device_worker()
            else:
                # Zero-demand actors keep the worker-count cap: with no
                # resources to admit them, ignore_cap would allow
                # unbounded process forks.
                has_demand = any(v > 0 for v in demand.values())
                w = await self._get_idle_worker(
                    ignore_cap=has_demand, spawn_sem=self._actor_spawn_sem)
        finally:
            if w is None or w.addr is None:
                self._release(lease_h)
        if w is None or w.addr is None:
            return {"ok": False}
        spans.emit("actor.spawn", t0, time.time(), attrs={
            "actor_id": h["actor_id"][:12], "worker": w.worker_id[:12]})
        if not w.is_device_worker:
            w.state = "actor"
        w.actor_ids.add(h["actor_id"])
        w.actor_leases[h["actor_id"]] = lease_h
        try:
            reply, _ = await self.clients.get(w.addr).call(
                "create_actor",
                {**h["creation_header"], "actor_id": h["actor_id"],
                 "owner_addr": h["owner_addr"]},
                blobs, timeout=300.0)
        except Exception as e:  # noqa: BLE001
            self._release(lease_h)
            w.actor_ids.discard(h["actor_id"])
            w.actor_leases.pop(h["actor_id"], None)
            if not w.is_device_worker and not w.actor_ids \
                    and w.state == "actor":
                # The live process must return to the pool, not leak as
                # a zero-actor "actor" worker nothing can ever reuse.
                w.state = "idle"
                self._try_grant_pending()
            return {"ok": False, "error": None, "detail": str(e)}
        if reply.get("error"):
            self._release(lease_h)
            w.actor_ids.discard(h["actor_id"])
            w.actor_leases.pop(h["actor_id"], None)
            if not w.is_device_worker:
                w.state = "idle"
            self._try_grant_pending()
            return {"ok": False, "error": reply["error"]}
        return {"ok": True, "worker_addr": w.addr, "worker_id": w.worker_id}

    async def rpc_create_actors(self, h: dict, blobs: list) -> dict:
        """Bulk actor placement: admit the whole wave under ONE lease-
        acquire pass, fan worker acquisition out concurrently through the
        spawn gate, and reply per-actor results in one message."""
        # Failpoint window: wave received, nothing admitted yet (crash =
        # the agent dies mid-wave; the controller's dispatch failure
        # reschedules every actor of the wave on survivors).
        if failpoints.ACTIVE:
            await failpoints.fire_async("agent.create_actors")
        actors = h["actors"]
        specs: list[list] = []
        off = 0
        for a in actors:
            n = int(a.get("nblobs", 0))
            specs.append(blobs[off:off + n])
            off += n
        t0 = time.time()
        results: dict[str, dict] = {}
        admitted: list[tuple[dict, list, dict]] = []
        for a, spec in zip(actors, specs):
            lease_h, refusal = self._admit_actor(a)
            if lease_h is None:
                results[a["actor_id"]] = refusal
            else:
                admitted.append((a, spec, lease_h))
        spans.emit("actor.lease", t0, time.time(), attrs={
            "count": len(actors), "admitted": len(admitted)})
        outs = await asyncio.gather(
            *[self._place_actor(a, spec, lh) for a, spec, lh in admitted],
            return_exceptions=True)
        for (a, _spec, _lh), out in zip(admitted, outs):
            if isinstance(out, BaseException):
                # _place_actor released the lease on its way out; the
                # wave must report the one actor, never die whole.
                logger.warning("bulk placement of %s failed: %s",
                               a["actor_id"][:12], out)
                out = {"ok": False, "error": None, "detail": str(out)}
            results[a["actor_id"]] = out
        return {"results": results}

    async def rpc_destroy_actor(self, h: dict, _b: list) -> dict:
        """Tear down one hosted actor and free its resources.  Dedicated
        workers exit (process isolation, like ray); the shared device worker
        only drops the actor instance — other GPU actors keep running."""
        actor_id = h["actor_id"]
        for w in self.workers.values():
            if actor_id in w.actor_ids:
                w.actor_ids.discard(actor_id)
                lease_h = w.actor_leases.pop(actor_id, None)
                if lease_h:
                    self._release(lease_h)
                if w.addr:
                    try:
                        if w.is_device_worker:
                            await self.clients.get(w.addr).notify(
                                "kill_actor_local", {"actor_id": actor_id})
                        else:
                            await self.clients.get(w.addr).notify(
                                "exit_worker", {"reason": "actor killed",
                                                "hard": True})
                    except Exception:  # noqa: BLE001
                        pass
                self._try_grant_pending()
                return {"found": True}
        return {"found": False}

    async def rpc_failpoints(self, h: dict, _b: list) -> dict:
        """Fault-injection control verb: apply to THIS agent and, with
        broadcast=True, fan out to every live worker it supervises (the
        "reach already-running processes" leg of failpoint propagation —
        env inheritance only covers processes spawned after arming)."""
        local = failpoints.control(
            {k: v for k, v in h.items() if k != "broadcast"})
        if h.get("broadcast"):
            sub = {k: v for k, v in h.items() if k != "broadcast"}
            live = [w for w in list(self.workers.values())
                    if w.addr and w.state not in ("dead", "stopping")]

            # Concurrent fan-out (see controller.rpc_failpoints): a
            # wedged worker costs one 10s timeout, not 10s × stragglers.
            async def _one(w):
                try:
                    reply, _ = await self.clients.get(w.addr).call(
                        "failpoints", sub, timeout=10.0)
                    return w.worker_id, reply
                except Exception as e:  # noqa: BLE001 - worker churning
                    return w.worker_id, {"error": repr(e)}

            local["workers"] = dict(await asyncio.gather(
                *(_one(w) for w in live)))
        return local

    async def rpc_spans(self, h: dict, _b: list) -> dict:
        """Flight-recorder harvest verb: read THIS agent's span buffer
        and, with broadcast=True, fan out to every live worker it
        supervises (the failpoints-verb shape — dead/wedged workers
        cost one bounded timeout each, concurrently, never a hang)."""
        local = spans.control(
            {k: v for k, v in h.items() if k != "broadcast"})
        if h.get("broadcast"):
            sub = {k: v for k, v in h.items() if k != "broadcast"}
            live = [w for w in list(self.workers.values())
                    if w.addr and w.state not in ("dead", "stopping")]

            async def _one(w):
                try:
                    reply, _ = await self.clients.get(w.addr).call(
                        "spans", sub, timeout=10.0)
                    return w.worker_id, reply
                except Exception as e:  # noqa: BLE001 - worker churning
                    return w.worker_id, {"error": repr(e)}

            local["workers"] = dict(await asyncio.gather(
                *(_one(w) for w in live)))
        return local

    async def rpc_telemetry(self, h: dict, _b: list) -> dict:
        raise NotImplementedError(
            "the telemetry timeline is not ported yet (ROADMAP.md queue 1: "
            "the telemetry timeline)")

    def _leak_scan(self) -> dict:
        """One leak-sentinel pass (memledger.sentinel_scan over this
        node's store): flags arena pins held by dead pids and
        creating-state blocks with dead creators, emits a
        `memory.leak` flight-recorder span per dirty scan, and keeps
        cumulative totals (a flagged pin the very next sweep reclaims
        must still count)."""
        if self.store is None:
            return {}
        scan = memledger.sentinel_scan(self.store.backend)
        scan["spilled_bytes"] = self.store.spilled_bytes
        self._leak_totals["scans"] += 1
        if scan.get("arena_orphan_pins") or \
                scan.get("creating_dead_creator"):
            self._leak_totals["orphan_pins_flagged"] += \
                scan["arena_orphan_pins"]
            self._leak_totals["orphan_pin_bytes_flagged"] += \
                scan["arena_orphan_pin_bytes"]
            self._leak_totals["creating_dead_creator_flagged"] += \
                scan["creating_dead_creator"]
            t = time.time()
            spans.emit("memory.leak", t, t, attrs={
                "node": self.node_id[:12],
                "orphan_pins": scan["arena_orphan_pins"],
                "orphan_pin_bytes": scan["arena_orphan_pin_bytes"],
                "orphan_pin_pids": ",".join(
                    str(p) for p in scan["orphan_pin_pids"]),
                "creating_dead_creator":
                    scan["creating_dead_creator"]})
            logger.warning(
                "leak sentinel: %d orphan pin(s) (%d B) from dead "
                "pid(s) %s, %d dead-creator creating block(s) on %s",
                scan["arena_orphan_pins"],
                scan["arena_orphan_pin_bytes"],
                scan["orphan_pin_pids"],
                scan["creating_dead_creator"], self.node_id[:12])
        scan["totals"] = dict(self._leak_totals)
        self._leak_last = scan
        return scan

    async def rpc_memory(self, h: dict, _b: list) -> dict:
        """Object-ledger harvest verb: THIS agent's ledger reply plus
        the node store's pin/spill attribution and the leak sentinel's
        latest scan; with broadcast=True, fan out to every live worker
        it supervises (the spans/failpoints-verb shape — dead/wedged
        workers cost one bounded timeout each, concurrently, never a
        hang).  op "leak_scan" runs a sentinel pass right now (chaos
        tests drive the scan deterministically instead of waiting out
        the reaper cadence)."""
        if h.get("op") == "leak_scan":
            return {"node_id": self.node_id, **self._leak_scan()}
        local = memledger.control(
            {k: v for k, v in h.items() if k != "broadcast"})
        local["node_id"] = self.node_id
        if h.get("op", "collect") == "collect" and self.store is not None:
            local["store"] = self.store.memory_report(
                limit=int(h.get("limit") or 5000))
            local["sentinel"] = dict(self._leak_last or {})
        # Failpoint window: local scan complete, reply/fan-out not yet
        # sent — a crashed or wedged agent here must degrade the
        # cluster harvest to partial-with-diagnostic, never a hang.
        if failpoints.ACTIVE:
            await failpoints.fire_async("memory.harvest")
        if h.get("broadcast"):
            sub = {k: v for k, v in h.items() if k != "broadcast"}
            live = [w for w in list(self.workers.values())
                    if w.addr and w.state not in ("dead", "stopping")]

            async def _one(w):
                try:
                    reply, _ = await self.clients.get(w.addr).call(
                        "memory", sub, timeout=10.0)
                    return w.worker_id, reply
                except Exception as e:  # noqa: BLE001 - worker churning
                    return w.worker_id, {"error": repr(e)}

            local["workers"] = dict(await asyncio.gather(
                *(_one(w) for w in live)))
        return local

    async def rpc_modules(self, h: dict, _b: list) -> dict:
        """This process's pid and the top-level packages it has imported
        (the port's layout check: no torch in the agent, and no jax,
        ray_tpu, zmq, msgpack, cloudpickle or psutil)."""
        return process_modules()

    async def rpc_ping(self, h: dict, _b: list) -> dict:
        states: dict[str, int] = {}
        for w in self.workers.values():
            states[w.state] = states.get(w.state, 0) + 1
        return {"node_id": self.node_id,
                "available": self.available,
                "pending_leases": len(self._pending),
                "active_leases": len(self._leases),
                "workers_by_state": states}


def _watch_parent() -> None:
    """Exit when our parent dies (reparented to init), so killed drivers /
    test runners never leak agent or worker trees."""
    import threading

    def _loop():
        while True:
            if os.getppid() <= 1:
                os._exit(0)
            time.sleep(1.0)

    threading.Thread(target=_loop, daemon=True, name="parent-watch").start()


def main() -> None:
    from ray_tpu_torch._private.stack_dump import install as _install_stack

    _install_stack('agent')
    from ray_tpu_torch._private.config import tune_gc

    tune_gc()
    import argparse
    import json as _json
    import signal

    p = argparse.ArgumentParser()
    p.add_argument("--controller", required=True)
    p.add_argument("--config-json", default="{}")
    p.add_argument("--resources-json", default="")
    p.add_argument("--labels-json", default="")
    p.add_argument("--node-id", default="")
    args = p.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s agent: %(message)s")
    from ray_tpu_torch.logging_config import configure_process_logging
    configure_process_logging()
    config = Config().override(_json.loads(args.config_json))
    resources = _json.loads(args.resources_json) if args.resources_json else None
    labels = _json.loads(args.labels_json) if args.labels_json else None

    _watch_parent()

    async def _run():
        from ray_tpu_torch._private.stack_dump import register_loop
        register_loop(asyncio.get_running_loop())
        agent = NodeAgent(config, args.controller, resources=resources,
                          node_id=args.node_id or None, labels=labels)
        await agent.start()

        def _term(*_a):
            agent.close()
            os._exit(0)

        signal.signal(signal.SIGTERM, _term)
        print(_json.dumps({"agent_addr": agent.server.address,
                           "node_id": agent.node_id}), flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
