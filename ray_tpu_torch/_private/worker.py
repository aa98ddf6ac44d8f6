"""CoreWorker: per-process runtime linked into drivers and workers.

Analog of the reference's core_worker library
(ray: src/ray/core_worker/core_worker.h:295 + python/ray/_raylet.pyx:3309).
One instance per process, in one of two modes:
  - "driver": created by ray_tpu_torch.init(); submits tasks, owns returned objects
  - "worker": created by worker_main in agent-forked processes; executes
    tasks/actors and doubles as a submitter for nested tasks

Subsystems, each mirroring a reference component:
  - FunctionManager: content-hash export of pickled functions/classes to the
    controller KV; lazy fetch+cache on workers
    (ray: python/ray/_private/function_manager.py:195,264)
  - LeaseManager: per-scheduling-key worker leases with reuse, pipelining and
    spillback redirects (ray: NormalTaskSubmitter normal_task_submitter.h:75)
  - actor submission: direct worker->worker calls with per-handle sequence
    numbers, address re-resolution on restart
    (ray: ActorTaskSubmitter transport/actor_task_submitter.cc)
  - execution: ordered per-caller actor queues, threaded / asyncio actors
    (ray: transport/actor_scheduling_queue.cc, fiber.h)
  - ownership: owned-object table with inline values, locations, borrower
    counts, and lineage resubmission (ray: reference_count.cc,
    task_manager.cc, object_recovery_manager.h:41)

The asyncio loop always runs on a dedicated IO thread; public API calls
bridge onto it with run_coroutine_threadsafe (the GIL-discipline analog of
_raylet.pyx keeping the hot path out of user threads).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import hashlib
import itertools
import logging
import os
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any


from ray_tpu_torch._private import failpoints
from ray_tpu_torch._private import memledger
from ray_tpu_torch._private import spans
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import MemoryStore
from ray_tpu_torch._private.rpc import (ClientPool, ConnectionLost,
                                       RemoteError, RpcServer, Subscriber)
from ray_tpu_torch._private.serialization import (deserialize_with_refs,
                                                 dumps_function,
                                                 loads_function, serialize)
from ray_tpu_torch.exceptions import (ActorDiedError, ActorError,
                                      GetTimeoutError, ObjectLostError,
                                      TaskCancelledError, TaskError)
from ray_tpu_torch.object_ref import ObjectRef, set_release_hook

from ray_tpu_torch._private.actor_state import (EXECUTING_ACTOR,
                                                EXECUTING_TASK,
                                          REPLY_EVICTED,
                                          ActorInstance,
                                          ActorSubmitState,
                                          StreamState)
from ray_tpu_torch._private.lease_manager import LeaseManager, PendingTask

logger = logging.getLogger(__name__)

_global_worker: "CoreWorker | None" = None


def global_worker() -> "CoreWorker":
    if _global_worker is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init()")
    return _global_worker


def set_global_worker(w: "CoreWorker | None") -> None:
    global _global_worker
    _global_worker = w


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        # Label constraints nest value lists; a raw list would make the
        # scheduling key unhashable.
        return tuple(_freeze(x) for x in v)
    return v


# --------------------------------------------------------------------------
@dataclass
class OwnedObject:
    """Owner-side record for one object (ray: reference_count.cc entry)."""

    state: str = "pending"           # pending | inline | stored | error
    frames: list[bytes] | None = None
    locations: list[str] = field(default_factory=list)
    # Serialized payload size, learned at fulfillment (ray: object size in
    # the owner's reference table; feeds Data's resource manager).
    size: int = 0
    error: BaseException | None = None
    local_refs: int = 0
    borrowers: int = 0
    # Refs nested inside this object's value: (object_id, owner_addr) pins
    # added when the value was created (put / task return), released when
    # this object is freed (ray: reference_count.cc contained-object refs).
    contained: list = field(default_factory=list)
    # Lineage for reconstruction (ray: TaskManager::ResubmitTask).
    submit_spec: tuple | None = None
    retries_left: int = 0


class _UntrackedRef(ObjectRef):
    """Internal temporary ref: participates in no reference counting.
    Bare ObjectRef construction inside the runtime must use this class —
    a plain ObjectRef's __del__ would decrement counts (owner local_refs /
    borrow table) that were never incremented for it."""

    __slots__ = ()

    def __del__(self):
        pass


class _SyncCall:
    """In-flight fused sync actor call (ISSUE-1 fast path): the return-0
    object id maps to this record so a get() right after the submit can
    block on the reply future directly — resolved on the rpc IO thread,
    no event-loop handoff on the caller's critical path."""

    __slots__ = ("task", "cfut", "client")

    def __init__(self, task, cfut, client):
        self.task = task
        self.cfut = cfut
        self.client = client


_EMPTY_ARGS_FRAMES: list | None = None


def _empty_args_frames() -> list:
    """Cached pickle of ((), {}) — the payload of every no-arg call.
    Frames are immutable bytes; a shallow list copy keeps per-task blob
    lists independent."""
    global _EMPTY_ARGS_FRAMES
    if _EMPTY_ARGS_FRAMES is None:
        sv = serialize(((), {}))
        _EMPTY_ARGS_FRAMES = [
            f.tobytes() if isinstance(f, memoryview) else f
            for f in sv.frames]
    return list(_EMPTY_ARGS_FRAMES)


def _copy_error(e: BaseException) -> BaseException:
    """Shallow-copy a cached error before raising it: raising the cached
    instance would attach the caller's traceback to it, pinning every frame
    (and every actor handle / large object in those frames) for as long as
    the error stays cached in the memory store."""
    import copy

    try:
        err = copy.copy(e)
        err.__traceback__ = None
        return err
    except Exception:  # noqa: BLE001 - uncopyable exception
        return e


class CoreWorker:
    def __init__(self, mode: str, controller_addr: str, agent_addr: str,
                 config: Config, worker_id: str | None = None,
                 node_id: str = "", job_id: str = "", pub_addr: str = "",
                 namespace: str = "default"):
        self.mode = mode
        self.config = config
        self.controller_addr = controller_addr
        self.agent_addr = agent_addr
        self.pub_addr = pub_addr
        self.worker_id = worker_id or WorkerID.from_random().hex()
        self.node_id = node_id
        self.job_id = job_id
        self.namespace = namespace
        # Flight-recorder process label: harvest output names spans by
        # role, not bare pid (driver vs executor worker).
        spans.set_process_label(
            "driver" if mode == "driver"
            else f"worker:{self.worker_id[:12]}")
        self.memory = MemoryStore()
        self.owned: dict[bytes, OwnedObject] = {}
        # Borrower-side table: refs this process holds but does not own
        # (object_id -> {count, owner}); see _register_borrows.
        self.borrows: dict[bytes, dict] = {}
        # Guards every owned/borrows counter mutation: ObjectRef.__del__
        # runs on arbitrary GC threads, user code on executor threads, RPC
        # handlers on the loop — bare `x -= 1` is a lost-update race.
        # RLock because _free_object (under lock) releases contained pins,
        # which re-enter the lock (ray: absl::Mutex on reference_count).
        self._ref_lock = threading.RLock()
        # Creation-arg pins per actor created by this process
        # (actor_id -> [(object_id, owner_addr)]).
        self.actor_creation_borrows: dict[str, list] = {}
        # Burst-fused actor registrations: unnamed
        # creations enqueue here and a loop-side flusher coalesces the
        # burst into ONE create_actors controller round trip (the
        # call_and_wait fusion shape applied to registration).  The
        # reply for an unnamed actor is fully determined client-side, so
        # the user thread never waits on it.
        self._actor_reg_batch: list[tuple[dict, list]] = []
        self._actor_reg_lock = threading.Lock()
        self._actor_reg_task: asyncio.Task | None = None
        self.functions: dict[str, Any] = {}
        self._exported: set[str] = set()
        # id(fn) -> (fid, weakref) — see export_function.
        self._fid_by_identity: dict[int, tuple] = {}
        self.actors_hosted: dict[str, ActorInstance] = {}
        self.actor_states: dict[str, ActorSubmitState] = {}
        self.current_actor_id: str | None = None
        # Lease resources + runtime env of the executing task, for
        # runtime_context.get_assigned_resources/get_runtime_env_string.
        self.current_resources: dict | None = None
        self.current_runtime_env: dict | None = None
        # Driver address of the job whose task is currently executing
        # (propagated in task headers like `trace`); None outside tasks.
        self.current_driver_addr: str | None = None
        self._put_seq = itertools.count()
        self._cancelled: set[bytes] = set()
        # task_id -> StreamState for streaming-generator tasks this process
        # submitted (owner side; mutated only on the IO loop).
        self.streams: dict[bytes, StreamState] = {}
        # Abandoned streams (generator GC'd): late items must NOT re-create
        # state (it would never be removed and would pin the item refs
        # forever).  Bounded FIFO of task_ids.
        self._dead_streams: set[bytes] = set()
        self._dead_stream_order: list[bytes] = []
        # return-0 object id -> task_id, recorded at streaming submits so
        # the generator wrapper can find its stream (popped immediately).
        self._ret0_task_ids: dict[bytes, bytes] = {}
        self._oom_worker_addrs: set[str] = set()
        # Known-dead worker addresses (set for O(1) membership on the
        # push hot path + FIFO order for bounded eviction).  Entries are
        # REVIVED when a fresh worker provably lives at the address (lease
        # grant / actor-alive event) — ephemeral ports get reused.
        self._dead_worker_addrs: set[str] = set()
        self._dead_addr_order: list[str] = []
        # Worker-local cache of this worker's own task returns: a consumer
        # task scheduled here reads them without asking the owner (ray:
        # locality — plasma already holds the return on the producing
        # node).  Bounded FIFO; consumers also evict after use.
        self._return_cache: list[bytes] = []
        self._running_async: dict[bytes, asyncio.Task] = {}
        self._shutdown = threading.Event()
        self._task_events: list[dict] = []
        self._event_tag: tuple[str, str] | None = None
        self.loop: asyncio.AbstractEventLoop = None  # set in start()
        self._default_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="task-exec")
        # Batched cross-thread posts: call_soon_threadsafe costs a self-pipe
        # write (syscall) per call, which at thousands of submits/releases
        # per second dominates the submit path.  One wakeup drains many.
        self._post_pending: list = []
        self._post_scheduled = False
        # Outstanding call_nowait RPC tasks: flushed at shutdown so a
        # fire-and-forget notification posted right before exit (e.g.
        # remove_placement_group) still reaches the wire.
        self._nowait_tasks: set = set()
        self._post_mutex = threading.Lock()
        # return-0 object id -> _SyncCall for fused sync actor calls
        # (see _submit_actor_direct): entries are claimed by the first
        # get() on the ref and always cleaned up by the loop-side
        # finalize when the reply (or transport failure) lands.
        self._sync_calls: dict[bytes, _SyncCall] = {}
        # Fused-path counter (tests assert the path engages).
        self._direct_sync_calls = 0

    # ---------------------------------------------------------------- setup
    def start(self) -> None:
        started = threading.Event()
        self._io_thread = threading.Thread(
            target=self._io_main, args=(started,), name="raytpu-io",
            daemon=True)
        self._io_thread.start()
        started.wait(30.0)
        if self.loop is None:
            raise RuntimeError("IO loop failed to start")
        set_release_hook(self._release_local_ref)
        from ray_tpu_torch._private.config import tune_gc

        tune_gc(framework_process=(self.mode != "driver"))

    # The executing call's task id and trace header (ray: OpenTelemetry
    # propagation, util/tracing/tracing_helper.py): child submissions
    # inherit the trace, and task events and profiling spans carry both.
    # They follow the call (actor_state.EXECUTING_TASK), since the device
    # worker runs many actors' calls at once; None outside any call.
    @property
    def current_task_id(self) -> str | None:
        c = EXECUTING_TASK.get()
        return None if c is None else c[0]

    @property
    def current_trace(self) -> dict | None:
        c = EXECUTING_TASK.get()
        return None if c is None else c[1]

    @property
    def driver_addr(self) -> str:
        """The owning job's driver address: this process for drivers,
        the submitting job's driver inside task/actor execution (falls
        back to this process for detached contexts)."""
        if self.mode == "driver":
            return self.address
        return self.current_driver_addr or self.address

    def _io_main(self, started: threading.Event) -> None:
        asyncio.run(self._io_async_main(started))

    async def _io_async_main(self, started: threading.Event) -> None:
        self.loop = asyncio.get_running_loop()
        from ray_tpu_torch._private.stack_dump import register_loop
        register_loop(self.loop)
        # Transport sockets live on the process-wide rpc IO thread; this
        # component only closes ITS server/clients/subscriber on the way
        # out (the shared context is never terminated — in-process
        # cluster nodes coexist on it).
        self.server = RpcServer()
        self.clients = ClientPool()
        self.server.register_all(self)
        self.server.start()
        self.address = self.server.address
        self.lease_manager = LeaseManager(self)
        if self.pub_addr:
            self._subscribe_events(self.pub_addr)
        if self.mode == "worker":
            await self.clients.get(self.agent_addr).call(
                "register_worker",
                {"worker_id": self.worker_id, "addr": self.address},
                timeout=30.0)
        flusher = self.loop.create_task(self._event_flush_loop())
        started.set()
        try:
            # Asyncio-native shutdown signal.  Parking a default-executor
            # thread on self._shutdown.wait would deadlock interpreter
            # exit: concurrent.futures' _python_exit joins executor threads
            # BEFORE regular atexit callbacks run, so a driver that never
            # calls ray_tpu_torch.shutdown() explicitly would hang forever.
            self._shutdown_async = asyncio.Event()
            if self._shutdown.is_set():
                self._shutdown_async.set()
            await self._shutdown_async.wait()
        finally:
            flusher.cancel()
            sub = getattr(self, "subscriber", None)
            if sub is not None:
                sub.close()
            self.server.close()
            self.clients.close()

    def _subscribe_events(self, pub_addr: str) -> None:
        """Subscribe to controller events (must run on the IO loop)."""
        self.pub_addr = pub_addr
        self.subscriber = Subscriber(address=pub_addr)
        self.subscriber.subscribe("actor", self._on_actor_event)
        self.subscriber.subscribe("worker", self._on_worker_event)
        self.subscriber.subscribe("node", self._on_node_event)
        if self.mode == "driver" and getattr(self, "log_to_driver", False):
            self.subscriber.subscribe("logs", self._on_log_lines)

    async def _on_worker_event(self, _topic: str, payload: dict) -> None:
        """Cluster-wide worker-death broadcast: mark the address dead and
        drop its client NOW — every pending call to it (e.g. a borrower's
        resolve_object against a dead owner) fails instead of waiting on
        a reconnecting client connection that reconnects forever."""
        if payload.get("event") != "dead":
            return
        addr = payload.get("addr")
        if not addr or addr == self.address:
            return
        self._mark_addr_dead(addr)
        self.clients.drop(addr)

    async def _on_node_event(self, _topic: str, payload: dict) -> None:
        """Node death fan-out (round-9 MTTR fix): an object pull from a
        dead node's agent used to wait out the full transfer RPC timeout
        (120s per location) before recovery could start — the dominant
        term in crash-mid-chunked-pull MTTR.  Mark the dead agent's
        address and fail its in-flight calls NOW; a rejoining node
        (same address) is revived on its "alive" event."""
        addr = payload.get("agent_addr")
        if not addr or addr == self.agent_addr:
            return          # our own agent's fate is ours anyway
        if payload.get("event") == "dead":
            self._mark_addr_dead(addr)
            self.clients.drop(addr)
        elif payload.get("event") == "alive":
            self._revive_addr(addr)

    def _mark_addr_dead(self, addr: str) -> None:
        """The ONE bookkeeping site for the dead-address registry (the
        eviction ring must never hold duplicate entries, or popping an
        old duplicate would un-mark a currently-dead address)."""
        if addr in self._dead_worker_addrs:
            return
        self._dead_worker_addrs.add(addr)
        self._dead_addr_order.append(addr)
        while len(self._dead_addr_order) > 1024:
            self._dead_worker_addrs.discard(self._dead_addr_order.pop(0))

    async def _on_log_lines(self, _topic: str, payload: dict) -> None:
        """Print streamed worker logs on the driver console
        (ray: log_monitor-fed driver output, prefixed per worker)."""
        import sys

        node = payload.get("node_id", "?")
        for src, line in payload.get("lines", []):
            print(f"({src}, node={node}) {line}", file=sys.stderr)

    def connect_events(self, pub_addr: str) -> None:
        self.loop.call_soon_threadsafe(self._subscribe_events, pub_addr)

    def shutdown(self) -> None:
        set_release_hook(None)
        # Flush fire-and-forget notifications first: a remove_pg posted
        # just before exit must reach the wire or its reservation leaks
        # cluster-wide (nobody else reaps this driver's PGs).  Batched
        # actor registrations too — a detached actor created right
        # before exit must reach the controller.
        try:
            self.run(self._actor_regs_settled(), timeout=3.0)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        try:
            self.run(self._drain_nowait(), timeout=3.0)
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        self._shutdown.set()
        ev = getattr(self, "_shutdown_async", None)
        if ev is not None and self.loop is not None:
            try:
                self.loop.call_soon_threadsafe(ev.set)
            except RuntimeError:
                pass
        self._io_thread.join(5.0)
        set_global_worker(None)

    def _post_to_loop(self, fn) -> None:
        """Run fn() on the IO loop; safe from any thread.  Posts made while
        a wakeup is already pending ride the same drain (one self-pipe
        write per burst instead of one per call)."""
        with self._post_mutex:
            self._post_pending.append(fn)
            if self._post_scheduled:
                return
            self._post_scheduled = True
        loop = self.loop
        try:
            if loop is None:
                raise RuntimeError("IO loop not running")
            loop.call_soon_threadsafe(self._drain_posts)
        except RuntimeError:
            # Reset so a later post retries the wakeup — a stuck True flag
            # would silently drop every future post (submit hangs).
            with self._post_mutex:
                self._post_scheduled = False
            raise

    def _drain_posts(self) -> None:
        while True:
            with self._post_mutex:
                pending = self._post_pending
                if not pending:
                    self._post_scheduled = False
                    return
                self._post_pending = []
            for fn in pending:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    logger.exception("posted callback failed")

    def run(self, coro, timeout: float | None = None):
        """Bridge a coroutine from any user thread onto the IO loop."""
        if threading.current_thread() is getattr(self, "_io_thread", None):
            # Blocking the loop on itself would deadlock forever (e.g. a
            # custom __setstate__ calling ray_tpu_torch.get() during inline
            # deserialization) — fail loudly instead.
            coro.close()
            raise RuntimeError(
                "ray_tpu_torch blocking API called from the runtime IO thread "
                "(e.g. inside a deserialization hook); move the call into "
                "task/actor code")
        # Hand-rolled bridge instead of run_coroutine_threadsafe: that
        # helper chains the Task to the concurrent Future with closures
        # that keep BOTH alive in a reference cycle, and each retains the
        # coroutine's exception.  Re-raising here then grows that
        # exception's traceback with the caller's frames, closing a cycle
        # (exc.tb → caller frame → future → Task → exc) that only a
        # CYCLIC gc pass reclaims — minutes away under tune_gc()'s raised
        # thresholds.  Everything the caller's frames reference (actor
        # handles, stream generators, arrays) is pinned that whole
        # window; a delayed ActorHandle.__del__ kill once starved a test
        # cluster of CPU leases and wedged the suite.  Here the exception
        # travels as a RESULT tuple: the Task keeps no payload and dies
        # by refcount the moment its done-callback returns, so liveness
        # never waits on the collector.
        cfut: concurrent.futures.Future = concurrent.futures.Future()
        loop = self.loop

        def _start():
            task = loop.create_task(coro)

            def _done(t):
                try:
                    payload = (True, t.result())
                except BaseException as e:  # noqa: BLE001
                    # Strip THIS frame from the traceback: with it, the
                    # exception would reference a frame whose locals
                    # reference the exception back — a refcount-immune
                    # cycle pinning the payload until a gc pass.
                    tb = e.__traceback__
                    if tb is not None:
                        e.__traceback__ = tb.tb_next
                    del tb   # else: frame-local ↔ frame self-cycle
                    payload = (False, e)
                try:
                    cfut.set_result(payload)
                except concurrent.futures.InvalidStateError:
                    pass

            task.add_done_callback(_done)

        loop.call_soon_threadsafe(_start)
        try:
            ok, val = cfut.result(timeout)
        finally:
            if cfut.done():
                cfut._result = None
            else:
                # Timed out: let the eventual payload free itself.
                cfut.add_done_callback(
                    lambda f: setattr(f, "_result", None))
        if ok:
            return val
        try:
            raise val
        finally:
            # raise grew val.__traceback__ to include THIS frame; the
            # frame-local `val` would close the cycle — drop it.
            del val

    async def acall(self, addr: str, method: str, header: dict | None = None,
                    blobs: list | None = None,
                    timeout: float | None = None) -> tuple[dict, list]:
        return await self.clients.get(addr).call(
            method, header or {}, blobs, timeout)

    def call(self, addr: str, method: str, header: dict | None = None,
             blobs: list | None = None,
             timeout: float | None = None) -> tuple[dict, list]:
        """Thread-safe RPC from user threads; client sockets are created on
        the IO loop (client connections are loop-bound)."""
        return self.run(self.acall(addr, method, header, blobs, timeout))

    def call_nowait(self, addr: str, method: str,
                    header: dict | None = None, blobs: list | None = None,
                    timeout: float = 30.0) -> None:
        """Fire an RPC without blocking on its reply (errors are logged,
        not raised).  For notifications whose effect the caller never
        reads back directly — e.g. remove_placement_group, where the
        reference's GCS also tears down asynchronously.  Per-connection
        per-connection ordering still serializes it before the caller's NEXT call to
        the same peer."""
        def _go():
            async def _run():
                try:
                    await self.clients.get(addr).call(
                        method, header, blobs, timeout=timeout)
                except Exception:  # noqa: BLE001 - fire-and-forget
                    logger.warning("call_nowait %s to %s failed", method,
                                   addr)
            t = self.loop.create_task(_run())
            self._nowait_tasks.add(t)
            t.add_done_callback(self._nowait_tasks.discard)

        self._post_to_loop(_go)

    async def _drain_nowait(self) -> None:
        pending = [t for t in self._nowait_tasks if not t.done()]
        if pending:
            await asyncio.wait(pending, timeout=2.0)

    # ------------------------------------------------------------ functions
    def export_function(self, fn: Any) -> str:
        # Identity cache: the same function object is submitted thousands of
        # times on the hot path; re-pickling + re-hashing it per call costs
        # ~100µs each (ray keeps the same discipline — the function is
        # exported once per (fn, job), function_manager.py:195).  Weakrefs,
        # not hard pins: a driver minting fresh closures per call must not
        # accumulate them (dead entries drop via the weakref callback).
        import weakref

        key = id(fn)
        hit = self._fid_by_identity.get(key)
        if hit is not None and hit[1]() is fn:
            return hit[0]
        blob = dumps_function(fn)
        fid = hashlib.blake2b(blob, digest_size=16).hexdigest()
        if fid not in self._exported:
            self.call(self.controller_addr, "kv_put",
                      {"ns": "fn", "key": fid}, [blob])
            self._exported.add(fid)
            self.functions[fid] = fn
        try:
            ref = weakref.ref(
                fn, lambda _r, k=key: self._fid_by_identity.pop(k, None))
            self._fid_by_identity[key] = (fid, ref)
        except TypeError:
            pass   # not weakref-able: skip caching
        return fid

    async def _fetch_function(self, fid: str) -> Any:
        fn = self.functions.get(fid)
        if fn is not None:
            return fn
        reply, blobs = await self.clients.get(self.controller_addr).call(
            "kv_get", {"ns": "fn", "key": fid})
        if not reply.get("found"):
            raise RuntimeError(f"function {fid} not found in KV")
        fn = await self.loop.run_in_executor(None, loads_function, blobs[0])
        self.functions[fid] = fn
        return fn

    # ----------------------------------------------------------- submission
    def submit_task(self, fn: Any, args: tuple, kwargs: dict,
                    options: dict) -> list[ObjectRef]:
        fid = self.export_function(fn)
        task_id = TaskID.from_random()
        num_returns = options.get("num_returns", 1)
        return_ids = [ObjectID.for_return(task_id, i).binary()
                      for i in range(num_returns)]
        resources = dict(options.get("resources") or {})
        resources.setdefault("CPU", options.get("num_cpus", 1))
        if options.get("num_gpus"):
            resources["GPU"] = options["num_gpus"]
        header, blobs, borrowed = self._build_task_payload(
            task_id.binary(), fid, args, kwargs, num_returns, resources,
            options)
        retries = options.get("max_retries",
                              self.config.default_task_max_retries)
        scheduling_key = (fid, _freeze(resources),
                          options.get("affinity_node_id"),
                          options.get("affinity_soft", False),
                          _freeze(options.get("label_hard") or {}),
                          _freeze(options.get("label_soft") or {}))
        task = PendingTask(
            task_id=task_id.binary(), header=header, blobs=blobs,
            return_ids=return_ids, retries_left=max(0, retries),
            retry_exceptions=bool(options.get("retry_exceptions")),
            scheduling_key=scheduling_key, borrowed=borrowed)
        refs = [ObjectRef(rid, self.address) for rid in return_ids]
        if options.get("streaming"):
            self._ret0_task_ids[return_ids[0]] = task_id.binary()
        with self._ref_lock:
            for rid in return_ids:
                rec = self.owned.setdefault(rid, OwnedObject())
                rec.local_refs += 1
                rec.submit_spec = (fid, header, blobs, scheduling_key)
                rec.retries_left = max(0, retries)
        fn_name = getattr(fn, "__qualname__",
                          getattr(fn, "__name__", fid[:12]))
        if memledger.ENABLED:
            # The submitted function IS the callsite that groups task
            # returns in `ray memory` (ray: "(task call) fn" rows).
            for rid in return_ids:
                memledger.note_create(rid, "task_return",
                                      "(task) " + fn_name)

        def _go():
            self.memory_entries_for(return_ids)
            self.lease_manager.submit(task)

        self._post_to_loop(_go)
        # The submitted TASK's trace context (not this process's current
        # one): its span_id/parent_span are what the OTLP bridge pairs.
        # Readable function name, not the fid hash — summarize_tasks
        # groups (and the timeline labels) by it.
        self._record_event(task_id.hex(), "SUBMITTED", fn_name,
                           trace=header["trace"])
        return refs

    def memory_entries_for(self, return_ids: list[bytes]) -> None:
        for rid in return_ids:
            self.memory.entry(rid)

    # ------------------------------------------------ streaming generators
    def submit_streaming_task(self, fn: Any, args: tuple, kwargs: dict,
                              options: dict):
        """Submit a generator task whose items stream back as they are
        produced (ray: streaming ObjectRefGenerator).  Returns the
        generator immediately — no waiting for the task."""
        from ray_tpu_torch.object_ref import StreamingObjectRefGenerator

        options = {**options, "num_returns": 1, "streaming": True}
        refs = self.submit_task(fn, args, kwargs, options)
        return StreamingObjectRefGenerator(
            self._task_id_of(refs[0]), refs[0], self)

    def submit_streaming_actor_task(self, actor_id: str, method: str,
                                    args: tuple, kwargs: dict,
                                    options: dict):
        from ray_tpu_torch.object_ref import StreamingObjectRefGenerator

        options = {**options, "num_returns": 1, "streaming": True}
        refs = self.submit_actor_task(actor_id, method, args, kwargs,
                                      options)
        return StreamingObjectRefGenerator(
            self._task_id_of(refs[0]), refs[0], self)

    def _task_id_of(self, ref: ObjectRef) -> bytes:
        """task_id for a return-0 ref minted by this process this session
        (submit paths record it)."""
        return self._ret0_task_ids.pop(ref.binary())

    def _stream_state(self, task_id: bytes) -> StreamState:
        st = self.streams.get(task_id)
        if st is None:
            st = StreamState()
            self.streams[task_id] = st
        return st

    def stream_next(self, task_id: bytes, index: int,
                    timeout: float | None = None) -> ObjectRef:
        """Blocking wait for item `index` of a streaming task.  Raises
        StopAsyncIteration past the end, or the task's error."""
        return self.run(self._stream_next_async(task_id, index), timeout)

    async def _stream_next_async(self, task_id: bytes,
                                 index: int) -> ObjectRef:
        st = self._stream_state(task_id)
        while True:
            if index < len(st.refs):
                return st.refs[index]
            if st.total is not None and index >= st.total:
                if st.error is not None:
                    # Copy: re-raising the STORED exception would grow its
                    # traceback in place and pin this caller's frames for
                    # the stream state's lifetime (see _copy_error).
                    raise _copy_error(st.error)
                raise StopAsyncIteration
            st.event.clear()
            await st.event.wait()

    def drop_stream(self, task_id: bytes) -> None:
        """Generator finalizer hook: forget the stream state (item refs
        release via their own ObjectRef finalizers) and tombstone the
        stream so late items are refused."""
        def _drop():
            self.streams.pop(task_id, None)
            self._dead_streams.add(task_id)
            self._dead_stream_order.append(task_id)
            while len(self._dead_stream_order) > 4096:
                self._dead_streams.discard(self._dead_stream_order.pop(0))
        try:
            self._post_to_loop(_drop)
        except RuntimeError:
            pass    # loop gone at teardown: nothing to clean

    async def rpc_stream_item(self, h: dict, blobs: list) -> dict:
        """Owner-side registration of one streamed item (the executing
        worker awaits this ack — that is the stream's backpressure AND the
        guarantee that every item is registered before the final task
        reply arrives)."""
        task_id = bytes.fromhex(h["task_id"])
        if task_id in self._dead_streams:
            # Consumer abandoned the stream: refuse the item so nothing
            # pins it (the producer keeps its retry budget intact; the
            # final reply cleans up the return-0 record).
            return {}
        st = self._stream_state(task_id)
        index = h["index"]
        tid = TaskID(task_id)
        iid = ObjectID.for_return(tid, index + 1).binary()
        if memledger.ENABLED:
            memledger.note_create(iid, "task_return", "(stream item)")
        with self._ref_lock:
            irec = self.owned.setdefault(iid, OwnedObject())
            prev_pins, irec.contained = irec.contained, [
                (bytes.fromhex(c[0]), c[1]) for c in h.get("contained", ())]
            rec0 = self.owned.get(ObjectID.for_return(tid, 0).binary())
            if rec0 is not None:
                irec.submit_spec = rec0.submit_spec
                irec.retries_left = rec0.retries_left
            irec.size = h.get("size", 0)
            if h.get("inline"):
                irec.state = "inline"
                irec.frames = list(blobs)
                self.memory.put_frames(iid, irec.frames)
            else:
                irec.state = "stored"
                irec.locations = [h["location"]]
                self.memory.put_locations(iid, irec.locations)
            if index >= len(st.refs):
                # One count for the ObjectRef held in the stream (handed
                # to the consumer by stream_next).
                irec.local_refs += 1
                st.refs.append(ObjectRef(iid, self.address))
            # else: a retried task re-shipped an index we already hold —
            # payload refreshed above, no new ref/pin.
        for c_oid, c_owner in prev_pins:
            self._release_borrow(c_oid, c_owner)
        st.event.set()
        return {}

    def _finish_stream(self, task: PendingTask, reply: dict,
                       blobs: list) -> None:
        """Owner-side handling of a streaming task's final reply: resolve
        the return-0 ref to an ObjectRefGenerator over all items (dynamic
        compat — the items are pinned as its contained refs) and wake
        consumers."""
        from ray_tpu_torch.object_ref import ObjectRefGenerator

        st = self._stream_state(task.task_id)
        abandoned = task.task_id in self._dead_streams
        status = reply.get("status")
        total = int(reply.get("streamed", 0))
        rid0 = task.return_ids[0]
        if status == "ok":
            prev_contained: list = []
            rec = None
            with self._ref_lock:
                rec = self.owned.get(rid0)
                contained = []
                for ref in st.refs[:total]:
                    iid = ref.binary()
                    irec = self.owned.get(iid)
                    if irec is not None:
                        irec.borrowers += 1
                        contained.append((iid, self.address))
                value = ObjectRefGenerator(list(st.refs[:total]))
                sv = serialize(value)
                if rec is None:
                    tmp = OwnedObject()
                    tmp.contained = contained
                    self._free_object(rid0, tmp)
                else:
                    prev_contained, rec.contained = rec.contained, contained
                    rec.state = "inline"
                    rec.frames = sv.frames
                    e = self.memory.entry(rid0)
                    e.frames = sv.frames
                    e.has_value, e.value = True, value
                    e.wake()
            for c_oid, c_owner in prev_contained:
                self._release_borrow(c_oid, c_owner)
            st.total = total
            self._record_event(task.task_id.hex(), "FINISHED",
                               trace=task.header.get("trace"))
        elif status == "cancelled":
            st.error = TaskCancelledError(task.task_id.hex())
            st.total = total
            self._resolve_error(rid0, st.error)
        else:
            exc, tb = None, reply.get("traceback", "")
            if blobs:
                try:
                    import pickle

                    exc = pickle.loads(blobs[0])
                except Exception:  # noqa: BLE001
                    exc = RuntimeError("task failed")
            if task.retry_exceptions and task.retries_left > 0:
                task.retries_left -= 1
                self.lease_manager.submit(task)
                return
            st.error = TaskError(exc or RuntimeError("task failed"), tb)
            st.total = total
            self._resolve_error(rid0, st.error)
            self._record_event(task.task_id.hex(), "FAILED",
                               trace=task.header.get("trace"))
        st.event.set()
        if abandoned:
            # The state above was a transient re-creation (the consumer is
            # gone); drop it again so nothing stays pinned.
            self.streams.pop(task.task_id, None)

    def _build_task_payload(self, task_id: bytes, fid: str, args: tuple,
                            kwargs: dict, num_returns: int,
                            resources: dict,
                            options: dict) -> tuple[dict, list, list]:
        # Top-level ObjectRef args are resolved to values worker-side before
        # execution (ray: DependencyResolver; nested refs stay refs).
        arg_refs: list[dict] = []
        borrowed: dict[bytes, str] = {}    # deduped per task
        if not args and not kwargs:
            # No-arg calls dominate ping/poll-style actor traffic; their
            # pickled payload is a constant — skip the serializer.
            frames = _empty_args_frames()
        else:
            plain_args: list[Any] = []
            for i, a in enumerate(args):
                if isinstance(a, ObjectRef):
                    arg_refs.append({"pos": i, "id": a.hex(),
                                     "owner": a.owner_addr or self.address})
                    plain_args.append(None)
                    borrowed.setdefault(a.binary(),
                                        a.owner_addr or self.address)
                else:
                    plain_args.append(a)
            sv = serialize((tuple(plain_args), kwargs))
            # Snapshot zero-copy view frames: the push happens later on the
            # IO loop (and again on retry / lineage resubmit), so args must
            # have submission-time semantics — a caller mutating its array
            # after .remote() must not corrupt the task (ray: by-value arg
            # copies).
            frames = [f.tobytes() if isinstance(f, memoryview) else f
                      for f in sv.frames]
            for ref in sv.contained_refs:
                borrowed.setdefault(ref.binary(),
                                    ref.owner_addr or self.address)
            for oid, owner in borrowed.items():
                self._add_borrow(oid, owner)
        # Trace context priority: an OPEN flight-recorder span (contextvar
        # — set by library spans and by async actor handlers) beats the
        # executing call's header; outside both, the submission roots a
        # new trace.
        tc = spans.task_trace_context() or self.current_trace
        header = {
            "task_id": task_id.hex(), "function_id": fid,
            "num_returns": num_returns, "resources": resources,
            "owner_addr": self.address, "arg_refs": arg_refs,
            "name": options.get("name", ""),
            # Job context: the driver's address travels with every task
            # (transitively through nested submissions), so driver-scoped
            # resources created INSIDE workers are owned by the job's
            # driver, not by a pooled worker process whose exit would reap
            # them.
            "driver_addr": self.driver_addr,
            # W3C-style propagation: a task submitted INSIDE a task
            # continues its trace; a driver submission roots a new one
            # (trace_id = root task id).  span_id = this task's id.
            "trace": {
                "trace_id": tc["trace_id"] if tc else task_id.hex(),
                "parent_span": tc["span_id"] if tc else None,
                "span_id": task_id.hex(),
            },
        }
        if options.get("dynamic"):
            header["dynamic"] = True
        if options.get("streaming"):
            header["streaming"] = True
        if options.get("runtime_env"):
            raise NotImplementedError(
                "runtime_env is not ported yet (ROADMAP.md queue 1: "
                "runtime envs and placement groups)")
        if options.get("affinity_node_id"):
            header["affinity_node_id"] = options["affinity_node_id"]
            header["affinity_soft"] = options.get("affinity_soft", False)
        if options.get("label_hard"):
            header["label_hard"] = options["label_hard"]
        if options.get("label_soft"):
            header["label_soft"] = options["label_soft"]
        return header, frames, list(borrowed.items())

    def _add_borrow(self, oid: bytes, owner_addr: str) -> None:
        if owner_addr == self.address or not owner_addr:
            with self._ref_lock:
                rec = self.owned.get(oid)
                if rec:
                    rec.borrowers += 1
        else:
            async def _notify():
                try:
                    await self.clients.get(owner_addr).notify(
                        "add_borrow", {"object_id": oid.hex()})
                except Exception:  # noqa: BLE001
                    pass
            self._post_to_loop(lambda: self.loop.create_task(_notify()))

    def _release_borrow(self, oid: bytes, owner_addr: str) -> None:
        """Undo one _add_borrow pin (submitter after reply, or borrower
        dropping a still-held ref)."""
        if owner_addr == self.address or not owner_addr:
            with self._ref_lock:
                rec = self.owned.get(oid)
                if rec:
                    rec.borrowers -= 1
                    if rec.local_refs <= 0 and rec.borrowers <= 0:
                        self._free_object(oid, rec)
        else:
            async def _notify():
                try:
                    await self.clients.get(owner_addr).notify(
                        "remove_borrow", {"object_id": oid.hex()})
                except Exception:  # noqa: BLE001
                    pass
            self._post_to_loop(lambda: self.loop.create_task(_notify()))

    def _release_task_borrows(self, task: "PendingTask") -> None:
        """Release this task's submission pins.  By reply time the
        executing worker has registered its own borrows for any arg refs it
        still holds (deserialize-time registration, _register_borrows), so
        the submission pins are pure transfer-window protection."""
        for oid, owner in task.borrowed:
            self._release_borrow(oid, owner)
        task.borrowed = []

    def _dedup_contained(self, contained_refs: list) -> list[tuple]:
        """Unique (object_id, owner) pairs for refs nested in one value."""
        seen: set[bytes] = set()
        out: list[tuple] = []
        for r in contained_refs:
            oid = r.binary()
            if oid in seen:
                continue
            seen.add(oid)
            out.append((oid, r.owner_addr or self.address))
        return out

    async def _register_borrows(self, refs: list) -> None:
        """Deserialize-time borrower registration (ray: reference_count.cc
        borrower bookkeeping): this process counts local instances of refs
        it does not own; the first instance registers with the owner, the
        last drop (in _release_local_ref) sends remove_borrow.  Awaited
        BEFORE the value is used so the registration lands while the
        sender's pin (submission pin / contained pin) still protects the
        object."""
        to_ack: list[tuple[bytes, str]] = []
        with self._ref_lock:
            for r in refs:
                oid = r.binary()
                owner = r.owner_addr
                if not owner or owner == self.address:
                    continue    # own refs are counted via local_refs
                entry = self.borrows.get(oid)
                if entry is not None:
                    entry["count"] += 1
                    continue
                self.borrows[oid] = {"count": 1, "owner": owner,
                                     "acked": False}
                to_ack.append((oid, owner))
        if not to_ack:
            return
        # Concurrent acks: one round-trip/timeout total, not one per owner.
        for oid, _owner in await self._pin_remote(to_ack):
            with self._ref_lock:
                entry = self.borrows.get(oid)
                if entry is not None:
                    entry["acked"] = True

    async def _pin_remote(self, pairs: list[tuple[bytes, str]]
                          ) -> list[tuple[bytes, str]]:
        """add_borrow each (object_id, owner) with an ack; return the pairs
        whose ack landed.  A failed/timed-out ack counts as NOT pinned and
        its matching release must be skipped: if the add actually landed we
        leak one borrow (object lives too long), never undercount and free
        an object another borrower still holds."""
        acked: list[tuple[bytes, str]] = []

        async def _one(oid: bytes, owner: str) -> None:
            try:
                reply, _ = await self.clients.get(owner).call(
                    "add_borrow", {"object_id": oid.hex()}, timeout=10.0)
                acked.append((oid, owner))
            except Exception:  # noqa: BLE001 - owner may already be gone
                return
            # Location hint riding the ack (see rpc_add_borrow): prefill
            # the entry so the upcoming get() pulls straight from the
            # holding node with no resolve_object round trip.  Hints can
            # go stale (the owner may free/move the object) — _get_one
            # falls back to the authoritative owner resolve when a
            # hinted pull misses.
            if isinstance(reply, dict) and reply.get("state") == "stored":
                e = self.memory.entry(oid)
                if not e.resolved():
                    e.locations = list(reply.get("locations") or [])
                    if e.locations:
                        e.hinted = True
                        e.wake()
        await asyncio.gather(*[_one(o, w) for o, w in pairs])
        return acked

    # -------- task reply handling (owner side) --------
    def _on_task_reply(self, task: PendingTask, reply: dict,
                       blobs: list[bytes]) -> None:
        status = reply.get("status")
        if task.actor_state is not None and not (
                status == "error" and task.retry_exceptions
                and task.retries_left > 0):
            # Terminal reply of an actor call: release its slot in the
            # submitter's unacked count (gates the fused sync fast path).
            # Exactly once — the direct path's IO-thread callback clears
            # actor_state before this runs.
            with task.actor_state.submit_lock:
                task.actor_state.unacked -= 1
            task.actor_state = None
        if status != "error" or not (task.retry_exceptions
                                     and task.retries_left > 0):
            # Terminal reply: drop submission borrow pins (retried tasks
            # keep theirs — the resend ships the same refs).
            self._release_task_borrows(task)
        if task.header.get("streaming"):
            self._finish_stream(task, reply, blobs)
            return
        if status == "ok":
            returns = reply["returns"]
            offset = 0
            for i, meta in enumerate(returns):
                rid = task.return_ids[i]
                if meta.get("dynamic") is not None:
                    offset = self._resolve_dynamic_return(
                        task, rid, meta, blobs, offset)
                    continue
                if meta["inline"]:
                    nframes = meta["nframes"]
                    frames = blobs[offset:offset + nframes]
                    offset += nframes
                else:
                    frames = None
                with self._ref_lock:
                    rec = self.owned.get(rid)
                    if rec is None:
                        # Return ref already dropped (fire-and-forget):
                        # don't resurrect the record — local_refs would
                        # stay 0 and the executor's contained pins would
                        # never release.  Free value + pins right away.
                        tmp = OwnedObject()
                        tmp.contained = [(bytes.fromhex(c[0]), c[1])
                                         for c in meta.get("contained", ())]
                        if not meta["inline"]:
                            tmp.locations = [meta["location"]]
                        self._free_object(rid, tmp)
                        continue
                    # A re-executed task (lineage reconstruction) re-pins
                    # its contained refs; release the previous round's
                    # pins first.
                    prev_contained, rec.contained = rec.contained, [
                        (bytes.fromhex(c[0]), c[1])
                        for c in meta.get("contained", ())]
                    rec.size = meta.get("size", 0)
                    if meta["inline"]:
                        rec.state = "inline"
                        rec.frames = frames
                        self.memory.put_frames(rid, frames)
                    else:
                        rec.state = "stored"
                        rec.locations = [meta["location"]]
                        self.memory.put_locations(rid, rec.locations)
                for c_oid, c_owner in prev_contained:
                    self._release_borrow(c_oid, c_owner)
            self._record_event(task.task_id.hex(), "FINISHED",
                               trace=task.header.get("trace"))
        elif status == "cancelled":
            err = TaskCancelledError(task.task_id.hex())
            for rid in task.return_ids:
                self._resolve_error(rid, err)
        else:
            exc, tb = None, reply.get("traceback", "")
            if blobs:
                try:
                    import pickle
                    exc = pickle.loads(blobs[0])
                except Exception:  # noqa: BLE001
                    exc = RuntimeError(reply.get("error", "task failed"))
            if task.retry_exceptions and task.retries_left > 0:
                task.retries_left -= 1
                self.lease_manager.submit(task)
                return
            err = TaskError(exc or RuntimeError("task failed"), tb)
            for rid in task.return_ids:
                self._resolve_error(rid, err)
            self._record_event(task.task_id.hex(), "FAILED",
                               trace=task.header.get("trace"))

    def _resolve_dynamic_return(self, task: PendingTask, rid: bytes,
                                meta: dict, blobs: list,
                                offset: int) -> int:
        """Materialize a dynamic-generator reply: one owned record per
        yielded item (the caller owns items exactly like fixed returns),
        and the return-0 value becomes an ObjectRefGenerator.  The
        return-0 record pins every item (contained refs), so items live
        while the generator object does."""
        from ray_tpu_torch.object_ref import ObjectRefGenerator

        tid = TaskID(task.task_id)
        rid0 = ObjectID.for_return(tid, 0).binary()
        # Lineage reconstruction of a lost ITEM resubmits the task with
        # return_ids=[item_id]: the reply then restores item payloads
        # only — rid is NOT the generator's return-0, so the generator
        # value/pins must not be rebuilt onto the item's record.
        item_reconstruction = rid != rid0
        gen_refs: list[ObjectRef] = []
        contained: list[tuple[bytes, str]] = []
        prev_item_pins: list[tuple[bytes, str]] = []
        prev_contained: list[tuple[bytes, str]] = []
        with self._ref_lock:
            rec = self.owned.get(rid)
            for j, im in enumerate(meta["dynamic"]):
                iid = ObjectID.for_return(tid, j + 1).binary()
                irec = self.owned.setdefault(iid, OwnedObject())
                if memledger.ENABLED:
                    memledger.note_create(iid, "task_return",
                                          "(generator item)")
                # Pins for refs nested in the item value (re-execution
                # releases the previous round's, as in the fixed path).
                prev_item_pins.extend(irec.contained)
                irec.contained = [(bytes.fromhex(c[0]), c[1])
                                  for c in im.get("contained", ())]
                # Items share the task's lineage: losing one re-runs the
                # whole generator task (same deterministic item ids).
                if rec is not None:
                    irec.submit_spec = rec.submit_spec
                    irec.retries_left = rec.retries_left
                irec.size = im.get("size", 0)
                if im["inline"]:
                    n = im["nframes"]
                    irec.state = "inline"
                    irec.frames = blobs[offset:offset + n]
                    self.memory.put_frames(iid, irec.frames)
                    offset += n
                else:
                    irec.state = "stored"
                    irec.locations = [im["location"]]
                    self.memory.put_locations(iid, irec.locations)
                if not item_reconstruction:
                    # One count for the live ObjectRef handed out below,
                    # one pin owned by the return-0 record.
                    irec.local_refs += 1
                    irec.borrowers += 1
                    contained.append((iid, self.address))
                    gen_refs.append(ObjectRef(iid, self.address))
            if not item_reconstruction:
                value = ObjectRefGenerator(gen_refs)
                sv = serialize(value)  # for remote resolvers of return-0
                if rec is None:
                    # Return ref dropped already: release the pins right
                    # away (the live gen_refs die with this frame).
                    tmp = OwnedObject()
                    tmp.contained = contained
                    self._free_object(rid, tmp)
                else:
                    prev_contained, rec.contained = rec.contained, \
                        contained
                    rec.state = "inline"
                    rec.frames = sv.frames
                    e = self.memory.entry(rid)
                    e.frames = sv.frames
                    e.has_value, e.value = True, value
                    e.wake()
        for c_oid, c_owner in prev_contained:
            self._release_borrow(c_oid, c_owner)
        for c_oid, c_owner in prev_item_pins:
            self._release_borrow(c_oid, c_owner)
        return offset

    def _service_entry_from_owned(self, oid: bytes, e) -> bool:
        """Lost-wake recovery: if this process's owner record for `oid`
        has resolved but the memory entry never woke (fill/wake race),
        republish the fill through the store (which wakes both waiter
        kinds).  Returns True when the entry is now resolvable."""
        rec = self.owned.get(oid)
        if rec is None or rec.state == "pending":
            return False
        with self._ref_lock:
            rec = self.owned.get(oid)
            if rec is None or rec.state == "pending":
                return False
            if e.resolved():
                # Fields landed but a set() was missed — just re-wake.
                e.wake()
            elif rec.state == "error" and rec.error is not None:
                self.memory.put_error(oid, rec.error)
            elif rec.state == "inline" and rec.frames is not None:
                self.memory.put_frames(oid, rec.frames)
            elif rec.state == "stored" and rec.locations:
                self.memory.put_locations(oid, rec.locations)
            else:
                return False
        logger.warning("recovered lost fill for %s (owner state=%s)",
                       oid.hex()[:12], rec.state)
        return True

    def _resolve_error(self, rid: bytes, err: BaseException) -> None:
        rec = self.owned.get(rid)
        if rec is None:
            # Ref already dropped before resolution — nobody can observe
            # the error; don't resurrect a record that can never be freed.
            return
        rec.state = "error"
        rec.error = err
        self.memory.put_error(rid, err)

    # ------------------------------------------------------------- get/put
    def put_object(self, value: Any) -> ObjectRef:
        from ray_tpu_torch._private import profiling

        trace = profiling.consume_put_arm()
        t_span0 = time.time() if spans.ENABLED else 0.0
        oid = ObjectID.for_put(WorkerID.from_hex(self.worker_id),
                               next(self._put_seq)).binary()
        sv = serialize(value)
        if trace is not None:
            trace["serialize_done"] = time.monotonic()
            trace["bytes"] = sv.total_bytes
        with self._ref_lock:
            rec = self.owned.setdefault(oid, OwnedObject())
            rec.local_refs += 1
            rec.size = sv.total_bytes
            # Contained pins for refs nested in the value (released when
            # this object is freed).  Fire-and-forget notify suffices here
            # (unlike _pack_returns): this process's later remove_borrow
            # rides the same owner connection, so the add is ordered
            # before it.
            for c_oid, owner in self._dedup_contained(sv.contained_refs):
                rec.contained.append((c_oid, owner))
                self._add_borrow(c_oid, owner)
        if trace is not None:
            trace["owner_reg_done"] = time.monotonic()
        if memledger.ENABLED:
            memledger.note_put(oid)
        put_path = "inline"
        if sv.total_bytes <= self.config.max_inline_object_size:
            if trace is not None:
                trace["path"] = "inline"
            rec.state = "inline"
            rec.frames = sv.frames
            # Fields publish synchronously (the get fast path reads them
            # from the caller's thread, GIL-ordered); only the asyncio
            # event must be set on the loop.
            e = self.memory.entry(oid)
            e.has_value, e.value = True, value
            e.frames = sv.frames
            # Coalesced wake: a burst of puts costs ONE self-pipe write
            # (call_soon_threadsafe per put made the loop thread do a
            # pipe read + GIL trade per object — the dominant cost of
            # put-heavy loops).
            self._post_to_loop(e.wake)
        else:
            put_path = "rpc"
            if trace is not None:
                trace["path"] = "rpc"

            async def _store():
                reply, _ = await self.clients.get(self.agent_addr).call(
                    "store_put", {"object_id": oid.hex()}, sv.frames)
                rec.state = "stored"
                rec.locations = [self.agent_addr]
                e = self.memory.entry(oid)
                e.has_value, e.value = True, value
                e.wake()
            self.run(_store())
            if trace is not None:
                trace["store_rpc_done"] = time.monotonic()
        if trace is not None:
            trace["put_done"] = time.monotonic()
            profiling.publish_put_trace(trace)
        if spans.ENABLED and t_span0 and sv.total_bytes > \
                self.config.max_inline_object_size:
            # Arena/RPC puts only: inline puts are a dict move, and a
            # span per tiny put would churn the ring for nothing.  The
            # t_span0 guard (here and at every task-span site) skips
            # work that started before a LIVE recorder flip — an
            # epoch-0 t0 would corrupt the merged timeline.
            spans.emit("arena.put", t_span0,
                       attrs={"bytes": sv.total_bytes,
                              "path": put_path})
        return ObjectRef(oid, self.address)

    _GET_MISS = object()

    def get_objects(self, refs: list[ObjectRef],
                    timeout: float | None = None) -> list[Any]:
        if len(refs) == 1 and self._sync_calls:
            # get-after-submit of a fused sync actor call: bind to the
            # in-flight reply future and wake straight from the IO
            # thread (the submit side already skipped the loop).
            sc = self._sync_calls.pop(refs[0].binary(), None)
            if sc is not None:
                out = self._finish_sync_call(refs[0], sc, timeout)
                if out is not CoreWorker._GET_MISS:
                    return [out]
        out = self._get_objects_fast(refs, timeout)
        if out is not CoreWorker._GET_MISS:
            return out
        return self.run(self._get_objects_async(refs, timeout))

    def _get_objects_fast(self, refs: list[ObjectRef],
                          timeout: float | None):
        """Resolve a batch in the CALLING thread when every ref is owned
        here and resolves from the in-process store — no coroutine per
        ref, no IO-loop round trip (the loop's scheduling jitter was the
        dominant cost of bulk gets of local objects).  Pending entries
        wait on a lazily-attached threading.Event that every fill site
        signals via MemoryEntry.wake().  Falls back to the async path
        for borrowed refs, node-store objects, and values containing
        ObjectRefs (borrow registration needs the loop)."""
        import threading

        MISS = CoreWorker._GET_MISS
        entries = []
        for r in refs:
            oid = r.binary()
            if not (oid in self.owned or r.owner_addr in ("",
                                                          self.address)):
                return MISS
            entries.append(self.memory.entry(oid))
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        out = []
        for r, e in zip(refs, entries):
            if not e.resolved():
                if e.t_event is None:
                    # CAS under the store lock: two concurrent getters
                    # must share ONE event (an overwrite would orphan
                    # the first waiter).
                    with self.memory._lock:
                        if e.t_event is None:
                            e.t_event = threading.Event()
                # Re-check AFTER publishing t_event: a fill between our
                # check and the attach would have missed it.
                if not e.resolved():
                    if deadline is None:
                        # NEVER wait unbounded here: the fast path has no
                        # failure-event machinery, so any lost fill (actor
                        # death races, reconstruction) would hang the
                        # caller forever.  After a grace period, hand the
                        # wait to the async path, which resolves through
                        # owners and observes death/lineage events.
                        if not e.t_event.wait(5.0):
                            logger.warning(
                                "sync get slow for %s; falling back to "
                                "the async resolution path", r.hex()[:12])
                            return MISS
                    elif not e.t_event.wait(
                            max(0.0, deadline - time.monotonic())):
                        raise GetTimeoutError(
                            f"get() timed out waiting for "
                            f"{r.hex()[:12]}")
            if e.error is not None:
                raise _copy_error(e.error)
            if e.has_value:
                out.append(e.value)
                continue
            if e.frames is not None:
                value, contained = deserialize_with_refs(e.frames)
                if contained:
                    return MISS
                e.has_value, e.value = True, value
                out.append(value)
                continue
            return MISS   # node-store locations / unresolved: loop path
        return out

    async def _get_objects_async(self, refs: list[ObjectRef],
                                 timeout: float | None) -> list[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        results = await asyncio.gather(
            *[self._get_one(r, deadline) for r in refs])
        out = []
        for r in results:
            if isinstance(r, BaseException):
                raise _copy_error(r)
            out.append(r)
        return out

    async def _deserialize_registering(self, frames) -> Any:
        """Materialize a value, registering this process as a borrower of
        any refs nested inside it (see _register_borrows)."""
        # Small payloads deserialize inline: a thread-pool hop costs more
        # (queue wakeup + context switch, ~0.2ms) than the pickle itself.
        if sum(len(f) for f in frames) <= self.config.max_inline_object_size:
            value, contained = deserialize_with_refs(frames)
        else:
            value, contained = await self.loop.run_in_executor(
                None, deserialize_with_refs, frames)
        if contained:
            await self._register_borrows(contained)
        return value

    async def _get_one(self, ref: ObjectRef, deadline: float | None) -> Any:
        e = self.memory.get_if_exists(ref.binary())
        owned_here = ref.binary() in self.owned or ref.owner_addr in (
            "", self.address)
        if e is None and owned_here:
            e = self.memory.entry(ref.binary())
        if e is not None:
            # Bounded-slice wait + watchdog instead of one unbounded
            # event wait: the owner record (self.owned) is the truth, and
            # a fill whose wake was lost in a race (observed once on the
            # bench box as a 600s wedge, BENCH_r04) would otherwise hang
            # this coroutine forever.  Every slice re-checks the record
            # and self-services a resolved-but-unwoken entry; a record
            # stuck "pending" is logged with its state so a real wedge
            # names itself in the process tail.
            waited = 0.0
            while not e.event.is_set():
                remaining = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                slice_t = 10.0 if remaining is None \
                    else min(10.0, remaining)
                try:
                    await asyncio.wait_for(e.event.wait(), slice_t)
                    break
                except asyncio.TimeoutError:
                    if remaining is not None and remaining <= slice_t:
                        raise GetTimeoutError(
                            f"get() timed out waiting for "
                            f"{ref.hex()[:12]}")
                    waited += slice_t
                    if self._service_entry_from_owned(ref.binary(), e):
                        break
                    if waited >= 30.0 and int(waited) % 30 < 10:
                        rec = self.owned.get(ref.binary())
                        logger.warning(
                            "get() still waiting for %s after %.0fs "
                            "(owner record: %s)", ref.hex()[:12], waited,
                            "absent" if rec is None else rec.state)
            if e.error is not None:
                return e.error
            if e.has_value:
                return e.value
            if e.frames is not None:
                value = await self._deserialize_registering(e.frames)
                e.has_value, e.value = True, value
                return value
            if e.locations:
                value = await self._pull_and_load(ref, e.locations, e)
                if not (isinstance(value, ObjectLostError)
                        and getattr(e, "hinted", False)
                        and not owned_here):
                    return value
                # A piggybacked location hint (borrow-ack fast path)
                # went stale — the owner may have moved/freed and
                # re-created state we don't see.  Clear it and ask the
                # owner authoritatively.
                e.locations = []
                e.hinted = False
            # fallthrough: resolved elsewhere
        return await self._get_from_owner(ref, deadline)

    async def _get_from_owner(self, ref: ObjectRef,
                              deadline: float | None) -> Any:
        if ref.owner_addr in self._dead_worker_addrs:
            # Known-dead owner: resolving would hang on a reconnecting
            # client connection; the object is lost with its owner (put objects
            # have no lineage; task returns resubmit via their OWN owner).
            from ray_tpu_torch.exceptions import OwnerDiedError

            return OwnerDiedError(
                ref.hex(),
                f"object {ref.hex()[:12]}: owner {ref.owner_addr} died "
                f"with the authoritative copy; put/borrowed objects have "
                f"no lineage, so reconstruction was not attempted")
        remaining = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        try:
            reply, blobs = await self.clients.get(ref.owner_addr).call(
                "resolve_object", {"object_id": ref.hex(), "wait": True},
                timeout=remaining)
        except asyncio.TimeoutError:
            raise GetTimeoutError(ref.hex()[:12])
        except (ConnectionLost, RemoteError) as err:
            return ObjectLostError(
                ref.hex(),
                f"object {ref.hex()[:12]}: owner {ref.owner_addr} "
                f"unreachable ({err}); lineage lives with the owner, so "
                f"reconstruction was not attempted")
        state = reply.get("state")
        if state == "inline":
            value = await self._deserialize_registering(blobs)
            e = self.memory.entry(ref.binary())
            e.has_value, e.value = True, value
            e.wake()
            return value
        if state == "error":
            import pickle
            return pickle.loads(blobs[0])
        if state == "stored":
            e = self.memory.entry(ref.binary())
            return await self._pull_and_load(ref, reply["locations"], e)
        return ObjectLostError(
            ref.hex(),
            f"object {ref.hex()[:12]}: owner {ref.owner_addr} no longer "
            f"holds it (state={state!r}); borrowed objects have no "
            f"lineage, so reconstruction was not attempted")

    async def _pull_and_load(self, ref: ObjectRef, locations: list[str],
                             entry) -> Any:
        """Fetch frames from a node store holding the object."""
        tried: list[str] = []
        for addr in locations:
            if addr in self._dead_worker_addrs:
                # Known-dead node/worker: a fresh client connection would silently
                # reconnect-forever; skip straight to the next copy (or
                # lineage) instead of burning the RPC timeout.
                tried.append(f"{addr} (known dead)")
                continue
            try:
                reply, blobs = await self.clients.get(addr).call(
                    "store_get", {"object_id": ref.hex()}, timeout=120.0)
            except Exception as e:  # noqa: BLE001
                tried.append(f"{addr} ({type(e).__name__})")
                continue
            if reply.get("found"):
                value = await self._deserialize_registering(blobs)
                entry.has_value, entry.value = True, value
                entry.wake()
                return value
            tried.append(f"{addr} (not found)")
        # Every location failed: try lineage reconstruction.
        rec = self.owned.get(ref.binary())
        if rec and rec.submit_spec and rec.retries_left > 0:
            # Failpoint window: every copy is gone and the owner is about
            # to resubmit the producing task (crash = the getter dies
            # mid-reconstruction; error = reconstruction refused).
            if failpoints.ACTIVE:
                await failpoints.fire_async("worker.lineage_resubmit")
            rec.retries_left -= 1
            fid, header, blobs_, key = rec.submit_spec
            logger.warning("reconstructing %s via lineage", ref.hex()[:12])
            rec.state = "pending"
            # Reset IN PLACE: delete+recreate would orphan any waiter
            # holding the old entry object (its event would never fire
            # again — a permanent hang for sync fast-path getters).
            self.memory.reset(ref.binary())
            task = PendingTask(
                task_id=bytes.fromhex(header["task_id"]), header=header,
                blobs=blobs_, return_ids=[ref.binary()],
                retries_left=rec.retries_left, retry_exceptions=False,
                scheduling_key=key)
            self.lease_manager.submit(task)
            return await self._get_one(
                _UntrackedRef(ref.binary(), self.address), None)
        # Name the ref, the nodes tried, and the lineage verdict: a bare
        # object id gives an operator nothing to act on (the detail used
        # to stop at a log line here and the surfaced error lost it).
        if rec is not None and rec.submit_spec:
            lineage = "lineage reconstruction exhausted its retry budget"
        elif rec is not None:
            lineage = ("no lineage to reconstruct from (the object was "
                       "put(), not returned by a task)")
        else:
            lineage = ("not owned by this process, so no lineage is "
                       "available here")
        return ObjectLostError(
            ref.hex(),
            f"object {ref.hex()[:12]} lost: locations tried "
            f"{tried if tried else '(none known)'}; {lineage}")

    def wait(self, refs: list[ObjectRef], num_returns: int,
             timeout: float | None) -> tuple[list[ObjectRef], list[ObjectRef]]:
        return self.run(self._wait_async(refs, num_returns, timeout))

    async def _wait_async(self, refs, num_returns, timeout):
        async def _ready(ref: ObjectRef) -> ObjectRef:
            # Readiness must not deserialize or pull payloads: a timeout=0
            # poll cancels in-flight _ready tasks, so any await beyond the
            # entry event (e.g. run_in_executor deserialize) would make
            # polling never observe completion.  Errors count as ready
            # (like ray).
            e = self.memory.get_if_exists(ref.binary())
            if e is None and (ref.binary() in self.owned
                              or ref.owner_addr in ("", self.address)):
                e = self.memory.entry(ref.binary())
            if e is not None:
                await e.event.wait()
            else:
                await self._get_one(ref, None)   # remote owner: fetch local
            return ref

        tasks = {asyncio.ensure_future(_ready(r)): r for r in refs}
        done_refs: list[ObjectRef] = []
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = set(tasks)
        while pending and len(done_refs) < num_returns:
            remaining = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            done, pending = await asyncio.wait(
                pending, timeout=remaining,
                return_when=asyncio.FIRST_COMPLETED)
            if not done:
                break
            for d in done:
                done_refs.append(tasks[d])
        for p in pending:
            p.cancel()
        not_done = [r for r in refs if r not in done_refs]
        return done_refs, not_done

    def object_sizes(self, refs: list[ObjectRef]) -> list[int | None]:
        """Owner-table payload sizes for locally-owned refs (None when
        unknown/pending/not owned here).  Cheap: no payload fetch.  Feeds
        Data's resource-aware backpressure (ray: reference table sizes →
        data/_internal/execution/resource_manager.py)."""
        out: list[int | None] = []
        with self._ref_lock:
            for r in refs:
                rec = self.owned.get(r.binary())
                out.append(rec.size if rec is not None
                           and rec.state in ("inline", "stored")
                           and rec.size > 0 else None)
        return out

    def ref_future(self, ref: ObjectRef) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()

        async def _wait():
            try:
                v = await self._get_one(ref, None)
                if fut.done():
                    return   # consumer cancelled/abandoned the future
                if isinstance(v, BaseException):
                    fut.set_exception(_copy_error(v))
                else:
                    fut.set_result(v)
            except BaseException as e:  # noqa: BLE001
                try:
                    if not fut.done():
                        fut.set_exception(e)
                except concurrent.futures.InvalidStateError:
                    pass

        self.loop.call_soon_threadsafe(lambda: self.loop.create_task(_wait()))
        return fut

    # -------------------------------------------------------------- refcount
    def _release_local_ref(self, object_id: bytes) -> None:
        """ObjectRef.__del__ hook.  Owner-side: drop a local count.
        Borrower-side: the last local instance sends remove_borrow to the
        owner (ray: borrower removal path)."""
        with self._ref_lock:
            rec = self.owned.get(object_id)
            if rec is not None:
                rec.local_refs -= 1
                if rec.local_refs <= 0 and rec.borrowers <= 0:
                    self._free_object(object_id, rec)
                return
            entry = self.borrows.get(object_id)
            if entry is None:
                return
            entry["count"] -= 1
            if entry["count"] > 0:
                return
            self.borrows.pop(object_id, None)
        # Past the lock: the entry is detached, only this thread sees it.
        # Un-acked registration (owner unreachable at deserialize time): a
        # remove here would be unmatched and could undercount the owner's
        # borrower count — skip it.
        if entry.get("acked", True):
            self._release_borrow(object_id, entry["owner"])
        # Drop the borrower-side cached value too: it may hold nested
        # ObjectRef instances whose releases cascade — without eviction
        # the cache would pin every nested borrow forever (the owner-side
        # analog lives in _free_object).
        self._evict_cached(object_id)

    def _evict_cached(self, object_id: bytes) -> None:
        """Delete a memory-store entry from any thread (the store is
        loop-affine)."""
        if self.loop is None or self._shutdown.is_set():
            return
        self._post_to_loop(lambda: self.memory.delete(object_id))

    def _note_deserialized_own_ref(self, object_id: bytes) -> None:
        """A deserialized copy of one of our own refs counts as a local
        reference (its __del__ will decrement)."""
        with self._ref_lock:
            rec = self.owned.get(object_id)
            if rec is not None:
                rec.local_refs += 1

    def _free_object(self, object_id: bytes, rec: OwnedObject) -> None:
        # Inline pop (== memledger.note_free): this runs once per freed
        # object on the release hot path.
        memledger._meta.pop(object_id, None)
        with self._ref_lock:
            self.owned.pop(object_id, None)
            contained, rec.contained = rec.contained, []
        # Refs nested in this object's value lose their container pin.
        for oid, owner in contained:
            self._release_borrow(oid, owner)
        locations = list(rec.locations)
        loop = self.loop
        if loop is None or self._shutdown.is_set():
            return

        def _cleanup():
            self.memory.delete(object_id)
            for addr in locations:
                loop.create_task(self._delete_remote(addr, object_id))
        self._post_to_loop(_cleanup)

    async def _delete_remote(self, addr: str, object_id: bytes) -> None:
        try:
            await self.clients.get(addr).notify(
                "store_delete", {"object_id": object_id.hex()})
        except Exception:  # noqa: BLE001
            pass

    def _announce_location(self, ref: ObjectRef) -> None:
        """A cross-node pull just cached a REPLICA of `ref` in this
        node's store.  The owner's location directory must learn about
        it, or _free_object will only scrub the owner-side copy and the
        replica leaks forever (pre-round-10: every cross-node get of a
        since-freed object stranded its replica — the DCN collectives
        hammer exactly this pattern, one replica per ring hop)."""
        owner = ref.owner_addr
        oid = ref.binary()
        if not owner or owner == self.address:
            with self._ref_lock:
                rec = self.owned.get(oid)
                if rec is not None and self.agent_addr not in rec.locations:
                    rec.locations.append(self.agent_addr)
            return

        async def _notify():
            try:
                await self.clients.get(owner).notify(
                    "add_location",
                    {"object_id": oid.hex(), "addr": self.agent_addr})
            except Exception:  # noqa: BLE001 - owner death handled by gets
                pass
        self.loop.create_task(_notify())

    async def rpc_add_location(self, h: dict, _b: list) -> dict:
        """Owner side of _announce_location.  If the object was already
        freed while the replica was being created, scrub the replica now
        — nobody else will."""
        oid = bytes.fromhex(h["object_id"])
        addr = h["addr"]
        with self._ref_lock:
            rec = self.owned.get(oid)
            if rec is not None:
                if addr not in rec.locations:
                    rec.locations.append(addr)
                return {}
        await self._delete_remote(addr, oid)
        return {}

    async def rpc_add_borrow(self, h: dict, _b: list) -> dict:
        oid = bytes.fromhex(h["object_id"])
        self._add_borrow(oid, self.address)
        # Piggyback the location directory on the ack: the borrower is
        # about to get() this ref, and answering here collapses its
        # resolve_object round trip into the borrow registration it
        # already pays (round 10: per-chunk resolve RTs against busy
        # owners dominated ring-collective pull latency).
        rec = self.owned.get(oid)
        if rec is not None and rec.state == "stored" and rec.locations:
            return {"state": "stored", "locations": list(rec.locations)}
        return {}

    async def rpc_remove_borrow(self, h: dict, _b: list) -> dict:
        self._release_borrow(bytes.fromhex(h["object_id"]), self.address)
        return {}

    # ------------------------------------------------- owner-side resolution
    async def rpc_resolve_object(self, h: dict, _b: list) -> tuple[dict, list]:
        """Serve an object's value/locations to a borrower
        (ray: OwnershipBasedObjectDirectory asking the owner)."""
        oid = bytes.fromhex(h["object_id"])
        rec = self.owned.get(oid)
        if rec is None:
            return {"state": "unknown"}, []
        if rec.state == "pending" and h.get("wait"):
            e = self.memory.entry(oid)
            await e.event.wait()
            rec = self.owned.get(oid) or rec
        if rec.state == "inline":
            return {"state": "inline"}, list(rec.frames or [])
        if rec.state == "stored":
            return {"state": "stored", "locations": rec.locations}, []
        if rec.state == "error":
            import pickle
            return {"state": "error"}, [pickle.dumps(rec.error)]
        return {"state": "pending"}, []

    # ------------------------------------------------------------ execution
    async def rpc_push_task_batch(self, h: dict,
                                  blobs: list) -> tuple[dict, list]:
        """Batched push: execute each task in order, one combined reply
        (amortizes per-message RPC overhead on the task hot path).  One
        member's escaping exception must NOT void its completed siblings
        (their side effects and pin ACKs are already real), so every
        member is error-isolated into its own reply."""
        tasks = h["tasks"]
        fns = []
        for th in tasks:
            fn = self._task_is_simple(th)
            if fn is None:
                fns = None
                break
            fns.append(fn)
        if fns is not None:
            # Fast path: the whole batch runs in ONE executor hop
            # (deserialize → call → serialize in the thread) instead of
            # 3 thread-pool round-trips per task — the per-task context
            # switches are the dominant control-plane cost.
            return await self._push_batch_fast(tasks, blobs, fns)
        replies, out_blobs = [], []
        offset = 0
        for th in tasks:
            n = th.pop("nframes")
            try:
                reply, rb = await self.rpc_push_task(
                    th, blobs[offset:offset + n])
            except BaseException as e:  # noqa: BLE001
                reply, rb = self._error_reply(e)
            offset += n
            reply["nblobs"] = len(rb)
            replies.append(reply)
            out_blobs.extend(rb)
        return {"replies": replies}, out_blobs

    def _task_is_simple(self, th: dict):
        """The one eligibility predicate for the one-executor-hop fast
        path (single pushes AND batches): returns the cached function, or
        None when the task needs the general path (ref args, runtime_env,
        dynamic/streaming returns, cancellation, uncached function)."""
        fn = self.functions.get(th.get("function_id", ""))
        if (fn is None or th.get("arg_refs") or th.get("runtime_env")
                or th.get("dynamic") or th.get("streaming")
                or bytes.fromhex(th["task_id"]) in self._cancelled):
            return None
        return fn

    def _exec_simple_thread(self, th: dict, frames: list, fn) -> dict:
        """Executor-thread body of the fast path: deserialize args, run the
        user function, serialize returns, store large
        returns.  Touches no loop-affine state (memory store, asyncio)."""
        import pickle as _pickle

        rec = {"arg_contained": (), "svs": None, "err": None, "stored": ()}
        hops = th.get("_hops")
        t_span0 = time.time() if spans.ENABLED else 0.0
        if isinstance(hops, dict):
            hops["exec_start"] = time.monotonic()
        task_token = EXECUTING_TASK.set((th["task_id"], th.get("trace")))
        prev_driver = self.current_driver_addr
        prev_res = self.current_resources
        prev_renv = self.current_runtime_env
        self.current_driver_addr = th.get("driver_addr") or prev_driver
        self.current_resources = th.get("resources")
        self.current_runtime_env = th.get("runtime_env")
        self._record_event(th["task_id"], "RUNNING", th.get("name", ""))
        try:
            value, contained = deserialize_with_refs(frames)
            rec["arg_contained"] = contained
            args, kwargs = value
            result = fn(*args, **kwargs)
            num_returns = th.get("num_returns", 1)
            values = [result] if num_returns == 1 else list(result)
            if num_returns != 1 and len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but "
                    f"returned {len(values)} values")
            svs = [serialize(v) for v in values]
            rec["svs"] = svs
            stored = [None] * len(svs)
            tid = TaskID(bytes.fromhex(th["task_id"]))
            inline_max = self.config.max_inline_object_size
            for i, sv in enumerate(svs):
                if sv.total_bytes > inline_max:
                    rid = ObjectID.for_return(tid, i).binary()
                    stored[i] = False   # stored through the agent
            rec["stored"] = stored
        except BaseException as e:  # noqa: BLE001
            tb_str = traceback.format_exc()
            try:
                payload = _pickle.dumps(e)
            except Exception:  # noqa: BLE001
                payload = _pickle.dumps(RuntimeError(str(e)))
            rec["err"] = (payload, tb_str)
        finally:
            EXECUTING_TASK.reset(task_token)
            self.current_driver_addr = prev_driver
            self.current_resources = prev_res
            self.current_runtime_env = prev_renv
            if isinstance(hops, dict):
                hops["exec_end"] = time.monotonic()
            if spans.ENABLED and t_span0:
                spans.emit_task(
                    th.get("trace"),
                    f"actor.{th['method']}" if th.get("method")
                    else f"task.{th.get('name') or 'fn'}",
                    t_span0, err="error" if rec["err"] else None)
        return rec

    async def _finalize_simple(self, th: dict, rec: dict) -> tuple[dict, list]:
        """Loop-side completion of one fast-path execution: borrow
        registration, contained-ref pins, local return caching, agent
        store fallback."""
        import pickle as _pickle

        tid = TaskID(bytes.fromhex(th["task_id"]))
        if rec["arg_contained"]:
            await self._register_borrows(rec["arg_contained"])
        if rec["err"] is not None:
            payload, tb_str = rec["err"]
            if self.mode == "worker":
                try:
                    cause = _pickle.loads(payload)
                except Exception:  # noqa: BLE001
                    cause = RuntimeError("task failed")
                err = TaskError(cause, tb_str)
                for i in range(th.get("num_returns", 1)):
                    self._cache_local_return(
                        ObjectID.for_return(tid, i).binary(), error=err)
            return {"status": "error", "traceback": tb_str}, [payload]
        returns, rb = [], []
        for i, sv in enumerate(rec["svs"]):
            contained = await self._pin_contained_refs(sv)
            rid = ObjectID.for_return(tid, i).binary()
            if rec["stored"][i] is None:       # inline-sized
                returns.append({"inline": True, "nframes": len(sv.frames),
                                "size": sv.total_bytes,
                                "contained": contained})
                rb.extend(sv.frames)
                if self.mode == "worker":
                    self._cache_local_return(rid, frames=sv.frames)
            else:
                if rec["stored"][i] is False:
                    await self.clients.get(self.agent_addr).call(
                        "store_put", {"object_id": rid.hex()}, sv.frames)
                returns.append({"inline": False,
                                "location": self.agent_addr,
                                "size": sv.total_bytes,
                                "contained": contained})
                if self.mode == "worker":
                    self._cache_local_return(rid,
                                             locations=[self.agent_addr])
        return {"status": "ok", "returns": returns}, rb

    async def _push_batch_fast(self, tasks: list, blobs: list,
                               fns: list) -> tuple[dict, list]:
        """One-executor-hop execution of a batch of simple tasks (function
        cached, no top-level ref args, no runtime_env, not dynamic).  The
        thread does the pure-Python work (deserialize, user code,
        serialize); everything loop-affine (borrow
        registration, contained-ref pins, memory-store caching, agent
        RPC fallback) happens here afterwards."""
        def _run_all():
            recs = []
            offset = 0
            for th, fn in zip(tasks, fns):
                n = th["nframes"]
                recs.append(self._exec_simple_thread(
                    th, blobs[offset:offset + n], fn))
                offset += n
            return recs

        recs = await self.loop.run_in_executor(self._default_executor,
                                               _run_all)
        replies, out_blobs = [], []
        for th, rec in zip(tasks, recs):
            # Per-member isolation: a finalize failure (e.g. agent store
            # RPC down) must not void siblings whose side effects are real.
            try:
                reply, rb = await self._finalize_simple(th, rec)
            except BaseException as e:  # noqa: BLE001
                reply, rb = self._error_reply(e)
            reply["nblobs"] = len(rb)
            replies.append(reply)
            out_blobs.extend(rb)
        return {"replies": replies}, out_blobs

    async def rpc_push_task(self, h: dict, blobs: list) -> tuple[dict, list]:
        fast = False
        try:
            fn = self._task_is_simple(h)
            if fn is not None:
                # Simple single task: same one-executor-hop fast path the
                # batches use (3 thread round-trips per call otherwise —
                # the sync-call latency cost).
                fast = True
                rec = await self.loop.run_in_executor(
                    self._default_executor, self._exec_simple_thread,
                    h, blobs, fn)
                reply, rb = await self._finalize_simple(h, rec)
            else:
                reply, rb = await self._execute_pushed_task(h, blobs)
        except BaseException as e:  # noqa: BLE001
            reply, rb = self._error_reply(e)
            fast = False
        if reply.get("status") == "error" and self.mode == "worker" \
                and not fast:
            # Cache the error locally (the fast path's _finalize_simple
            # already did — don't double-fill the bounded return cache):
            # a same-batch consumer of this task's return must resolve it
            # WITHOUT an owner round-trip — the owner only learns the
            # error when the whole batch replies, which waits on that
            # consumer (deadlock otherwise).
            import pickle

            try:
                cause = pickle.loads(rb[0]) if rb else None
            except Exception:  # noqa: BLE001
                cause = None
            err = TaskError(cause or RuntimeError("task failed"),
                            reply.get("traceback", ""))
            tid = TaskID(bytes.fromhex(h["task_id"]))
            for i in range(h.get("num_returns", 1)):
                self._cache_local_return(
                    ObjectID.for_return(tid, i).binary(), error=err)
        return reply, rb

    async def _execute_pushed_task(self, h: dict,
                                   blobs: list) -> tuple[dict, list]:
        task_id = bytes.fromhex(h["task_id"])
        if task_id in self._cancelled:
            self._cancelled.discard(task_id)
            return {"status": "cancelled"}, []
        fn = await self._fetch_function(h["function_id"])
        args, kwargs = await self._resolve_args(h, blobs)
        self._record_event(h["task_id"], "RUNNING", h.get("name", ""),
                           trace=h.get("trace"))

        def _thunk():
            return fn(*args, **kwargs)
        if h.get("streaming"):
            try:
                return await self._run_streaming(h, _thunk,
                                                 self._default_executor)
            finally:
                self._evict_untracked_args(h)
        t_span0 = time.time() if spans.ENABLED else 0.0
        try:
            result = await self._run_user_code(
                _thunk, task_id=task_id, trace=h.get("trace"),
                driver_addr=h.get("driver_addr"),
                resources=h.get("resources"),
                runtime_env=h.get("runtime_env"))
        except BaseException as e:  # noqa: BLE001
            if spans.ENABLED and t_span0:
                spans.emit_task(h.get("trace"),
                                f"task.{h.get('name') or 'fn'}",
                                t_span0, err=type(e).__name__)
            return self._error_reply(e)
        finally:
            self._evict_untracked_args(h)
        if spans.ENABLED and t_span0:
            spans.emit_task(h.get("trace"),
                            f"task.{h.get('name') or 'fn'}", t_span0)
        return await self._pack_returns(result, h)

    def _make_stream_shipper(self, h: dict):
        """Shared item shipper for streaming generators: serializes one
        item and delivers it to the owner as an ACKED stream_item call
        (the ack is the backpressure, and it guarantees every item is
        registered owner-side before the final reply — which travels on a
        different socket — can arrive)."""
        owner = h["owner_addr"]
        tid = TaskID(bytes.fromhex(h["task_id"]))
        inline_max = self.config.max_inline_object_size

        async def _ship(item, idx: int) -> None:
            sv = serialize(item)
            contained = await self._pin_contained_refs(sv)
            iid = ObjectID.for_return(tid, idx + 1).binary()
            hdr = {"task_id": h["task_id"], "index": idx,
                   "size": sv.total_bytes, "contained": contained}
            if sv.total_bytes <= inline_max:
                hdr["inline"] = True
                if self.mode == "worker":
                    self._cache_local_return(iid, frames=sv.frames)
                await self.clients.get(owner).call(
                    "stream_item", hdr, sv.frames, timeout=60.0)
            else:
                await self.clients.get(self.agent_addr).call(
                    "store_put", {"object_id": iid.hex()}, sv.frames)
                hdr["inline"] = False
                hdr["location"] = self.agent_addr
                if self.mode == "worker":
                    self._cache_local_return(iid,
                                             locations=[self.agent_addr])
                await self.clients.get(owner).call("stream_item", hdr,
                                                   timeout=60.0)

        return _ship

    async def _run_streaming(self, h: dict, thunk,
                             executor) -> tuple[dict, list]:
        """Executor side of a streaming generator: iterate the user
        generator on the executor thread, shipping each item as produced
        (see _make_stream_shipper)."""
        loop = self.loop
        ship = self._make_stream_shipper(h)
        count = 0

        def _producer():
            nonlocal count
            token = EXECUTING_TASK.set((h["task_id"], h.get("trace")))
            prev_driver = self.current_driver_addr
            self.current_driver_addr = h.get("driver_addr") or prev_driver
            try:
                for item in thunk():
                    asyncio.run_coroutine_threadsafe(
                        ship(item, count), loop).result()
                    count += 1
            finally:
                EXECUTING_TASK.reset(token)
                self.current_driver_addr = prev_driver

        try:
            await loop.run_in_executor(executor, _producer)
        except BaseException as e:  # noqa: BLE001
            reply, rb = self._error_reply(e)
            reply["streaming"] = True
            reply["streamed"] = count
            return reply, rb
        finally:
            self._evict_untracked_args(h)
        return {"status": "ok", "streaming": True, "streamed": count}, []

    async def _run_streaming_async(self, h: dict, factory,
                                   sem=None) -> tuple[dict, list]:
        """Async-actor streaming: factory() returns an async generator
        (iterated on the loop, items ship as yielded) or a coroutine
        (awaited; its value streams as a single item).  `sem` (the
        concurrency-group bound) is held across the whole stream."""
        import inspect as _inspect

        ship = self._make_stream_shipper(h)
        count = 0
        # Carry the request's trace context across the stream (same
        # reason as the async actor path: no process-global to lean on).
        token = spans.adopt_task_trace(h.get("trace"))
        try:
            if sem is not None:
                await sem.acquire()
            try:
                target = factory()
                if _inspect.isasyncgen(target):
                    async for item in target:
                        await ship(item, count)
                        count += 1
                else:
                    item = await target
                    await ship(item, count)
                    count += 1
            finally:
                if sem is not None:
                    sem.release()
        except BaseException as e:  # noqa: BLE001
            reply, rb = self._error_reply(e)
            reply["streaming"] = True
            reply["streamed"] = count
            return reply, rb
        finally:
            if token is not None:
                spans._ctx.reset(token)
            self._evict_untracked_args(h)
        return {"status": "ok", "streaming": True, "streamed": count}, []

    def _evict_untracked_args(self, h: dict) -> None:
        """Drop cached values fetched for this task's top-level ref args.
        Untracked fetches (no owned record, no borrow entry) have no
        release path of their own; left in the cache they'd pin any refs
        nested inside those values forever."""
        for r in h.get("arg_refs", ()):
            oid = bytes.fromhex(r["id"])
            if oid not in self.owned and oid not in self.borrows:
                self.memory.delete(oid)

    async def _resolve_args(self, h: dict, blobs: list) -> tuple[tuple, dict]:
        """Deserialize args (registering borrows for nested refs — ray:
        borrower protocol, reference_count.cc) and resolve top-level refs
        to values."""
        args_t, kwargs = await self._deserialize_registering(blobs)
        args = list(args_t)
        if h.get("arg_refs"):
            ref_objs = [_UntrackedRef(bytes.fromhex(r["id"]), r["owner"])
                        for r in h["arg_refs"]]
            values = await self._get_objects_async(ref_objs, None)
            for r, v in zip(h["arg_refs"], values):
                args[r["pos"]] = v
        return tuple(args), kwargs

    async def _run_user_code(self, thunk, task_id: bytes | None = None,
                             executor=None, instance_actor: str | None = None,
                             trace: dict | None = None,
                             driver_addr: str | None = None,
                             resources: dict | None = None,
                             runtime_env: dict | None = None):
        prev_driver = self.current_driver_addr
        prev_res = self.current_resources
        prev_renv = self.current_runtime_env
        self.current_driver_addr = driver_addr or prev_driver
        self.current_resources = resources
        self.current_runtime_env = runtime_env
        call = (task_id.hex() if task_id else None, trace)

        def _in_call():
            # Set in the thread that runs the call: run_in_executor does
            # not carry this loop task's context over.
            token = EXECUTING_TASK.set(call)
            try:
                return thunk()
            finally:
                EXECUTING_TASK.reset(token)
        try:
            return await self.loop.run_in_executor(
                executor or self._default_executor, _in_call)
        finally:
            self.current_driver_addr = prev_driver
            self.current_resources = prev_res
            self.current_runtime_env = prev_renv

    def _evicted_reply(self, seq: int) -> tuple[dict, list]:
        """Reply for a resend whose original execution completed but
        whose (large) result was trimmed from the dedupe cache: an
        explicit error, NOT a re-execution — the method's side effects
        are already applied and must not double-apply (at-most-once)."""
        from ray_tpu_torch.exceptions import ReplyEvictedError

        return self._error_reply(ReplyEvictedError(
            f"seq {seq}: the call already executed, but its reply "
            f"(>64KiB) was evicted from the reply cache before the "
            f"resend arrived; refusing to re-execute (side effects are "
            f"applied exactly once — re-fetch state with another call)"))

    def _error_reply(self, e: BaseException) -> tuple[dict, list]:
        import pickle
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(e)
        except Exception:  # noqa: BLE001
            payload = pickle.dumps(RuntimeError(str(e)))
        return {"status": "error", "traceback": tb}, [payload]

    async def _pack_returns(self, result: Any, h: dict) -> tuple[dict, list]:
        if h.get("dynamic"):
            return await self._pack_dynamic_returns(result, h)
        num_returns = h.get("num_returns", 1)
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                return self._error_reply(ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(values)} values"))
        returns, out_blobs = [], []
        task_id = bytes.fromhex(h["task_id"])
        for i, v in enumerate(values):
            sv = await self.loop.run_in_executor(None, serialize, v)
            contained = await self._pin_contained_refs(sv)
            rid = ObjectID.for_return(TaskID(task_id), i).binary()
            if sv.total_bytes <= self.config.max_inline_object_size:
                returns.append({"inline": True, "nframes": len(sv.frames),
                                "size": sv.total_bytes,
                                "contained": contained})
                out_blobs.extend(sv.frames)
                if self.mode == "worker":
                    self._cache_local_return(rid, frames=sv.frames)
            else:
                await self.clients.get(self.agent_addr).call(
                    "store_put", {"object_id": rid.hex()}, sv.frames)
                returns.append({"inline": False,
                                "location": self.agent_addr,
                                "size": sv.total_bytes,
                                "contained": contained})
                if self.mode == "worker":
                    self._cache_local_return(
                        rid, locations=[self.agent_addr])
        return {"status": "ok", "returns": returns}, out_blobs

    async def _pin_contained_refs(self, sv) -> list:
        """Pin refs nested in a return value — added HERE and ACKED
        before the reply, because the reply releases the caller's
        submission pins (different connection: no FIFO guarantee) — the
        pins become owned by the caller's return-object record, which
        releases them when the return object is freed (ray:
        contained-in-owned refs, reference_count.cc).  Only pins that
        actually landed are reported: the caller's later release must
        match an add, or the owner undercounts."""
        pairs = self._dedup_contained(sv.contained_refs)
        pinned: list[tuple[bytes, str]] = []
        remote_pins = []
        for oid, owner in pairs:
            if owner == self.address:
                with self._ref_lock:
                    rec_c = self.owned.get(oid)
                    if rec_c:
                        rec_c.borrowers += 1
                        pinned.append((oid, owner))
            else:
                remote_pins.append((oid, owner))
        if remote_pins:
            pinned.extend(await self._pin_remote(remote_pins))
        return [[oid.hex(), owner] for oid, owner in pinned]

    def _cache_local_return(self, rid: bytes, frames: list | None = None,
                            locations: list | None = None,
                            error: BaseException | None = None) -> None:
        """Locality cache: a same-worker consumer resolves this return
        without an owner round-trip — which would DEADLOCK inside a
        batched push (the producer's reply ships only when the whole
        batch completes) and is a wasted RTT otherwise.  Retried tasks
        overwrite by object id; as in the reference, retries assume
        deterministic tasks (a stale copy on a worker equals a stale
        plasma copy on a node)."""
        e = self.memory.entry(rid)
        # Reset before set: a retried task that failed here earlier must
        # not leave its stale error (or stale frames) shadowing the new
        # outcome for same-worker consumers.
        e.frames, e.locations, e.error, e.has_value, e.value = \
            None, [], None, False, None
        if frames is not None:
            e.frames = frames
        if locations is not None:
            e.locations = list(locations)
        if error is not None:
            e.error = error
        e.wake()
        self._return_cache.append(rid)
        while len(self._return_cache) > 512:
            old = self._return_cache.pop(0)
            if old not in self.owned and old not in self.borrows:
                self.memory.delete(old)

    async def _pack_dynamic_returns(self, result: Any,
                                    h: dict) -> tuple[dict, list]:
        """num_returns="dynamic": materialize the generator's items as
        individual return objects (item i → return index i+1; index 0 is
        the generator descriptor the caller resolves to an
        ObjectRefGenerator).  ray: dynamic generator returns."""
        task_id = bytes.fromhex(h["task_id"])
        try:
            iter(result)
        except TypeError:
            return self._error_reply(TypeError(
                'num_returns="dynamic" requires the task to return an '
                f"iterable/generator, got {type(result).__name__}"))
        # The generator BODY runs lazily — drain it in the executor like
        # any other user code (on the loop it would stall all RPC
        # handling); body exceptions propagate via the generic error path.
        items = await self.loop.run_in_executor(None, list, result)
        metas, out_blobs = [], []
        for i, v in enumerate(items):
            sv = await self.loop.run_in_executor(None, serialize, v)
            contained = await self._pin_contained_refs(sv)
            rid = ObjectID.for_return(TaskID(task_id), i + 1).binary()
            if sv.total_bytes <= self.config.max_inline_object_size:
                metas.append({"inline": True, "nframes": len(sv.frames),
                              "size": sv.total_bytes,
                              "contained": contained})
                out_blobs.extend(sv.frames)
                if self.mode == "worker":
                    self._cache_local_return(rid, frames=sv.frames)
            else:
                await self.clients.get(self.agent_addr).call(
                    "store_put", {"object_id": rid.hex()}, sv.frames)
                metas.append({"inline": False,
                              "location": self.agent_addr,
                              "size": sv.total_bytes,
                              "contained": contained})
                if self.mode == "worker":
                    self._cache_local_return(
                        rid, locations=[self.agent_addr])
        return {"status": "ok",
                "returns": [{"inline": True, "nframes": 0,
                             "contained": [], "dynamic": metas}]}, out_blobs

    # --------------------------------------------------------------- actors
    async def rpc_create_actor(self, h: dict, blobs: list) -> dict:
        prev_actor_id = self.current_actor_id
        try:
            cls = await self._fetch_function(h["function_id"])
            args, kwargs = await self._resolve_args(h, blobs)
            is_async = bool(h.get("is_async"))
            renv_desc = h.get("runtime_env")
            # Visible DURING __init__: an actor constructor may ask
            # get_runtime_context().get_actor_id() (ray allows it).
            self.current_actor_id = h["actor_id"]

            def _construct():
                token = EXECUTING_ACTOR.set(h["actor_id"])
                try:
                    return cls(*args, **kwargs)
                finally:
                    EXECUTING_ACTOR.reset(token)
            if is_async:
                instance = _construct()
            else:
                instance = await self.loop.run_in_executor(
                    self._default_executor, _construct)
            self.actors_hosted[h["actor_id"]] = ActorInstance(
                h["actor_id"], instance,
                max_concurrency=h.get("max_concurrency"),
                is_async=is_async, runtime_env=renv_desc,
                concurrency_groups=h.get("concurrency_groups"),
                method_groups=h.get("method_groups"))
            return {"ok": True}
        except BaseException as e:  # noqa: BLE001
            self.current_actor_id = prev_actor_id
            return {"error": f"{type(e).__name__}: {e}\n"
                             f"{traceback.format_exc()}"}
        finally:
            self._evict_untracked_args(h)

    async def rpc_actor_call(self, h: dict, blobs: list) -> tuple[dict, list]:
        inst = self.actors_hosted.get(h.get("actor_id", ""))
        if inst is not None and self._actor_batch_simple(inst, [h]):
            # Lone simple call: the same one-executor-hop treatment the
            # batch fast path gets (deserialize→run→serialize in the
            # thread) — this is the sync actor-call latency path, which
            # otherwise pays 3 thread round-trips per call.  Delegate to
            # the batch implementation (ONE copy of the seqno-advance /
            # successor-wake / execute protocol) and unwrap.
            reply, out_blobs = await self._actor_batch_fast(
                inst, [{**h, "nframes": len(blobs)}], blobs)
            single = reply["replies"][0]
            single.pop("nblobs", None)
            return single, out_blobs
        started = await self._actor_call_begin(h, blobs)
        return await started

    def _actor_batch_simple(self, inst: ActorInstance, calls: list) -> bool:
        """True when the whole batch can run as one executor thunk: sync
        single-threaded actor (executor FIFO preserves call order across
        concurrent batches), contiguous in-order seqnos from one caller,
        no ref args / runtime_env / dynamic returns."""
        if inst.is_async or inst.max_concurrency != 1 or inst.runtime_env \
                or inst.concurrency_groups:
            return False
        caller = calls[0].get("caller")
        expected = inst.next_seq.get(
            caller, calls[0].get("seq_floor", calls[0].get("seqno", 0)))
        for ch in calls:
            if (ch.get("arg_refs") or ch.get("dynamic")
                    or ch.get("streaming")
                    or ch.get("actor_id") != inst.actor_id
                    or ch.get("caller") != caller
                    or ch.get("seqno", 0) != expected
                    or not callable(getattr(inst.instance,
                                            ch.get("method", ""), None))):
                return False
            expected += 1
        return True

    async def _actor_batch_fast(self, inst: ActorInstance, calls: list,
                                blobs: list) -> tuple[dict, list]:
        """One-executor-hop execution of a simple actor-call batch (see
        _push_batch_fast).  Seqnos advance for the whole batch up front —
        the batch occupies one FIFO slot on the actor's executor, so a
        later batch's thunk queues behind it and order is preserved."""
        caller = calls[0].get("caller")
        last_seq = calls[-1].get("seqno", 0)
        inst.next_seq[caller] = last_seq + 1
        buf = inst.buffered.get(caller, {})
        nxt_fut = buf.pop(last_seq + 1, None)
        if nxt_fut and not nxt_fut.done():
            nxt_fut.set_result(None)
        # Dedupe entries BEFORE execution: a retransmit racing this batch
        # must share these replies, not re-run the methods.
        shared = {}
        for ch in calls:
            fut = self.loop.create_future()
            shared[ch.get("seqno", 0)] = fut
            inst.cache_reply((caller, ch.get("seqno", 0)), fut)

        methods = [getattr(inst.instance, ch["method"]) for ch in calls]

        def _run_all():
            recs = []
            offset = 0
            for ch, m in zip(calls, methods):
                n = ch["nframes"]
                recs.append(self._exec_simple_thread(
                    ch, blobs[offset:offset + n], m))
                offset += n
            return recs

        try:
            recs = await self.loop.run_in_executor(inst.executor, _run_all)
            replies, out_blobs = [], []
            for ch, rec in zip(calls, recs):
                try:
                    reply, rb = await self._finalize_simple(ch, rec)
                except BaseException as e:  # noqa: BLE001
                    reply, rb = self._error_reply(e)
                fut = shared.get(ch.get("seqno", 0))
                if fut is not None and not fut.done():
                    fut.set_result((dict(reply), rb))  # pre-"nblobs" copy
                reply["nblobs"] = len(rb)
                replies.append(reply)
                out_blobs.extend(rb)
            return {"replies": replies}, out_blobs
        except BaseException as e:
            # Never leave a dedupe future pending: a resend awaiting it
            # would hang forever.
            for fut in shared.values():
                if not fut.done():
                    fut.set_result(self._error_reply(e))
            raise

    async def rpc_actor_call_batch(self, h: dict,
                                   blobs: list) -> tuple[dict, list]:
        """Batched actor calls from one caller: START all in seqno order
        (so async/threaded actors still overlap execution), then gather
        the replies into one message (amortizes per-call RPC overhead)."""
        calls = h["calls"]
        if calls:
            inst = self.actors_hosted.get(calls[0].get("actor_id", ""))
            if inst is not None and self._actor_batch_simple(inst, calls):
                return await self._actor_batch_fast(inst, calls, blobs)
        finishers = []
        offset = 0
        for ch in h["calls"]:
            n = ch.pop("nframes")
            finishers.append(
                await self._actor_call_begin(ch, blobs[offset:offset + n]))
            offset += n
        # Error-isolate each member: a sibling's escaping exception must
        # not abort calls that already executed (their side effects are
        # real; a batch-level error would retry or fail them all).
        results = await asyncio.gather(*finishers,
                                       return_exceptions=True)
        replies, out_blobs = [], []
        for r in results:
            if isinstance(r, BaseException):
                rh, rb = self._error_reply(r)
            else:
                rh, rb = r
            rh["nblobs"] = len(rb)
            replies.append(rh)
            out_blobs.extend(rb)
        return {"replies": replies}, out_blobs

    async def _actor_call_begin(self, h: dict, blobs: list):
        """Ordering + dispatch phase; returns an awaitable yielding the
        packed reply (execution proceeds concurrently after dispatch)."""
        inst = self.actors_hosted.get(h["actor_id"])
        if inst is None:
            async def _not_hosted():
                return ({"status": "error",
                         "traceback": "actor not hosted here"},
                        [__import__("pickle").dumps(
                            ActorDiedError(h["actor_id"], "not hosted"))])
            return _not_hosted()
        caller = h.get("caller", "?")
        seq = h.get("seqno", 0)
        if os.environ.get("RAY_TPU_TORCH_ACTOR_TRACE"):
            logger.info("actor_call %s seq=%s nxt=%s method=%s",
                        h["actor_id"][:12], seq,
                        inst.next_seq.get(caller), h.get("method"))
        # The caller's seq_floor (lowest unacked seqno at send time) is
        # the baseline for a first-contact caller — NOT this call's own
        # seqno: a reordered first batch would otherwise set the baseline
        # past its preceding calls, demoting them to "stale retries"
        # executed out of order.  A restarted actor incarnation still
        # accepts the caller's continuing sequence (floor > 0 after acks).
        floor = h.get("seq_floor")
        nxt = inst.next_seq.setdefault(
            caller, seq if floor is None else floor)
        if floor is not None and floor > nxt:
            # Seqnos [nxt, floor) were acked or terminally failed
            # submitter-side and will never arrive; without this advance
            # every later call parks forever behind the gap.  Wake EVERY
            # parked call at or below the floor, not just buffered[floor]:
            # a call delivered before its predecessors terminally failed
            # would otherwise wait on a future nobody resolves (leaking
            # its dispatch task and arg blobs).  Woken stale entries
            # (seq < floor) re-check on resume and take the reply-cache /
            # at-least-once path.
            inst.next_seq[caller] = nxt = floor
            buf = inst.buffered.get(caller, {})
            for s in sorted(s for s in buf if s <= floor):
                gap_fut = buf.pop(s)
                if gap_fut and not gap_fut.done():
                    gap_fut.set_result(None)
        if seq < nxt:
            # Stale seqno: a retry resend after connection loss (the reply
            # was lost, OR the retry raced an execution still in flight).
            # Share the ORIGINAL execution's reply — re-running would
            # double-apply stateful methods (a counter once advanced by a
            # retransmitted batch whose originals were mid-execution).
            hit = inst.reply_cache.get((caller, seq))
            if hit is REPLY_EVICTED:
                return self._immediate_reply(self._evicted_reply(seq))
            if hit is not None:
                return self._share_reply(hit)
            # Beyond the dedupe window: execute out of order — the
            # documented at-least-once fallback, never park (a parked
            # stale seq would never be woken: completions only pop
            # upward).
            try:
                started = await self._start_actor_method(inst, h, blobs)
            except BaseException as e:  # noqa: BLE001
                return self._immediate_reply(self._error_reply(e))
            return started
        if seq != nxt:
            # Out-of-order arrival: park until predecessors START
            # (ray: ActorSchedulingQueue buffering by seq_no).  A resend
            # of an already-parked seqno must JOIN the original's park
            # future, not replace it — the clobbered original would wait
            # forever on a future nobody resolves.
            fut = inst.buffered.setdefault(caller, {}).setdefault(
                seq, self.loop.create_future())
            await fut
            # A seq_floor fast-forward may have woken us STALE (our
            # predecessors terminally failed and the floor moved past
            # us): serve the original reply if cached, else execute out
            # of order (at-least-once fallback) WITHOUT touching
            # next_seq — the in-order epilogue below would rewind it
            # past the floor and re-demote every later call.
            if seq < inst.next_seq.get(caller, 0):
                hit = inst.reply_cache.get((caller, seq))
                if hit is REPLY_EVICTED:
                    return self._immediate_reply(self._evicted_reply(seq))
                if hit is not None:
                    return self._share_reply(hit)
                try:
                    started = await self._start_actor_method(inst, h,
                                                             blobs)
                except BaseException as e:  # noqa: BLE001
                    return self._immediate_reply(self._error_reply(e))
                return started
        # In-order start, possibly-concurrent execution: async actors and
        # threaded actors (max_concurrency > 1) overlap; the default
        # single-thread executor serializes (ray: fiber.h vs ordered queue).
        # The sequence MUST advance even when dispatch fails (bad args, arg
        # resolution error): a burned seqno would otherwise park every later
        # call from this caller forever.
        hit = inst.reply_cache.get((caller, seq))
        if hit is not None and hit is not REPLY_EVICTED:
            # A resend racing the ORIGINAL's still-running dispatch: arg
            # resolution (a slow pull, lineage) can outlast the reply
            # watchdog, and next_seq only advances after dispatch — so
            # dedupe on the reply-cache placeholder the original
            # registered below, never re-execute.
            return self._share_reply(hit)
        # The placeholder goes in BEFORE the first await (loop-atomic
        # with the check above); next_seq still advances only after
        # dispatch, so executor submission order keeps matching seqno
        # order (advancing early would let the successor submit first).
        shared: asyncio.Future = self.loop.create_future()
        inst.cache_reply((caller, seq), shared)
        try:
            started = await self._start_actor_method(inst, h, blobs)
        except BaseException as e:  # noqa: BLE001
            if not shared.done():
                shared.set_result(self._error_reply(e))
            return self._share_reply(shared)
        finally:
            inst.next_seq[caller] = seq + 1
            buf = inst.buffered.get(caller, {})
            nxt_fut = buf.pop(seq + 1, None)
            if nxt_fut and not nxt_fut.done():
                nxt_fut.set_result(None)
        self.loop.create_task(self._pipe_reply(started, shared))
        return self._share_reply(shared)

    async def _pipe_reply(self, started, shared: "asyncio.Future") -> None:
        """Resolve a pre-registered dedupe future from an execution's
        awaitable (never leave it pending — resends await it)."""
        try:
            res = await started
        except BaseException as e:  # noqa: BLE001
            res = self._error_reply(e)
        if not shared.done():
            shared.set_result(res)

    @staticmethod
    def _share_reply(fut):
        """Awaitable over a SHARED reply future: shielded, so one
        consumer's cancellation (connection close mid-reply) cannot kill
        the execution other resends share."""
        async def _get():
            return await asyncio.shield(fut)
        return _get()

    @staticmethod
    def _immediate_reply(reply: tuple):
        async def _done():
            return reply
        return _done()

    async def _start_actor_method(self, inst: ActorInstance, h: dict,
                                  blobs: list):
        """Resolve args and dispatch the method; returns an awaitable that
        yields the packed reply.  Dispatch (executor submit / task create)
        happens before returning, so callers can release the sequence lock
        while execution proceeds."""
        if h["method"] == "__ray_call__":
            # Generic run-this-callable-on-the-actor dispatch (ray:
            # ActorHandle._actor_method_call's __ray_call__): the first
            # arg is a function receiving the instance.  Library layers
            # (e.g. compiled-DAG execution loops) build on this without
            # core knowing about them.
            def method(fn, *a, _inst=inst.instance, **kw):  # noqa: ANN001
                return fn(_inst, *a, **kw)
        else:
            method = getattr(inst.instance, h["method"], None)
        if method is None:
            async def _err():
                return self._error_reply(
                    AttributeError(f"actor has no method {h['method']!r}"))
            return _err()
        args, kwargs = await self._resolve_args(h, blobs)
        task_id = bytes.fromhex(h["task_id"])
        self._record_event(h["task_id"], "RUNNING",
                           f"{type(inst.instance).__name__}.{h['method']}",
                           trace=h.get("trace"))
        group = inst.group_of(h)   # named concurrency group (or None)
        if h.get("streaming"):
            import inspect as _inspect

            if _inspect.isasyncgenfunction(method) or (
                    inst.is_async
                    and asyncio.iscoroutinefunction(method)):
                # Async generator (or coroutine) method: iterate on the
                # loop, shipping items as yielded; the group's semaphore
                # is held for the stream's duration.
                sem = inst.semaphore_for(group) if group \
                    else inst.default_semaphore()
                return self._run_streaming_async(
                    h, lambda: method(*args, **kwargs), sem)

            # Sync streaming generator method: items ship as produced; the
            # generator runs on the actor's (group's) own executor (FIFO
            # with its other calls).
            def _gen_thunk():
                return method(*args, **kwargs)
            return self._run_streaming(h, _gen_thunk,
                                       inst.executor_for(group))
        t_span0 = time.time() if spans.ENABLED else 0.0
        if inst.is_async and asyncio.iscoroutinefunction(method):
            # Concurrency bound: named group's semaphore, or the default
            # group's (only active once the actor declares groups).
            sem = inst.semaphore_for(group) if group \
                else inst.default_semaphore()

            async def _run_async():
                # Async actor methods interleave on one loop: the
                # handler task carries the request's trace context, task
                # id and actor in its own contextvars copy, so nested
                # handle calls / recorder spans continue THIS request's
                # trace.
                spans.adopt_task_trace(h.get("trace"))
                EXECUTING_ACTOR.set(inst.actor_id)
                EXECUTING_TASK.set((h["task_id"], h.get("trace")))

                async def _invoke():
                    return await method(*args, **kwargs)

                if sem is None:
                    return await _invoke()
                async with sem:
                    return await _invoke()

            atask = self.loop.create_task(_run_async())
            self._running_async[task_id] = atask
        else:
            def _call():
                token = EXECUTING_TASK.set((h["task_id"], h.get("trace")))
                prev_driver = self.current_driver_addr
                self.current_driver_addr = (h.get("driver_addr")
                                            or prev_driver)
                try:
                    return method(*args, **kwargs)
                finally:
                    EXECUTING_TASK.reset(token)
                    self.current_driver_addr = prev_driver
            atask = self.loop.run_in_executor(inst.executor_for(group),
                                              _call)

        async def _finish():
            try:
                result = await atask
            except asyncio.CancelledError:
                return {"status": "cancelled"}, []
            except BaseException as e:  # noqa: BLE001
                if spans.ENABLED and t_span0:
                    spans.emit_task(h.get("trace"),
                                    f"actor.{h['method']}", t_span0,
                                    err=type(e).__name__)
                return self._error_reply(e)
            finally:
                self._running_async.pop(task_id, None)
                self._evict_untracked_args(h)
            if spans.ENABLED and t_span0:
                spans.emit_task(h.get("trace"), f"actor.{h['method']}",
                                t_span0)
            return await self._pack_returns(result, h)

        return _finish()

    async def rpc_kill_actor_local(self, h: dict, _b: list) -> dict:
        self.actors_hosted.pop(h["actor_id"], None)
        return {}

    # -------- caller side --------
    def _actor_state(self, actor_id: str) -> ActorSubmitState:
        st = self.actor_states.get(actor_id)
        if st is None:
            st = ActorSubmitState(actor_id)
            self.actor_states[actor_id] = st
        return st

    def submit_actor_task(self, actor_id: str, method: str, args: tuple,
                          kwargs: dict, options: dict) -> list[ObjectRef]:
        task_id = TaskID.from_random()
        num_returns = options.get("num_returns", 1)
        return_ids = [ObjectID.for_return(task_id, i).binary()
                      for i in range(num_returns)]
        header, blobs, borrowed = self._build_task_payload(
            task_id.binary(), "", args, kwargs, num_returns, {}, options)
        header.update({"actor_id": actor_id, "method": method,
                       "caller": self.worker_id})
        if options.get("concurrency_group"):
            header["concurrency_group"] = options["concurrency_group"]
        if options.get("streaming"):
            self._ret0_task_ids[return_ids[0]] = task_id.binary()
        with self._ref_lock:
            for rid in return_ids:
                rec = self.owned.setdefault(rid, OwnedObject())
                rec.local_refs += 1
        if memledger.ENABLED:
            site = "(actor) " + method
            for rid in return_ids:
                memledger.note_create(rid, "task_return", site)
        refs = [ObjectRef(rid, self.address) for rid in return_ids]
        max_task_retries = options.get("max_task_retries", 0)
        st = self._actor_state(actor_id)
        direct_cli = None
        with st.submit_lock:
            # Seqno at SUBMIT time (not loop time): submission order ==
            # seqno order no matter which path carries the call, and the
            # receiver's parking protocol handles any transport
            # interleaving between the two paths.
            header["seqno"] = st.seqno
            st.seqno += 1
            prior_unacked = st.unacked
            st.unacked += 1
            addr = st.address
            if (prior_unacked == 0 and addr
                    and not st.dead
                    and not st.outbox and num_returns == 1
                    and not options.get("streaming")
                    and max_task_retries == 0
                    and not borrowed and not header.get("arg_refs")
                    and addr not in self._dead_worker_addrs):
                # Sole in-flight call to a resolved live actor: eligible
                # for the fused sync fast path.  Requires an EXISTING
                # client (RpcClient construction is loop-bound).
                cli = self.clients._clients.get(addr)
                if cli is not None and not cli._closed:
                    direct_cli = cli
                    # In inflight_seqs BEFORE the lock releases: a
                    # racing loop-path submit must compute a seq_floor
                    # that includes this still-in-flight call, or the
                    # receiver would fast-forward past it and execute
                    # the two out of order.
                    st.inflight_seqs.add(header["seqno"])
        if direct_cli is not None:
            # With unacked==0 every earlier seqno is terminally settled,
            # so our own seqno is the correct floor.
            header["seq_floor"] = header["seqno"]
            if self._submit_actor_direct(st, direct_cli, header, blobs,
                                         return_ids):
                return refs
            # Fallback: leave the seqno IN inflight_seqs — the loop
            # path's _send_actor_batch re-adds it (idempotent) and its
            # finally removes it; discarding here would reopen the
            # floor window until the outbox drains.

        def _go():
            self.memory_entries_for(return_ids)
            self._push_actor_task(
                st, header, blobs, return_ids, max_task_retries, borrowed)

        self._post_to_loop(_go)
        return refs

    def _submit_actor_direct(self, st: ActorSubmitState, cli, header: dict,
                             blobs: list, return_ids: list[bytes]) -> bool:
        """Fused sync-path submit (the ISSUE-1 round-trip collapse): the
        request posts straight to the rpc IO thread and the reply wakes a
        blocked getter FROM the IO thread — the caller's critical path
        crosses no event loop in either direction.  Owner bookkeeping
        (_on_task_reply) still runs on the loop, posted off that path.
        Returns False to fall back to the loop path (nothing sent)."""
        task = PendingTask(
            task_id=bytes.fromhex(header["task_id"]), header=header,
            blobs=blobs, return_ids=return_ids, retries_left=0,
            retry_exceptions=False, scheduling_key=(), borrowed=[],
            actor_state=st)
        addr = cli.address
        try:
            cfut = cli.call_direct_start("actor_call", header, blobs)
        except Exception:  # noqa: BLE001 - client raced closed: loop path
            return False
        self.memory_entries_for(return_ids)     # thread-safe store
        rid0 = return_ids[0]
        self._sync_calls[rid0] = _SyncCall(task, cfut, cli)
        self._direct_sync_calls += 1

        def _on_reply(f):
            # Resolving thread (IO thread, or close()): keep it tiny —
            # release the unacked slot NOW so the next sync call can
            # take the fast path before the loop finalize runs, then
            # post the real bookkeeping to the loop.
            if task.actor_state is not None:
                with st.submit_lock:
                    st.unacked -= 1
                    st.inflight_seqs.discard(header.get("seqno", 0))
                task.actor_state = None
            try:
                self._post_to_loop(
                    lambda: self._finalize_direct(task, st, f, rid0, addr))
            except RuntimeError:
                pass        # shutdown: nothing left to bookkeep

        cfut.add_done_callback(_on_reply)
        resend_s = self.config.actor_reply_resend_s
        if resend_s and resend_s > 0:
            # Lost-reply watchdog for the fused path (the loop path has
            # its own in _actor_call_with_resend): periodically resend
            # the SAME msgid until the reply future resolves.  The
            # receiver dedupes by seqno, so the retry is safe; genuine
            # actor death resolves cfut via ConnectionLost (death
            # broadcast → clients.drop) and stops the timer chain.
            timer = []      # TimerHandle box, owned by the loop thread

            def _watchdog():
                timer.clear()
                if cfut.done():
                    return
                logger.warning(
                    "no reply for direct actor call seq=%s to %s after "
                    "%.1fs; resending (receiver dedupes by seqno)",
                    header.get("seqno"), addr, resend_s)
                try:
                    cli.resend_direct(cfut, "actor_call", header, blobs)
                except Exception:  # noqa: BLE001 - client closed: cfut
                    return         # already failed with ConnectionLost
                timer.append(self.loop.call_later(resend_s, _watchdog))

            def _cancel_timer(_f):
                # Cancel NOW, not at expiry: the pending timer pins the
                # call's header and arg blobs — at a sustained call rate
                # that is resend_s seconds of already-answered argument
                # buffers held live.  Handle.cancel() drops the closure
                # immediately.
                try:
                    self._post_to_loop(
                        lambda: timer and timer.pop().cancel())
                except RuntimeError:
                    pass    # shutdown: loop (and timer) already gone

            try:
                self._post_to_loop(lambda: timer.append(
                    self.loop.call_later(resend_s, _watchdog)))
            except RuntimeError:
                pass        # shutdown race: call resolves via close()
            else:
                cfut.add_done_callback(_cancel_timer)
        return True

    def _finalize_direct(self, task: PendingTask, st: ActorSubmitState,
                         cfut, rid0: bytes, addr: str) -> None:
        """Loop-side completion of a direct-path actor call: fills the
        owner record exactly like the loop path would, so every other
        resolution surface (entry events, wait(), borrowers) observes
        the same outcome."""
        self._sync_calls.pop(rid0, None)
        try:
            kind, a, b = cfut.result()
        except Exception as e:  # noqa: BLE001 - transport loss
            if st.address == addr:
                st.address = None
            self._fail_actor_call(task, ActorError(
                st.actor_id, f"actor worker connection lost: {e}"))
            return
        if kind == "ok":
            self._on_task_reply(task, a, b)
            return
        # Remote handler raised (the transport-level error reply): the
        # at-most-once discipline of the loop path applies.
        import pickle

        try:
            exc, _tb = pickle.loads(a)
        except Exception:  # noqa: BLE001 - unpicklable remote error
            exc = RemoteError("actor_call", "remote failure")
        self._fail_actor_call(
            task, ActorError(st.actor_id, f"actor call failed: {exc!r}"))

    def _finish_sync_call(self, ref: ObjectRef, sc: _SyncCall,
                          timeout: float | None):
        """User-thread wait of a fused sync actor call: block on the
        reply future directly.  Anything non-trivial (errors, multi/
        stored/ref-bearing returns, transport loss, slow replies) hands
        off to the normal resolution paths via _GET_MISS — the loop-side
        finalize fills the owner record regardless of this wait."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait_s = 5.0 if deadline is None else \
                min(5.0, max(0.0, deadline - time.monotonic()))
            try:
                kind, a, b = sc.cfut.result(wait_s)
                break
            except concurrent.futures.TimeoutError:
                if deadline is not None \
                        and time.monotonic() >= deadline:
                    raise GetTimeoutError(
                        f"get() timed out waiting for {ref.hex()[:12]}")
                if deadline is None:
                    # Same discipline as _get_objects_fast: never wait
                    # unbounded on one event source — the async path has
                    # the death-event and watchdog machinery.
                    return CoreWorker._GET_MISS
            except Exception:  # noqa: BLE001 - transport loss
                return CoreWorker._GET_MISS
        if kind != "ok" or a.get("status") != "ok":
            return CoreWorker._GET_MISS      # errors flow via the record
        returns = a.get("returns") or []
        if len(returns) != 1:
            return CoreWorker._GET_MISS
        meta = returns[0]
        if (not meta.get("inline") or meta.get("dynamic") is not None
                or meta.get("contained")):
            return CoreWorker._GET_MISS
        value, contained = deserialize_with_refs(
            b[:meta.get("nframes", len(b))])
        if contained:
            return CoreWorker._GET_MISS      # borrow registration: loop
        return value

    def _push_actor_task(self, st: ActorSubmitState, header: dict,
                         blobs: list, return_ids: list[bytes],
                         retries: int,
                         borrowed: list | None = None) -> None:
        task = PendingTask(
            task_id=bytes.fromhex(header["task_id"]), header=header,
            blobs=blobs, return_ids=return_ids, retries_left=0,
            retry_exceptions=False, scheduling_key=(),
            borrowed=borrowed or [], actor_state=st)
        # Coalescing outbox: one drainer per actor sends queued calls in
        # seqno order, many per RPC when the queue is deep (per-message
        # overhead is the 1:1 actor-call throughput cost); a lone call
        # goes out immediately as a single actor_call.
        st.outbox.append((task, retries))
        if not st.draining:
            st.draining = True
            self.loop.create_task(self._drain_actor_outbox(st))

    async def _drain_actor_outbox(self, st: ActorSubmitState) -> None:
        """Dispatch outbox batches, keeping several in flight: a batch's
        reply arrives only when its calls COMPLETE, so awaiting each batch
        would serialize long-running calls on async/threaded actors.
        per-connection ordering + receiver seqno parking preserve call
        order across concurrent batches."""
        if st.send_sem is None:
            st.send_sem = asyncio.Semaphore(
                self.config.actor_max_inflight_batches)
        try:
            while st.outbox:
                limit = self.config.actor_call_batch_size
                if st.outbox[0][0].header.get("streaming"):
                    # Streaming calls ride alone: their reply waits on the
                    # LAST generated item, which would gate every batch
                    # sibling's reply behind the whole stream.
                    batch = st.outbox[:1]
                else:
                    batch = []
                    for entry in st.outbox[:limit]:
                        if entry[0].header.get("streaming"):
                            break
                        batch.append(entry)
                del st.outbox[:len(batch)]
                await st.send_sem.acquire()
                t = self.loop.create_task(self._send_actor_batch(st, batch))
                t.add_done_callback(lambda _t, s=st: s.send_sem.release())
        finally:
            st.draining = False
            if st.outbox:
                st.draining = True
                self.loop.create_task(self._drain_actor_outbox(st))

    def _fail_actor_call(self, task: PendingTask,
                         err: BaseException) -> None:
        if task.actor_state is not None:
            with task.actor_state.submit_lock:
                task.actor_state.unacked -= 1
            task.actor_state = None
        for rid in task.return_ids:
            self._resolve_error(rid, err)
        self._release_task_borrows(task)

    async def _send_actor_batch(self, st: ActorSubmitState,
                                batch: list) -> None:
        """Deliver one batch (retrying per-call budgets on connection
        loss); returns once every call has a reply or a terminal error."""
        seqs = [t.header.get("seqno", 0) for t, _ in batch]
        with st.submit_lock:
            # inflight_seqs is shared with the fused direct path (adds
            # from user threads, removes from the IO thread) — every
            # multi-element mutation and the floor's min() iterate it
            # under the submit lock.
            st.inflight_seqs.update(seqs)
        try:
            await self._send_actor_batch_inner(st, batch)
        finally:
            with st.submit_lock:
                st.inflight_seqs.difference_update(seqs)

    async def _send_actor_batch_inner(self, st: ActorSubmitState,
                                      batch: list) -> None:
        while True:
            if st.dead:
                err = ActorDiedError(st.actor_id, st.death_cause)
                for task, _ in batch:
                    self._fail_actor_call(task, err)
                return
            addr = await self._resolve_actor_addr(st)
            if addr is None:
                continue    # loops back; st.dead set or address refreshed
            if addr in self._dead_worker_addrs:
                # Known-dead worker: the transport would hang on a fresh connection.
                # BUT the OS recycles ports — a stale death broadcast can
                # name the address a NEW live worker now occupies.  Probe:
                # if the current occupant hosts OUR actor, unmark and send.
                try:
                    reply, _ = await self.clients.get(addr).call(
                        "ping", {}, timeout=2.0)
                    if st.actor_id not in (reply or {}).get("actors", []):
                        raise ConnectionLost(addr)
                    self._dead_worker_addrs.discard(addr)
                except Exception:  # noqa: BLE001 - genuinely dead
                    # NO clients.drop here: the pooled connection may be
                    # carrying another actor's live traffic to a recycled
                    # port; dropping it would fail those calls.
                    st.address = None
                    st.stale_spins += 1
                    if st.stale_spins > 10:   # ~30s of stale ALIVE replies
                        for task, _ in batch:
                            self._fail_actor_call(task, ActorError(
                                st.actor_id,
                                "actor worker is dead (no restart "
                                "observed)"))
                        return
                    await asyncio.sleep(1.0)
                    continue
            st.stale_spins = 0
            # seq_floor: the lowest UNACKED seqno — the receiver's
            # baseline for a first-contact caller, and its fast-forward
            # point past seqnos that will never arrive (terminally failed
            # calls).  Without it, a reordered FIRST batch (socket
            # recreate mid-burst) set the baseline at its own seqnos and
            # earlier calls were executed as if they were stale retries.
            with st.submit_lock:
                floor = min(st.inflight_seqs) if st.inflight_seqs else 0
            for t, _ in batch:
                t.header["seq_floor"] = floor
            try:
                if len(batch) == 1:
                    task, _ = batch[0]
                    reply, rblobs = await self._actor_call_with_resend(
                        addr, "actor_call", task.header, task.blobs)
                    self._on_task_reply(task, reply, rblobs)
                    return
                headers = [{**t.header, "nframes": len(t.blobs)}
                           for t, _ in batch]
                blobs: list = []
                for t, _ in batch:
                    blobs.extend(t.blobs)
                reply, rblobs = await self._actor_call_with_resend(
                    addr, "actor_call_batch", {"calls": headers}, blobs)
            except (ConnectionLost, RemoteError):
                if st.address == addr:
                    st.address = None
                # In-flight calls lost: resend only those with an explicit
                # retry budget (ray: max_task_retries; default 0 =
                # at-most-once → actor error).
                still = []
                for task, r in batch:
                    if r > 0:
                        still.append((task, r - 1))
                    else:
                        self._fail_actor_call(task, ActorError(
                            st.actor_id, "actor worker connection lost"))
                        # A dead seqno must leave the floor NOW: resent
                        # survivors stamped with a floor that includes it
                        # would park at the receiver forever behind a gap
                        # that never fills.
                        st.inflight_seqs.discard(
                            task.header.get("seqno", 0))
                if not still:
                    return
                batch = still
                continue
            offset = 0
            for (task, _), tr in zip(batch, reply["replies"]):
                n = tr.pop("nblobs")
                self._on_task_reply(task, tr, rblobs[offset:offset + n])
                offset += n
            return

    async def _actor_call_with_resend(self, addr: str, method: str,
                                      header: dict, blobs: list):
        """Actor-call transport with a lost-reply watchdog (the round-9
        "dropped actor reply" window): after actor_reply_resend_s with
        no reply, RESEND the same msgid+seqnos (rpc call_with_resend —
        the pending future stays registered across deadlines, so a
        large reply still in flight when the watchdog fires lands
        instead of being dropped and tombstoning as REPLY_EVICTED on
        the resend, mirroring the fused path's resend_direct).  The
        receiver's at-most-once machinery makes the resend safe — a
        seqno whose execution completed serves the cached reply, one
        still in flight attaches the resend to the shared execution
        future (rpc_actor_call stale-seqno path), so stateful methods
        never double-apply.  Genuine worker death still surfaces as
        ConnectionLost via the death broadcast (clients.drop fails the
        pending future), which breaks the wait into the caller's
        retry/fail handling."""
        resend_s = self.config.actor_reply_resend_s
        cli = self.clients.get(addr)
        if not resend_s or resend_s <= 0:
            return await cli.call(method, header, blobs)
        return await cli.call_with_resend(method, header, blobs,
                                          resend_s=resend_s)

    async def _resolve_actor_addr(self, st: ActorSubmitState) -> str | None:
        if st.address:
            return st.address
        if st.resolving is None or st.resolving.done():
            st.resolving = self.loop.create_task(self._do_resolve(st))
        await asyncio.shield(st.resolving)
        return st.address

    async def _do_resolve(self, st: ActorSubmitState) -> None:
        # Never overtake our own (batched, possibly still queued)
        # registration: UNKNOWN from the controller reads as dead.
        await self._actor_regs_settled()
        if st.dead:
            return          # registration flush failed; cause is set
        reply, _ = await self.clients.get(self.controller_addr).call(
            "get_actor_info",
            {"actor_id": st.actor_id, "wait": True, "timeout": 120.0},
            timeout=150.0)
        # NOTE: no _revive_addr here — a controller ALIVE reply can be
        # stale (death report still in flight); only the supervising
        # agent's lease grant or a fresh alive EVENT proves liveness.
        if reply.get("state") == "ALIVE":
            st.address = reply["address"]
        elif reply.get("state") in ("DEAD", "UNKNOWN"):
            st.dead = True
            st.death_cause = reply.get("cause") or reply.get("state", "")

    async def _on_actor_event(self, _topic: str, payload: dict) -> None:
        if payload.get("batch"):
            # A scheduler wave publishes its whole ALIVE storm as ONE
            # message (controller._run_actor_wave).
            for ev in payload["batch"]:
                await self._on_actor_event(_topic, ev)
            return
        actor_id = payload.get("actor_id", "")
        ev = payload.get("event")
        if ev == "dead":
            # Even with no submit state (actor created here, never
            # called), the death must release this process's
            # creation-arg pins.
            self._release_creation_borrows(actor_id)
        st = self.actor_states.get(actor_id)
        if st is None:
            return
        if ev == "alive":
            self._revive_addr(payload["address"])
            st.address = payload["address"]
            st.dead = False
            return
        old = st.address
        st.address = None
        if ev == "dead":
            st.dead = True
            st.death_cause = payload.get("cause", "")
        # reconnecting client connections never surface peer death; dropping the client
        # fails its in-flight futures with ConnectionLost so callers waiting
        # on a dead actor's reply unblock (ray: worker failure pubsub →
        # ActorTaskSubmitter::DisconnectActor).
        if old:
            self.clients.drop(old)

    def create_actor(self, cls: Any, args: tuple, kwargs: dict,
                     options: dict) -> tuple[str, bool]:
        """Returns (actor_id, existing) — existing=True when get_if_exists
        matched a live actor instead of creating one."""
        fid = self.export_function(cls)
        actor_id = ActorID.from_random().hex()
        resources = dict(options.get("resources") or {})
        resources.setdefault("CPU", options.get("num_cpus", 1))
        if options.get("num_gpus"):
            resources["GPU"] = options["num_gpus"]
        task_id = TaskID.from_random()
        # Creation-arg borrow pins live as long as the actor: the instance
        # typically retains deserialized refs, and there is no reply-time
        # held-ref report for creation tasks.  Released when this process
        # kills the actor or observes its death.
        header, blobs, creation_borrows = self._build_task_payload(
            task_id.binary(), fid, args, kwargs, 0, resources, options)
        header.update({
            "function_id": fid,
            "class_name": getattr(cls, "__name__", "?"),
            "max_concurrency": options.get("max_concurrency"),
            "is_async": bool(options.get("is_async")),
        })
        if options.get("concurrency_groups"):
            header["concurrency_groups"] = dict(
                options["concurrency_groups"])
            header["method_groups"] = dict(
                options.get("method_groups") or {})
        reg = {"actor_id": actor_id, "creation_header": header,
               "owner_addr": self.address, "resources": resources,
               "max_restarts": options.get("max_restarts", 0),
               "name": options.get("name"),
               "namespace": options.get("namespace", self.namespace),
               "get_if_exists": options.get("get_if_exists", False),
               "detached": options.get("lifetime") == "detached",
               "affinity_node_id": options.get("affinity_node_id"),
               "label_hard": options.get("label_hard"),
               "label_soft": options.get("label_soft"),
               "affinity_soft": options.get("affinity_soft", False)}
        if not reg["name"]:
            # Burst fusion: an UNNAMED actor's registration reply is
            # fully determined client-side (the id is ours; there is no
            # name-taken outcome), so don't pay one controller RT per
            # actor — enqueue, let the loop-side flusher coalesce the
            # burst into ONE create_actors RT, and return immediately.
            # Later RPCs naming the actor gate on _actor_regs_settled so
            # they can never overtake the registration.
            if creation_borrows:
                self.actor_creation_borrows[actor_id] = creation_borrows
            self._enqueue_actor_registration(reg, blobs)
            return actor_id, False
        try:
            reply, _ = self.call(
                self.controller_addr, "create_actor", reg,
                blobs, timeout=120.0)
            if reply.get("error"):
                raise ValueError(reply["error"])
        except BaseException:
            # Failed creation (name taken, controller error, timeout):
            # the creation payload is discarded, so its pins must go too.
            for oid, owner in creation_borrows:
                self._release_borrow(oid, owner)
            raise
        existing = bool(reply.get("existing"))
        if creation_borrows:
            if existing:
                # get_if_exists hit: the creation payload is discarded, so
                # its pins must be released immediately.
                for oid, owner in creation_borrows:
                    self._release_borrow(oid, owner)
            else:
                self.actor_creation_borrows[reply["actor_id"]] = \
                    creation_borrows
        return reply["actor_id"], existing

    def _release_creation_borrows(self, actor_id: str) -> None:
        for oid, owner in self.actor_creation_borrows.pop(actor_id, ()):
            self._release_borrow(oid, owner)

    # ----------------------- batched actor registration (wave fusion)
    def _enqueue_actor_registration(self, reg: dict, blobs: list) -> None:
        with self._actor_reg_lock:
            self._actor_reg_batch.append((reg, blobs))
        self._post_to_loop(self._ensure_actor_reg_flusher)

    def _ensure_actor_reg_flusher(self) -> None:
        """Loop-side: make sure a flusher task is draining the batch."""
        if self._actor_reg_task is None or self._actor_reg_task.done():
            self._actor_reg_task = self.loop.create_task(
                self._flush_actor_regs())

    async def _flush_actor_regs(self) -> None:
        """Drain enqueued registrations, ONE create_actors RPC per drain.
        Registrations arriving while a flush RPC is in flight pile up
        and ride the next drain — burst size tracks controller latency
        automatically (the call_and_wait fusion shape)."""
        while True:
            with self._actor_reg_lock:
                batch, self._actor_reg_batch = self._actor_reg_batch, []
            if not batch:
                return
            t0 = time.time()
            header = {"actors": [dict(reg, nblobs=len(blobs))
                                 for reg, blobs in batch]}
            frames = [f for _reg, blobs in batch for f in blobs]
            try:
                await self.clients.get(self.controller_addr).call(
                    "create_actors", header, frames, timeout=120.0)
            except Exception as e:  # noqa: BLE001
                # The registrations never reached the controller: fail
                # the handles fast (resolvers see dead, not a 120s park)
                # and drop the creation-arg pins.
                logger.warning("batched actor registration failed: %r", e)
                for reg, _blobs in batch:
                    st = self._actor_state(reg["actor_id"])
                    st.dead = True
                    st.death_cause = f"actor registration failed: {e!r}"
                    self._release_creation_borrows(reg["actor_id"])
            spans.emit("actor.submit", t0, attrs={"count": len(batch)})

    async def _actor_regs_settled(self) -> None:
        """Wait until every enqueued registration has been flushed: an
        RPC naming the actor (resolve, kill) must never overtake its own
        registration on the controller connection."""
        while True:
            t = self._actor_reg_task
            if t is not None and not t.done():
                await asyncio.shield(t)
                continue
            with self._actor_reg_lock:
                if not self._actor_reg_batch:
                    return
            self._ensure_actor_reg_flusher()

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        async def _kill():
            # Bounded settle: the ordering guard must not chain the
            # flusher's full RPC timeout in front of the kill — with an
            # unreachable controller the remove fails anyway, and a
            # remove racing an undelivered registration is a no-op.
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._actor_regs_settled(), 30.0)
            return await self.acall(self.controller_addr, "remove_actor",
                                    {"actor_id": actor_id}, timeout=30.0)
        self.run(_kill())
        st = self.actor_states.get(actor_id)
        if st:
            st.dead = True
            st.address = None
            st.death_cause = "killed"
        self._release_creation_borrows(actor_id)

    def kill_actor_async(self, actor_id: str) -> None:
        """Fire-and-forget kill used by ActorHandle GC (must not block in
        __del__, which can run on any thread including the IO loop's)."""
        loop = self.loop
        if loop is None or self._shutdown.is_set():
            return

        def _go():
            async def _run():
                await self._actor_regs_settled()
                await self.acall(
                    self.controller_addr, "remove_actor",
                    {"actor_id": actor_id, "cause": "handle out of scope"},
                    timeout=30.0)
            loop.create_task(_run())
            self._release_creation_borrows(actor_id)
        try:
            loop.call_soon_threadsafe(_go)
        except RuntimeError:
            pass

    # ------------------------------------------------------------- cancel
    def cancel_task(self, ref: ObjectRef) -> None:
        async def _cancel():
            try:
                await self.clients.get(ref.owner_addr or self.address).notify(
                    "cancel_task", {"object_id": ref.hex()})
            except Exception:  # noqa: BLE001
                pass
        self.run(_cancel())

    async def rpc_cancel_task(self, h: dict, _b: list) -> dict:
        # Owner-side: mark queued tasks cancelled; cancel running async ones.
        oid = bytes.fromhex(h["object_id"])
        for key, q in self.lease_manager.queues.items():
            for t in list(q):
                if oid in t.return_ids:
                    q.remove(t)
                    err = TaskCancelledError(t.task_id.hex())
                    for rid in t.return_ids:
                        self._resolve_error(rid, err)
                    return {}
        atask = self._running_async.get(oid)
        if atask:
            atask.cancel()
        return {}

    # ------------------------------------------------------------- control
    async def rpc_worker_died(self, h: dict, _b: list) -> dict:
        addr = h.get("worker_addr", "")
        if h.get("oom"):
            # Remembered so the push-failure error names the real killer
            # (ray: OOM kills surface as OutOfMemoryError, not a generic
            # worker crash).
            self._oom_worker_addrs.add(addr)
        # Dead-address registry: reconnecting client connections never surface peer death, so
        # a LATER send to this address would create a fresh silently-
        # hanging connection.  Sends check this set first (ray: worker
        # failure pubsub gates the submitter the same way).
        if addr:
            self._mark_addr_dead(addr)
        self.clients.drop(addr)
        return {}

    def _revive_addr(self, addr: str) -> None:
        """A live worker provably exists at this address now (lease
        granted on it / actor alive there): clear stale death marks so a
        reused ephemeral port isn't treated as dead forever.  Purge the
        eviction ring too — a stale ring entry would later pop and
        un-mark the address if it dies AGAIN in the meantime."""
        self._dead_worker_addrs.discard(addr)
        self._oom_worker_addrs.discard(addr)
        if addr in self._dead_addr_order:
            self._dead_addr_order.remove(addr)

    async def rpc_exit_worker(self, h: dict, _b: list) -> dict:
        logger.info("worker exiting: %s", h.get("reason"))
        self.loop.call_later(0.05, self._shutdown.set)
        if h.get("hard"):
            self.loop.call_later(0.1, lambda: os._exit(0))
        return {}

    async def rpc_ping(self, h: dict, _b: list) -> dict:
        return {"worker_id": self.worker_id,
                "actors": list(self.actors_hosted)}

    async def rpc_failpoints(self, h: dict, _b: list) -> dict:
        """Runtime fault-injection control verb (see _private/failpoints):
        arm/clear/read the deterministic failpoint table of THIS process
        without restarting it."""
        return failpoints.control(h)

    async def rpc_spans(self, h: dict, _b: list) -> dict:
        """Flight-recorder harvest verb (see _private/spans): read/clear
        THIS process's span ring buffer."""
        return spans.control(h)

    async def rpc_memory(self, h: dict, _b: list) -> dict:
        """Object-ledger harvest verb (see _private/memledger): THIS
        process's owner-side reference table + ledger annotations."""
        return memledger.control(h)

    async def rpc_telemetry(self, h: dict, _b: list) -> dict:
        """Telemetry-timeline harvest verb (see _private/telemetry):
        THIS process's metrics-snapshot ring."""
        raise NotImplementedError(
            "the telemetry timeline is not ported yet (ROADMAP.md queue 1: "
            "the telemetry timeline)")

    # ------------------------------------------------------------ telemetry
    def _record_event(self, task_id: str, state: str, name: str = "",
                      trace: dict | None = None) -> None:
        tc = trace or self.current_trace
        tag = self._event_tag
        if tag is None:
            # worker/node ids are fixed after start; slice them once
            # (this runs twice per task on the submit hot path).
            tag = self._event_tag = (self.worker_id[:12],
                                     self.node_id[:12])
        self._task_events.append(
            {"task_id": task_id, "state": state, "name": name,
             "t": time.time(), "worker": tag[0], "node": tag[1],
             "trace_id": tc["trace_id"][:16] if tc else "",
             # Parent span for the OTLP export bridge (utils/tracing.py):
             # present only on events of tasks submitted inside tasks.
             "parent": (tc.get("parent_span") or "")[:16] if tc else ""})
        if len(self._task_events) > self.config.task_event_buffer_size:
            self._task_events = self._task_events[-self.config.
                                                  task_event_buffer_size:]

    async def _event_flush_loop(self) -> None:
        """Push buffered task events to the controller timeline
        (ray: TaskEventBuffer task_event_buffer.h:206)."""
        while True:
            await asyncio.sleep(1.0)
            if self._task_events:
                events, self._task_events = self._task_events, []
                try:
                    await self.clients.get(self.controller_addr).notify(
                        "push_task_events", {"events": events})
                except Exception:  # noqa: BLE001
                    pass
