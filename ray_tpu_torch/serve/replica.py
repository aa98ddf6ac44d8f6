"""Replica actor: hosts one copy of a deployment's user callable (port of
ray_tpu/serve/replica.py).

Analog of ray: python/ray/serve/_private/replica.py (ReplicaActor).  Async
actor: requests overlap up to max_ongoing_requests; sync user code runs on a
thread pool so the event loop keeps serving queue-length probes (the same
reason the reference's replica is an asyncio actor).

Two differences from the reference, both because the port's device worker
hosts every `num_gpus` replica of its host in one process:

  - The user object is built on the replica's pool, not on the worker's
    event loop (an async actor's constructor runs on that loop, and an 8B
    engine's construction would stall every call into the process for
    its whole length).  `check_health`, the controller's init probe,
    resolves when the object is built and raises its constructor's error.
  - `get_current_context()` falls back to the context of the replica that
    the calling thread's actor names (`get_runtime_context().
    get_actor_id()`), not to the last replica built in the process; a
    thread that names no actor gets the process's only replica, or None
    when it hosts several.

Not ported: `handle_request_streaming` (streaming responses, ROADMAP.md
queue 1: serve) and the multiplexed-model residency report.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import dataclasses
import inspect
import time
import weakref
from typing import Any


@dataclasses.dataclass
class ReplicaContext:
    """Identity of the replica the calling code runs inside (ray:
    serve.get_replica_context / ReplicaContext)."""
    app_name: str
    deployment: str
    replica_tag: str
    servable_object: Any


# Per-call context (ContextVar: carries into the task handling one
# request and, via copy_context().run, into pool threads), with a
# fallback keyed by the executing actor for threads the call did not
# hand its context to.  Weak values: a killed replica's context (and the
# user object it names) must not outlive the replica in a process that
# goes on hosting others.
_ctx_var: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_replica_ctx", default=None)
_by_actor: "weakref.WeakValueDictionary[str, ReplicaContext]" = \
    weakref.WeakValueDictionary()

_METRICS = None


def _replica_metrics():
    """Per-deployment request series (utils.metrics registry): req/s and
    live queue depth for deployments that run no LLM engine (the engine
    exports its own richer serve_llm_* series)."""
    global _METRICS
    if _METRICS is None:
        from ray_tpu_torch.utils import metrics as um

        # (app, deployment, replica): deployment names default to the
        # class name, so two apps' same-named deployments would
        # otherwise merge into one series, and the replica tag keeps N
        # replicas' gauges distinct when they share one process (the
        # device worker hosts every num_gpus replica).
        tk = ("app", "deployment", "replica")
        _METRICS = {
            "processed": um.get_or_create(
                um.Counter, "serve_replica_processed",
                "Requests completed by this replica", tk),
            "ongoing": um.get_or_create(
                um.Gauge, "serve_replica_ongoing",
                "Requests queued + executing on this replica", tk),
            "rejected": um.get_or_create(
                um.Counter, "serve_replica_rejected",
                "Requests rejected by bounded-queue admission", tk),
        }
    return _METRICS


def _actor_id() -> str | None:
    from ray_tpu_torch.runtime_context import get_runtime_context

    try:
        return get_runtime_context().get_actor_id()
    except Exception:  # noqa: BLE001 - no runtime in this process
        return None


def get_current_context() -> ReplicaContext | None:
    ctx = _ctx_var.get()
    if ctx is not None:
        return ctx
    aid = _actor_id()
    if aid is not None:
        return _by_actor.get(aid)
    hosted = list(_by_actor.values())
    return hosted[0] if len(hosted) == 1 else None


class Replica:
    """Created via remote(Replica).options(max_concurrency=...)."""

    def __init__(self, cls, init_args: tuple, init_kwargs: dict,
                 max_ongoing_requests: int, user_config: Any = None,
                 app_name: str = "default", deployment: str = "",
                 max_queued_requests: int = -1):
        from ray_tpu_torch.serve import slo

        self._cls = cls
        self._max_ongoing = max_ongoing_requests
        self._num_ongoing = 0
        self._num_processed = 0
        # Bounded admission queue (overload control): requests waiting
        # past max_ongoing_requests count against this budget; beyond
        # it (per priority tier) the request rejects EARLY with
        # ServeOverloadedError instead of queueing unboundedly.
        # -1 = default bound of 2 x max_ongoing.
        self._max_queued = (2 * max_ongoing_requests
                            if max_queued_requests < 0
                            else max_queued_requests)
        self._num_rejected = 0
        # Recent queue-wait samples (ms, slot-acquisition wait).
        self._queue_waits = slo.LatencyWindow(maxlen=256)
        # EWMA service seconds — sizes ServeOverloadedError.retry_after_s.
        self._svc_ewma_s = 0.0
        # Replica-side concurrency bound: routers cap dispatch too, but
        # multiple handles can race past their local counts.
        self._slots = asyncio.Semaphore(max_ongoing_requests)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, max_ongoing_requests))
        aid = _actor_id()
        self._context = ReplicaContext(
            app_name=app_name, deployment=deployment,
            replica_tag=aid or "", servable_object=None)
        if aid is not None:
            _by_actor[aid] = self._context
        self._instance = None
        # The user object is built on the pool under this replica's
        # context (and its actor's), off the worker's event loop.
        token = _ctx_var.set(self._context)
        try:
            build_ctx = contextvars.copy_context()
        finally:
            _ctx_var.reset(token)
        self._built = self._pool.submit(
            build_ctx.run, self._build, init_args, init_kwargs,
            user_config)

    def _build(self, init_args: tuple, init_kwargs: dict,
               user_config: Any) -> None:
        self._instance = self._cls(*init_args, **init_kwargs)
        self._context.servable_object = self._instance
        if user_config is not None:
            self._reconfigure_sync(user_config)

    async def _ready(self):
        """The user object, once built (its constructor's error, if it
        raised)."""
        if not self._built.done():
            await asyncio.wrap_future(self._built)
        self._built.result()
        return self._instance

    def _reconfigure_sync(self, user_config: Any) -> None:
        fn = getattr(self._instance, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    async def reconfigure(self, user_config: Any) -> None:
        """Apply a new user_config without restarting (ray: replica.py
        reconfigure path driven by DeploymentState on config-only changes)."""
        inst = await self._ready()
        fn = getattr(inst, "reconfigure", None)
        if fn is None:
            return
        if inspect.iscoroutinefunction(fn):
            await fn(user_config)
        else:
            call_ctx = contextvars.copy_context()
            await asyncio.get_running_loop().run_in_executor(
                self._pool, lambda: call_ctx.run(fn, user_config))

    def _admit_or_reject(self, priority, args: tuple,
                         kwargs: dict) -> None:
        """Bounded-queue admission decision (overload control): a
        request arriving while `max_queued_requests` others already
        wait for a slot rejects EARLY with a typed, retriable
        ServeOverloadedError.  Priority tiers: HIGH may use 2x the
        budget, LOW half (serve/slo.py queue_budget).  Runs BEFORE
        _num_ongoing is incremented, so a rejected request never
        pollutes the router's load signal."""
        from ray_tpu_torch.serve import slo

        budget = slo.queue_budget(
            slo.request_priority(priority, args, kwargs),
            self._max_queued)
        # Reject iff the tier's queue budget is consumed: compare the
        # FULL ongoing count so budget 0 ('no queue') still admits to
        # free execution slots.
        if self._num_ongoing < self._max_ongoing + budget:
            return
        queued = max(0, self._num_ongoing - self._max_ongoing)
        self._num_rejected += 1
        try:
            _replica_metrics()["rejected"].inc(1, self._metric_tags())
        except Exception:  # noqa: BLE001 - metrics never block serving
            pass
        from ray_tpu_torch.exceptions import ServeOverloadedError

        # How long until a queue slot plausibly frees: the wave ahead
        # of this request, served max_ongoing-wide at the EWMA service
        # time.
        retry = (queued + 1) * max(self._svc_ewma_s, 0.01) \
            / max(1, self._max_ongoing)
        raise ServeOverloadedError(
            "replica admission queue full",
            deployment=self._context.deployment,
            queue_depth=queued,
            retry_after_s=round(min(30.0, max(0.05, retry)), 3))

    async def handle_request(self, method: str, args: tuple,
                             kwargs: dict,
                             priority: int | None = None) -> Any:
        """Execute one request (ray: replica.py handle_request).
        `_num_ongoing` counts queued + executing — the queue-length signal
        the router consumes."""
        from ray_tpu_torch import tracing
        from ray_tpu_torch._private import failpoints

        inst = await self._ready()
        if failpoints.ACTIVE:
            # Admission-window failpoint: latency/queue-full injection
            # BEFORE the bounded-queue decision and the ongoing count.
            await failpoints.fire_async("serve.admit")
        self._admit_or_reject(priority, args, kwargs)
        self._num_ongoing += 1
        self._observe_load()
        t_adm = time.time() if tracing.ENABLED else 0.0
        t_q0 = time.perf_counter()
        try:
            async with self._slots:
                self._queue_waits.observe(
                    "queue", (time.perf_counter() - t_q0) * 1000.0)
                # How long this request waited for a replica slot, in
                # the request's own trace (the handler task's adopted
                # context).
                if tracing.ENABLED and t_adm:
                    tracing.emit("serve.admit", t_adm,
                                 attrs={"deployment":
                                        self._context.deployment})
                # Admitted, the user callable not yet run (crash = the
                # replica dies mid-request; the handle must requeue).
                if failpoints.ACTIVE:
                    await failpoints.fire_async("serve.replica_call")
                target = getattr(inst, method)
                token = _ctx_var.set(self._context)
                t_svc0 = time.perf_counter()
                try:
                    if inspect.iscoroutinefunction(target):
                        return await target(*args, **kwargs)
                    # copy_context carries the replica identity, the
                    # actor and the call's trace into the pool thread
                    # (run_in_executor alone does not).
                    call_ctx = contextvars.copy_context()
                    return await asyncio.get_running_loop().run_in_executor(
                        self._pool,
                        lambda: call_ctx.run(target, *args, **kwargs))
                finally:
                    _ctx_var.reset(token)
                    dur = time.perf_counter() - t_svc0
                    self._svc_ewma_s = dur if not self._svc_ewma_s \
                        else 0.8 * self._svc_ewma_s + 0.2 * dur
        finally:
            self._num_ongoing -= 1
            self._num_processed += 1
            self._observe_load(done=True)

    def _metric_tags(self) -> dict:
        return {"app": self._context.app_name,
                "deployment": self._context.deployment,
                "replica": (self._context.replica_tag or "")[:12]}

    def _observe_load(self, done: bool = False) -> None:
        """Mirror the live queue depth (and completions) into the
        per-replica metric series."""
        try:
            m = _replica_metrics()
            tags = self._metric_tags()
            m["ongoing"].set(float(self._num_ongoing), tags)
            if done:
                m["processed"].inc(1, tags)
        except Exception:  # noqa: BLE001 - metrics never block serving
            pass

    async def get_queue_len(self) -> int:
        """Probe for the power-of-two-choices router (ray:
        replica_scheduler/pow_2_scheduler.py queue-length RPC)."""
        return self._num_ongoing

    async def get_metrics(self) -> dict:
        out = {"num_ongoing": self._num_ongoing,
               "num_processed": self._num_processed,
               "max_ongoing": self._max_ongoing,
               "max_queued": self._max_queued,
               "num_rejected": self._num_rejected,
               # Recent slot-wait percentiles (ms).
               "queue_wait_ms": self._queue_waits.snapshot().get(
                   "queue"),
               "ts": time.time()}
        # Surface the user callable's own stats() (e.g. the LLM engine's
        # cache hit/preempt counters) through the serve state API.
        fn = getattr(self._instance, "stats", None) \
            if self._built.done() else None
        if fn is not None:
            try:
                r = fn()
                if inspect.isawaitable(r):
                    r = await r
                out["user_stats"] = r
            except Exception:  # noqa: BLE001 - stats must not fail probes
                pass
        return out

    async def check_health(self) -> bool:
        """The controller's init probe and health poll: waits for the user
        object, then calls its check_health if it has one; raising marks
        the replica unhealthy (ray: deployment_state.py health-check
        polling)."""
        inst = await self._ready()
        fn = getattr(inst, "check_health", None)
        if fn is not None:
            r = fn()
            if inspect.isawaitable(r):
                await r
        return True

    async def prepare_for_shutdown(self) -> None:
        """Drain: wait for ongoing requests, then call the user object's
        shutdown hook (ray: replica graceful shutdown)."""
        while self._num_ongoing > 0:
            await asyncio.sleep(0.02)
        # Drop this replica's tagged series: the hosting process (the
        # shared device worker) outlives replicas.
        try:
            tags = self._metric_tags()
            for m in _replica_metrics().values():
                m.remove(tags)
        except Exception:  # noqa: BLE001 - metrics never block shutdown
            pass
        if not self._built.done() or self._built.exception() is not None:
            return
        fn = getattr(self._instance, "shutdown", None)
        if fn is not None:
            r = fn()
            if inspect.isawaitable(r):
                await r
