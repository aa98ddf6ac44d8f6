"""DeploymentHandle: the client-side router to a deployment's replicas
(port of ray_tpu/serve/handle.py).

Analog of ray: python/ray/serve/handle.py (DeploymentHandle.remote:714,786)
with the power-of-two-choices replica scheduler (ray:
_private/replica_scheduler/pow_2_scheduler.py:51) folded in.  Replica
membership comes from the controller and is cached with a TTL; the
scheduler picks 2 random replicas and routes to the one with the lower
locally-tracked in-flight count.

Threading: `remote()` must never block — handles are used from the driver
(plain threads) AND from inside async replica actors, where blocking
would deadlock the worker IO loop (membership RPC replies arrive on that
same loop).  Membership refresh therefore runs on a daemon router
thread, one per deployment per process, shared by all handles to it; when
no membership is cached yet, the request is queued to that thread and the
DeploymentResponse is backed by a Future[ObjectRef].

Not ported (ROADMAP.md queue 1: serve): streaming responses
(`DeploymentResponseGenerator`; `options(stream=True)` raises) and the
cache-aware and adapter-aware routing (the replica prefix summaries, the
tier-2 store view and the adapter residency the reference's router
thread polls), so `_Router.pick` is the reference's no-match path: power of
two choices.
"""
from __future__ import annotations

import concurrent.futures
import queue as queue_mod
import random
import threading
import time
from typing import Any

from ray_tpu_torch import tracing
from ray_tpu_torch.actor import ActorHandle
from ray_tpu_torch.object_ref import ObjectRef

_MEMBERSHIP_TTL_S = 0.5
# A router thread ends after this long with no call and nothing queued.
_ROUTER_IDLE_S = 10 * _MEMBERSHIP_TTL_S
# Dead-replica requeue budget per request: a submit that lands on a
# replica which dies before producing any response is re-routed to
# another running replica at most this many times (ray: serve retries
# ActorDiedError/ActorUnavailableError requests that never started).
_REQUEUE_BUDGET = 3


def _later(what: str):
    raise NotImplementedError(
        f"serve: {what} is not ported yet (ROADMAP.md queue 1: serve)")


def _is_replica_death(e: BaseException) -> bool:
    """True for errors that mean the REPLICA PROCESS failed before (or
    while) handling the request — never for user-code exceptions, which
    arrive as TaskError and must surface to the caller, and never for
    ObjectLostError: a lost RESULT object means the request already
    executed to completion and only the stored reply was lost."""
    from ray_tpu_torch.exceptions import (ActorError, ConnectionLost,
                                          WorkerCrashedError)

    return isinstance(e, (ActorError, WorkerCrashedError, ConnectionLost))


def _as_overload(e: BaseException):
    """The typed early-rejection behind a response failure, or None:
    ServeOverloadedError (admission overflow) or AdapterLoadError (a
    multi-LoRA request whose adapter could not be paged in).  Either
    crosses the process boundary wrapped in TaskError like any user
    exception — unwrap it so callers get the TYPED error.  Both mean the
    request NEVER RAN, so they spend no dead-replica requeue budget."""
    from ray_tpu_torch.exceptions import (AdapterLoadError,
                                          ServeOverloadedError, TaskError)
    from ray_tpu_torch.serve.lora import AdapterLoadError as LoraLoadError

    typed = (ServeOverloadedError, AdapterLoadError, LoraLoadError)
    if isinstance(e, typed):
        return e
    if isinstance(e, TaskError) and isinstance(
            getattr(e, "cause", None), typed):
        return e.cause
    return None


class _NoCapacity(RuntimeError):
    """No replica can accept the request right now — retried by the router
    thread until the 30s assignment deadline."""


class DeploymentResponse:
    """Future for one request (ray: serve/handle.py DeploymentResponse).

    Awaitable; `.result()` blocks (only call it off the worker IO loop);
    passing it to another handle call chains on the underlying ObjectRef.
    """

    def __init__(self, ref: ObjectRef | None,
                 ref_future: "concurrent.futures.Future | None" = None,
                 requeue=None):
        self._ref = ref
        self._ref_future = ref_future
        # Callable(exc) -> ObjectRef | None: re-route this request to
        # another running replica after the assigned one died before
        # producing a response (None = budget exhausted / no replica).
        self._requeue = requeue

    def _to_object_ref(self, timeout_s: float | None = 30.0) -> ObjectRef:
        if self._ref is None:
            self._ref = self._ref_future.result(timeout=timeout_s)
        return self._ref

    def result(self, timeout_s: float | None = None) -> Any:
        import ray_tpu_torch
        from ray_tpu_torch.exceptions import GetTimeoutError

        # One deadline for the WHOLE call, spanning requeue retries —
        # each retry gets the remaining budget, not a fresh timeout_s.
        deadline = None if timeout_s is None \
            else time.monotonic() + timeout_s
        while True:
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(
                    f"deployment response not ready within {timeout_s}s")
            try:
                ref = self._to_object_ref(
                    remaining if remaining is not None else 30.0)
                # Ref resolution may have blocked (router-queued
                # submit): re-derive the budget.
                if deadline is not None:
                    remaining = max(0.0, deadline - time.monotonic())
                value = ray_tpu_torch.get(ref, timeout=remaining)
                # The requeue closure pins the request's args/kwargs;
                # once a response has been produced it can never be used
                # again — release the payload with the closure.
                self._requeue = None
                return value
            except concurrent.futures.TimeoutError:
                bound = timeout_s if timeout_s is not None else 30.0
                raise GetTimeoutError(
                    "deployment response not ready: replica submit did "
                    f"not resolve within {bound}s") from None
            except Exception as e:  # noqa: BLE001 - filtered below
                ov = _as_overload(e)
                if ov is not None:
                    self._requeue = None   # rejected = never ran; typed
                    raise ov from None
                if self._requeue is None or not _is_replica_death(e):
                    raise
                if deadline is None:
                    ref = self._requeue(e)
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise
                    # Cap the re-route wait too: it blocks on membership
                    # refresh + the router thread.
                    ref = self._requeue(e, wait_s=remaining)
                if ref is None:
                    self._requeue = None   # budget exhausted — for good
                    raise
                self._ref = ref

    def __await__(self):
        import asyncio

        async def _resolve():
            while True:
                try:
                    # Ref resolution INSIDE the try: a router-submitted
                    # request whose replica died at submit time fails
                    # the ref_future itself, and must requeue exactly
                    # like a post-submit death.
                    ref = self._ref
                    if ref is None:
                        ref = await asyncio.wrap_future(self._ref_future)
                        self._ref = ref
                    value = await ref
                    self._requeue = None   # see result(): drop the payload
                    return value
                except Exception as e:  # noqa: BLE001 - filtered below
                    ov = _as_overload(e)
                    if ov is not None:
                        self._requeue = None
                        raise ov from None
                    if self._requeue is None or not _is_replica_death(e):
                        raise
                    # The requeue refreshes membership over blocking RPC
                    # — never on this (possibly worker-IO) loop.
                    loop = asyncio.get_running_loop()
                    new_ref = await loop.run_in_executor(
                        None, self._requeue, e)
                    if new_ref is None:
                        self._requeue = None
                        raise
                    self._ref = new_ref

        return _resolve().__await__()

    def __reduce__(self):
        return (DeploymentResponse, (self._to_object_ref(),))


class _Router:
    """Membership cache, in-flight counts and the router thread of one
    deployment, shared by every handle to it in this process (the handles
    that `options()` and `__getattr__` derive included).

    The thread completes queued submits and keeps membership fresh while
    requests flow (ray: Router long-poll updates, _private/router.py:320).
    It ends after `_ROUTER_IDLE_S` with no call and nothing queued, or at
    `serve.shutdown()` (`close`); the next queued submit starts it
    again."""

    def __init__(self, controller_id: str, app: str, deployment: str):
        self.controller_id = controller_id
        self.app = app
        self.deployment = deployment
        self.lock = threading.Lock()
        self.replicas: list[str] = []       # replica actor ids
        self.handles: dict[str, ActorHandle] = {}
        self.inflight: dict[str, int] = {}
        self.max_ongoing = 0                # 0 = no cap known yet
        self.fetched_at = 0.0
        self.used_at = time.monotonic()     # the last call routed here
        self._q: queue_mod.Queue = queue_mod.Queue()
        self._thread: threading.Thread | None = None
        self._closed = False

    def cached(self) -> tuple[bool, bool]:
        """(any replica cached, cache younger than the TTL); a call."""
        with self.lock:
            self.used_at = time.monotonic()
            return (bool(self.replicas),
                    self.used_at - self.fetched_at < _MEMBERSHIP_TTL_S)

    def refresh_blocking(self) -> None:
        """Fetch membership from the controller.  Blocks — router thread /
        driver thread only."""
        import ray_tpu_torch

        info = ray_tpu_torch.get(
            ActorHandle(self.controller_id).get_deployment_info.remote(
                self.app, self.deployment), timeout=30.0)
        with self.lock:
            self.fetched_at = time.monotonic()
            self.replicas = list(info["replicas"])
            self.max_ongoing = info.get("max_ongoing", 0)
            for rid in self.replicas:
                self.handles.setdefault(rid, ActorHandle(rid))
                self.inflight.setdefault(rid, 0)
            for rid in list(self.handles):
                if rid not in self.replicas:
                    self.handles.pop(rid)
                    self.inflight.pop(rid, None)

    def put(self, item) -> None:
        """Queue a submit (None only asks for a refresh) and start the
        thread if it is not running."""
        with self.lock:
            if self._closed:
                raise RuntimeError("serve has shut down")
            if item is not None:
                self.used_at = time.monotonic()
                self._q.put(item)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._main, daemon=True,
                    name=f"serve-router:{self.app}/{self.deployment}")
                self._thread.start()

    def close(self) -> None:
        """End the thread; submits still queued fail."""
        with self.lock:
            self._closed = True
        self._q.put(None)

    def _main(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=_MEMBERSHIP_TTL_S)
            except queue_mod.Empty:
                item = None
            with self.lock:
                # put() starts a thread under this lock whenever none is
                # set, so a submit queued after this check is never lost.
                if self._closed or (
                        item is None and self._q.empty()
                        and time.monotonic() - self.used_at
                        > _ROUTER_IDLE_S):
                    self._thread = None
                    break
                stale = time.monotonic() - self.fetched_at \
                    > _MEMBERSHIP_TTL_S
            if stale:
                try:
                    self.refresh_blocking()
                except Exception:  # noqa: BLE001 - controller restarting
                    pass
            if item is not None:
                self._serve(item)
        while True:
            try:
                item = self._q.get_nowait()
            except queue_mod.Empty:
                return
            if item is not None and item[0].set_running_or_notify_cancel():
                item[0].set_exception(RuntimeError("serve has shut down"))

    def _serve(self, item) -> None:
        fut, submit_fn, args, kwargs, deadline = item
        # PENDING→RUNNING is atomic with a consumer's cancel(): an
        # abandoned submit (requeue caller timed out) is skipped
        # instead of executed-with-no-consumer.  A _NoCapacity
        # retry re-enters here already RUNNING — don't re-claim.
        if not fut.running() and not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(submit_fn(args, kwargs))
        except _NoCapacity as e:
            if time.monotonic() > deadline:
                # Every replica stayed at its cap (or membership
                # stayed empty) for the whole assignment window:
                # reject with the typed, retriable error.
                from ray_tpu_torch.exceptions import ServeOverloadedError

                with self.lock:
                    depth = sum(self.inflight.values())
                fut.set_exception(ServeOverloadedError(
                    str(e), deployment=self.deployment,
                    queue_depth=depth, retry_after_s=1.0))
            else:
                time.sleep(0.05)
                self._q.put(item)
        except Exception as e:  # noqa: BLE001
            fut.set_exception(e)

    def pick(self, exclude=()) -> tuple[str, ActorHandle]:
        """Power-of-two choices over in-flight counts, skipping replicas at
        their max_ongoing_requests cap — the routing-side backpressure of
        ray: pow_2_scheduler.py:51.  `exclude` holds replica ids that
        already FAILED this request (dead-replica requeue must land
        somewhere else)."""
        with self.lock:
            reps = [r for r in self.replicas if r not in exclude] \
                if exclude else self.replicas
            if not reps:
                raise _NoCapacity(
                    f"deployment {self.deployment!r} has no running "
                    f"replicas"
                    + (f" ({len(exclude)} excluded after failure)"
                       if exclude else ""))
            cap = self.max_ongoing
            if cap > 0:
                eligible = [r for r in reps
                            if self.inflight.get(r, 0) < cap]
                if not eligible:
                    raise _NoCapacity(
                        f"all replicas of {self.deployment!r} are at "
                        f"max_ongoing_requests={cap}")
            else:
                eligible = reps
            if len(eligible) == 1:
                choice = eligible[0]
            else:
                a, b = random.sample(eligible, 2)
                choice = a if self.inflight.get(a, 0) <= \
                    self.inflight.get(b, 0) else b
            self.inflight[choice] = self.inflight.get(choice, 0) + 1
            handle = self.handles[choice]
        return choice, handle

    def done(self, rid: str) -> None:
        with self.lock:
            if self.inflight.get(rid, 0) > 0:
                self.inflight[rid] -= 1


_ROUTERS: dict[tuple[str, str, str], _Router] = {}
_ROUTERS_LOCK = threading.Lock()


def _router_for(controller_id: str, app: str, deployment: str) -> _Router:
    key = (controller_id, app, deployment)
    with _ROUTERS_LOCK:
        router = _ROUTERS.get(key)
        if router is None:
            router = _ROUTERS[key] = _Router(*key)
        return router


def close_routers() -> None:
    """End this process's router threads and drop their caches
    (`serve.shutdown()`)."""
    with _ROUTERS_LOCK:
        routers = list(_ROUTERS.values())
        _ROUTERS.clear()
    for router in routers:
        router.close()


class DeploymentHandle:
    def __init__(self, deployment: str, app: str, controller_id: str,
                 method_name: str = "__call__", stream: bool = False,
                 priority: int | None = None):
        if stream:
            _later("streaming responses (options(stream=True))")
        self.deployment_name = deployment
        self.app_name = app
        self._controller_id = controller_id
        self._method = method_name
        # Admission-priority tier for requests through this handle
        # (serve/slo.py: 0=high, 1=normal, 2=low); None = let the
        # replica resolve it from the request payload.
        self._priority = priority
        self._router = _router_for(controller_id, app, deployment)

    # -- routing ------------------------------------------------------------
    def _submit(self, args: tuple, kwargs: dict,
                state: dict | None = None) -> ObjectRef:
        # Routing happens OUTSIDE the flight-recorder span: a
        # _NoCapacity attempt (the router thread retries every 50ms for
        # up to 30s) must not burn ring slots on phantom error spans,
        # nor consume the queued_at stamp the eventually-successful
        # attempt needs for its serve.queue span.
        rid, handle = self._router.pick(
            state["failed"] if state is not None else ())
        if state is not None:
            state["rid"] = rid
        # Flight-recorder route span: roots the request's trace at the
        # handle edge (or joins the caller's); the actor call submitted
        # inside the span parents to it.
        with tracing.span(
                "serve.route",
                ctx=state.get("trace") if state is not None else None,
                attrs={"deployment": self.deployment_name,
                       "replica": rid}):
            t_q = state.pop("queued_at", None) if state is not None \
                else None
            if t_q is not None:
                # Time the request waited in the router-thread queue
                # (no membership / no capacity) before routing.
                tracing.emit("serve.queue", t_q)
            try:
                args = tuple(a._to_object_ref()
                             if isinstance(a, DeploymentResponse)
                             else a for a in args)
                kwargs = {k: (v._to_object_ref()
                              if isinstance(v, DeploymentResponse) else v)
                          for k, v in kwargs.items()}
            except BaseException:
                self._router.done(rid)
                raise
            pr = {} if self._priority is None \
                else {"priority": self._priority}
            ref = handle.handle_request.remote(self._method, args,
                                               kwargs, **pr)
            ref.future().add_done_callback(
                lambda _f: self._router.done(rid))
            return ref

    def _make_requeue(self, submit_fn, args: tuple, kwargs: dict,
                      state: dict):
        """Bounded dead-replica requeue for one request: refresh
        membership (dropping the dead replica), then re-route through
        the router thread — which keeps retrying while the controller
        starts a replacement — to a replica that has not already failed
        this request.  Returns the new ref or None (budget spent /
        nothing to route to: the original error surfaces)."""
        def _requeue(exc: BaseException, wait_s: float = 35.0):
            if state["budget"] <= 0:
                return None
            state["budget"] -= 1
            if state.get("rid"):
                state["failed"].add(state["rid"])
            try:
                self._router.refresh_blocking()
            except Exception:  # noqa: BLE001 - controller restarting
                pass
            fut: concurrent.futures.Future = concurrent.futures.Future()
            state["queued_at"] = time.time()
            try:
                self._router.put(
                    (fut, submit_fn, args, kwargs,
                     time.monotonic() + min(30.0, wait_s)))
                return fut.result(timeout=wait_s)
            except Exception:  # noqa: BLE001 - surface the ORIGINAL error
                # Still queued (router wedged in a refresh): cancel so
                # the router skips it — executing an abandoned submit
                # would dispatch a request nobody consumes.
                fut.cancel()
                return None
        return _requeue

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        chained_pending = any(
            isinstance(a, DeploymentResponse) and a._ref is None
            for a in list(args) + list(kwargs.values()))
        # Per-request routing state: requeue budget + replicas that
        # already failed it (see _make_requeue) + the caller's trace
        # context, captured HERE (API edge, caller thread) because the
        # submit may execute later on the router thread, which has no
        # ambient context of its own.
        state = {"budget": _REQUEUE_BUDGET, "failed": set(), "rid": None,
                 "trace": tracing.capture() if tracing.ENABLED else None}

        def submit(a, k):
            return self._submit(a, k, state=state)

        requeue = self._make_requeue(submit, args, kwargs, state)
        # An unresolved chained response would require a blocking wait to
        # convert to an ObjectRef — never do that on the caller's thread
        # (it may be a worker IO loop); hand it to the router thread.
        have, fresh = self._router.cached()
        if have and not chained_pending:
            if not fresh:    # serve stale, refresh in background
                self._router.put(None)
            try:
                return DeploymentResponse(submit(args, kwargs),
                                          requeue=requeue)
            except _NoCapacity:
                pass         # queue to the router thread below
        fut: concurrent.futures.Future = concurrent.futures.Future()
        state["queued_at"] = time.time()
        self._router.put(
            (fut, submit, args, kwargs, time.monotonic() + 30.0))
        return DeploymentResponse(None, ref_future=fut, requeue=requeue)

    def options(self, method_name: str | None = None,
                stream: bool | None = None,
                priority: int | None = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name, self._controller_id,
            method_name or self._method, bool(stream),
            self._priority if priority is None else priority)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def __repr__(self):
        return (f"DeploymentHandle({self.app_name}/{self.deployment_name}"
                f".{self._method})")

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name, self.app_name,
                                   self._controller_id, self._method,
                                   False, self._priority))
