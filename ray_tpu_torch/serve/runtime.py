"""The runtime seam of the port's serve layer.

The reference's LLMServer and its adapter and prefix-store clients call
the ray_tpu runtime directly: `ray_tpu.put` / `ray_tpu.get` and
`ObjectRef` for the KV and adapter payloads, `serve.get_deployment_handle`
for the decode pool, `replica.get_current_context` for the deployment's
name, and the serve controller actor behind the adapter and prefix-store
directories.  The port imports none of that.  Its server and clients make
those calls on a `ServeRuntime` the caller passes in.

`ServeRuntime()` itself is the runtime of a process outside any cluster,
which is how the reference behaves when its object plane is not up: a
"put" hands the value itself along, nothing is a ref, no replica context,
no controller, and a deployment named by a string cannot be resolved.  A
binding to a real runtime subclasses it and overrides each member.

`LocalHandle` is a deployment handle to a server in the same process, for
tests and single-process runs: `.remote(...)` runs the bound method on a
worker thread and returns an awaitable, `.options(method_name=...)` binds
another method, as a serve handle does.

The RLHF actor topology (rl/rlhf.py, rl/rollout_llm.py,
collective/collective.py) makes the reference's other runtime calls on
the same object:

- the actor face: `remote(cls)` (an actor class whose
  `.options(num_cpus=..., max_concurrency=...)` and `.remote(*a, **k)`
  behave as `ray_tpu.remote(cls)`'s: an actor's `method.remote(...)`
  returns a ref), `get(ref_or_list, timeout)` and `kill(actor)`;
- the collective face: `init_collective_group`, `get_rank`,
  `deregister_collective_group`, `destroy_collective_group` and
  `broadcast_async` (a waitable with `.wait(timeout)`), as
  `ray_tpu.collective` has them;
- the failpoint hook `failpoint(site)`.

The serve engine, the server and the rollout workers report through three
more faces, with the call shapes of the reference's `ray_tpu.tracing`,
`ray_tpu.utils.metrics` and `ray_tpu.memledger`:

- tracing: `tracing_enabled()` (read per call, the reference's live
  `tracing.ENABLED`), `trace_capture()` and `trace_current()` (the
  (trace id, span id) context a request carries, or None), `emit(name,
  t0, t1=None, ctx=None, attrs=None)` (a span recorded after the fact, on
  the wall clock) and `span(name, attrs=None, ctx=None)` (a span over a
  `with` block, yielding its mutable attrs);
- metrics: `metric(kind, name, description, tag_keys, boundaries=None)`,
  the reference's idempotent `get_or_create` of a "counter", "gauge" or
  "histogram", whose `inc` / `set` / `observe(value, tags)` record;
- the memory ledger: `register_provider(key, rows_fn)`,
  `unregister_provider(key)` and `memory_tag(kind, label)`, a context
  that tags what the block creates (the reference's `memledger.tag`).

The null runtime makes no actors and forms no groups: those calls raise,
naming `LocalRuntime`.  Its hooks record nothing: `tracing_enabled()` is
False, so callers skip every capture and timestamp; its metrics are
`NULL_METRIC`.  `LocalRuntime` is the runtime of one process, as
`LocalHandle` is an in-process deployment handle: each actor is built in
the caller's process and runs its methods on a thread pool of its own,
`kill` makes every pending and later call raise `ActorDiedError`, a
collective group is an in-process rendezvous whose every wait has a
deadline, and a `Recorder` holds its spans, metrics and memory providers
(the counterpart of the reference's process-local span ring and metric
registry).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import contextvars
import inspect
import itertools
import os
import re
import threading
import time

from ray_tpu_torch.utils import metrics as um

NO_CLUSTER = (
    "no runtime to {what}: ServeRuntime() is a process outside any "
    "cluster; pass a LocalRuntime (one process) or a binding to a "
    "cluster")


class ActorDiedError(RuntimeError):
    """A call on an actor that was killed, or died, before it answered."""

    def __reduce__(self):
        return (type(self), self.args)


class CollectiveGroupError(RuntimeError):
    """A collective wait ended by the group's destruction: the message is
    the destroyer's reason."""

    def __reduce__(self):
        return (type(self), self.args)


def resolve_tree(runtime, refs, timeout: float | None = None):
    """The reference's forms of a weight push: a tree, one ref to it, or a
    list of refs to dict shards that merge into the tree (refs resolve
    through `runtime`)."""
    if runtime.is_ref(refs):
        return runtime.get(refs, timeout=timeout)
    if (isinstance(refs, (list, tuple)) and refs
            and all(runtime.is_ref(r) for r in refs)):
        got = [runtime.get(r, timeout=timeout) for r in refs]
        if len(got) == 1:
            return got[0]
        if not all(isinstance(g, dict) for g in got):
            raise ValueError(
                "update_weights: a multi-ref push must resolve to "
                "dict shards that merge into the param tree; got "
                f"{[type(g).__name__ for g in got]}")
        tree = {}
        for g in got:
            tree.update(g)
        return tree
    return refs


def makes_actors(runtime) -> bool:
    """Whether `runtime` overrides the null runtime's `remote`."""
    return runtime is not None \
        and type(runtime).remote is not ServeRuntime.remote


class ServeRuntime:
    """Runtime calls of LLMServer, LoraClient and PrefixStoreClient.  The
    base class is the null runtime (no cluster)."""

    def put(self, value):
        """Seal `value` into the object plane; returns what `get` takes."""
        return value

    def get(self, ref, timeout: float | None = None):
        """The value behind a ref that `is_ref` accepts."""
        return ref

    def is_ref(self, x) -> bool:
        return False

    def deployment_handle(self, name: str, app: str):
        """Handle to deployment `name` of `app`: `.remote(...)` returns an
        awaitable, `.options(method_name=...)` another handle."""
        raise LookupError(
            f"no serve runtime to resolve deployment {name!r} of app "
            f"{app!r}; pass a handle instead of a name")

    def replica_context(self):
        """The current replica's context (`.deployment`, `.app_name`,
        `.replica_tag`), or None outside a replica."""
        return None

    def controller(self):
        """Handle to the serve controller actor, whose `lora_<verb>` and
        `prefix_store_<verb>` methods return refs for `get`; None when
        there is none."""
        return None

    # ------------------------------------------------------ actor face
    def remote(self, cls):
        """An actor class of `cls`: `.options(num_cpus=...,
        max_concurrency=...)` another one, `.remote(*args, **kwargs)` an
        actor handle whose `method.remote(...)` returns a ref for
        `get`."""
        raise RuntimeError(NO_CLUSTER.format(
            what=f"make actors of {getattr(cls, '__name__', cls)!r}"))

    def kill(self, actor) -> None:
        """Kill `actor`: its pending and later calls raise."""
        raise RuntimeError(NO_CLUSTER.format(what="kill an actor"))

    # ------------------------------------------------- collective face
    def init_collective_group(self, world_size: int, rank: int,
                              group_name: str = "default") -> None:
        """Join group `group_name` as `rank` of `world_size` (called by
        every member, from its own actor or the driver)."""
        raise RuntimeError(NO_CLUSTER.format(
            what=f"form collective group {group_name!r}"))

    def get_rank(self, group_name: str = "default") -> int:
        """The caller's rank in `group_name`, -1 outside it."""
        return -1

    def deregister_collective_group(self, group_name: str) -> None:
        """Drop the caller's own state for `group_name` (an abandoned
        epoch), leaving the group to the others."""
        raise RuntimeError(NO_CLUSTER.format(
            what=f"deregister collective group {group_name!r}"))

    def destroy_collective_group(self, group_name: str,
                                 reason: str | None = None) -> None:
        """Tear `group_name` down for every member: parked waiters raise
        with `reason`."""
        raise RuntimeError(NO_CLUSTER.format(
            what=f"destroy collective group {group_name!r}"))

    def broadcast_async(self, payload, src_rank: int,
                        group_name: str = "default"):
        """Broadcast `payload` (a numpy array, given by `src_rank` only;
        None elsewhere).  Returns a waitable whose `.wait(timeout)` gives
        the source's payload on every rank."""
        raise RuntimeError(NO_CLUSTER.format(
            what=f"broadcast over collective group {group_name!r}"))

    # ------------------------------------------------------------ hooks
    def failpoint(self, site: str) -> None:
        """Fault-injection site `site` (`rl.rollout_step`,
        `rl.weight_sync`, the six `serve.*` sites); an armed site raises
        or kills its actor."""

    # ------------------------------------------------------ tracing face
    def tracing_enabled(self) -> bool:
        """Whether spans are recorded now (callers read it per call and
        skip every capture and timestamp when it is False)."""
        return False

    def trace_capture(self):
        """The current (trace id, span id) context for a request to carry
        to another thread, or None."""
        return None

    def trace_current(self):
        """The current (trace id, span id) context, or None."""
        return None

    def emit(self, name: str, t0: float, t1: float | None = None,
             ctx=None, attrs: dict | None = None) -> None:
        """Record one finished span from wall-clock `t0` to `t1` (now when
        None), under context `ctx` (the current one when None)."""

    def span(self, name: str, attrs: dict | None = None, ctx=None):
        """A tracing span over the `with` block, under `ctx` (the current
        context when None); yields the span's mutable attrs."""
        return contextlib.nullcontext({})

    # ------------------------------------------------------ metrics face
    def metric(self, kind: str, name: str, description: str = "",
               tag_keys: tuple = (), boundaries=None):
        """The metric `name` of `kind` ("counter", "gauge" or
        "histogram"), created at the first call and returned after that;
        `inc(value, tags)`, `set(value, tags)`, `observe(value, tags)`."""
        return NULL_METRIC

    # ------------------------------------------------ memory-ledger face
    def register_provider(self, key: str, rows_fn) -> None:
        """Attach `rows_fn() -> [row dict]` (memory the object plane does
        not hold, such as an engine's KV pool) to the memory harvest."""

    def unregister_provider(self, key: str) -> None:
        """Detach the provider registered under `key`."""

    def memory_tag(self, kind: str, label: str | None = None):
        """A context that tags the objects the block creates."""
        return contextlib.nullcontext()


class _NullMetric:
    """The null runtime's metric: records nothing."""

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        pass

    def set(self, value: float, tags: dict | None = None) -> None:
        pass

    def observe(self, value: float, tags: dict | None = None) -> None:
        pass


NULL_METRIC = _NullMetric()


class LocalResponse:
    """Awaitable result of LocalHandle.remote."""

    def __init__(self, fut: concurrent.futures.Future):
        self._fut = fut

    def __await__(self):
        return asyncio.wrap_future(self._fut).__await__()

    def result(self, timeout: float | None = None):
        return self._fut.result(timeout)


class LocalHandle:
    """Deployment handle to `target` (a server object) in this process.
    Each `.remote` call runs on the handle's thread pool; an async method
    runs in its own event loop there."""

    def __init__(self, target, method_name: str = "__call__",
                 executor: concurrent.futures.Executor | None = None):
        self._target = target
        self._method = method_name
        self._pool = executor or concurrent.futures.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="local-handle")

    def options(self, *, method_name: str = "__call__") -> "LocalHandle":
        return LocalHandle(self._target, method_name, self._pool)

    def remote(self, *args, **kwargs) -> LocalResponse:
        fn = getattr(self._target, self._method)

        def call():
            out = fn(*args, **kwargs)
            return asyncio.run(out) if inspect.iscoroutine(out) else out

        return LocalResponse(self._pool.submit(call))

    def close(self) -> None:
        """Stop the thread pool (shared with every `.options` sibling)."""
        self._pool.shutdown(wait=True, cancel_futures=True)


# --------------------------------------------------------- LocalRuntime
class LocalRef:
    """The result of a LocalRuntime actor call; `LocalRuntime.get`
    resolves it."""

    __slots__ = ("_fut",)

    def __init__(self, fut: concurrent.futures.Future):
        self._fut = fut


class _Actor:
    """One in-process actor: its object, thread pool and open calls."""

    def __init__(self, name: str, max_concurrency: int):
        self.name = name
        self.instance = None
        self.pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(max_concurrency)),
            thread_name_prefix=f"actor-{name}")
        self.lock = threading.Lock()
        self.dead: str | None = None
        self.pending: set = set()

    def settle(self, fut, result=None, exc=None) -> None:
        with self.lock:
            self.pending.discard(fut)
            if fut.done():
                return
            if self.dead is not None:
                exc = ActorDiedError(self.dead)
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)


class LocalActorHandle:
    """Handle to a LocalRuntime actor: `handle.method.remote(...)`."""

    def __init__(self, runtime: "LocalRuntime", actor: _Actor):
        self._runtime = runtime
        self._actor = actor

    def __getattr__(self, name: str) -> "_LocalMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _LocalMethod(self._runtime, self._actor, name)

    def __repr__(self) -> str:
        return f"LocalActorHandle({self._actor.name})"


class _LocalMethod:
    def __init__(self, runtime, actor, name):
        self._runtime, self._actor, self._name = runtime, actor, name

    def options(self, **_ignored) -> "_LocalMethod":
        return self

    def remote(self, *args, **kwargs) -> LocalRef:
        return self._runtime._call(self._actor, self._name, args, kwargs)


class LocalActorClass:
    """`LocalRuntime.remote(cls)`: `.options(...)` and `.remote(...)`."""

    def __init__(self, runtime: "LocalRuntime", cls, opts: dict):
        self._runtime, self._cls, self._opts = runtime, cls, opts

    def options(self, **opts) -> "LocalActorClass":
        """`max_concurrency` sizes the actor's thread pool (1 unless
        given); the rest (`num_cpus`, placement, names) means nothing in
        one process and is accepted as ray_tpu accepts it."""
        return LocalActorClass(self._runtime, self._cls,
                               {**self._opts, **opts})

    def remote(self, *args, **kwargs) -> LocalActorHandle:
        """Build the actor in this process, on the caller's thread (a
        constructor that raises raises here)."""
        return self._runtime._spawn(self._cls, self._opts, args, kwargs)


# The longest any collective wait of a LocalRuntime lasts (the
# reference's default RAY_TPU_COLLECTIVE_TIMEOUT_S).
COLLECTIVE_TIMEOUT_S = 120.0


class _Group:
    """An in-process collective rendezvous."""

    def __init__(self, name: str, world_size: int):
        self.name = name
        self.world_size = world_size
        self.cond = threading.Condition()
        self.ranks: dict = {}          # member -> rank
        self.seq: dict = {}            # member -> last op's seq
        self.slots: dict = {}          # seq -> [payload, takers left]
        self.destroyed: str | None = None


class _Received:
    """Waitable of a broadcast: the source's payload once it is there."""

    _UNSET = object()

    def __init__(self, group: _Group, seq: int, src_rank: int,
                 payload=_UNSET):
        self._g, self._seq, self._src = group, seq, src_rank
        self._out = payload

    def wait(self, timeout: float | None = None):
        if self._out is not _Received._UNSET:
            return self._out
        g = self._g
        limit = COLLECTIVE_TIMEOUT_S if timeout is None \
            else min(timeout, COLLECTIVE_TIMEOUT_S)
        deadline = time.monotonic() + limit
        with g.cond:
            while self._seq not in g.slots and g.destroyed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"collective group {g.name!r}: broadcast {self._seq}"
                        f" from rank {self._src} not received within "
                        f"{limit:.1f} s")
                g.cond.wait(left)
            if g.destroyed is not None:
                raise CollectiveGroupError(g.destroyed)
            slot = g.slots[self._seq]
            slot[1] -= 1
            if slot[1] <= 0:
                del g.slots[self._seq]
            self._out = slot[0]
        return self._out


# ------------------------------------------------------------- Recorder
TRACE_ENV = "RAY_TPU_TRACE"          # the reference's recorder kill switch
SPAN_CAPACITY = 4096


def _attrs(attrs: dict | None) -> dict:
    """Span attrs as plain values (the reference's `_clean_attrs`)."""
    out = {}
    for k, v in (attrs or {}).items():
        ok = v is None or isinstance(v, (bool, int, float, str))
        out[str(k)] = v if ok else str(v)
    return out


class Recorder:
    """One process's spans, metrics and memory providers: a bounded span
    ring (SPAN_CAPACITY records, the reference's default; older ones are
    overwritten) with a snapshot by trace id, a metric registry with a
    snapshot, the providers' rows, and an on/off switch for spans
    (`set_enabled`; on unless RAY_TPU_TRACE=0, as the reference's
    recorder).  Metrics and providers record whether spans are on or not,
    as in the reference.  Span records have the reference's keys: "tid",
    "sid", "par", "name", "t0", "t1" (wall clock) and "attrs"."""

    def __init__(self):
        self.enabled = os.environ.get(TRACE_ENV, "1") not in (
            "0", "false", "False", "")
        self._buf: list = [None] * SPAN_CAPACITY
        self._cursor = itertools.count()
        self._ids = itertools.count(1)
        self._ctx = contextvars.ContextVar(f"recorder_ctx_{id(self):x}",
                                           default=None)
        self._lock = threading.Lock()
        self._metrics: dict = {}        # name -> um.Metric
        self._providers: dict = {}
        self._tags: dict[tuple, int] = {}

    # -------------------------------------------------------------- spans
    def set_enabled(self, on: bool) -> None:
        self.enabled = bool(on)

    def _new_id(self) -> str:
        return f"{os.getpid() & 0xFFFFFFFF:08x}{next(self._ids):08x}"

    def _append(self, rec: dict) -> None:
        self._buf[next(self._cursor) % SPAN_CAPACITY] = rec

    def current(self):
        return self._ctx.get()

    def emit(self, name: str, t0: float, t1: float | None = None,
             ctx=None, attrs: dict | None = None) -> None:
        if not self.enabled:
            return
        c = ctx if ctx is not None else self._ctx.get()
        tid, par = c if c is not None else (self._new_id(), "")
        self._append({"tid": tid, "sid": self._new_id(), "par": par or "",
                      "name": name, "t0": t0,
                      "t1": time.time() if t1 is None else t1,
                      "attrs": _attrs(attrs)})

    @contextlib.contextmanager
    def span(self, name: str, attrs: dict | None = None, ctx=None):
        if not self.enabled:
            yield {}
            return
        parent = ctx if ctx is not None else self._ctx.get()
        sid = self._new_id()
        tid, par = parent if parent is not None else (self._new_id(), "")
        token = self._ctx.set((tid, sid))
        live = dict(attrs or {})
        t0 = time.time()
        try:
            yield live
        except BaseException as e:
            live["error"] = type(e).__name__
            raise
        finally:
            self._ctx.reset(token)
            self._append({"tid": tid, "sid": sid, "par": par, "name": name,
                          "t0": t0, "t1": time.time(),
                          "attrs": _attrs(live)})

    def spans(self, trace_id: str | None = None) -> list[dict]:
        """The buffered spans (of one trace when given), in ring order:
        the order they were recorded until the ring wraps."""
        return [r for r in list(self._buf) if r is not None
                and (trace_id is None or r["tid"] == trace_id)]

    # ------------------------------------------------------------ metrics
    def metric(self, kind: str, name: str, description: str = "",
               tag_keys: tuple = (), boundaries=None):
        """This recorder's metric `name` (`ray_tpu_torch.utils.metrics`'
        classes, kept in this recorder's registry, not flushed)."""
        return um.of_kind(kind, name, description, tag_keys, boundaries,
                          registry=self._metrics)

    def metrics(self) -> dict[str, dict]:
        """Every metric's snapshot, by name."""
        return {s["name"]: s for s in um.registry_snapshots(self._metrics)}

    # ------------------------------------------------------ memory ledger
    def register_provider(self, key: str, rows_fn) -> None:
        with self._lock:
            self._providers[key] = rows_fn

    def unregister_provider(self, key: str) -> None:
        with self._lock:
            self._providers.pop(key, None)

    def memory_rows(self) -> list[dict]:
        """Every provider's rows, each with its "provider" key (a provider
        that raises gives none, as in the reference's harvest)."""
        with self._lock:
            providers = list(self._providers.items())
        out = []
        for key, fn in providers:
            try:
                out += [{**row, "provider": key} for row in fn()]
            except Exception:  # noqa: BLE001 - one provider, not the harvest
                pass
        return out

    @contextlib.contextmanager
    def memory_tag(self, kind: str, label: str | None = None):
        """Counts the blocks entered per (kind, label); the process has no
        object plane of its own to tag."""
        with self._lock:
            self._tags[(kind, label)] = self._tags.get((kind, label), 0) + 1
        yield

    def memory_tags(self) -> dict[tuple, int]:
        with self._lock:
            return dict(self._tags)


_FAILPOINT = re.compile(r"^(?:nth:(\d+)\+)?(crash|raise)$")


class LocalRuntime(ServeRuntime):
    """The runtime of one process (see the module docstring).

    Actors: `remote(cls).options(max_concurrency=N).remote(*a, **k)`
    builds `cls(*a, **k)` here and gives it N threads; a ref argument at
    the top level of a call resolves before the method runs (as on a
    cluster).  `kill` makes the actor's pending and later calls raise
    `ActorDiedError` at once; a call already running finishes on its
    thread and its result is dropped; the object's `stop()`, where it has
    one, runs on a thread of its own, in place of the process exit that
    frees a real actor's resources.

    Collectives: a member is an actor (or the driver: any thread outside
    an actor); a broadcast's source deposits its payload and returns, the
    others take it, and every wait ends at its timeout or
    COLLECTIVE_TIMEOUT_S, whichever is sooner (TimeoutError), or at a
    destroy (CollectiveGroupError with the destroyer's reason).

    Failpoints: `arm(site, "nth:N+crash" | "nth:N+raise", actor=None)`
    fires at the site's Nth hit (by `actor` only, if given) and disarms:
    `crash` kills the actor the site runs in and raises ActorDiedError in
    it, `raise` raises RuntimeError.

    Tracing, metrics and the memory ledger go to `self.recorder` (a
    `Recorder`; `set_enabled(False)` stops the spans).  Spans of actor
    calls land in the same buffer: the process is one."""

    def __init__(self):
        self.recorder = Recorder()
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._actors: list[_Actor] = []
        self._groups: dict[str, _Group] = {}
        self._armed: dict[str, dict] = {}
        self._stopping: list[threading.Thread] = []

    # ----------------------------------------------------------- objects
    def is_ref(self, x) -> bool:
        return isinstance(x, LocalRef)

    def get(self, ref, timeout: float | None = None):
        """The value behind a LocalRef, or each of a list of them (one
        deadline for the whole list); anything else as it is."""
        if isinstance(ref, (list, tuple)):
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            return [self.get(r, None if deadline is None else max(
                0.0, deadline - time.monotonic())) for r in ref]
        if isinstance(ref, LocalRef):
            return ref._fut.result(timeout)
        return ref

    # ------------------------------------------------------------ actors
    def remote(self, cls) -> LocalActorClass:
        return LocalActorClass(self, cls, {})

    def _spawn(self, cls, opts, args, kwargs) -> LocalActorHandle:
        actor = _Actor(getattr(cls, "__name__", "actor"),
                       opts.get("max_concurrency") or 1)
        prev = getattr(self._tls, "actor", None)
        self._tls.actor = actor
        try:
            actor.instance = cls(*args, **kwargs)
        except BaseException:
            actor.pool.shutdown(wait=False)
            raise
        finally:
            self._tls.actor = prev
        with self._lock:
            self._actors.append(actor)
        return LocalActorHandle(self, actor)

    def _resolve_arg(self, x):
        return self.get(x) if isinstance(x, LocalRef) else x

    def _call(self, actor: _Actor, method: str, args, kwargs) -> LocalRef:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with actor.lock:
            if actor.dead is not None:
                fut.set_exception(ActorDiedError(actor.dead))
                return LocalRef(fut)
            actor.pending.add(fut)

        def run():
            if fut.done():
                return
            self._tls.actor = actor
            try:
                a = [self._resolve_arg(x) for x in args]
                k = {n: self._resolve_arg(v) for n, v in kwargs.items()}
                inst = actor.instance
                if inst is None:
                    raise ActorDiedError(actor.dead or actor.name)
                out = getattr(inst, method)(*a, **k)
                if inspect.iscoroutine(out):
                    out = asyncio.run(out)
            except BaseException as e:  # noqa: BLE001 - to the ref
                actor.settle(fut, exc=e)
            else:
                actor.settle(fut, result=out)
            finally:
                self._tls.actor = None

        try:
            actor.pool.submit(run)
        except RuntimeError:               # pool shut down by a kill
            actor.settle(fut, exc=ActorDiedError(actor.dead or actor.name))
        return LocalRef(fut)

    def kill(self, actor: LocalActorHandle) -> None:
        self._kill(actor._actor, f"actor {actor._actor.name} was killed")

    def _kill(self, actor: _Actor, reason: str) -> None:
        with actor.lock:
            if actor.dead is not None:
                return
            actor.dead = reason
            pending, actor.pending = list(actor.pending), set()
            inst, actor.instance = actor.instance, None
            for f in pending:
                if not f.done():
                    f.set_exception(ActorDiedError(reason))
        actor.pool.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            if actor in self._actors:
                self._actors.remove(actor)
        stop = getattr(inst, "stop", None)
        if callable(stop):
            t = threading.Thread(target=stop, daemon=True,
                                 name=f"stop-{actor.name}")
            t.start()
            with self._lock:
                self._stopping.append(t)

    def shutdown(self, timeout: float = 60.0) -> None:
        """Kill every live actor, destroy every group, and wait (at most
        `timeout` seconds) for the killed actors' `stop()`s."""
        with self._lock:
            actors, groups = list(self._actors), list(self._groups)
        for a in actors:
            self._kill(a, f"actor {a.name}: runtime shut down")
        for name in groups:
            self.destroy_collective_group(name, "runtime shut down")
        deadline = time.monotonic() + timeout
        with self._lock:
            stopping, self._stopping = self._stopping, []
        for t in stopping:
            t.join(max(0.0, deadline - time.monotonic()))

    # --------------------------------------- tracing, metrics and memory
    def set_enabled(self, on: bool) -> None:
        """Turn span recording on or off (the reference's
        `tracing.set_enabled`)."""
        self.recorder.set_enabled(on)

    def tracing_enabled(self) -> bool:
        return self.recorder.enabled

    def trace_capture(self):
        return self.recorder.current()

    def trace_current(self):
        return self.recorder.current()

    def emit(self, name, t0, t1=None, ctx=None, attrs=None) -> None:
        self.recorder.emit(name, t0, t1, ctx, attrs)

    def span(self, name, attrs=None, ctx=None):
        return self.recorder.span(name, attrs, ctx)

    def metric(self, kind, name, description="", tag_keys=(),
               boundaries=None):
        return self.recorder.metric(kind, name, description, tag_keys,
                                    boundaries)

    def register_provider(self, key, rows_fn) -> None:
        self.recorder.register_provider(key, rows_fn)

    def unregister_provider(self, key) -> None:
        self.recorder.unregister_provider(key)

    def memory_tag(self, kind, label=None):
        return self.recorder.memory_tag(kind, label)

    # -------------------------------------------------------- failpoints
    def arm(self, site: str, action: str, actor=None) -> None:
        m = _FAILPOINT.match(action)
        if m is None:
            raise ValueError(f"failpoint action {action!r}: want "
                             "'[nth:N+]crash' or '[nth:N+]raise'")
        with self._lock:
            self._armed[site] = {
                "nth": int(m.group(1) or 1), "hits": 0, "base": m.group(2),
                "actor": None if actor is None else actor._actor}

    def failpoint(self, site: str) -> None:
        if not self._armed:
            return
        me = getattr(self._tls, "actor", None)
        with self._lock:
            arm = self._armed.get(site)
            if arm is None or arm["actor"] not in (None, me):
                return
            arm["hits"] += 1
            if arm["hits"] < arm["nth"]:
                return
            del self._armed[site]
        if arm["base"] == "raise" or me is None:
            raise RuntimeError(f"injected by failpoint {site!r}")
        reason = f"actor {me.name} crashed at failpoint {site!r}"
        self._kill(me, reason)
        raise ActorDiedError(reason)

    # ------------------------------------------------------- collectives
    def _member(self):
        return getattr(self._tls, "actor", None)

    def init_collective_group(self, world_size: int, rank: int,
                              group_name: str = "default") -> None:
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank {rank} out of range for world {world_size}")
        with self._lock:
            g = self._groups.get(group_name)
            if g is None or g.world_size != world_size:
                g = self._groups[group_name] = _Group(group_name,
                                                      world_size)
        with g.cond:
            g.ranks[self._member()] = rank
            g.seq[self._member()] = 0

    def _group(self, group_name: str) -> _Group:
        g = self._groups.get(group_name)
        if g is None or self._member() not in g.ranks:
            raise RuntimeError(
                f"collective group {group_name!r} not initialized for "
                "this member; call init_collective_group first")
        return g

    def get_rank(self, group_name: str = "default") -> int:
        g = self._groups.get(group_name)
        return -1 if g is None else g.ranks.get(self._member(), -1)

    def deregister_collective_group(self, group_name: str) -> None:
        me = self._member()
        with self._lock:
            g = self._groups.get(group_name)
            if g is None:
                return
            g.ranks.pop(me, None)
            g.seq.pop(me, None)
            if not g.ranks:
                del self._groups[group_name]

    def destroy_collective_group(self, group_name: str,
                                 reason: str | None = None) -> None:
        with self._lock:
            g = self._groups.pop(group_name, None)
        if g is None:
            return
        with g.cond:
            g.destroyed = reason or \
                f"collective group {group_name!r} destroyed"
            g.slots.clear()
            g.cond.notify_all()

    def broadcast_async(self, payload, src_rank: int,
                        group_name: str = "default") -> _Received:
        g = self._group(group_name)
        me = self._member()
        with g.cond:
            if g.destroyed is not None:
                raise CollectiveGroupError(g.destroyed)
            g.seq[me] += 1
            seq = g.seq[me]
            if g.ranks[me] != src_rank:
                return _Received(g, seq, src_rank)
            if g.world_size > 1:
                g.slots[seq] = [payload, g.world_size - 1]
                g.cond.notify_all()
        return _Received(g, seq, src_rank, payload)


class ClusterRuntime(ServeRuntime):
    """ServeRuntime over the port's own runtime (`ray_tpu_torch.init()`:
    the controller, the node agent and worker processes of `_private/`),
    the counterpart of the tests' `RayTpuRuntime` binding to ray_tpu.

    It binds the object plane (`put`, `get`, `is_ref`), the actor face
    (`remote`, `kill`: a `num_gpus` actor runs in the node's device
    worker, any other in a plain worker that sees no CUDA device), the
    collective face (`collective/collective.py`: groups over the object
    plane, one member per actor, so members in the device worker keep
    their own ranks), the failpoint hook (`_private/failpoints.py`), the
    tracing face (`tracing.py`, the process's flight recorder, harvested
    cluster-wide by `ray_tpu_torch.tracing.harvest()`), the metric face
    (`utils/metrics.py`, flushed to the controller's KV) and the
    memory-ledger face (`_private/memledger.py`) and the serve face
    (`serve/api.py`, `serve/replica.py`: a deployment's handle, the
    current replica's context or None outside one, the serve
    controller's handle or None before `serve.start()`).  It holds no
    state, so it pickles into actors."""

    # ---------------------------------------------------------- objects
    def put(self, value):
        import ray_tpu_torch

        return ray_tpu_torch.put(value)

    def get(self, ref, timeout: float | None = None):
        import ray_tpu_torch

        return ray_tpu_torch.get(ref, timeout=timeout)

    def is_ref(self, x) -> bool:
        from ray_tpu_torch.object_ref import ObjectRef

        return isinstance(x, ObjectRef)

    # ------------------------------------------------------------ serve
    def deployment_handle(self, name: str, app: str):
        from ray_tpu_torch.serve import api

        return api.get_deployment_handle(name, app)

    def replica_context(self):
        from ray_tpu_torch.serve import replica

        return replica.get_current_context()

    def controller(self):
        from ray_tpu_torch.serve import api

        return api.controller_or_none()

    # ----------------------------------------------------------- actors
    def remote(self, cls):
        import ray_tpu_torch

        return ray_tpu_torch.remote(cls)

    def kill(self, actor) -> None:
        import ray_tpu_torch

        ray_tpu_torch.kill(actor)

    # ------------------------------------------------------ collectives
    def init_collective_group(self, world_size: int, rank: int,
                              group_name: str = "default") -> None:
        from ray_tpu_torch.collective import collective

        collective.init_collective_group(world_size, rank, "object_store",
                                         group_name)

    def get_rank(self, group_name: str = "default") -> int:
        from ray_tpu_torch.collective import collective

        return collective.get_rank(group_name)

    def deregister_collective_group(self, group_name: str) -> None:
        from ray_tpu_torch.collective import collective

        collective.deregister_collective_group(group_name)

    def destroy_collective_group(self, group_name: str,
                                 reason: str | None = None) -> None:
        from ray_tpu_torch.collective import collective

        collective.destroy_collective_group(group_name, reason=reason)

    def broadcast_async(self, payload, src_rank: int,
                        group_name: str = "default"):
        from ray_tpu_torch.collective import collective

        return collective.broadcast_async(payload, src_rank, group_name)

    # ------------------------------------------------------------ hooks
    def failpoint(self, site: str) -> None:
        from ray_tpu_torch._private import failpoints

        if failpoints.ACTIVE:
            failpoints.fire(site)

    # ---------------------------------------------------------- tracing
    def tracing_enabled(self) -> bool:
        from ray_tpu_torch import tracing

        return tracing.ENABLED

    def trace_capture(self):
        from ray_tpu_torch import tracing

        return tracing.capture()

    def trace_current(self):
        from ray_tpu_torch import tracing

        return tracing.current()

    def emit(self, name, t0, t1=None, ctx=None, attrs=None) -> None:
        from ray_tpu_torch import tracing

        tracing.emit(name, t0, t1, ctx=ctx, attrs=attrs)

    def span(self, name: str, attrs: dict | None = None, ctx=None):
        from ray_tpu_torch import tracing

        return tracing.span(name, attrs=attrs, ctx=ctx)

    # ---------------------------------------------------------- metrics
    def metric(self, kind, name, description="", tag_keys=(),
               boundaries=None):
        return um.of_kind(kind, name, description, tag_keys, boundaries)

    # ---------------------------------------------------- memory ledger
    def register_provider(self, key, rows_fn) -> None:
        from ray_tpu_torch._private import memledger

        memledger.register_provider(key, rows_fn)

    def unregister_provider(self, key) -> None:
        from ray_tpu_torch._private import memledger

        memledger.unregister_provider(key)

    def memory_tag(self, kind, label=None):
        from ray_tpu_torch._private import memledger

        return memledger.tag(kind, label=label)
