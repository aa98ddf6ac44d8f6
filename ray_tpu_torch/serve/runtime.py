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
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import inspect


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
