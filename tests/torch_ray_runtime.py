"""The port's runtime seam bound to the ray_tpu runtime, for the tests
that run ray_tpu_torch on a real cluster (the binding lives with the
tests: the port imports nothing of ray_tpu).

`RayTpuRuntime` binds every member of `ray_tpu_torch.serve.runtime.
ServeRuntime`: the object plane (`ray_tpu.put` / `get`, `ObjectRef`),
serve (`get_deployment_handle`, the replica context, the serve
controller actor), actors (`ray_tpu.remote`, `ray_tpu.kill`), the
collective face (`ray_tpu.collective`, backend "object_store"), the
failpoint hook (`ray_tpu._private.failpoints`), the tracing face
(`ray_tpu.tracing`), the metrics face (`ray_tpu.utils.metrics`) and the
memory-ledger face (`ray_tpu.memledger`).  It holds no state, so it
pickles into actors and replicas, which import this module by name (a
worker gets the driver's sys.path).

Import it from here; do not define a second binding."""
from __future__ import annotations

from ray_tpu_torch.serve.runtime import ServeRuntime

CONTROLLER = "SERVE_CONTROLLER"


class RayTpuRuntime(ServeRuntime):
    """ServeRuntime over ray_tpu."""

    # ---------------------------------------------------------- objects
    def put(self, value):
        import ray_tpu

        return ray_tpu.put(value)

    def get(self, ref, timeout: float | None = None):
        import ray_tpu

        return ray_tpu.get(ref, timeout=timeout)

    def is_ref(self, x) -> bool:
        from ray_tpu import ObjectRef

        return isinstance(x, ObjectRef)

    # ------------------------------------------------------------ serve
    def deployment_handle(self, name: str, app: str):
        from ray_tpu import serve

        return serve.get_deployment_handle(name, app)

    def replica_context(self):
        from ray_tpu.serve import replica

        return replica.get_current_context()

    def controller(self):
        import ray_tpu

        try:
            return ray_tpu.get_actor(CONTROLLER)
        except Exception:  # noqa: BLE001 - serve not running
            return None

    # ----------------------------------------------------------- actors
    def remote(self, cls):
        import ray_tpu

        return ray_tpu.remote(cls)

    def kill(self, actor) -> None:
        import ray_tpu

        ray_tpu.kill(actor)

    # ------------------------------------------------------ collectives
    def init_collective_group(self, world_size: int, rank: int,
                              group_name: str = "default") -> None:
        from ray_tpu import collective

        collective.init_collective_group(world_size, rank, "object_store",
                                         group_name)

    def get_rank(self, group_name: str = "default") -> int:
        from ray_tpu import collective

        return collective.get_rank(group_name)

    def deregister_collective_group(self, group_name: str) -> None:
        from ray_tpu import collective

        collective.deregister_collective_group(group_name)

    def destroy_collective_group(self, group_name: str,
                                 reason: str | None = None) -> None:
        from ray_tpu import collective

        collective.destroy_collective_group(group_name, reason=reason)

    def broadcast_async(self, payload, src_rank: int,
                        group_name: str = "default"):
        from ray_tpu import collective

        return collective.broadcast_async(payload, src_rank, group_name)

    # ------------------------------------------------------------ hooks
    def failpoint(self, site: str) -> None:
        from ray_tpu._private import failpoints

        if failpoints.ACTIVE:
            failpoints.fire(site)

    # ---------------------------------------------------------- tracing
    def tracing_enabled(self) -> bool:
        from ray_tpu import tracing

        return tracing.ENABLED

    def trace_capture(self):
        from ray_tpu import tracing

        return tracing.capture()

    def trace_current(self):
        from ray_tpu import tracing

        return tracing.current()

    def emit(self, name, t0, t1=None, ctx=None, attrs=None) -> None:
        from ray_tpu import tracing

        tracing.emit(name, t0, t1, ctx=ctx, attrs=attrs)

    def span(self, name: str, attrs: dict | None = None, ctx=None):
        from ray_tpu import tracing

        return tracing.span(name, attrs=attrs, ctx=ctx)

    # ---------------------------------------------------------- metrics
    def metric(self, kind, name, description="", tag_keys=(),
               boundaries=None):
        from ray_tpu.utils import metrics as um

        cls = {"counter": um.Counter, "gauge": um.Gauge,
               "histogram": um.Histogram}[kind]
        kw = {"boundaries": boundaries} if kind == "histogram" else {}
        return um.get_or_create(cls, name, description, tag_keys, **kw)

    # ---------------------------------------------------- memory ledger
    def register_provider(self, key, rows_fn) -> None:
        from ray_tpu import memledger

        memledger.register_provider(key, rows_fn)

    def unregister_provider(self, key) -> None:
        from ray_tpu import memledger

        memledger.unregister_provider(key)

    def memory_tag(self, kind, label=None):
        from ray_tpu import memledger

        return memledger.tag(kind, label=label)
