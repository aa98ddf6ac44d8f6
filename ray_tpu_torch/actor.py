"""ActorClass / ActorHandle: the @ray_tpu_torch.remote actor API.

Analog of ray: python/ray/actor.py (ActorClass._remote, ActorHandle).
Method calls go directly worker→worker with per-handle sequence numbers; the
controller is only involved at creation, restart, and address resolution
(ray: steady-state actor calls never touch the scheduler, SURVEY §3.3).
"""
from __future__ import annotations

import inspect

from ray_tpu_torch.remote_function import resolve_pg_options

_ACTOR_OPTION_KEYS = {
    "num_cpus", "num_gpus", "resources", "max_restarts", "max_task_retries",
    "max_concurrency", "name", "namespace", "lifetime", "get_if_exists",
    "scheduling_strategy", "placement_group", "placement_group_bundle_index",
    "runtime_env", "memory", "num_returns", "concurrency_groups",
}


def _validate(opts: dict) -> None:
    for k in opts:
        if k not in _ACTOR_OPTION_KEYS:
            raise ValueError(f"unknown actor option {k!r}")


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1,
                 concurrency_group: str | None = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def _call_opts(self) -> dict:
        opts: dict = {"num_returns": self._num_returns}
        if self._concurrency_group is not None:
            opts["concurrency_group"] = self._concurrency_group
        return opts

    def remote(self, *args, **kwargs):
        if self._num_returns == "streaming":
            from ray_tpu_torch._private.worker import global_worker

            opts = self._call_opts()
            opts.pop("num_returns", None)
            return global_worker().submit_streaming_actor_task(
                self._handle._actor_id, self._name, args, kwargs, opts)
        return self._handle._invoke(self._name, args, kwargs,
                                    self._call_opts())

    def options(self, **opts) -> "ActorMethod":
        nr = opts.get("num_returns", self._num_returns)
        if nr == "dynamic":
            raise NotImplementedError(
                'num_returns="dynamic" is only supported on task '
                'functions; use num_returns="streaming" for actor '
                "generator methods")
        return ActorMethod(
            self._handle, self._name, nr,
            opts.get("concurrency_group", self._concurrency_group))

    def bind(self, *args, **kwargs):
        """Lazy DAG node for this actor method (ray: dag/class_node.py
        ClassMethodNode via actor_method.bind)."""
        raise NotImplementedError(
            "DAGs are not ported yet (ROADMAP.md queue 1: DAG and "
            "channels)")

    def __call__(self, *args, **kwargs):
        raise TypeError(f"actor methods cannot be called directly; use "
                        f"{self._name}.remote()")


class ActorHandle:
    def __init__(self, actor_id: str, method_names: set[str] | None = None,
                 owner: bool = False,
                 method_opts: dict[str, dict] | None = None,
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._method_names = method_names or set()
        # @ray_tpu_torch.method(...) declarations per method (num_returns etc.;
        # concurrency_group resolves worker-side via method_groups).
        self._method_opts = method_opts or {}
        # Actor-level retry budget for calls caught mid-death (ray:
        # max_task_retries declared on the class); rides the handle so
        # every call site — including deserialized copies — applies it.
        self._max_task_retries = max_task_retries
        # The original handle owns the actor's lifetime: dropping it kills
        # the actor (ray: actor handle reference counting; non-detached
        # actors die when all handles go out of scope).  Deserialized copies
        # never own.
        self._owner = owner

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def __del__(self):
        if getattr(self, "_owner", False):
            try:
                from ray_tpu_torch._private.worker import _global_worker

                if _global_worker is not None \
                        and not _global_worker._shutdown.is_set():
                    _global_worker.kill_actor_async(self._actor_id)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    def _invoke(self, method: str, args: tuple, kwargs: dict, opts: dict):
        from ray_tpu_torch._private.worker import global_worker

        if getattr(self, "_max_task_retries", 0) \
                and "max_task_retries" not in opts:
            opts = {**opts, "max_task_retries": self._max_task_retries}
        core = global_worker()
        refs = core.submit_actor_task(self._actor_id, method, args, kwargs,
                                      opts)
        n = opts.get("num_returns", 1)
        return refs[0] if n == 1 else refs

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        if self._method_names and name not in self._method_names:
            raise AttributeError(
                f"actor has no method {name!r}; methods: "
                f"{sorted(self._method_names)}")
        opts = self._method_opts.get(name, {})
        return ActorMethod(self, name,
                           num_returns=opts.get("num_returns", 1))

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:12]}…)"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_names, False,
                              self._method_opts,
                              getattr(self, "_max_task_retries", 0)))


class ActorClass:
    def __init__(self, cls: type, **default_options):
        _validate(default_options)
        self._cls = cls
        self._default_options = default_options
        self._method_names = {
            n for n, _ in inspect.getmembers(cls, inspect.isfunction)
            if not n.startswith("__")
        }
        self._is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction))

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def options(self, **options) -> "ActorClass":
        _validate(options)
        clone = ActorClass(self._cls)
        clone._default_options = {**self._default_options, **options}
        return clone

    def _remote(self, args: tuple, kwargs: dict, opts: dict) -> ActorHandle:
        from ray_tpu_torch._private.worker import global_worker

        options = resolve_pg_options(opts)
        options["is_async"] = self._is_async
        if options.get("concurrency_groups"):
            # Map methods to their @ray_tpu_torch.method(concurrency_group=...)
            # declarations; the executing worker routes by this table.
            options["method_groups"] = {
                n: m.__ray_tpu_method_opts__["concurrency_group"]
                for n, m in inspect.getmembers(self._cls,
                                               inspect.isfunction)
                if getattr(m, "__ray_tpu_method_opts__", {}).get(
                    "concurrency_group")}
        core = global_worker()
        actor_id, existing = core.create_actor(self._cls, args, kwargs,
                                               options)
        # The creating handle owns the actor's lifetime unless the actor
        # is detached OR named (ray counts every handle — including ones
        # from get_actor — and kills on the last drop; this runtime does
        # not do distributed handle counting, and killing a named actor on
        # the creator's drop would break other processes' get_actor
        # handles, so named actors live until ray_tpu_torch.kill / shutdown).
        owner = not (existing or options.get("name")
                     or options.get("lifetime") == "detached")
        method_opts = {
            n: dict(m.__ray_tpu_method_opts__)
            for n, m in inspect.getmembers(self._cls, inspect.isfunction)
            if getattr(m, "__ray_tpu_method_opts__", None)}
        return ActorHandle(actor_id, self._method_names, owner=owner,
                           method_opts=method_opts,
                           max_task_retries=int(
                               opts.get("max_task_retries") or 0))

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor classes cannot be instantiated directly; use "
            f"{self._cls.__name__}.remote()")

    def __repr__(self):
        return f"ActorClass({self._cls.__name__})"
