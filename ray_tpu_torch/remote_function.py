"""RemoteFunction: the object @ray_tpu_torch.remote wraps a function into.

Analog of ray: python/ray/remote_function.py (RemoteFunction, _remote:266).
"""
from __future__ import annotations

import functools
from typing import Callable

_OPTION_KEYS = {
    "num_cpus", "num_gpus", "num_returns", "resources", "max_retries",
    "retry_exceptions", "name", "scheduling_strategy", "placement_group",
    "placement_group_bundle_index", "runtime_env", "memory",
}


def validate_options(opts: dict) -> None:
    """ray: python/ray/_private/ray_option_utils.py validation table."""
    for k in opts:
        if k not in _OPTION_KEYS:
            raise ValueError(f"unknown option {k!r}; valid: {sorted(_OPTION_KEYS)}")
    if "num_returns" in opts and opts["num_returns"] is not None:
        nr = opts["num_returns"]
        if nr == "dynamic":
            return      # generator task: one ref resolving to N item refs
        if nr == "streaming":
            return      # generator task: items stream back as produced
        if not isinstance(nr, int) or nr < 0:
            raise ValueError('num_returns must be a non-negative int, '
                             '"dynamic", or "streaming"')


def resolve_pg_options(opts: dict) -> dict:
    """Translate scheduling-strategy options into the affinity and label
    fields the scheduler understands.  Placement groups are a later slice
    of the port: any group but "default" raises."""
    out = dict(opts)
    strategy = out.pop("scheduling_strategy", None)
    pg = out.pop("placement_group", None)
    out.pop("placement_group_bundle_index", None)
    if strategy is not None and hasattr(strategy, "placement_group"):
        pg = strategy.placement_group
    elif strategy is not None and hasattr(strategy, "node_id"):
        out["affinity_node_id"] = strategy.node_id
        out["affinity_soft"] = bool(getattr(strategy, "soft", False))
    elif strategy is not None and hasattr(strategy, "hard"):
        # NodeLabelSchedulingStrategy (constraints already lowered).
        if strategy.hard:
            out["label_hard"] = strategy.hard
        if strategy.soft:
            out["label_soft"] = strategy.soft
    if pg is not None and pg != "default":
        raise NotImplementedError(
            "placement groups are not ported yet (ROADMAP.md queue 1: "
            "runtime envs and placement groups)")
    return out


class RemoteFunction:
    def __init__(self, fn: Callable, **default_options):
        validate_options(default_options)
        self._function = fn
        self._default_options = default_options
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def options(self, **options) -> "RemoteFunction":
        validate_options(options)
        merged = {**self._default_options, **options}
        clone = RemoteFunction(self._function, **{})
        clone._default_options = merged
        return clone

    def _remote(self, args: tuple, kwargs: dict, opts: dict):
        from ray_tpu_torch._private.worker import global_worker

        options = resolve_pg_options(opts)
        core = global_worker()
        if options.get("num_returns") == "dynamic":
            # One return ref whose value is an ObjectRefGenerator over the
            # yielded items (ray: num_returns="dynamic").
            options = {**options, "num_returns": 1, "dynamic": True}
            return core.submit_task(self._function, args, kwargs,
                                    options)[0]
        if options.get("num_returns") == "streaming":
            # Items stream back as produced (ray: ObjectRefGenerator);
            # returns the generator immediately.
            return core.submit_streaming_task(self._function, args,
                                              kwargs, options)
        refs = core.submit_task(self._function, args, kwargs, options)
        n = options.get("num_returns", 1)
        if n == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "remote functions cannot be called directly; use "
            f"{getattr(self._function, '__name__', 'fn')}.remote()")

    def bind(self, *args, **kwargs):
        """Lazy DAG node instead of immediate submission (ray:
        dag/function_node.py via remote_function.bind)."""
        raise NotImplementedError(
            "DAGs are not ported yet (ROADMAP.md queue 1: DAG and "
            "channels)")

    def __repr__(self):
        return f"RemoteFunction({getattr(self._function, '__name__', '?')})"

