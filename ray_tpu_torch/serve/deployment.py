"""Deployment decorator + application graph, copied from
ray_tpu/serve/deployment.py.

Analog of ray: python/ray/serve/deployment.py (Deployment, @serve.deployment)
and serve/api.py:510 (serve.run builds the app graph into deployments).
`Deployment.bind()` produces an `Application` node; bound nodes appearing in
another node's init args become `DeploymentHandle`s at deploy time (model
composition, ray: serve DeploymentNode DAG).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable

from ray_tpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                        autoscaling_config_from_dict)


def _wrap_function(func: Callable) -> type:
    """A function deployment becomes a class whose __call__ is the function
    (ray: serve/deployment.py function deployments)."""
    if inspect.iscoroutinefunction(func):
        class _FuncDeployment:
            async def __call__(self, *args, **kwargs):
                return await func(*args, **kwargs)
    else:
        class _FuncDeployment:
            def __call__(self, *args, **kwargs):
                return func(*args, **kwargs)

    _FuncDeployment.__name__ = getattr(func, "__name__", "func_deployment")
    return _FuncDeployment


class Deployment:
    def __init__(self, cls_or_func: Callable, name: str,
                 config: DeploymentConfig):
        self._is_function = not inspect.isclass(cls_or_func)
        self._func_or_class = cls_or_func
        self._cls = (_wrap_function(cls_or_func) if self._is_function
                     else cls_or_func)
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def options(self, **kwargs) -> "Deployment":
        cfg = dataclasses_replace(self.config, kwargs)
        name = kwargs.pop("name", self.name)
        return Deployment(self._func_or_class, name, cfg)

    def __repr__(self):
        return f"Deployment({self.name})"


def dataclasses_replace(config: DeploymentConfig, opts: dict) -> DeploymentConfig:
    import dataclasses

    fields = {f.name for f in dataclasses.fields(DeploymentConfig)}
    updates = {k: v for k, v in opts.items() if k in fields}
    if isinstance(updates.get("autoscaling_config"), dict):
        updates["autoscaling_config"] = autoscaling_config_from_dict(
            updates["autoscaling_config"])
    elif isinstance(updates.get("autoscaling_config"), AutoscalingConfig):
        updates["autoscaling_config"].validate()
    if updates.get("num_replicas") == "auto":
        # Same translation as the decorator: autoscaling with defaults.
        updates.setdefault(
            "autoscaling_config",
            config.autoscaling_config or AutoscalingConfig())
        updates["num_replicas"] = updates["autoscaling_config"].min_replicas
    return dataclasses.replace(config, **updates)


class Application:
    """A bound deployment graph node (ray: serve Application /
    DeploymentNode).  Children appear wherever a bound node was passed in
    init args/kwargs."""

    def __init__(self, deployment: Deployment, init_args: tuple,
                 init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs

    def _walk(self, seen: dict) -> list["Application"]:
        """Post-order unique traversal: children before parents."""
        if id(self) in seen:
            return []
        seen[id(self)] = self
        out: list[Application] = []
        for a in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(a, Application):
                out.extend(a._walk(seen))
        out.append(self)
        return out


def deployment(cls_or_func=None, *, name: str | None = None,
               num_replicas: int | str = 1,
               max_ongoing_requests: int = 8,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               user_config: Any = None,
               health_check_period_s: float = 1.0,
               graceful_shutdown_timeout_s: float = 5.0,
               ray_actor_options: dict | None = None,
               max_queued_requests: int = -1):
    """@serve.deployment (ray: serve/api.py deployment decorator).

    num_replicas="auto" enables autoscaling with defaults (ray: serve
    num_replicas="auto").  max_queued_requests bounds the replica-side
    admission queue (-1 = 2 x max_ongoing_requests, 0 = no queue);
    beyond it requests reject early with ServeOverloadedError.
    """
    if isinstance(autoscaling_config, dict):
        autoscaling_config = autoscaling_config_from_dict(
            autoscaling_config)
    elif isinstance(autoscaling_config, AutoscalingConfig):
        autoscaling_config.validate()
    if num_replicas == "auto":
        autoscaling_config = autoscaling_config or AutoscalingConfig()
        num_replicas = autoscaling_config.min_replicas

    def wrap(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=ray_actor_options or {},
            max_queued_requests=max_queued_requests)
        return Deployment(target, name or target.__name__, cfg)

    if cls_or_func is not None:
        return wrap(cls_or_func)
    return wrap
