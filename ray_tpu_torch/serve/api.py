"""Public serve API on the port's runtime: start/run/status/delete/shutdown
+ handles (port of ray_tpu/serve/api.py).

Analog of ray: python/ray/serve/api.py (serve.run:510, serve.start,
serve.status, serve.delete, serve.shutdown, serve.get_app_handle).

Not ported (ROADMAP.md queue 1: serve): the HTTP proxy and the gRPC
ingress (`HTTPOptions`, `start(http_options=...)`, `list_proxies`,
`proxy_ports`, `http_port`, `grpc_port`, `ingress`), batching
(`batch`), multiplexing (`multiplexed`, `get_multiplexed_model_id`) and
the declarative config (`apply_config`), which raise
NotImplementedError.  `route_prefix` is kept as the app's recorded
route, as `status()` reports it.
"""
from __future__ import annotations

import hashlib
import time

import ray_tpu_torch
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import Application
from ray_tpu_torch.serve.handle import DeploymentHandle, close_routers

_controller = None      # ActorHandle


def _later(what: str, part: str = "the HTTP proxy and gRPC ingress"):
    raise NotImplementedError(
        f"serve: {what} is not ported yet (ROADMAP.md queue 1: serve, "
        f"{part})")


def get_replica_context():
    """Identity of the replica this code runs in (ray:
    serve.get_replica_context): .app_name, .deployment, .replica_tag,
    .servable_object.  Raises outside a replica."""
    from ray_tpu_torch.serve import replica as _replica

    ctx = _replica.get_current_context()
    if ctx is None:
        raise RuntimeError(
            "get_replica_context() may only be called inside a "
            "deployment replica")
    return ctx


def start(http_options: dict | None = None, detached: bool = True):
    """Ensure the serve controller (a named detached actor) is running
    (ray: serve.start); returns its handle.  No proxy is started."""
    global _controller
    if http_options:
        _later("start(http_options=...)")
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    if _controller is None:
        _controller = ray_tpu_torch.remote(ServeController).options(
            name=CONTROLLER_NAME, get_if_exists=True, lifetime="detached",
            max_concurrency=32, num_cpus=0.1).remote()
    return _controller


def _deployment_version(app_node: Application) -> str:
    """Code/config version: changing only user_config or num_replicas keeps
    the version → in-place reconfigure/scale instead of replica restart
    (ray: deployment_state.py version/config-change classification)."""
    from ray_tpu_torch._private.serialization import serialize

    d = app_node.deployment
    sv = serialize((
        d._cls, app_node.init_args, app_node.init_kwargs,
        d.config.max_ongoing_requests, d.config.ray_actor_options))
    h = hashlib.sha1()
    for f in sv.frames:
        h.update(f)
    return h.hexdigest()[:12]


def run(app: Application, *, name: str = "default",
        route_prefix: str = "/", _blocking: bool = True,
        timeout_s: float = 120.0) -> DeploymentHandle:
    """Deploy an application graph and return a handle to its ingress
    (ray: serve.run api.py:510)."""
    from ray_tpu_torch.exceptions import TaskError

    if not isinstance(app, Application):
        raise TypeError("serve.run takes the result of Deployment.bind()")
    ctrl = start()
    nodes = app._walk({})
    names = set()
    for node in nodes:
        if node.deployment.name in names:
            raise ValueError(
                f"duplicate deployment name {node.deployment.name!r} in app")
        names.add(node.deployment.name)

    deployments = []
    for node in nodes:
        # Replace bound child nodes with handles (model composition).
        def sub(v):
            if isinstance(v, Application):
                return DeploymentHandle(v.deployment.name, name,
                                        ctrl.actor_id)
            return v
        deployments.append({
            "name": node.deployment.name,
            "cls": node.deployment._cls,
            "init_args": tuple(sub(a) for a in node.init_args),
            "init_kwargs": {k: sub(v) for k, v in node.init_kwargs.items()},
            "config": node.deployment.config,
            "version": _deployment_version(node),
        })
    try:
        ray_tpu_torch.get(ctrl.deploy_app.remote(
            name, route_prefix, app.deployment.name, deployments),
            timeout=60.0)
    except TaskError as e:
        # A cut feature the controller refused: the typed error itself.
        if isinstance(e.cause, NotImplementedError):
            raise e.cause from None
        raise
    if _blocking:
        ok = ray_tpu_torch.get(ctrl.wait_for_deployments_ready.remote(
            name, timeout_s), timeout=timeout_s + 10.0)
        if not ok:
            raise TimeoutError(
                f"app {name!r} did not become ready in {timeout_s}s: "
                f"{status()}")
    return DeploymentHandle(app.deployment.name, name, ctrl.actor_id)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    ctrl = _require_controller()
    ingress = ray_tpu_torch.get(ctrl.app_ingress.remote(name), timeout=30.0)
    if ingress is None:
        raise ValueError(f"no serve app named {name!r}")
    return DeploymentHandle(ingress, name, ctrl.actor_id)


def get_deployment_handle(deployment_name: str,
                          app_name: str = "default") -> DeploymentHandle:
    ctrl = _require_controller()
    return DeploymentHandle(deployment_name, app_name, ctrl.actor_id)


def status() -> dict:
    ctrl = _require_controller()
    return ray_tpu_torch.get(ctrl.status.remote(), timeout=30.0)


def replica_metrics(app_name: str | None = None,
                    deployment: str | None = None) -> dict:
    """Per-replica metrics including the user callable's stats() dict
    (e.g. the LLM engine's prefix-cache hit/evict/preempt counters) —
    {app: {deployment: {replica: metrics}}}.  The state-API detail
    surface next to serve.status() (ray: serve application details)."""
    ctrl = _require_controller()
    return ray_tpu_torch.get(
        ctrl.replica_metrics.remote(app_name, deployment=deployment),
        timeout=30.0)


def delete(name: str, _blocking: bool = True) -> None:
    ctrl = _require_controller()
    ray_tpu_torch.get(ctrl.delete_app.remote(name), timeout=30.0)
    if _blocking:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if name not in ray_tpu_torch.get(ctrl.status.remote(),
                                             timeout=30.0):
                return
            time.sleep(0.1)
        raise TimeoutError(f"app {name!r} was not deleted within 60s")


def shutdown() -> None:
    """Tear down all apps and the controller (ray: serve.shutdown)."""
    global _controller
    if _controller is None:
        # A fresh process must still be able to tear down a detached
        # serve instance by name.
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except Exception:  # noqa: BLE001 - nothing running
            _controller = None
    if _controller is not None:
        try:
            ray_tpu_torch.get(_controller.graceful_shutdown.remote(),
                              timeout=30.0)
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if not ray_tpu_torch.get(_controller.status.remote(),
                                         timeout=30.0):
                    break
                time.sleep(0.1)
        except Exception:  # noqa: BLE001
            pass
        try:
            ray_tpu_torch.kill(_controller)
        except Exception:  # noqa: BLE001
            pass
        _controller = None
    close_routers()


def controller_or_none():
    """The serve controller's handle, or None when serve has not started
    (the named actor is looked up once per process while it lives)."""
    global _controller
    if _controller is None:
        try:
            _controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except ValueError:
            return None
    return _controller


def _require_controller():
    ctrl = controller_or_none()
    if ctrl is None:
        raise RuntimeError(
            "serve is not running; call serve.start() or serve.run()")
    return ctrl


class HTTPOptions(dict):
    """serve.start(http_options=...) options: the HTTP proxy is not
    ported, so constructing them raises."""

    def __init__(self, *args, **kwargs):
        _later("HTTPOptions")


def list_proxies() -> list[str]:
    _later("list_proxies")


def proxy_ports() -> list[int]:
    _later("proxy_ports")


def http_port() -> int:
    _later("http_port")


def grpc_port() -> int:
    _later("grpc_port")


def ingress(_app=None):
    _later("ingress")


def batch(_func=None, **_options):
    _later("batch", "batching")


def multiplexed(_func=None, **_options):
    _later("multiplexed", "multiplexing")


def get_multiplexed_model_id() -> str:
    _later("get_multiplexed_model_id", "multiplexing")


def apply_config(_config: dict) -> dict:
    _later("apply_config", "the declarative config")
