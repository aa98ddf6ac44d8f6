"""ray_tpu_torch.serve: online model serving on the port's runtime (port of
ray_tpu/serve/__init__.py).

The controller's reconcile loop, replica actors and power-of-two routing
(`api.py`, `controller.py`, `replica.py`, `handle.py`), and the paged
continuous-batching LLM engine and server (`llm.py`).  The public names
load lazily, so `import ray_tpu_torch.serve.llm` pays for nothing of the
serve runtime, and the runtime's processes import no torch.
"""
import importlib

# Imported here, not lazily: importing the submodule `deployment` would
# otherwise bind the package attribute `deployment` to the module.
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment

_EXPORTS = {
    "api": ("HTTPOptions", "apply_config", "batch", "delete",
            "get_app_handle", "get_deployment_handle",
            "get_multiplexed_model_id", "get_replica_context", "grpc_port",
            "http_port", "ingress", "list_proxies", "multiplexed",
            "proxy_ports", "replica_metrics", "run", "shutdown", "start",
            "status"),
    "handle": ("DeploymentHandle", "DeploymentResponse"),
    "llm": ("LLMEngine", "LLMServer"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
_WHERE["ServeOverloadedError"] = "ray_tpu_torch.exceptions"
_WHERE["AdapterLoadError"] = "ray_tpu_torch.serve.lora"

__all__ = sorted([*_WHERE, "AutoscalingConfig", "DeploymentConfig",
                  "Application", "Deployment", "deployment"])


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'ray_tpu_torch.serve' has no attribute {name!r}")
    if "." not in mod:
        mod = f"ray_tpu_torch.serve.{mod}"
    return getattr(importlib.import_module(mod), name)
