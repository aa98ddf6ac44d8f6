"""Serve configuration dataclasses, copied from ray_tpu/serve/config.py
(the port imports nothing of ray_tpu).

Analog of ray: python/ray/serve/config.py + serve/schema.py (DeploymentSchema,
AutoscalingConfig) — the declarative spec the controller reconciles against
(ray: _private/deployment_state.py).  `AutoscalingConfig` is data here:
the port's controller does not autoscale yet and refuses a deployment
that carries one (ROADMAP.md queue 1: serve).
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class AutoscalingConfig:
    """Scale replicas on ongoing-request load AND SLO attainment (ray:
    serve/config.py AutoscalingConfig; policy in
    _private/autoscaling_state.py + serve/slo.py here).

    target_ongoing_requests: per-replica load the autoscaler steers toward.
    target_p99_ttft_ms / target_queue_wait_ms: optional SLO targets — a
    sustained p99 breach scales OUT past the load-based answer, and a
    near-breach blocks downscale (see slo.slo_desired).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.2
    target_p99_ttft_ms: float | None = None
    target_queue_wait_ms: float | None = None

    def validate(self, where: str = "autoscaling_config") -> None:
        """Field-naming validation (deploy-time: serve/schema.py and the
        @serve.deployment decorator both call this — a bad config must
        fail at validation, not at the controller's first decision)."""
        if self.min_replicas < 1:
            raise ValueError(
                f"{where}.min_replicas must be >= 1, got "
                f"{self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"{where}.max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if not self.target_ongoing_requests > 0:
            raise ValueError(
                f"{where}.target_ongoing_requests must be > 0, got "
                f"{self.target_ongoing_requests}")
        for name in ("upscale_delay_s", "downscale_delay_s",
                     "metrics_interval_s"):
            v = getattr(self, name)
            if v < 0:
                raise ValueError(f"{where}.{name} must be >= 0, got {v}")
        for name in ("target_p99_ttft_ms", "target_queue_wait_ms"):
            v = getattr(self, name)
            if v is not None and not v > 0:
                raise ValueError(
                    f"{where}.{name} must be > 0 when set, got {v}")


def autoscaling_config_from_dict(d: dict,
                                 where: str = "autoscaling_config"
                                 ) -> AutoscalingConfig:
    """dict → validated AutoscalingConfig with field-naming errors
    (unknown keys, min>max, non-positive targets) — the one conversion
    path shared by schema.py, deployment.py, and dataclasses_replace."""
    fields = {f.name for f in dataclasses.fields(AutoscalingConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(
            f"unknown {where} keys {sorted(unknown)}; valid: "
            f"{sorted(fields)}")
    cfg = AutoscalingConfig(**d)
    cfg.validate(where)
    return cfg


@dataclasses.dataclass
class DeploymentConfig:
    """Per-deployment settings (ray: serve/config.py DeploymentConfig).

    max_queued_requests: replica-side admission queue bound (requests
    waiting past max_ongoing_requests); beyond it the replica rejects
    early with ServeOverloadedError instead of queueing unboundedly.
    -1 = default bound of 2 x max_ongoing_requests; 0 = no queue.
    """
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    autoscaling_config: AutoscalingConfig | None = None
    user_config: Any = None
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    max_queued_requests: int = -1


# Replica lifecycle states (ray: _private/common.py ReplicaState).
REPLICA_STARTING = "STARTING"
REPLICA_RUNNING = "RUNNING"
REPLICA_STOPPING = "STOPPING"


@dataclasses.dataclass
class ReplicaInfo:
    replica_id: str
    deployment: str
    app: str
    actor_id: str
    state: str = REPLICA_STARTING
    version: str = ""
