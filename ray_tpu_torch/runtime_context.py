"""Runtime context: introspection of the current worker/task/actor.

Analog of ray: python/ray/runtime_context.py.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RuntimeContext:
    job_id: str
    node_id: str
    worker_id: str
    actor_id: str | None
    task_id: str | None
    namespace: str
    trace_context: dict | None = None
    controller_address: str = ""
    assigned_resources: dict | None = None
    runtime_env: dict | None = None

    def get_node_id(self) -> str:
        return self.node_id

    def get_actor_id(self) -> str | None:
        return self.actor_id

    def get_task_id(self) -> str | None:
        return self.task_id

    def get_job_id(self) -> str:
        return self.job_id

    def get_worker_id(self) -> str:
        return self.worker_id

    def get_trace_context(self) -> dict | None:
        """The executing task's trace context — {"trace_id",
        "parent_span", "span_id"} — propagated automatically through
        nested task/actor submissions (ray: OpenTelemetry propagation,
        util/tracing/tracing_helper.py); None on the driver."""
        return self.trace_context

    # ------------------------------------------- reference-surface extras
    def get(self) -> dict:
        """Legacy dict form (ray: RuntimeContext.get)."""
        out = {"job_id": self.job_id, "node_id": self.node_id,
               "namespace": self.namespace}
        if self.actor_id:
            out["actor_id"] = self.actor_id
        if self.task_id:
            out["task_id"] = self.task_id
        return out

    @property
    def gcs_address(self) -> str:
        """The controller address (the GCS analog)."""
        return self.controller_address

    def get_placement_group_id(self) -> str | None:
        """PG id of the current task/actor, or None (ray:
        get_placement_group_id)."""
        raise NotImplementedError(
            "placement groups are not ported yet (ROADMAP.md queue 1: "
            "runtime envs and placement groups)")

    def get_actor_name(self) -> str | None:
        """Name of the current actor when it has one (ray:
        get_actor_name)."""
        if not self.actor_id:
            return None
        from ray_tpu_torch._private.worker import global_worker

        core = global_worker()
        reply, _ = core.call(core.controller_addr, "list_actors",
                             timeout=30.0)
        for a in reply["actors"]:
            if a["actor_id"] == self.actor_id:
                return a.get("name")
        return None

    def get_assigned_resources(self) -> dict:
        """Resources of the current task/actor lease (ray:
        get_assigned_resources)."""
        return dict(self.assigned_resources or {})

    def get_accelerator_ids(self) -> dict:
        """{"GPU": [...]} CUDA device ids visible to this worker (ray:
        get_accelerator_ids; the reference answers {"TPU": [...]})."""
        from ray_tpu_torch.api import get_gpu_ids

        return {"GPU": [str(i) for i in get_gpu_ids()]}

    def get_runtime_env_string(self) -> str:
        import json as _json

        return _json.dumps(self.runtime_env or {})


def get_runtime_context() -> RuntimeContext:
    """The context of the calling code.  Its actor id is that of the actor
    whose method (or constructor) runs in this thread or task; a process
    hosting many actors (the device worker) tells them apart this way.
    In a thread the actor started itself it is the process's one actor,
    as in the reference, where an actor is a process; where the process
    hosts several, such a thread is no actor's (None), since it cannot be
    told which one started it."""
    from ray_tpu_torch._private.actor_state import EXECUTING_ACTOR
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    actor_id = EXECUTING_ACTOR.get()
    if actor_id is None:
        hosted = list(core.actors_hosted)
        actor_id = hosted[0] if len(hosted) == 1 else None
    return RuntimeContext(
        job_id=core.job_id,
        node_id=core.node_id,
        worker_id=core.worker_id,
        actor_id=actor_id,
        task_id=core.current_task_id,
        namespace=core.namespace,
        trace_context=core.current_trace,
        controller_address=core.controller_addr,
        assigned_resources=getattr(core, "current_resources", None),
        runtime_env=getattr(core, "current_runtime_env", None),
    )
