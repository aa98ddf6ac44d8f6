"""Public exception types (analog of ray: python/ray/exceptions.py)."""
from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised; carries the remote traceback text and original cause.

    Raised from ray_tpu_torch.get on a failed task's ObjectRef
    (ray: RayTaskError python/ray/exceptions.py).
    """

    def __init__(self, cause: BaseException, remote_tb: str = ""):
        self.cause = cause
        self.remote_tb = remote_tb
        super().__init__(f"{type(cause).__name__}: {cause}\n{remote_tb}")

    def __reduce__(self):
        # Multi-field exceptions MUST override reduce: the default
        # replays args=(message,) into __init__, which mangles the
        # fields at every process hop (errors are routinely pickled —
        # cached returns, relay chains, actor death fan-out).
        return (TaskError, (self.cause, self.remote_tb))


class ActorError(RayTpuError):
    """Actor call failed because the actor is dead or died mid-call
    (ray: RayActorError)."""

    def __init__(self, actor_id: str = "", cause: str = ""):
        self.actor_id = actor_id
        self.cause = cause
        super().__init__(f"actor {actor_id[:12]} unavailable: {cause}")

    def __reduce__(self):
        return (type(self), (self.actor_id, self.cause))


class ActorDiedError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    """Object is gone from every node store and could not be reconstructed
    (ray: ObjectLostError / ObjectReconstructionFailedError).

    `detail`, when present, is the full diagnosis (ref, locations tried,
    lineage verdict) and becomes the message verbatim — the old
    single-arg form truncated everything to 12 chars, which is fine for
    a bare hex id and destroys anything richer."""

    def __init__(self, object_id: str = "", detail: str = ""):
        self.object_id = object_id
        self.detail = detail
        super().__init__(detail or f"object {object_id[:12]} lost")

    def __reduce__(self):
        # type(self), not ObjectLostError: pickling an OwnerDiedError
        # across a process hop must not demote it to the base class
        # (callers catch the subclass).
        return (type(self), (self.object_id, self.detail))


class ReplyEvictedError(RayTpuError):
    """The actor call EXECUTED — its side effects are applied exactly
    once — but the reply (>64KiB) was evicted from the receiver's dedupe
    cache before a lost-reply resend arrived, so the result is gone.
    Deliberately NOT an ActorError subclass: retry layers that re-route
    on replica/worker death (serve's dead-replica requeue, task retries)
    must not classify this as a death and re-run the call."""


class WorkerCrashedError(RayTpuError):
    """Worker process died while executing the task (ray: WorkerCrashedError)."""


class ConnectionLost(RayTpuError):
    """The rpc transport lost the peer process mid-call — it died or its
    socket went away (analog of ray: GrpcUnavailable/RpcError).  Defined
    here rather than in `_private/rpc.py` (which raises it) so library
    layers — serve's dead-replica requeue classifies on it — depend only
    on the public exception surface, never on transport internals."""


class OutOfMemoryError(WorkerCrashedError):
    """The worker was OOM-killed by the node memory monitor (ray:
    OutOfMemoryError): the task may retry, but the cause is memory
    pressure, not a crash in user code."""


class OwnerDiedError(ObjectLostError):
    """The object's OWNER process died, taking the authoritative copy
    and location directory with it (ray: OwnerDiedError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """ray_tpu_torch.get(timeout=...) expired (ray: GetTimeoutError)."""


class TaskCancelledError(RayTpuError):
    """Task cancelled via ray_tpu_torch.cancel (ray: TaskCancelledError)."""


class PendingCallsLimitExceeded(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class ServeOverloadedError(RayTpuError, RuntimeError):
    """A serve request was rejected at admission: every replica's
    bounded queue is full (or the router could not place the request
    before its deadline).  Typed and RETRIABLE — the caller should back
    off ``retry_after_s`` and resend; the request never started, so a
    resend cannot double-execute.  Subclasses RuntimeError so legacy
    ``except RuntimeError`` no-capacity handling keeps working.

    The serve analog of ray: serve.exceptions.BackPressureError."""

    def __init__(self, message: str = "serve deployment overloaded",
                 deployment: str = "", queue_depth: int = 0,
                 retry_after_s: float = 1.0):
        self.deployment = deployment
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s
        super().__init__(
            f"{message} (deployment={deployment!r}, "
            f"queue_depth={queue_depth}, retry_after_s={retry_after_s})")
        self._message = message

    def __reduce__(self):
        # Multi-field exceptions MUST override reduce (see TaskError):
        # the default replays args=(formatted,) into __init__ and
        # mangles the fields at every process hop.
        return (ServeOverloadedError,
                (self._message, self.deployment, self.queue_depth,
                 self.retry_after_s))


class AdapterLoadError(RayTpuError, RuntimeError):
    """A multi-LoRA request's adapter could not be made resident: the
    registry has no such model id, the fetched weights failed
    validation, every adapter slot is busy, or the load faulted
    (serve.adapter_load failpoint).  Typed and raised EARLY — before
    the request occupies a batch slot — so a load fault degrades to a
    clean rejection, never a wedged engine loop.  Subclasses
    RuntimeError so legacy blanket handlers keep working."""

    def __init__(self, message: str = "adapter load failed",
                 model_id: str = "", deployment: str = "",
                 reason: str = ""):
        self.model_id = model_id
        self.deployment = deployment
        self.reason = reason
        super().__init__(
            f"{message} (model_id={model_id!r}, "
            f"deployment={deployment!r}, reason={reason!r})")
        self._message = message

    def __reduce__(self):
        # Multi-field exceptions MUST override reduce (see TaskError).
        return (AdapterLoadError,
                (self._message, self.model_id, self.deployment,
                 self.reason))


# ----------------------------------------------------- reference aliases
# Reference-spelled names for drop-in `except ray.exceptions.X` code.
# Same classes, not look-alikes: an except on either name catches both.
RayError = RayTpuError
RayTaskError = TaskError
UserCodeException = TaskError
RayActorError = ActorError
ActorUnavailableError = ActorError
RaySystemError = RayTpuError


def __getattr__(name):
    # Channel errors live with the channels, a later slice of the port.
    if name in ("RayChannelError", "RayChannelTimeoutError"):
        raise NotImplementedError(
            "channels are not ported yet (ROADMAP.md queue 1: DAG and "
            "channels)")
    raise AttributeError(f"module 'ray_tpu_torch.exceptions' has no "
                         f"attribute {name!r}")
