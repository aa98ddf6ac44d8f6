"""Central config table with env-var overrides.

Analog of the reference's single config macro table
(ray: src/ray/common/ray_config_def.h — 217 RAY_CONFIG entries, overridable
via RAY_<name> env vars and a _system_config dict passed to init).  Here the
table is a dataclass; every field can be overridden by `RAY_TPU_TORCH_<NAME>` env
vars or the `_system_config` dict passed to `ray_tpu_torch.init`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class Config:
    # --- object store ---
    # Objects <= this many bytes travel inline in RPC replies / the owner's
    # in-process memory store (ray: max_direct_call_object_size, 100KB).
    max_inline_object_size: int = 100 * 1024
    # Node store bytes per node agent; past this, objects spill to disk.
    object_store_memory: int = 512 * 1024 * 1024
    # --- scheduling ---
    # Hybrid policy: pack onto lower-index nodes until utilization crosses
    # this threshold, then spread (ray: scheduler_spread_threshold=0.5).
    scheduler_spread_threshold: float = 0.5
    # Max task leases a submitter keeps per scheduling key
    # (ray: max_pending_lease_requests_per_scheduling_category).
    max_leases_per_scheduling_key: int = 8
    # Max tasks coalesced into one push to a leased worker (hides RPC
    # round-trip latency and amortizes per-message overhead; the pusher
    # still takes only its fair share of the queue, so batching never
    # starves other idle workers).
    task_push_pipeline_depth: int = 16
    # Max queued calls per actor coalesced into one RPC, and how many
    # such batches may be in flight concurrently (execution overlap for
    # async/threaded actors).
    actor_call_batch_size: int = 64
    actor_max_inflight_batches: int = 16
    # Reply watchdog for in-flight actor calls: a reply lost in transit
    # (dropped message, wedged-but-alive peer) would otherwise park the
    # caller forever — the transport never surfaces it.  After this many seconds
    # without a reply the call is RESENT with its original seqno; the
    # receiver's reply cache / in-flight dedupe returns the original
    # execution's result without re-running, so the resend is safe for
    # stateful methods.  (Replies >64KiB shed their payload from the
    # cache on completion; a resend that hits the tombstone gets an
    # explicit "reply evicted" error — still never a re-execution.)
    # 0 disables.
    actor_reply_resend_s: float = 60.0
    # Idle seconds before a leased worker is returned to the pool.
    lease_idle_timeout_s: float = 1.0
    # Max seconds a lease request parks agent-side waiting for capacity
    # before the agent answers {"retry": True} and drops the entry.  The
    # park must stay well under the client's RPC timeout: a grant fired
    # into a future whose client already gave up would lease a worker to
    # nobody — the submitter is alive, so the probe never reaps it, and
    # the leak is permanent (each cycle wedges one more worker until the
    # node can grant nothing at all).
    lease_park_s: float = 20.0
    # Workers prestarted per node agent at boot.
    prestart_workers: int = 2
    # Hard cap on worker processes per node agent.
    max_workers_per_node: int = 16
    # Concurrent worker FORKS in flight (not total workers): an actor
    # burst must queue spawns, not stampede N interpreters at once —
    # under CPU contention every fork then misses its startup timeout.
    max_concurrent_worker_spawns: int = 4
    # --- actor control plane (wave batching) ---
    # Accumulation tick for the controller's actor scheduler wave: actor
    # registrations landing within one tick are placed against a single
    # cluster view and dispatched as ONE create_actors RPC per agent.
    actor_wave_tick_s: float = 0.005
    # DEAD-actor tombstones stay visible (death_cause, get_actor_info)
    # for this grace window, then are GC'd; the table is also hard-capped
    # at actor_tombstone_max tombstones (oldest dropped first), so
    # 10k-actor churn cannot grow the controller resident set unbounded.
    actor_tombstone_grace_s: float = 60.0
    actor_tombstone_max: int = 2000
    # --- health / fault tolerance ---
    heartbeat_period_s: float = 0.5
    # Missed-heartbeat budget before a node is declared dead
    # (ray: num_heartbeats_timeout analog).
    node_death_timeout_s: float = 5.0
    actor_restart_backoff_s: float = 0.2
    default_task_max_retries: int = 3
    # --- memory ---
    memory_monitor_period_s: float = 0.25
    # Kill a worker when host/cgroup memory use crosses this fraction
    # (ray: memory_usage_threshold, ray_config_def.h:65).
    memory_usage_threshold: float = 0.95
    # --- misc ---
    task_event_buffer_size: int = 4096

    def override(self, d: dict[str, Any] | None) -> "Config":
        cfg = dataclasses.replace(self)
        for f in dataclasses.fields(cfg):
            env = os.environ.get(f"RAY_TPU_TORCH_{f.name.upper()}")
            if env is not None:
                setattr(cfg, f.name, _coerce(f.type, env))
        if d:
            for k, v in d.items():
                if not hasattr(cfg, k):
                    raise ValueError(f"unknown system config key {k!r}")
                setattr(cfg, k, v)
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))


def _coerce(typ: Any, raw: str) -> Any:
    t = str(typ)
    if "int" in t:
        return int(raw)
    if "float" in t:
        return float(raw)
    if "bool" in t:
        return raw.lower() in ("1", "true", "yes")
    return raw


DEFAULT = Config()


def tune_gc(framework_process: bool = True) -> None:
    """Long-running-process GC posture, applied by every runtime process
    after startup imports settle.

    The default (700, 10, 10) thresholds run a full gen2 pass every
    ~70k net allocations; with jax/numpy's import graph resident a pass
    costs ~110ms on the dev box, which shows up as bursty 100ms+ stalls
    in the middle of task bursts and bulk memcpys (ray leans on the
    same trick: ray._private.worker freezes after import).  freeze()
    parks the startup object graph in the permanent generation so
    gen2 passes only walk runtime-created objects; the raised
    thresholds trade a little cycle-reclaim latency for not running
    gen2 inside every few thousand task submissions.

    In the USER'S driver process (framework_process=False) this is far
    less invasive: no freeze (it would permanently exempt the user's
    pre-init objects from cycle collection) and thresholds change only
    if the application left the defaults in place."""
    import gc

    if framework_process:
        gc.collect()
        gc.freeze()
        gc.set_threshold(20_000, 25, 25)
    elif gc.get_threshold() == (700, 10, 10):
        gc.set_threshold(20_000, 25, 25)
