"""Actor transport state: caller-side submit state and worker-side
hosted-actor instances.

Analog of ray: ActorTaskSubmitter caller state
(transport/actor_task_submitter.cc) and the ordered per-caller
scheduling queues + concurrency groups of the receiver
(transport/actor_scheduling_queue.cc, concurrency_group_manager.cc).
Split out of worker.py (round-4 modularization); the seqno/resend
PROTOCOL itself stays with CoreWorker — these are its data structures.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import threading
from dataclasses import dataclass, field
from typing import Any

# Tombstone left in reply_cache when a large reply's payload is trimmed:
# the execution COMPLETED — only its (big) result was dropped to bound
# memory.  A resend that hits it must NOT re-execute the method
# (at-most-once for stateful actors); it gets an explicit "reply
# evicted" error instead of a silently double-applied side effect.
REPLY_EVICTED = "reply-evicted"

# The actor whose code runs in this thread or task.  One process may host
# many actors (the device worker hosts every "GPU" actor of its host), so
# the process-global `CoreWorker.current_actor_id` names only the last
# one built; each actor's executor threads carry their own actor's id
# here (set by the pool's initializer), and so do its constructor and
# its async methods' tasks.  `runtime_context.get_actor_id()` reads it.
EXECUTING_ACTOR: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_executing_actor", default=None)


# The (task_id, trace header) of the call that runs in this thread or
# task, None outside one: `CoreWorker.current_task_id` and
# `current_trace` read it.  Each executor sets it around the call it runs
# and resets it after, so a pool thread carries nothing into its next
# call and two calls running at once keep their own traces.
EXECUTING_TASK: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_executing_task", default=None)


def _pool(max_workers: int, actor_id: str, prefix: str):
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=prefix,
        initializer=EXECUTING_ACTOR.set, initargs=(actor_id,))


@dataclass
class StreamState:
    """Owner-side state of one streaming-generator task (ray:
    ObjectRefGenerator streaming reports, _raylet.pyx:277,1103): item refs
    appear here as the executing worker ships them, long before the task's
    final reply."""

    refs: list = field(default_factory=list)      # minted item ObjectRefs
    total: int | None = None                      # set by the final reply
    error: BaseException | None = None
    event: asyncio.Event = field(default_factory=asyncio.Event)


@dataclass
class ActorSubmitState:
    """Caller-side state for one remote actor (per ActorHandle target)."""

    actor_id: str
    address: str | None = None
    seqno: int = 0
    resolving: asyncio.Future | None = None
    dead: bool = False
    death_cause: str = ""
    # Coalescing outbox: queued calls drain in seqno order, many per RPC.
    outbox: list = field(default_factory=list)
    draining: bool = False
    # Bounds concurrent in-flight batches (created lazily on the loop).
    send_sem: Any = None
    # Consecutive sends skipped because the resolved address is dead.
    stale_spins: int = 0
    # Seqnos currently inside _send_actor_batch (unacked): min() is the
    # seq_floor stamped on outgoing batches — the receiver's baseline.
    inflight_seqs: set = field(default_factory=set)
    # Guards seqno assignment and the unacked count across USER threads
    # and the loop: the fused sync fast path submits off-loop, so the
    # per-submission seqno must be taken where the submission happens
    # (submission order == seqno order regardless of which path sends).
    submit_lock: threading.Lock = field(default_factory=threading.Lock)
    # Calls submitted but not yet terminally replied/failed.  The fused
    # path is only taken at unacked == 0 (no ordering hazard with queued
    # or in-flight loop-path sends; seq_floor is then trivially our own
    # seqno).
    unacked: int = 0


class ActorInstance:
    """Worker-side hosted actor with ordered per-caller execution."""

    def __init__(self, actor_id: str, instance: Any,
                 max_concurrency: int | None,
                 is_async: bool, runtime_env: dict | None = None,
                 concurrency_groups: dict | None = None,
                 method_groups: dict | None = None):
        self.actor_id = actor_id
        self.instance = instance
        self.is_async = is_async
        self.runtime_env = runtime_env
        # max_concurrency None = not set by the user.  The async DEFAULT
        # group then gets ray's permissive 1000 bound — binding it to 1
        # would deadlock previously-safe async self-calls the moment any
        # named group is declared.
        self._async_default_limit = max_concurrency or 1000
        max_concurrency = max_concurrency or 1
        self.max_concurrency = max_concurrency
        self.executor = _pool(max_concurrency, actor_id,
                              f"actor-{actor_id[:12]}")
        # Named concurrency groups (ray: concurrency_group_manager.cc):
        # each group gets its own executor (sync actors) / semaphore
        # (async actors) so one saturated group never gates another.
        # The default group is the base executor / max_concurrency.
        self.concurrency_groups = dict(concurrency_groups or {})
        self.method_groups = dict(method_groups or {})
        self.group_executors: dict[str, Any] = {}
        for name, limit in self.concurrency_groups.items():
            self.group_executors[name] = _pool(
                max(1, int(limit)), actor_id,
                f"actor-{actor_id[:12]}-{name}")
        # Async actors: per-group semaphores, created lazily ON the loop.
        self._group_sems: dict[str, asyncio.Semaphore] = {}
        # Per-caller ordered delivery (ray: ActorSchedulingQueue seq_nos).
        self.next_seq: dict[str, int] = {}
        self.buffered: dict[str, dict[int, tuple]] = {}
        # (caller, seqno) -> shared reply task: a retransmitted call
        # (reply lost / retry raced the original) returns the ORIGINAL
        # execution's reply instead of re-executing — stateful methods
        # must not run twice because the transport retried.  Bounded
        # window; a resend older than the window re-executes (the
        # documented at-least-once fallback).
        import collections

        self.reply_cache: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()

    def cache_reply(self, key: tuple, task) -> None:
        # Window ≥ the max inflight depth (batch_size × inflight batches
        # = 1024): a retransmit always targets calls that were in
        # flight.  Large replies shed their payload on completion —
        # memory stays bounded — but leave a REPLY_EVICTED tombstone so
        # a resend still dedupes (it gets an error, not a re-execution;
        # the reply-resend watchdog depends on this for at-most-once).
        self.reply_cache[key] = task
        while len(self.reply_cache) > 1024:
            self.reply_cache.popitem(last=False)

        def _trim(t):
            try:
                r = t.result()
            except BaseException:  # noqa: BLE001 - incl. cancellation
                return
            if isinstance(r, tuple) and len(r) == 2 and sum(
                    len(b) for b in r[1]
                    if isinstance(b, (bytes, bytearray, memoryview))
                    ) > 65536 and key in self.reply_cache:
                self.reply_cache[key] = REPLY_EVICTED

        task.add_done_callback(_trim)

    def group_of(self, header: dict) -> str | None:
        """Resolve the concurrency group for one call (per-call override
        wins over the method's declared group)."""
        return header.get("concurrency_group") \
            or self.method_groups.get(header.get("method", ""))

    def executor_for(self, group: str | None):
        if group is None:
            return self.executor
        ex = self.group_executors.get(group)
        if ex is None:
            raise ValueError(
                f"actor has no concurrency group {group!r}; declared: "
                f"{sorted(self.concurrency_groups)}")
        return ex

    def semaphore_for(self, group: str | None) -> "asyncio.Semaphore | None":
        """Async-actor concurrency bound for a NAMED group (the default
        group is bounded by max_concurrency at the call sites)."""
        if group is None:
            return None
        if group not in self.concurrency_groups:
            raise ValueError(
                f"actor has no concurrency group {group!r}; declared: "
                f"{sorted(self.concurrency_groups)}")
        sem = self._group_sems.get(group)
        if sem is None:
            sem = asyncio.Semaphore(
                max(1, int(self.concurrency_groups[group])))
            self._group_sems[group] = sem
        return sem

    def default_semaphore(self) -> "asyncio.Semaphore | None":
        """Default-group bound for async actors — only once the actor
        declares named groups (otherwise async concurrency keeps its
        historical unbounded-by-default behavior).  The limit is the
        user's explicit max_concurrency, or 1000 (ray's async default)."""
        if not self.concurrency_groups:
            return None
        sem = self._group_sems.get("_default")
        if sem is None:
            sem = asyncio.Semaphore(max(1, self._async_default_limit))
            self._group_sems["_default"] = sem
        return sem
