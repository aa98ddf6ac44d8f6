"""Task-lease transport: per-scheduling-key worker leases.

Analog of ray: NormalTaskSubmitter (normal_task_submitter.h:75) — lease
acquisition with spillback redirects, lease reuse with an idle linger,
pipelined batched pushes onto leased workers, and push-failure retry.
Split out of worker.py (round-4 modularization: the 3.3k-line monolith
hid two round-3 transport bugs); behavior is unchanged — the manager
still drives its owning CoreWorker (`self.core`) directly.
"""
from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

from ray_tpu_torch._private.rpc import ConnectionLost, RemoteError
from ray_tpu_torch.exceptions import WorkerCrashedError

logger = logging.getLogger(__name__)


@dataclass
class PendingTask:
    task_id: bytes
    header: dict
    blobs: list[bytes]
    return_ids: list[bytes]
    retries_left: int
    retry_exceptions: bool
    scheduling_key: tuple
    # (object_id, owner_addr) pins added at submission for every ref shipped
    # in the args; released when the reply arrives unless the executing
    # worker reports the ref still held (ray: reference_count.cc borrows).
    borrowed: list = field(default_factory=list)
    # ActorSubmitState of the target actor (actor tasks only): the
    # terminal reply/failure decrements its unacked count exactly once
    # (cleared to None at the decrement site).
    actor_state: object = None


class LeaseManager:
    """Leases workers from node agents and pushes queued tasks to them
    (ray: NormalTaskSubmitter; lease reuse + rate limiting
    normal_task_submitter.h:53-72)."""

    def __init__(self, core: "CoreWorker"):
        self.core = core
        # scheduling_key -> state
        self.queues: dict[tuple, list[PendingTask]] = {}
        self.pushers: dict[tuple, int] = {}
        self.headers: dict[tuple, dict] = {}
        self.arrivals: dict[tuple, asyncio.Event] = {}

    def submit(self, task: PendingTask) -> None:
        q = self.queues.setdefault(task.scheduling_key, [])
        q.append(task)
        self.headers[task.scheduling_key] = {
            "resources": task.header.get("resources", {}),
            "affinity_node_id": task.header.get("affinity_node_id"),
            "affinity_soft": task.header.get("affinity_soft", False),
            "label_hard": task.header.get("label_hard"),
            "label_soft": task.header.get("label_soft"),
            "submitter": self.core.address,
        }
        ev = self.arrivals.get(task.scheduling_key)
        if ev is not None:
            ev.set()
        self._maybe_start_pusher(task.scheduling_key)

    def _maybe_start_pusher(self, key: tuple) -> None:
        active = self.pushers.get(key, 0)
        qlen = len(self.queues.get(key, []))
        limit = self.core.config.max_leases_per_scheduling_key
        if qlen > 0 and active < min(limit, qlen):
            self.pushers[key] = active + 1
            self.core.loop.create_task(self._pusher(key))

    async def _pusher(self, key: tuple) -> None:
        """One pusher = one lease lifetime: acquire worker, drain queue, and
        hold the lease briefly when idle so steady task streams reuse the
        same worker (ray: lease reuse + worker idle timeout)."""
        lease = None
        try:
            lease = await self._acquire_lease(key)
            if lease is None:
                return
            q = self.queues.get(key, [])
            depth = self.core.config.task_push_pipeline_depth
            while True:
                while q:
                    # Pipeline pushes onto one leased worker to hide the RPC
                    # round-trip — but never take more than this pusher's
                    # fair share of the queue, or a fast lease would hoard
                    # tasks other idle workers could run in parallel (ray:
                    # NormalTaskSubmitter pipelines per lease with the same
                    # constraint).
                    active = max(1, self.pushers.get(key, 1))
                    fair = -(-len(q) // active)          # ceil division
                    batch = [q.pop(0)
                             for _ in range(min(depth, fair, len(q)))]
                    # One RPC for a whole batch of dependency-free tasks:
                    # per-message transport + event-loop overhead is the
                    # control-plane cost, so coalescing amortizes it N×.
                    # Tasks WITH top-level ref args never join a batch —
                    # their arg resolution may need an earlier batch
                    # member's reply, which only ships when the whole
                    # batch finishes (deadlock).
                    def _solo(t):
                        # Streaming tasks also go solo: their reply waits
                        # on the LAST item, which would gate every batch
                        # sibling's reply behind the stream.
                        return (t.header.get("arg_refs")
                                or t.header.get("streaming"))
                    plain = [t for t in batch if not _solo(t)]
                    dep = [t for t in batch if _solo(t)]
                    ops = []
                    if len(plain) == 1:
                        ops.append(self._push_one(plain[0], lease))
                    elif plain:
                        ops.append(self._push_batch(plain, lease))
                    ops.extend(self._push_one(t, lease) for t in dep)
                    if len(ops) == 1:
                        oks = [await ops[0]]
                    else:
                        oks = await asyncio.gather(*ops)
                    if not all(oks):
                        # Dead lease: abandon it — failed tasks already
                        # re-queued and will ride a fresh lease (the
                        # finally block restarts a pusher).
                        return
                # Queue drained: only the last surviving pusher lingers.
                if self.pushers.get(key, 0) > 1:
                    break
                ev = self.arrivals.setdefault(key, asyncio.Event())
                ev.clear()
                try:
                    await asyncio.wait_for(
                        ev.wait(), self.core.config.lease_idle_timeout_s)
                except asyncio.TimeoutError:
                    break
                if not q:
                    break
        finally:
            self.pushers[key] = self.pushers.get(key, 1) - 1
            if lease is not None:
                await self._release_lease(lease)
            # Re-check: tasks may have arrived while we were releasing.
            self._maybe_start_pusher(key)

    async def _acquire_lease(self, key: tuple) -> dict | None:
        header = self.headers[key]
        addr = self.core.agent_addr
        hops = 8
        while hops > 0:
            try:
                reply, _ = await self.core.clients.get(addr).call(
                    "request_lease", header, timeout=300.0)
            except Exception as e:  # noqa: BLE001
                logger.warning("lease request to %s failed: %r", addr, e)
                return None
            if reply.get("retry"):
                # The agent's bounded park expired with the node still
                # busy: re-request (the park IS the backoff, so this
                # stays quiet).  Not a hop — a saturated cluster must
                # wait indefinitely, exactly like a queued task.
                continue
            hops -= 1
            if reply.get("granted"):
                # The agent vouches a live worker holds this address.
                self.core._revive_addr(reply["worker_addr"])
                return reply
            if reply.get("spill_to"):
                addr = reply["spill_to"]
                continue
            if reply.get("unfeasible"):
                # No node can ever run this with current membership; park the
                # queue and retry on a timer (cluster may grow).
                await asyncio.sleep(1.0)
                addr = self.core.agent_addr
                continue
        return None

    async def _release_lease(self, lease: dict) -> None:
        try:
            agent = lease.get("agent_addr") or self.core.agent_addr
            await self.core.clients.get(agent).call(
                "return_lease", {"lease_id": lease["lease_id"]}, timeout=10.0)
        except Exception:  # noqa: BLE001
            pass

    def _dead_addr_error(self, worker_addr: str) -> ConnectionLost | None:
        """A send to a known-dead worker must fail NOW: the transport would happily
        open a fresh connection to the dead address and hang forever."""
        if worker_addr in self.core._oom_worker_addrs:
            return ConnectionLost(
                f"{worker_addr}: OOM-killed by the node memory monitor")
        if worker_addr in self.core._dead_worker_addrs:
            return ConnectionLost(f"{worker_addr}: worker is dead")
        return None

    async def _push_one(self, task: PendingTask, lease: dict) -> bool:
        """Returns False when the lease's worker failed (the caller must
        abandon the lease — retried tasks re-queue onto a fresh one)."""
        worker_addr = lease["worker_addr"]
        err = self._dead_addr_error(worker_addr)
        if err is None:
            try:
                reply, blobs = await self.core.clients.get(
                    worker_addr).call("push_task", task.header, task.blobs)
            except (ConnectionLost, RemoteError) as e:
                err = self._dead_addr_error(worker_addr) or e
        if err is not None:
            await self._on_push_failure(task, err)
            return False
        self.core._on_task_reply(task, reply, blobs)
        return True

    async def _push_batch(self, batch: list, lease: dict) -> bool:
        """Push N tasks in one RPC (worker executes them in order and
        replies once with all results).  False = dead lease."""
        worker_addr = lease["worker_addr"]
        err = self._dead_addr_error(worker_addr)
        if err is None:
            blobs: list = []
            headers = []
            for t in batch:
                headers.append({**t.header, "nframes": len(t.blobs)})
                blobs.extend(t.blobs)
            try:
                reply, rblobs = await self.core.clients.get(
                    worker_addr).call("push_task_batch",
                                      {"tasks": headers}, blobs)
            except (ConnectionLost, RemoteError) as e:
                err = self._dead_addr_error(worker_addr) or e
        if err is not None:
            for t in batch:
                await self._on_push_failure(t, err)
            return False
        offset = 0
        for t, tr in zip(batch, reply["replies"]):
            n = tr.pop("nblobs")
            self.core._on_task_reply(t, tr, rblobs[offset:offset + n])
            offset += n
        return True

    async def _on_push_failure(self, task: PendingTask, exc: Exception) -> None:
        """Worker died mid-task: retry if budget remains
        (ray: TaskManager::FailOrRetryPendingTask task_manager.h:48)."""
        if task.retries_left > 0:
            task.retries_left -= 1
            logger.warning("task %s worker died; retrying (%d left)",
                           task.task_id.hex()[:12], task.retries_left)
            self.submit(task)
        else:
            from ray_tpu_torch.exceptions import OutOfMemoryError

            cls = (OutOfMemoryError if "OOM-killed" in str(exc)
                   else WorkerCrashedError)
            err = cls(
                f"worker died executing task {task.task_id.hex()[:12]}: {exc}")
            for rid in task.return_ids:
                self.core._resolve_error(rid, err)
            self.core._release_task_borrows(task)
