"""Cluster controller: the head-node control plane.

TPU-native analog of the reference's GCS server
(ray: src/ray/gcs/gcs_server/gcs_server.h:78).  Owns:
  - node membership + health (ray: GcsNodeManager, GcsHealthCheckManager)
  - actor directory + restart policy (ray: GcsActorManager gcs_actor_manager.cc:311)
  - actor scheduling (ray: GcsActorScheduler gcs_actor_scheduler.cc:49)
  - cluster resource view, periodically published to node agents — the
    push-based analog of the ray_syncer resource gossip
    (ray: src/ray/common/ray_syncer/ray_syncer.h:88)
  - KV store for function/class exports and named entities
    (ray: GcsKvManager / GcsFunctionManager)
  - pub/sub of node/actor events (ray: gcs_pub_sub.h)

Single asyncio process; all state in memory (the reference's default
StorageType::IN_MEMORY).  Placement groups and snapshot persistence are
later slices of the port (ROADMAP.md queue 1).
"""
from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import time
from dataclasses import dataclass, field

from ray_tpu_torch._private import failpoints
from ray_tpu_torch._private import memledger
from ray_tpu_torch._private import scheduler as sched
from ray_tpu_torch._private import spans
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.rpc import (ClientPool, Publisher, RpcServer,
                                       process_modules)

logger = logging.getLogger(__name__)

# Actor lifecycle states (ray: rpc::ActorTableData states).
PENDING, ALIVE, RESTARTING, DEAD = "PENDING", "ALIVE", "RESTARTING", "DEAD"


@dataclass
class NodeInfo:
    node_id: str
    agent_addr: str
    resources: dict[str, float]
    available: dict[str, float]
    labels: dict[str, str] = field(default_factory=dict)
    state: str = "ALIVE"
    last_heartbeat: float = field(default_factory=time.monotonic)
    # load: queued-task resource demand reported by the agent, used by the
    # hybrid policy's utilization term.
    load: int = 0


@dataclass
class ActorInfo:
    actor_id: str
    name: str | None
    namespace: str
    owner_addr: str
    creation_spec: list[bytes]          # serialized creation task frames
    creation_header: dict
    resources: dict[str, float]
    max_restarts: int
    state: str = PENDING
    address: str | None = None          # worker rpc address once ALIVE
    node_id: str | None = None
    restarts_used: int = 0
    death_cause: str | None = None
    waiters: list[asyncio.Future] = field(default_factory=list)
    detached: bool = False
    affinity_node_id: str | None = None
    affinity_soft: bool = False
    label_hard: dict | None = None
    label_soft: dict | None = None
    # Wave-scheduler bookkeeping: dedup flag for the wave queue, and the death timestamp driving tombstone GC.
    queued: bool = False
    died_at: float | None = None


class Controller:
    def __init__(self, config: Config, host: str = "127.0.0.1",
                 port: int | None = None):
        self.config = config
        self.host = host
        self.server = RpcServer(host=host, port=port)
        self.publisher: Publisher | None = None  # created in start()
        self.clients = ClientPool()
        self.nodes: dict[str, NodeInfo] = {}
        self.actors: dict[str, ActorInfo] = {}
        self.named_actors: dict[tuple[str, str], str] = {}
        self.kv: dict[str, dict[str, bytes]] = {}
        self.jobs: dict[str, dict] = {}
        self._tasks_events: list[dict] = []
        self._bg: list[asyncio.Task] = []
        self._probing: set[str] = set()
        # --- actor wave scheduler ---
        # Pending actors accumulate here for one tick, are placed against
        # a single cluster view, and dispatched as ONE create_actors RPC
        # per agent per wave (ray: GcsActorScheduler batching).
        self._actor_queue: list[ActorInfo] = []
        # Infeasible-now actors park HERE and wait for a capacity signal
        # (node registration / heartbeat reporting more availability).
        self._actor_parked: list[ActorInfo] = []
        self._actor_wave_wake = asyncio.Event()
        self._actor_retry = asyncio.Event()
        # actor_id -> futures of get_actor_info(wait=True) calls that
        # arrived BEFORE the (batched, in-flight) registration: a handle
        # can cross processes ahead of its create_actors flush.
        self._unknown_actor_waiters: dict[str, list[asyncio.Future]] = {}

    # ---------------------------------------------------------------- setup
    async def start(self) -> None:
        self.publisher = Publisher(host=self.host)
        self.server.register_all(self)
        self.server.start()
        loop = asyncio.get_running_loop()
        self._bg.append(loop.create_task(self._health_loop()))
        self._bg.append(loop.create_task(self._resource_broadcast_loop()))
        self._bg.append(loop.create_task(self._actor_wave_loop()))
        self._bg.append(loop.create_task(self._actor_unpark_loop()))
        logger.info("controller up at %s (pub %s)",
                    self.server.address, self.publisher.address)

    def close(self) -> None:
        for t in self._bg:
            t.cancel()
        self.server.close()
        if self.publisher is not None:
            self.publisher.close()
        self.clients.close()

    # ------------------------------------------------------------ node mgmt
    async def rpc_register_node(self, h: dict, _b: list) -> dict:
        node = NodeInfo(
            node_id=h["node_id"], agent_addr=h["agent_addr"],
            resources=dict(h["resources"]), available=dict(h["resources"]),
            labels=h.get("labels", {}),
        )
        self.nodes[node.node_id] = node
        # A new node is new capacity: wake parked (infeasible) actors.
        self._actor_retry.set()
        await self.publisher.publish(
            "node", {"event": "alive", "node_id": node.node_id,
                     "agent_addr": node.agent_addr})
        logger.info("node %s registered: %s", node.node_id[:12], node.resources)
        return {"config": self.config.to_json(),
                "pub_addr": self.publisher.address}

    async def rpc_heartbeat(self, h: dict, _b: list) -> dict:
        node = self.nodes.get(h["node_id"])
        if node is None or node.state != "ALIVE":
            return {"ok": False}          # stale node: tell it to re-register
        node.last_heartbeat = time.monotonic()
        prev = node.available
        node.available = dict(h["available"])
        node.load = h.get("load", 0)
        # Resource-freed signal for parked actors: this node now reports
        # MORE of some resource than before (an actor or lease was
        # released there).
        if self._actor_parked and any(
                v > prev.get(k, 0.0) + 1e-9
                for k, v in node.available.items()):
            self._actor_retry.set()
        return {"ok": True}

    async def _health_loop(self) -> None:
        last_tick = time.monotonic()
        while True:
            await asyncio.sleep(self.config.heartbeat_period_s)
            now = time.monotonic()
            # If OUR loop stalled (CPU starvation on a loaded box), agents' heartbeats are queued BEHIND this timer
            # callback — judging staleness now would declare live nodes
            # dead.  Skip a round so the queued heartbeats land first.
            stalled = (now - last_tick) > 4 * self.config.heartbeat_period_s
            last_tick = now
            if stalled:
                continue
            try:
                self._gc_actor_tombstones(now)
            except Exception:  # noqa: BLE001
                logger.exception("actor tombstone GC failed")
            for node in list(self.nodes.values()):
                if (node.state == "ALIVE"
                        and now - node.last_heartbeat
                        > self.config.node_death_timeout_s
                        and node.node_id not in self._probing):
                    # Silence may be load, not death (the agent's loop can
                    # be starved on a saturated host).  Probe directly off
                    # the health loop — only an agent that also fails the
                    # probe is declared dead (GCS-pull analog of ray's
                    # health checks).
                    self._probing.add(node.node_id)
                    asyncio.get_running_loop().create_task(
                        self._probe_node(node))

    async def _probe_node(self, node: NodeInfo) -> None:
        try:
            await self.clients.get(node.agent_addr).call(
                "ping", {}, timeout=self.config.node_death_timeout_s)
            node.last_heartbeat = time.monotonic()
        except Exception:  # noqa: BLE001 - unreachable: genuinely dead
            if node.state == "ALIVE":
                await self._on_node_dead(node)
        finally:
            self._probing.discard(node.node_id)

    async def _on_node_dead(self, node: NodeInfo) -> None:
        node.state = "DEAD"
        logger.warning("node %s declared dead", node.node_id[:12])
        # Fail OUR in-flight calls to the dead agent NOW (the transport never
        # surfaces peer death): a wave dispatch mid-flight gets
        # ConnectionLost and reschedules its actors immediately instead
        # of waiting out the RPC timeout.
        self.clients.drop(node.agent_addr)
        await self.publisher.publish(
            "node", {"event": "dead", "node_id": node.node_id,
                     "agent_addr": node.agent_addr})
        # Restart or fail actors that lived there.
        for actor in list(self.actors.values()):
            if actor.node_id == node.node_id and actor.state == ALIVE:
                await self._on_actor_dead(actor, f"node {node.node_id[:12]} died")

    # ----------------------------------------------------------- resources
    def _cluster_view(self) -> dict:
        return {
            n.node_id: {
                "agent_addr": n.agent_addr,
                "total": n.resources,
                "available": n.available,
                "load": n.load,
                "labels": n.labels,
            }
            for n in self.nodes.values() if n.state == "ALIVE"
        }

    async def _resource_broadcast_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.heartbeat_period_s)
            if self.nodes:
                await self.publisher.publish(
                    "resources", {"view": self._cluster_view()})

    async def rpc_get_cluster_view(self, h: dict, _b: list) -> dict:
        return {"view": self._cluster_view()}

    async def rpc_push_logs(self, h: dict, _b: list) -> dict:
        """Worker log lines from a node agent → "logs" topic (drivers
        with log_to_driver print them; ray: log_monitor → GCS pubsub)."""
        await self.publisher.publish(
            "logs", {"node_id": h.get("node_id", "?"),
                     "lines": h.get("lines", [])})
        return {}

    # ------------------------------------------------------------------ KV
    async def rpc_kv_put(self, h: dict, b: list) -> dict:
        ns = self.kv.setdefault(h.get("ns", ""), {})
        existed = h["key"] in ns
        if not (h.get("no_overwrite") and existed):
            ns[h["key"]] = b[0] if b else b""
        return {"existed": existed}

    async def rpc_kv_get(self, h: dict, _b: list) -> tuple[dict, list]:
        ns = self.kv.get(h.get("ns", ""), {})
        val = ns.get(h["key"])
        return {"found": val is not None}, ([val] if val is not None else [])

    async def rpc_kv_del(self, h: dict, _b: list) -> dict:
        ns = self.kv.get(h.get("ns", ""), {})
        return {"deleted": ns.pop(h["key"], None) is not None}

    async def rpc_kv_keys(self, h: dict, _b: list) -> dict:
        ns = self.kv.get(h.get("ns", ""), {})
        prefix = h.get("prefix", "")
        return {"keys": [k for k in ns if k.startswith(prefix)]}

    async def rpc_kv_multiget(self, h: dict, _b: list) -> tuple[dict, list]:
        """Batched kv_get: explicit `keys`, or every key under a
        `prefix` — ONE round trip where list_metrics used to pay one
        per worker (the values ride back as blobs in key order)."""
        ns = self.kv.get(h.get("ns", ""), {})
        keys = h.get("keys")
        if keys is None:
            prefix = h.get("prefix", "")
            keys = [k for k in ns if k.startswith(prefix)]
        found, blobs = [], []
        for k in keys:
            val = ns.get(k)
            if val is not None:
                found.append(k)
                blobs.append(val)
        return {"keys": found}, blobs

    # --------------------------------------------------------------- actors
    def _register_actor(self, h: dict, blobs: list) -> dict:
        """Register one actor + hand it to the scheduler (ray:
        HandleRegisterActor/HandleCreateActor gcs_actor_manager.cc:311,
        335).  Shared by the single verb and the batched create_actors."""
        name = h.get("name")
        namespace = h.get("namespace", "default")
        if name:
            key = (namespace, name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing and existing.state != DEAD:
                    if h.get("get_if_exists"):
                        return {"actor_id": existing.actor_id, "existing": True}
                    return {"error": f"actor name {name!r} already taken"}
        actor = ActorInfo(
            actor_id=h["actor_id"], name=name, namespace=namespace,
            owner_addr=h["owner_addr"], creation_spec=list(blobs),
            creation_header=h["creation_header"],
            resources=h.get("resources", {}), max_restarts=h.get("max_restarts", 0),
            detached=h.get("detached", False),
        )
        actor.affinity_node_id = h.get("affinity_node_id")
        actor.affinity_soft = h.get("affinity_soft", False)
        actor.label_hard = h.get("label_hard")
        actor.label_soft = h.get("label_soft")
        self.actors[actor.actor_id] = actor
        if name:
            self.named_actors[(namespace, name)] = actor.actor_id
        # A resolver may have raced ahead of this (batched) registration.
        for fut in self._unknown_actor_waiters.pop(actor.actor_id, ()):
            if not fut.done():
                fut.set_result(None)
        self._enqueue_actor(actor)
        return {"actor_id": actor.actor_id}

    async def rpc_create_actor(self, h: dict, blobs: list) -> dict:
        return self._register_actor(h, blobs)

    async def rpc_create_actors(self, h: dict, blobs: list) -> dict:
        """Batched registration: a driver's burst of N creations lands as
        ONE controller round trip; per-actor blob frames are multiplexed
        in order (h["actors"][i]["nblobs"] frames each)."""
        results = []
        off = 0
        for spec in h["actors"]:
            n = int(spec.get("nblobs", 0))
            results.append(self._register_actor(spec, blobs[off:off + n]))
            off += n
        return {"results": results}

    # ------------------------------------------------- actor wave scheduler
    def _enqueue_actor(self, actor: ActorInfo) -> None:
        if actor.queued or actor.state not in (PENDING, RESTARTING):
            return
        actor.queued = True
        self._actor_queue.append(actor)
        self._actor_wave_wake.set()

    def _requeue_actor_later(self, actor: ActorInfo, delay: float) -> None:
        """Backoff requeue (agent refusals / dispatch failures): an
        immediate requeue would spin the wave loop hot against the same
        stale view."""
        if delay <= 0:
            self._enqueue_actor(actor)
        else:
            asyncio.get_running_loop().call_later(
                delay, self._enqueue_actor, actor)

    async def _actor_wave_loop(self) -> None:
        """The scheduler wave: pending actors accumulate for one tick,
        are placed against a single cluster view, grouped by target node,
        and dispatched as ONE create_actors bulk verb per agent (ray:
        GcsActorScheduler batching)."""
        while True:
            await self._actor_wave_wake.wait()
            if self.config.actor_wave_tick_s > 0:
                await asyncio.sleep(self.config.actor_wave_tick_s)
            self._actor_wave_wake.clear()
            batch, self._actor_queue = self._actor_queue, []
            for a in batch:
                a.queued = False
            batch = [a for a in batch if a.state in (PENDING, RESTARTING)]
            if not batch:
                continue
            try:
                await self._run_actor_wave(batch)
            except Exception:  # noqa: BLE001
                logger.exception("actor wave failed; rescheduling %d "
                                 "actor(s)", len(batch))
                for a in batch:
                    self._requeue_actor_later(
                        a, self.config.actor_restart_backoff_s)

    async def _actor_unpark_loop(self) -> None:
        """Re-queue parked (infeasible) actors when capacity appears:
        node registration or a heartbeat reporting more availability set
        _actor_retry.  The timeout leg is only a
        missed-signal safety net — NOT the primary retry mechanism."""
        while True:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(self._actor_retry.wait(),
                                       4 * self.config.heartbeat_period_s)
            self._actor_retry.clear()
            if self._actor_parked:
                parked, self._actor_parked = self._actor_parked, []
                for a in parked:
                    self._enqueue_actor(a)

    async def _run_actor_wave(self, batch: list[ActorInfo]) -> None:
        t0 = time.time()
        view = self._cluster_view()
        # Scratch availability, decremented per placement: one wave must
        # not overbook a node against the shared stale view.
        scratch = {nid: dict(n["available"]) for nid, n in view.items()}
        sview = {nid: {**n, "available": scratch[nid]}
                 for nid, n in view.items()}
        by_node: dict[str, list[ActorInfo]] = {}
        parked = 0
        for actor in batch:
            strategy = None
            if actor.affinity_node_id:
                strategy = sched.NodeAffinity(actor.affinity_node_id,
                                              soft=actor.affinity_soft)
            node_id = sched.pick_node(sview, actor.resources, self.config,
                                      strategy=strategy,
                                      label_hard=actor.label_hard,
                                      label_soft=actor.label_soft)
            if node_id is None:
                self._actor_parked.append(actor)
                parked += 1
                continue
            for k, v in actor.resources.items():
                scratch[node_id][k] = scratch[node_id].get(k, 0.0) - v
            by_node.setdefault(node_id, []).append(actor)
        granted = refused = 0
        events: list[dict] = []
        if by_node:
            outs = await asyncio.gather(
                *[self._dispatch_wave(nid, actors)
                  for nid, actors in by_node.items()])
            for evs, ref in outs:
                events.extend(evs)
                refused += ref
            granted = len(events)
        if events:
            # ONE batched pub-sub message for the whole wave's ALIVE
            # storm (subscribers iterate the batch).
            await self.publisher.publish("actor", {"batch": events})
        spans.emit("actor.wave", t0, time.time(), attrs={
            "count": len(batch), "nodes": len(by_node),
            "granted": granted, "refused": refused, "parked": parked})

    async def _dispatch_wave(self, node_id: str,
                             actors: list[ActorInfo]) -> tuple[list, int]:
        """ONE create_actors RPC carrying every actor of this wave placed
        on node_id.  Returns (alive events, refused count); refused and
        transport-failed actors are re-queued (partial grants reschedule
        only the refused actors)."""
        backoff = self.config.actor_restart_backoff_s
        node = self.nodes.get(node_id)
        try:
            # Failpoint window: mid-wave on the controller side (error =
            # this node's whole sub-wave reschedules).
            if failpoints.ACTIVE:
                await failpoints.fire_async("controller.actor_wave")
            if node is None or node.state != "ALIVE":
                raise RuntimeError(f"node {node_id[:12]} left the view")
            header = {"actors": [
                {"actor_id": a.actor_id,
                 "creation_header": a.creation_header,
                 "resources": a.resources,
                 "owner_addr": a.owner_addr,
                 "nblobs": len(a.creation_spec)} for a in actors]}
            blobs = [f for a in actors for f in a.creation_spec]
            reply, _ = await self.clients.get(node.agent_addr).call(
                "create_actors", header, blobs, timeout=120.0)
            results = reply.get("results", {})
        except Exception as e:  # noqa: BLE001
            logger.warning("actor wave on %s failed: %s — rescheduling "
                           "%d actor(s)", node_id[:12], e, len(actors))
            for a in actors:
                self._requeue_actor_later(a, backoff)
            return [], 0
        events: list[dict] = []
        refused = 0
        for a in actors:
            r = results.get(a.actor_id) or {}
            if a.state not in (PENDING, RESTARTING):
                # Killed while the wave was in flight: a grant must not
                # resurrect it — tear the placement down at the agent.
                if r.get("ok"):
                    with contextlib.suppress(Exception):
                        await self.clients.get(node.agent_addr).notify(
                            "destroy_actor", {"actor_id": a.actor_id})
                continue
            if r.get("ok"):
                events.append(self._actor_alive(
                    a, node_id, r["worker_addr"]))
            elif r.get("error"):
                await self._fail_actor(a, r["error"])
            else:
                refused += 1
                self._requeue_actor_later(a, backoff)
        return events, refused

    def _actor_alive(self, actor: ActorInfo, node_id: str,
                     worker_addr: str) -> dict:
        actor.state = ALIVE
        actor.address = worker_addr
        actor.node_id = node_id
        for fut in actor.waiters:
            if not fut.done():
                fut.set_result(None)
        actor.waiters.clear()
        return {"event": "alive", "actor_id": actor.actor_id,
                "address": actor.address}

    async def _fail_actor(self, actor: ActorInfo, cause: str) -> None:
        actor.state = DEAD
        actor.death_cause = cause
        actor.died_at = time.monotonic()
        for fut in actor.waiters:
            if not fut.done():
                fut.set_result(None)
        actor.waiters.clear()
        await self.publisher.publish(
            "actor", {"event": "dead", "actor_id": actor.actor_id,
                      "cause": cause})

    def _gc_actor_tombstones(self, now: float) -> int:
        """Bounded DEAD-actor directory: tombstones keep death_cause
        visible for the grace window, then drop; the table is also
        hard-capped (oldest first) so 10k-actor churn cannot grow the
        controller resident set without bound.  Runs off the health
        loop's tick."""
        grace = self.config.actor_tombstone_grace_s
        cap = max(0, self.config.actor_tombstone_max)
        dead = sorted((a for a in self.actors.values() if a.state == DEAD),
                      key=lambda a: a.died_at or 0.0)
        excess = len(dead) - cap
        dropped = 0
        for i, a in enumerate(dead):
            expired = a.died_at is not None and now - a.died_at > grace
            if i >= excess and not expired:
                continue
            self.actors.pop(a.actor_id, None)
            key = (a.namespace, a.name)
            if a.name and self.named_actors.get(key) == a.actor_id:
                del self.named_actors[key]
            dropped += 1
        return dropped

    async def _on_actor_dead(self, actor: ActorInfo, cause: str) -> None:
        """Restart if budget remains (ray: GcsActorManager::OnWorkerDead
        gcs_actor_manager.cc:991)."""
        if actor.state == DEAD:
            return
        unlimited = actor.max_restarts < 0
        if unlimited or actor.restarts_used < actor.max_restarts:
            actor.restarts_used += 1
            actor.state = RESTARTING
            actor.address = None
            actor.node_id = None
            await self.publisher.publish(
                "actor", {"event": "restarting", "actor_id": actor.actor_id})
            self._enqueue_actor(actor)
        else:
            await self._fail_actor(actor, cause)

    async def rpc_report_worker_death(self, h: dict, _b: list) -> dict:
        """Broadcast a dead worker ADDRESS so every process gates its
        sends/resolutions (ray: GCS WORKER_FAILURE pubsub)."""
        await self.publisher.publish(
            "worker", {"event": "dead", "addr": h.get("addr", "")})
        return {}

    async def rpc_report_actor_death(self, h: dict, _b: list) -> dict:
        actor = self.actors.get(h["actor_id"])
        if actor:
            if h.get("no_restart"):
                actor.max_restarts = 0
            await self._on_actor_dead(actor, h.get("cause", "worker died"))
        return {}

    async def rpc_get_actor_info(self, h: dict, _b: list) -> dict:
        """Resolve an actor to an address; long-polls until ALIVE or DEAD."""
        actor = self.actors.get(h["actor_id"])
        if actor is None and h.get("wait"):
            # A handle can cross processes AHEAD of its batched, still
            # in-flight registration: park briefly for the registration
            # to land instead of answering UNKNOWN (which resolvers
            # treat as terminally dead).  Short grace: the race window
            # is one flush RPC (~ms), and a genuinely unknown id — e.g.
            # a tombstone-GC'd long-dead actor — must not stall its
            # resolver for long.
            fut = asyncio.get_running_loop().create_future()
            waiters = self._unknown_actor_waiters.setdefault(
                h["actor_id"], [])
            waiters.append(fut)
            try:
                await asyncio.wait_for(
                    fut, timeout=min(2.0, h.get("timeout", 60.0)))
            except asyncio.TimeoutError:
                pass
            finally:
                with contextlib.suppress(ValueError):
                    waiters.remove(fut)
                if not waiters:
                    self._unknown_actor_waiters.pop(h["actor_id"], None)
            actor = self.actors.get(h["actor_id"])
        if actor is None:
            return {"state": "UNKNOWN"}
        if h.get("wait") and actor.state in (PENDING, RESTARTING):
            fut = asyncio.get_running_loop().create_future()
            actor.waiters.append(fut)
            try:
                await asyncio.wait_for(fut, timeout=h.get("timeout", 60.0))
            except asyncio.TimeoutError:
                pass
        return {"state": actor.state, "address": actor.address,
                "node_id": actor.node_id, "cause": actor.death_cause}

    async def rpc_get_actor_by_name(self, h: dict, _b: list) -> dict:
        actor_id = self.named_actors.get(
            (h.get("namespace", "default"), h["name"]))
        if actor_id is None:
            return {"found": False}
        actor = self.actors.get(actor_id)
        if actor is None or actor.state == DEAD:
            # The name table keeps dead entries (the creation taken-check
            # tolerates them); a lookup must not hand out a handle to a
            # terminally dead actor — callers treat "found" as "usable"
            # (e.g. destroy_collective_group killing a leftover
            # rendezvous would otherwise always "find" the old corpse).
            return {"found": False}
        return {"found": True, "actor_id": actor_id}

    async def rpc_remove_actor(self, h: dict, _b: list) -> dict:
        """ray_tpu_torch.kill() / handle GC: tear the actor down, no restart."""
        actor = self.actors.get(h["actor_id"])
        if actor is None:
            return {}
        actor.max_restarts = 0
        node = self.nodes.get(actor.node_id) if actor.node_id else None
        if node is not None and node.state == "ALIVE":
            try:
                await self.clients.get(node.agent_addr).call(
                    "destroy_actor", {"actor_id": actor.actor_id},
                    timeout=10.0)
            except Exception:  # noqa: BLE001
                pass
        await self._fail_actor(actor, h.get("cause", "killed via ray_tpu_torch.kill"))
        return {}

    # ------------------------------------------------------------ state API
    async def rpc_list_nodes(self, h: dict, _b: list) -> dict:
        return {"nodes": [
            {"node_id": n.node_id, "state": n.state, "agent_addr": n.agent_addr,
             "resources": n.resources, "available": n.available}
            for n in self.nodes.values()]}

    async def rpc_list_actors(self, h: dict, _b: list) -> dict:
        return {"actors": [
            {"actor_id": a.actor_id, "name": a.name, "state": a.state,
             "node_id": a.node_id, "address": a.address,
             "restarts": a.restarts_used, "resources": a.resources,
             "function_id": a.creation_header.get("function_id", ""),
             "class_name": a.creation_header.get("class_name", "")}
            for a in self.actors.values()]}

    async def rpc_push_task_events(self, h: dict, _b: list) -> dict:
        """Task state-transition events for the timeline
        (ray: GcsTaskManager gcs_task_manager.h:86)."""
        self._tasks_events.extend(h.get("events", []))
        cap = self.config.task_event_buffer_size * 16
        if len(self._tasks_events) > cap:
            self._tasks_events = self._tasks_events[-cap:]
        return {}

    async def rpc_get_task_events(self, h: dict, _b: list) -> dict:
        return {"events": self._tasks_events[-h.get("limit", 10000):]}

    async def rpc_register_job(self, h: dict, _b: list) -> dict:
        self.jobs[h["job_id"]] = {"state": "RUNNING", "start": time.time(),
                                  "driver_addr": h.get("driver_addr")}
        return {}

    async def rpc_job_finished(self, h: dict, _b: list) -> dict:
        j = self.jobs.get(h["job_id"])
        if j is not None:
            j["state"] = "FINISHED"
            j["end"] = time.time()
        return {}

    async def rpc_failpoints(self, h: dict, _b: list) -> dict:
        """Cluster-wide fault-injection control verb: apply to the
        controller itself and, with broadcast=True, fan out to every
        ALIVE agent (each of which fans out to its workers)."""
        local = failpoints.control(
            {k: v for k, v in h.items() if k != "broadcast"})
        if h.get("broadcast"):
            # Concurrent fan-out: per-agent calls are independent, and a
            # wedged-but-ALIVE agent (exactly what this subsystem tests)
            # must cost ONE 15s timeout, not 15s × unreachable agents.
            alive = [n for n in list(self.nodes.values())
                     if n.state == "ALIVE"]

            async def _one(node):
                try:
                    reply, _ = await self.clients.get(node.agent_addr).call(
                        "failpoints", h, timeout=15.0)
                    return node.node_id, reply
                except Exception as e:  # noqa: BLE001 - node churning
                    return node.node_id, {"error": repr(e)}

            local["nodes"] = dict(await asyncio.gather(
                *(_one(n) for n in alive)))
        return local

    async def _harvest_agent_fanout(self, verb: str, h: dict) -> dict:
        """Fan a harvest verb out to every ALIVE agent (each of which
        fans to its workers) — the failpoints-verb shape shared by the
        spans/telemetry/memory verbs: a wedged agent costs ONE bounded
        timeout, concurrently, and its hole surfaces as {"error"}."""
        alive = [n for n in list(self.nodes.values())
                 if n.state == "ALIVE"]

        async def _one(node):
            try:
                reply, _ = await self.clients.get(node.agent_addr).call(
                    verb, h, timeout=15.0)
                return node.node_id, reply
            except Exception as e:  # noqa: BLE001 - node churning
                return node.node_id, {"error": repr(e)}

        return dict(await asyncio.gather(*(_one(n) for n in alive)))

    async def _harvest_driver_fanout(self, verb: str,
                                     sub: dict) -> dict:
        """Fan a harvest verb out to every RUNNING job driver.  Job
        DRIVERS are workers no agent supervises, yet they hold harvest
        state like any worker — objects they own, the span that ROOTS
        every serve request they submitted, the metric series of a
        driver-resident engine; without this leg an external observer
        (`ray-tpu memory/slow/top` attaching as its own driver) reads
        partial tables and disconnected trees.  A driver that answers
        neither the verb nor a ping is demoted to UNREACHABLE so stale
        jobs cost only a short probe on later harvests (clean exits
        report job_finished and are skipped outright) — and PROMOTED
        BACK to RUNNING the moment one answers again: a single missed
        window (stalled IO thread, steal burst) must not hide a live
        driver's state forever."""
        async def _drv(jid, j):
            addr = j["driver_addr"]
            demoted = j.get("state") == "UNREACHABLE"
            try:
                reply, _ = await self.clients.get(addr).call(
                    verb, sub, timeout=3.0 if demoted else 10.0)
                if demoted:
                    j["state"] = "RUNNING"
                return jid, reply
            except Exception as e:  # noqa: BLE001
                if not demoted:
                    try:
                        await self.clients.get(addr).call(
                            "ping", {}, timeout=5.0)
                        return jid, {"error": repr(e)}
                    except Exception:  # noqa: BLE001 - driver gone
                        j["state"] = "UNREACHABLE"
                return jid, {"error": f"driver unreachable: {e!r}",
                             "gone": True}

        drivers = [(jid, j) for jid, j in list(self.jobs.items())
                   if j.get("state") in ("RUNNING", "UNREACHABLE")
                   and j.get("driver_addr")]
        return dict(await asyncio.gather(
            *(_drv(jid, j) for jid, j in drivers)))

    async def rpc_spans(self, h: dict, _b: list) -> dict:
        """Cluster-wide flight-recorder harvest: this controller's span
        buffer and, with broadcast=True, every ALIVE agent's (each of
        which fans out to its workers) plus every RUNNING job driver's
        (drivers hold the spans that ROOT serve requests) — the
        failpoints-verb fan-out shape, so a wedged agent costs ONE
        bounded timeout."""
        sub = {k: v for k, v in h.items() if k != "broadcast"}
        local = spans.control(sub)
        if h.get("broadcast"):
            local["nodes"], local["drivers"] = await asyncio.gather(
                self._harvest_agent_fanout("spans", h),
                self._harvest_driver_fanout("spans", sub))
        return local

    async def rpc_telemetry(self, h: dict, _b: list) -> dict:
        """Cluster-wide telemetry-timeline harvest: this controller's
        metrics-snapshot ring and, with broadcast=True, every ALIVE
        agent's (each of which fans out to its workers) — the
        spans-verb fan-out shape, so a wedged agent costs ONE bounded
        timeout and the merged timeline degrades to
        partial-with-diagnostic.  RUNNING job drivers join the fan-out
        (a driver-resident engine's series live nowhere else)."""
        raise NotImplementedError(
            "the telemetry timeline is not ported yet (ROADMAP.md queue 1: "
            "the telemetry timeline)")

    async def rpc_memory(self, h: dict, _b: list) -> dict:
        """Cluster-wide object-ledger harvest: this controller's ledger
        reply and, with broadcast=True, every ALIVE agent's (each of
        which joins in its arena pin table and fans out to its
        workers) — the spans-verb fan-out shape, so a wedged agent
        costs ONE bounded timeout and the merged table degrades to
        partial-with-diagnostic."""
        sub = {k: v for k, v in h.items() if k != "broadcast"}
        local = memledger.control(sub)
        if h.get("broadcast"):
            # Drivers own objects no agent supervises — see
            # _harvest_driver_fanout (shared with spans/telemetry).
            local["nodes"], local["drivers"] = await asyncio.gather(
                self._harvest_agent_fanout("memory", h),
                self._harvest_driver_fanout("memory", sub))
        return local

    async def rpc_modules(self, h: dict, _b: list) -> dict:
        """This process's pid and the top-level packages it has imported
        (the port's layout check: no jax, ray_tpu, zmq, msgpack,
        cloudpickle or psutil)."""
        return process_modules()

    async def rpc_ping(self, h: dict, _b: list) -> dict:
        return {"pong": True, "t": time.time(),
                "pub_addr": self.publisher.address}


def _watch_parent() -> None:
    import threading

    def _loop():
        while True:
            if os.getppid() <= 1:
                os._exit(0)
            time.sleep(1.0)

    threading.Thread(target=_loop, daemon=True, name="parent-watch").start()


def main() -> None:
    from ray_tpu_torch._private.stack_dump import install as _install_stack

    _install_stack('controller')
    from ray_tpu_torch._private.config import tune_gc

    tune_gc()
    import argparse
    import json as _json
    import sys

    _watch_parent()
    p = argparse.ArgumentParser()
    p.add_argument("--config-json", default="{}")
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s controller: %(message)s")
    from ray_tpu_torch.logging_config import configure_process_logging
    configure_process_logging()
    config = Config().override(_json.loads(args.config_json))

    async def _run():
        from ray_tpu_torch._private.stack_dump import register_loop
        register_loop(asyncio.get_running_loop())
        c = Controller(config, port=args.port or None)
        await c.start()
        # Hand the chosen addresses back to the parent over stdout.
        print(_json.dumps({"controller_addr": c.server.address,
                           "pub_addr": c.publisher.address}), flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
