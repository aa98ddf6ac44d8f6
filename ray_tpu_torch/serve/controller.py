"""ServeController: the reconciling control plane for serve (port of
ray_tpu/serve/controller.py).

Analog of ray: python/ray/serve/_private/controller.py (ServeController,
run_control_loop:372) + deployment_state.py (DeploymentState reconciler) +
deployment_scheduler.py.

A *threaded* actor (not asyncio): the control loop and RPC methods run on
the actor's thread pool so they may freely make blocking framework calls
(create actor / get / kill) — the same reason the reference runs its
reconciler off the replica event loops.  Replica membership is versioned;
handles poll `get_deployment_info` (the long-poll analog of ray:
_private/long_poll.py LongPollHost).

Concurrency discipline: the controller lock only guards in-memory state —
no RPC is ever made while holding it.  Replica starts/health checks are
asynchronous (pending ObjectRefs polled each reconcile tick), so one slow
replica init never stalls reconciliation of other deployments (ray:
deployment_state starts replicas async and polls readiness).

Not ported (ROADMAP.md queue 1: serve): the per-node HTTP proxies and
the gRPC ingress (`_reconcile_proxies`, `set_http_options`,
`list_proxies`, `get_app_routes`), autoscaling with the SLO loop
(`_autoscale*`, `set_autoscale_enabled`; a deployment with an
`autoscaling_config` is refused at `deploy_app`), the autoscaler demand
floor, the PD pool rebalance and the memory observation pass.  The
directory verbs `prefix_store_*` and `lora_*` keep the reference's names
over the port's `StoreDirectory` and `AdapterDirectory`, less the
`summary` views only the cut routing reads.
"""
from __future__ import annotations

import logging
import threading
import time
import traceback
from typing import Any

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"
RECONCILE_PERIOD_S = 0.2
REPLICA_INIT_TIMEOUT_S = 120.0


class _DeploymentState:
    """Target spec + live replicas for one deployment (ray:
    deployment_state.py DeploymentState)."""

    def __init__(self, app: str, name: str, cls, init_args, init_kwargs,
                 config, version: str):
        self.app = app
        self.name = name
        self.cls = cls
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.config = config
        self.version = version
        self.target_replicas = config.num_replicas
        # replica actor_id -> {"handle", "state", "init_ref", "init_deadline",
        #                      "health_ref", "health_deadline", "last_health"}
        self.replicas: dict[str, dict] = {}
        # Old-version replicas still serving during a rolling code update;
        # advertised only until the new version is up (ray: gradual rollout).
        self.draining: dict[str, dict] = {}
        self.membership_version = 0
        self.deleting = False
        self.superseded = False   # replaced by a newer _DeploymentState


class ServeController:
    """Named detached actor; one per cluster (ray: controller.py:86)."""

    def __init__(self):
        from ray_tpu_torch.serve.lora import AdapterDirectory
        from ray_tpu_torch.serve.prefix_store import StoreDirectory

        self._lock = threading.RLock()
        # app -> {"route_prefix", "ingress", "deployments": {name: state}}
        self._apps: dict[str, dict] = {}
        # Tier-2 prefix-store directory (serve/prefix_store.py): hash →
        # demoted-subtree entries published by the replicas.  Scrubbed
        # with the app (delete_app) and with each dead replica.
        self._prefix_store = StoreDirectory()
        # Multi-LoRA adapter registry (serve/lora.py): model_id →
        # sealed-adapter object ref + version.  Cluster-scoped, cleared at
        # graceful_shutdown — the directory holds the primary refs.
        self._lora = AdapterDirectory()
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._run_control_loop, daemon=True, name="serve-ctrl")
        self._thread.start()

    # ------------------------------------------------------------ public RPC
    def deploy_app(self, app_name: str, route_prefix: str, ingress: str,
                   deployments: list[dict]) -> None:
        """Declarative (re)deploy of a whole app (ray: serve.run →
        controller.deploy_apps).  Never blocks on replica RPCs: code
        changes hand old replicas to the new state's drain list; config
        changes are applied by the reconcile loop."""
        for d in deployments:
            if d["config"].autoscaling_config is not None:
                raise NotImplementedError(
                    f"deployment {d['name']!r}: autoscaling_config is not "
                    "ported yet (ROADMAP.md queue 1: serve, autoscaling "
                    "and the SLO loop); set num_replicas instead")
        reconfigures: list[tuple[Any, Any]] = []
        with self._lock:
            app = self._apps.setdefault(
                app_name, {"route_prefix": route_prefix, "ingress": ingress,
                           "deployments": {}})
            app["route_prefix"] = route_prefix
            app["ingress"] = ingress
            new_names = {d["name"] for d in deployments}
            for name, st in list(app["deployments"].items()):
                if name not in new_names:
                    st.deleting = True
                    st.target_replicas = 0
            for d in deployments:
                cur = app["deployments"].get(d["name"])
                if cur is not None and cur.version == d["version"] \
                        and not cur.deleting:
                    # Config-only change: rescale/reconfigure in place
                    # (ray: deployment_state config-change classification).
                    old_user_config = cur.config.user_config
                    cur.config = d["config"]
                    cur.target_replicas = d["config"].num_replicas
                    if d["config"].user_config is not None and \
                            d["config"].user_config != old_user_config:
                        reconfigures.append((cur, d["config"].user_config))
                    continue
                new_st = _DeploymentState(
                    app_name, d["name"], d["cls"], d["init_args"],
                    d["init_kwargs"], d["config"], d["version"])
                if cur is not None:
                    cur.superseded = True
                    # Old replicas keep serving until the new version is up.
                    new_st.draining.update(cur.replicas)
                    new_st.draining.update(cur.draining)
                app["deployments"][d["name"]] = new_st
        for st, user_config in reconfigures:
            self._reconfigure_in_place(st, user_config)

    def _reconfigure_in_place(self, st: _DeploymentState, user_config) -> None:
        import ray_tpu_torch

        with self._lock:
            handles = [rec["handle"] for rec in st.replicas.values()
                       if rec["state"] == "RUNNING"]
        refs = [h.reconfigure.remote(user_config) for h in handles]
        for ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=30.0)
            except Exception:  # noqa: BLE001
                logger.warning("reconfigure failed:\n%s",
                               traceback.format_exc())

    def delete_app(self, app_name: str) -> None:
        with self._lock:
            app = self._apps.get(app_name)
            if app is None:
                return
            for st in app["deployments"].values():
                st.deleting = True
                st.target_replicas = 0
        # The deleted app's demoted prefix entries must not outlive it
        # (the directory's borrowed refs go here; the replicas drop their
        # primary refs in LLMServer.shutdown during drain).
        self._prefix_store.forget(app_name)

    def get_deployment_info(self, app_name: str, deployment: str) -> dict:
        with self._lock:
            st = self._state(app_name, deployment)
            if st is None:
                return {"version": -1, "replicas": [], "max_ongoing": 0}
            running = [rid for rid, rec in st.replicas.items()
                       if rec["state"] == "RUNNING"]
            if not running:
                # During a rolling update the old version keeps serving.
                running = [rid for rid, rec in st.draining.items()
                           if rec["state"] == "RUNNING"]
            return {
                "version": st.membership_version,
                "replicas": running,
                "max_ongoing": st.config.max_ongoing_requests,
            }

    def app_ingress(self, app_name: str) -> str | None:
        """The ingress deployment of `app_name` (None if it has none
        alive); `serve.get_app_handle` reads it (the reference reads the
        proxies' route table, `get_app_routes`)."""
        with self._lock:
            app = self._apps.get(app_name)
            if app is None or all(st.deleting
                                  for st in app["deployments"].values()):
                return None
            return app["ingress"]

    def replica_metrics(self, app_name: str | None = None,
                        deployment: str | None = None) -> dict:
        """Per-replica metrics incl. the user callable's own stats()
        (e.g. the LLM engine's KV-cache hit/preempt counters) — the serve
        state API's detail surface (ray: serve application details'
        replica_details).  Fanned out OUTSIDE the lock: a slow replica
        must not wedge the control loop.  `deployment` narrows the
        fan-out to one deployment."""
        import ray_tpu_torch

        with self._lock:
            targets = []
            for an, app in self._apps.items():
                if app_name is not None and an != app_name:
                    continue
                for dname, st in app["deployments"].items():
                    if deployment is not None and dname != deployment:
                        continue
                    for rid, rec in st.replicas.items():
                        if rec["state"] == "RUNNING":
                            targets.append((an, dname, rid,
                                            rec["handle"]))
        out: dict = {}
        refs = []
        for an, dname, rid, handle in targets:
            try:
                refs.append((an, dname, rid,
                             handle.get_metrics.remote()))
            except Exception:  # noqa: BLE001 - replica mid-restart
                pass
        for an, dname, rid, ref in refs:
            try:
                m = ray_tpu_torch.get(ref, timeout=5.0)
            except Exception:  # noqa: BLE001
                m = {"error": "unreachable"}
            out.setdefault(an, {}).setdefault(dname, {})[rid[:12]] = m
        return out

    # --------------------------------------------- prefix-store verbs
    # Thin RPC surface over the StoreDirectory (serve/prefix_store.py):
    # replicas publish/withdraw demoted subtrees and the miss path looks
    # up the deepest stored prefix.  All logic lives in the directory.
    def prefix_store_publish(self, app: str, meta: dict, ref) -> dict:
        return self._prefix_store.publish(app, meta, ref)

    def prefix_store_lookup(self, app: str, hashes: list, page: int,
                            seed, weight_version: int | None = None,
                            min_depth: int = 0):
        return self._prefix_store.lookup(
            app, hashes, page, seed, weight_version=weight_version,
            min_depth=min_depth)

    def prefix_store_forget(self, app: str, replica: str | None = None,
                            below_version: int | None = None,
                            hashes: list | None = None) -> int:
        return self._prefix_store.forget(
            app, replica=replica, below_version=below_version,
            hashes=hashes)

    def prefix_store_stats(self) -> dict:
        return self._prefix_store.stats()

    # ------------------------------------------------ multi-LoRA verbs
    # Thin RPC surface over the AdapterDirectory (serve/lora.py):
    # drivers publish/withdraw adapters, replicas look them up for the
    # page-in miss path.  All logic lives in the directory.
    def lora_publish(self, model_id: str, meta: dict, ref) -> dict:
        return self._lora.publish(model_id, meta, ref)

    def lora_lookup(self, model_id: str):
        return self._lora.lookup(model_id)

    def lora_forget(self, model_id: str) -> bool:
        return self._lora.forget(model_id)

    def lora_stats(self) -> dict:
        return self._lora.stats()

    def status(self) -> dict:
        """Serve status tree (ray: serve.status / ServeStatusSchema)."""
        with self._lock:
            out = {}
            for app_name, app in self._apps.items():
                deps = {}
                for name, st in app["deployments"].items():
                    running = sum(1 for r in st.replicas.values()
                                  if r["state"] == "RUNNING")
                    deps[name] = {
                        "status": ("DELETING" if st.deleting else
                                   "HEALTHY" if running >= st.target_replicas
                                   else "UPDATING"),
                        "replicas": running,
                        "target_replicas": st.target_replicas,
                        # Seconds from each running replica's creation to
                        # RUNNING, which the init deadline bounds.
                        "replica_init_s": {
                            rid[:12]: r["init_s"]
                            for rid, r in st.replicas.items()
                            if r["state"] == "RUNNING"},
                    }
                alive = any(not st.deleting
                            for st in app["deployments"].values())
                out[app_name] = {
                    "status": "RUNNING" if alive and all(
                        d["status"] == "HEALTHY" for d in deps.values())
                    else "DELETING" if not alive else "DEPLOYING",
                    "route_prefix": app["route_prefix"],
                    "deployments": deps,
                }
            return out

    def graceful_shutdown(self) -> None:
        with self._lock:
            for app in self._apps.values():
                for st in app["deployments"].values():
                    st.deleting = True
                    st.target_replicas = 0
        self._prefix_store.clear()
        # Published adapters die with serve (the directory holds their
        # primary refs — dropping the entries releases the arena bytes).
        self._lora.clear()

    def wait_for_deployments_ready(self, app_name: str,
                                   timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                app = self._apps.get(app_name)
                if app is not None:
                    states = [st for st in app["deployments"].values()
                              if not st.deleting]
                    if states and all(
                        sum(1 for r in st.replicas.values()
                            if r["state"] == "RUNNING") >= st.target_replicas
                            and st.target_replicas > 0
                            for st in states):
                        return True
            time.sleep(0.05)
        return False

    # --------------------------------------------------------- control loop
    def _state(self, app_name: str, deployment: str) -> _DeploymentState | None:
        app = self._apps.get(app_name)
        if app is None:
            return None
        return app["deployments"].get(deployment)

    def _run_control_loop(self) -> None:
        """ray: controller.py:372 run_control_loop."""
        while not self._shutdown.is_set():
            try:
                self._reconcile_once()
            except Exception:  # noqa: BLE001
                logger.error("reconcile error:\n%s", traceback.format_exc())
            time.sleep(RECONCILE_PERIOD_S)

    def _reconcile_once(self) -> None:
        with self._lock:
            states = [st for app in self._apps.values()
                      for st in app["deployments"].values()]
        for st in states:
            # A state replaced by deploy_app mid-snapshot must not be
            # reconciled: starting replicas into it would leak actors.
            with self._lock:
                if st.superseded or self._state(st.app, st.name) is not st:
                    continue
            self._reconcile_deployment(st)
        with self._lock:
            for app_name, app in list(self._apps.items()):
                for name, st in list(app["deployments"].items()):
                    if st.deleting and not st.replicas and not st.draining:
                        del app["deployments"][name]
                if not app["deployments"]:
                    del self._apps[app_name]

    def _reconcile_deployment(self, st: _DeploymentState) -> None:
        """Start/stop replicas toward target; poll pending inits and
        health checks (ray: deployment_state.py update loop)."""
        self._poll_starting(st)
        self._poll_health(st)

        with self._lock:
            running = {rid: rec for rid, rec in st.replicas.items()
                       if rec["state"] == "RUNNING"}
            starting = sum(1 for rec in st.replicas.values()
                           if rec["state"] == "STARTING")
            n = len(running) + starting
            target = st.target_replicas
        if n < target:
            for _ in range(target - n):
                self._start_replica(st)
        elif len(running) > target:
            extra = list(running)[target - len(running):] if target else \
                list(running)
            for rid in extra[:len(running) - target]:
                self._remove_replica(st, rid, drain=True)
        # Rolling update: once the new version serves, retire the old.
        with self._lock:
            new_up = any(rec["state"] == "RUNNING"
                         for rec in st.replicas.values())
            drain_now = (list(st.draining.items())
                         if (new_up and len(running) >= target) or st.deleting
                         else [])
            for rid, _rec in drain_now:
                st.draining.pop(rid, None)
        for _rid, rec in drain_now:
            self._stop_replica(rec, drain=True,
                               timeout=st.config.graceful_shutdown_timeout_s)

    def _poll_starting(self, st: _DeploymentState) -> None:
        """Flip STARTING→RUNNING when the init probe resolves (non-blocking;
        ray: replica startup polling in deployment_state)."""
        import ray_tpu_torch

        with self._lock:
            pending = [(rid, rec) for rid, rec in st.replicas.items()
                       if rec["state"] == "STARTING"]
        for rid, rec in pending:
            ready, _ = ray_tpu_torch.wait([rec["init_ref"]], timeout=0)
            if ready:
                try:
                    ray_tpu_torch.get(ready[0], timeout=1.0)
                    with self._lock:
                        rec["state"] = "RUNNING"
                        rec["last_health"] = time.monotonic()
                        # The span REPLICA_INIT_TIMEOUT_S bounds.
                        rec["init_s"] = rec["last_health"] - rec["started"]
                        st.membership_version += 1
                except Exception:  # noqa: BLE001
                    logger.error("replica init failed:\n%s",
                                 traceback.format_exc())
                    self._remove_replica(st, rid, drain=False)
            elif time.monotonic() > rec["init_deadline"]:
                logger.error("replica %s init timed out", rid[:12])
                self._remove_replica(st, rid, drain=False)

    def _poll_health(self, st: _DeploymentState) -> None:
        """Issue/collect health probes without blocking (ray:
        deployment_state health-check polling)."""
        import ray_tpu_torch

        with self._lock:
            running = [(rid, rec) for rid, rec in st.replicas.items()
                       if rec["state"] == "RUNNING"]
        for rid, rec in running:
            ref = rec.get("health_ref")
            if ref is not None:
                ready, _ = ray_tpu_torch.wait([ref], timeout=0)
                if ready:
                    rec["health_ref"] = None
                    try:
                        ray_tpu_torch.get(ready[0], timeout=1.0)
                        rec["last_health"] = time.monotonic()
                    except Exception:  # noqa: BLE001
                        logger.warning(
                            "replica %s failed health check; replacing",
                            rid[:12])
                        self._remove_replica(st, rid, drain=False)
                elif time.monotonic() > rec["health_deadline"]:
                    logger.warning("replica %s health check timed out",
                                   rid[:12])
                    self._remove_replica(st, rid, drain=False)
            elif time.monotonic() - rec.get("last_health", 0) \
                    >= st.config.health_check_period_s:
                rec["health_ref"] = rec["handle"].check_health.remote()
                rec["health_deadline"] = time.monotonic() + \
                    st.config.health_check_timeout_s

    def _start_replica(self, st: _DeploymentState) -> None:
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        actor_opts = dict(st.config.ray_actor_options)
        actor_opts.setdefault("num_cpus", 0.1)
        actor_opts["max_concurrency"] = max(
            8, st.config.max_ongoing_requests + 2)
        started = time.monotonic()
        try:
            handle = ray_tpu_torch.remote(Replica).options(
                **actor_opts).remote(
                st.cls, st.init_args, st.init_kwargs,
                st.config.max_ongoing_requests, st.config.user_config,
                app_name=st.app, deployment=st.name,
                max_queued_requests=st.config.max_queued_requests)
        except Exception:  # noqa: BLE001
            logger.error("replica start failed:\n%s", traceback.format_exc())
            return
        rid = handle.actor_id
        init_ref = handle.check_health.remote()
        with self._lock:
            if st.superseded or self._state(st.app, st.name) is not st:
                # Lost a race with a redeploy: don't leak the actor.
                ray_tpu_torch.kill(handle)
                return
            st.replicas[rid] = {
                "handle": handle, "state": "STARTING",
                "init_ref": init_ref,
                "started": started,
                "init_deadline": started + REPLICA_INIT_TIMEOUT_S,
                "health_ref": None, "health_deadline": 0.0,
                "last_health": time.monotonic()}

    def _remove_replica(self, st: _DeploymentState, rid: str,
                        drain: bool) -> None:
        with self._lock:
            rec = st.replicas.pop(rid, None)
            st.membership_version += 1
        # A removed replica's demoted prefix entries are doomed (its
        # objects die with the owning process): scrub them so lookups
        # don't chase dead refs.  Drained replicas withdraw themselves
        # too (LLMServer.shutdown); this covers crashes and health-check
        # kills.
        self._prefix_store.forget(st.app, replica=rid)
        if rec is not None:
            rec["state"] = "STOPPING"
            self._stop_replica(rec, drain=drain,
                               timeout=st.config.graceful_shutdown_timeout_s)

    def _stop_replica(self, rec: dict, drain: bool = True,
                      timeout: float = 5.0) -> None:
        import ray_tpu_torch

        if drain:
            try:
                ray_tpu_torch.get(rec["handle"].prepare_for_shutdown.remote(),
                                  timeout=timeout)
            except Exception:  # noqa: BLE001
                pass
        try:
            ray_tpu_torch.kill(rec["handle"])
        except Exception:  # noqa: BLE001
            pass
