"""Serve on the port's own runtime (`ray_tpu_torch.serve`: config,
deployments, replicas, handles and the controller), on the CPU.

One cluster of the port (`ray_tpu_torch.init(resources={"CPU": 4,
"GPU": 1})`) and one `serve.start()` boot for the module and are shut down
after it (the router test shuts serve down and starts it again); every
get, wait and `result` waits 60 s or less.

- The port's `LLMServer` deployed through `serve.run` (one replica in the
  device worker, `num_gpus=1`, on the CPU): the `debug` preset in f32,
  page 8, max_batch 2, steps_per_sync 4, seed 11, two LoRA slots of rank
  4, one parameter tree on both sides (`params_from_jax`).  Four
  concurrent greedy requests through a `DeploymentHandle` give the tokens
  of the JAX `LLMServer` in this process; an adapter published through
  the port's controller directory gives the JAX server's tokens with the
  same adapter; `replica_metrics` carries the server's stats.
- Plain deployments, as tests/test_serve.py drives the reference's:
  composition through a handle, two replicas both called, a user_config
  reconfigure in place, `get_replica_context` inside and outside.
- A killed replica: the controller's health poll replaces it and the
  handle's next calls succeed.
- The cut features raise NotImplementedError naming ROADMAP.md queue 1.
- The handles to a deployment share one router thread, which ends when
  idle and at `serve.shutdown()`.
- The worker's task and trace follow the call: two calls running at once
  on a threaded actor record spans under their own traces.

Tolerance: token identity at temperature 0."""
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.serve.runtime import ClusterRuntime

T = 60.0
EKW = dict(max_batch=2, max_len=64, page_size=8, steps_per_sync=4,
           seed=11)
PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
           for k, n in ((7, 21), (5, 13), (11, 30), (3, 9))]
NEW = 6


@pytest.fixture(scope="module")
def m():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import (lora_adapter_from_jax,
                                              params_from_jax)

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    jad = jax.tree.map(np.asarray, jl.init_lora_adapter(
        jax.random.PRNGKey(1), jcfg, 4))
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams,
        tparams=params_from_jax(np_params, tcfg, device="cpu"), jad=jad,
        tad=lora_adapter_from_jax(jad, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def serve():
    from ray_tpu_torch import serve as s

    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        s.start()
        yield s
    finally:
        try:
            s.shutdown()
        finally:
            ray_tpu_torch.shutdown()


def _port_server():
    """The port's LLMServer on one torch thread, shipped by value."""
    from ray_tpu_torch.serve.llm import LLMServer

    class PortLLMServer(LLMServer):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

    return PortLLMServer


def _jax_tokens(m, reqs, **kw):
    """The in-process JAX LLMServer's outputs for `reqs`, sent at once."""
    import asyncio

    from ray_tpu.serve.llm import LLMServer

    srv = LLMServer(m.jcfg, params=m.jparams, lora_slots=2, lora_rank=4,
                    **EKW, **kw)
    try:
        async def go():
            return await asyncio.gather(*(srv(r) for r in reqs))

        return [r["tokens"] for r in asyncio.run(
            asyncio.wait_for(go(), T))]
    finally:
        srv.shutdown()


def test_llm_deployment_matches_jax_server(serve, m):
    from ray_tpu.serve import lora as jlora
    from ray_tpu_torch.serve.lora import LoraClient

    app = serve.deployment(_port_server()).options(
        name="llm", max_ongoing_requests=4,
        ray_actor_options={"num_gpus": 1}).bind(
            m.tcfg, params=m.tparams, device="cpu",
            runtime=ClusterRuntime(), lora_slots=2, lora_rank=4, **EKW)
    h = serve.run(app, name="llm_app", timeout_s=T)
    try:
        base = [{"prompt": p, "max_new_tokens": NEW} for p in PROMPTS]
        got = [r.result(timeout_s=T)["tokens"]
               for r in [h.remote(q) for q in base]]
        assert got == _jax_tokens(m, base)
        assert all(len(t) == NEW for t in got)
        # An adapter through the port's controller directory against the
        # JAX server's in-process directory holding the same adapter.
        entry = LoraClient(runtime=ClusterRuntime()).publish("port/a",
                                                             m.tad)
        assert entry["version"] == 1
        jd = jlora.AdapterDirectory()
        jlora.LoraClient(directory=jd).publish("port/a", m.jad)
        tuned = [{**q, "model_id": "port/a"} for q in base[:2]]
        got_a = [r.result(timeout_s=T)["tokens"]
                 for r in [h.remote(q) for q in tuned]]
        assert got_a == _jax_tokens(m, tuned, lora_directory=jd)
        assert got_a != got[:2]
        rm = serve.replica_metrics("llm_app", deployment="llm")
        (stats,) = [r["user_stats"] for r in rm["llm_app"]["llm"].values()]
        assert stats["completed"] >= 6
        assert stats["lora"]["load_errors"] == 0
    finally:
        serve.delete("llm_app")


def test_composition_through_a_handle(serve):
    @serve.deployment
    class Adder:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, x):
            return x + self.offset

    @serve.deployment
    class Ingress:
        def __init__(self, adder):
            self.adder = adder

        async def __call__(self, x):
            partial = await self.adder.remote(x)
            return partial * 10

    h = serve.run(Ingress.bind(Adder.bind(5)), name="compose", timeout_s=T)
    try:
        assert h.remote(1).result(timeout_s=T) == 60
        st = serve.status()["compose"]
        assert st["status"] == "RUNNING"
        assert set(st["deployments"]) == {"Adder", "Ingress"}
        assert serve.get_app_handle("compose").remote(2).result(
            timeout_s=T) == 70
    finally:
        serve.delete("compose")


def test_two_replicas_both_receive_calls(serve):
    @serve.deployment(num_replicas=2, max_ongoing_requests=4)
    class WhoAmI:
        def __call__(self, _x):
            import os as _os
            import time as _time

            _time.sleep(0.05)
            return _os.getpid()

    h = serve.run(WhoAmI.bind(), name="lb", timeout_s=T)
    try:
        pids = {r.result(timeout_s=T) for r in [h.remote(i)
                                                for i in range(16)]}
        assert len(pids) == 2, pids
    finally:
        serve.delete("lb")


def test_user_config_reconfigures_in_place(serve):
    @serve.deployment(user_config={"threshold": 1})
    class Thresholder:
        def __init__(self):
            import os as _os

            self.threshold = None
            self.pid = _os.getpid()

        def reconfigure(self, config):
            self.threshold = config["threshold"]

        def __call__(self, _x):
            return self.threshold, self.pid

    h = serve.run(Thresholder.bind(), name="cfg", timeout_s=T)
    try:
        first, pid = h.remote(0).result(timeout_s=T)
        assert first == 1
        serve.run(Thresholder.options(user_config={"threshold": 7}).bind(),
                  name="cfg", timeout_s=T)
        deadline = time.monotonic() + T
        while h.remote(0).result(timeout_s=T)[0] != 7:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert h.remote(0).result(timeout_s=T) == (7, pid)
    finally:
        serve.delete("cfg")


def test_replica_context_inside_and_outside(serve):
    @serve.deployment
    class WhereAmI:
        def __call__(self, _req=None):
            from ray_tpu_torch import serve as _serve

            ctx = _serve.get_replica_context()
            rt = ClusterRuntime()
            return {"app": ctx.app_name, "dep": ctx.deployment,
                    "tag": ctx.replica_tag,
                    "self": ctx.servable_object is self,
                    "runtime_same": rt.replica_context() is ctx,
                    "controller": rt.controller() is not None}

    h = serve.run(WhereAmI.bind(), name="ctxapp", timeout_s=T)
    try:
        out = h.remote().result(timeout_s=T)
        assert out == {"app": "ctxapp", "dep": "WhereAmI",
                       "tag": out["tag"], "self": True,
                       "runtime_same": True, "controller": True}
        assert out["tag"]
        with pytest.raises(RuntimeError, match="inside a"):
            serve.get_replica_context()
        rt = ClusterRuntime()
        assert rt.replica_context() is None
        assert rt.controller() is not None
        assert rt.deployment_handle("WhereAmI", "ctxapp").remote().result(
            timeout_s=T)["tag"] == out["tag"]
    finally:
        serve.delete("ctxapp")


def test_killed_replica_is_replaced(serve):
    from ray_tpu_torch.actor import ActorHandle

    @serve.deployment(health_check_period_s=0.2)
    class Tagged:
        def __call__(self):
            from ray_tpu_torch import serve as _serve

            return _serve.get_replica_context().replica_tag

    h = serve.run(Tagged.bind(), name="heal", timeout_s=T)
    try:
        old = h.remote().result(timeout_s=T)
        ray_tpu_torch.kill(ActorHandle(old))
        deadline = time.monotonic() + T
        while True:
            st = serve.status()["heal"]["deployments"]["Tagged"]
            if st["replicas"] == 1 and h.remote().result(
                    timeout_s=T) != old:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.1)
        tags = {h.remote().result(timeout_s=T) for _ in range(4)}
        assert len(tags) == 1 and old not in tags
    finally:
        serve.delete("heal")


def test_cut_features_raise_naming_the_roadmap(serve):
    @serve.deployment
    def double(x):
        return 2 * x

    h = serve.run(double.bind(), name="fn_app", timeout_s=T)
    try:
        assert h.remote(21).result(timeout_s=T) == 42
        with pytest.raises(NotImplementedError, match="queue 1: serve"):
            h.options(stream=True)
    finally:
        serve.delete("fn_app")
    with pytest.raises(NotImplementedError, match="queue 1: serve"):
        serve.run(double.options(
            name="scaled", autoscaling_config={"max_replicas": 2}).bind(),
            name="auto_app", timeout_s=T)
    for cut in (serve.http_port, serve.grpc_port, serve.proxy_ports,
                serve.list_proxies, serve.batch, serve.multiplexed,
                serve.get_multiplexed_model_id):
        with pytest.raises(NotImplementedError, match="queue 1: serve"):
            cut()
    with pytest.raises(NotImplementedError, match="queue 1: serve"):
        serve.apply_config({"applications": []})
    with pytest.raises(NotImplementedError, match="queue 1: serve"):
        serve.start(http_options={"port": 0})


def _router_threads(prefix="serve-router:"):
    """The port's router threads whose name starts with `prefix` (the
    reference's, left by its serve tests in the same process, are named
    "serve-router-<deployment>" and never end)."""
    import threading

    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def test_router_threads_are_shared_and_end(serve):
    """Every handle to a deployment in this process shares one router
    thread, the handles that `options()`, `__getattr__`,
    `get_app_handle` and `get_deployment_handle` derive included; it ends
    when idle, and `serve.shutdown()` ends every router thread at once."""
    from ray_tpu_torch.serve import handle as handle_mod

    @serve.deployment
    class Echo:
        def __call__(self, x):
            return x

        def twice(self, x):
            return 2 * x

    h = serve.run(Echo.bind(), name="routers", timeout_s=T)
    try:
        derived = [h, h.options(method_name="__call__"),
                   serve.get_app_handle("routers"),
                   serve.get_deployment_handle("Echo", "routers")]
        for i, d in enumerate(derived * 3):
            assert d.remote(i).result(timeout_s=T) == i
            assert d.twice.remote(i).result(timeout_s=T) == 2 * i
            time.sleep(0.1)
        assert len({id(d._router) for d in derived}) == 1
        assert len(_router_threads("serve-router:routers/")) == 1
        deadline = time.monotonic() + 4 * handle_mod._ROUTER_IDLE_S
        while _router_threads("serve-router:routers/"):
            assert time.monotonic() < deadline
            time.sleep(0.2)
        # The next call through an ended router starts its thread again.
        assert h.remote(7).result(timeout_s=T) == 7
        assert len(_router_threads("serve-router:routers/")) == 1
    finally:
        serve.delete("routers")
    serve.shutdown()
    try:
        deadline = time.monotonic() + 10.0
        while _router_threads():
            assert time.monotonic() < deadline, _router_threads()
            time.sleep(0.1)
        with pytest.raises(RuntimeError, match="shut down"):
            h._router.put(None)
    finally:
        serve.start()


def test_concurrent_calls_keep_their_own_trace(serve):
    """Two calls run at once on one threaded actor, each submitted under
    its own driver span; both wait at a barrier, then record a span,
    and neither leaves it before both have opened theirs.  Each span
    (and the call's task id) is its own call's; a later call submitted
    outside any span sees neither trace."""
    from ray_tpu_torch import tracing

    class Twin:
        def __init__(self):
            import threading as _threading

            self.barrier = _threading.Barrier(2, timeout=30)

        def traced(self, wait):
            import ray_tpu_torch as _rt
            from ray_tpu_torch import tracing as _tr

            if wait:
                self.barrier.wait()
            with _tr.span("t.iso"):
                if wait:
                    self.barrier.wait()
                return (_tr.current()[0],
                        _rt.get_runtime_context().get_task_id())

    actor = ray_tpu_torch.remote(Twin).options(
        max_concurrency=2, num_cpus=0.1).remote()
    try:
        refs, tids = [], []
        for name in ("t.call_a", "t.call_b"):
            with tracing.span(name):
                tids.append(tracing.current()[0])
                refs.append(actor.traced.remote(True))
        got = ray_tpu_torch.get(refs, timeout=T)
        assert [g[0] for g in got] == tids and tids[0] != tids[1]
        assert got[0][1] != got[1][1] and None not in (got[0][1],
                                                        got[1][1])
        later = ray_tpu_torch.get(actor.traced.remote(False), timeout=T)
        assert later[0] not in tids and later[1] not in (got[0][1],
                                                         got[1][1])
    finally:
        ray_tpu_torch.kill(actor)
