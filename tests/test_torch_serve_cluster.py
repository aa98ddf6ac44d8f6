"""The port's LLMServer deployed on ray_tpu serve, through the runtime
seam's binding (tests/torch_ray_runtime.py `RayTpuRuntime`), on the CPU.

The `debug` preset in float32, page 8, max_batch 2, steps_per_sync 4,
seed 11 (tests/test_pd_disagg.py's engine knobs), one parameter tree on
both sides (`params_from_jax`).  Deployed as the reference deploys its
own (tests/serve_test_app.py, tests/test_pd_disagg.py `_pd_app`):

- a unified deployment with two LoRA slots of rank 4, and an adapter
  registered through the serve controller's directory (`LoraClient`
  publish through the runtime; the replica pages it in through the
  controller and pulls it through the object plane);
- a prefill / decode pair, the KV pages put into the object plane by the
  prefill replica and pulled by the decode replica.

Against the reference `LLMServer` deployed with the same knobs, params
and adapter: the greedy tokens of base requests on the unified and PD
deployments, and of adapter requests.  The runtime and serve boot once
for the module (each shut down after it only if it started here); every
wait has a timeout."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from torch_ray_runtime import RayTpuRuntime

T = 180.0
EKW = dict(max_batch=2, max_len=64, page_size=8, steps_per_sync=4,
           seed=11)
PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
           for k, n in ((7, 13), (5, 21))]
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
    np_params = jax.tree.map(np.array,
                             jl.init_params(jax.random.PRNGKey(7), jcfg))
    jad = jax.tree.map(np.array, jl.init_lora_adapter(
        jax.random.PRNGKey(1), jcfg, 4))
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, np_params=np_params, jad=jad,
        tparams=params_from_jax(np_params, tcfg, device="cpu"),
        tad=lora_adapter_from_jax(jad, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def serve_rt():
    import ray_tpu
    from ray_tpu import serve

    started = not ray_tpu.is_initialized()
    if started:
        ray_tpu.init(resources={"CPU": 6})
    serve.start()
    yield serve
    serve.shutdown()
    if started:
        ray_tpu.shutdown()


def _port_server():
    """The port's LLMServer on one torch thread, shipped by value."""
    from ray_tpu_torch.serve.llm import LLMServer

    class PortLLMServer(LLMServer):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

    return PortLLMServer


def _apps(serve, m):
    from ray_tpu.serve.llm import LLMServer as RefServer

    port_cls = _port_server()
    port_kw = dict(params=m.tparams, device="cpu", runtime=RayTpuRuntime(),
                   **EKW)
    ref_kw = dict(params=m.np_params, **EKW)

    def unified(cls, name, cfg, kw):
        return serve.deployment(cls).options(
            name=name, max_ongoing_requests=4).bind(
                cfg, lora_slots=2, lora_rank=4, **kw)

    def pd(cls, prefix, cfg, kw):
        decode = serve.deployment(cls).options(
            name=f"{prefix}_decode", max_ongoing_requests=4).bind(
                cfg, role="decode", **kw)
        return serve.deployment(cls).options(
            name=f"{prefix}_prefill", max_ongoing_requests=4).bind(
                cfg, role="prefill", decode_deployment=decode, **kw)

    return {
        "ref_unified": unified(RefServer, "ref_llm", m.jcfg, ref_kw),
        "port_unified": unified(port_cls, "port_llm", m.tcfg, port_kw),
        "ref_pd": pd(RefServer, "ref", m.jcfg, ref_kw),
        "port_pd": pd(port_cls, "port", m.tcfg, port_kw),
    }


@pytest.fixture(scope="module")
def handles(serve_rt, m):
    from ray_tpu.serve.lora import LoraClient as RefLoraClient
    from ray_tpu_torch.serve.lora import LoraClient

    out = {name: serve_rt.run(app, name=name, route_prefix=f"/{name}")
           for name, app in _apps(serve_rt, m).items()}
    RefLoraClient().publish("ref/a", m.jad)
    LoraClient(runtime=RayTpuRuntime()).publish("port/a", m.tad)
    yield out
    for name in out:
        serve_rt.delete(name)


def _tokens(h, prompt, **kw):
    return h.remote({"prompt": prompt, "max_new_tokens": NEW, **kw}).result(
        timeout_s=T)


def test_unified_deployment_matches_reference(handles):
    for p in PROMPTS:
        want = _tokens(handles["ref_unified"], p)["tokens"]
        got = _tokens(handles["port_unified"], p)["tokens"]
        assert got == want and len(got) == NEW


def test_pd_pair_moves_kv_through_the_object_plane(handles):
    for p in PROMPTS:
        want = _tokens(handles["ref_pd"], p)
        got = _tokens(handles["port_pd"], p)
        assert want.get("disagg") is True and got.get("disagg") is True
        assert got["tokens"] == want["tokens"]
        assert got["tokens"] == _tokens(handles["port_unified"],
                                        p)["tokens"]


def test_adapter_through_the_controller_directory(handles):
    from ray_tpu_torch.serve.lora import LoraClient

    entry = LoraClient(runtime=RayTpuRuntime()).lookup("port/a")
    assert entry is not None and entry["rank"] == 4
    for p in PROMPTS:
        want = _tokens(handles["ref_unified"], p, model_id="ref/a")
        got = _tokens(handles["port_unified"], p, model_id="port/a")
        assert got["tokens"] == want["tokens"]
        assert got["tokens"] != _tokens(handles["port_unified"],
                                        p)["tokens"]
