"""The port's paths on its own runtime, through `ClusterRuntime`
(ray_tpu_torch/serve/runtime.py), on the CPU.

One cluster of the port (`ray_tpu_torch.init(resources={"CPU": 4,
"GPU": 1})`) boots for the module and is shut down after it; every get
has a timeout.

- The actor face, as tests/test_torch_local_runtime.py checks it on
  `LocalRuntime`: max_concurrency and ref arguments, a kill that fails
  later calls with `ActorDiedError`, `resolve_tree` over refs; the serve
  face before `serve.start()` (tests/test_torch_serve_port.py runs it
  with serve up).
- PPO's first two step()s through `config.build(runtime=ClusterRuntime(),
  device="cpu")`, held as tests/test_torch_rl_cluster.py holds
  `RayTpuRuntime`: each batch equal bit for bit to the same algorithm's
  on a `LocalRuntime` handed the same params, the params within 1e-4; a
  learner asked for CUDA in a worker with no CUDA device raises.
- An `LLMRolloutWorker` actor on the `debug` preset in f32 (params by
  one put, a positional argument the runtime resolves): its greedy
  rollout equals the in-process worker's and the
  reference's (ray_tpu.rl.rollout_llm on JAX, temperature 0)."""
import copy
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.serve.runtime import ClusterRuntime, resolve_tree

T = 120.0
TOL4 = dict(atol=1e-4, rtol=1e-4)
ENGINE = dict(max_batch=8, max_len=128, page_size=8, steps_per_sync=3)
PROMPT = [(i * 7 + 3) % 127 + 1 for i in range(12)]
PROMPTS = [PROMPT[:10], [p % 120 + 1 for p in PROMPT[:10]]]


class CappedRuntime(ClusterRuntime):
    """ClusterRuntime whose actors run on one torch thread and whose gets
    wait at most T seconds."""

    def remote(self, cls):
        class OneThread(cls):
            def __init__(self, *a, **kw):
                import torch as _torch

                _torch.set_num_threads(1)
                super().__init__(*a, **kw)

        return ray_tpu_torch.remote(OneThread)

    def get(self, ref, timeout=None):
        return super().get(ref, timeout=T if timeout is None else timeout)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        yield ClusterRuntime()
    finally:
        ray_tpu_torch.shutdown()


class Sleeper:
    def __init__(self):
        self.lock = threading.Lock()
        self.running = self.peak = 0

    def hold(self, s):
        import time as _time

        with self.lock:
            self.running += 1
            self.peak = max(self.peak, self.running)
        _time.sleep(s)
        with self.lock:
            self.running -= 1
        return self.peak

    def echo(self, x):
        return x


def test_actor_face(cluster):
    rt = cluster
    four = rt.remote(Sleeper).options(num_cpus=1,
                                      max_concurrency=4).remote()
    assert max(rt.get([four.hold.remote(0.3) for _ in range(4)],
                      timeout=T)) == 4
    one = rt.remote(Sleeper).remote()
    assert max(rt.get([one.hold.remote(0.05) for _ in range(3)],
                      timeout=T)) == 1
    # A top-level ref argument resolves before the method runs; a nested
    # one is handed over as it is.
    ref = one.echo.remote({"a": 1})
    assert rt.get(one.echo.remote(ref), timeout=T) == {"a": 1}
    nested = rt.get(one.echo.remote([ref]), timeout=T)
    assert rt.is_ref(nested[0]) and rt.get(nested, timeout=T) == [{"a": 1}]
    # resolve_tree: one ref to a tree, and dict shards that merge.
    shards = [rt.put({"w": np.ones(2)}), rt.put({"b": np.zeros(1)})]
    tree = resolve_tree(rt, shards, timeout=T)
    assert sorted(tree) == ["b", "w"]
    assert resolve_tree(rt, rt.put({"x": 1}), timeout=T) == {"x": 1}
    assert resolve_tree(rt, {"y": 2}) == {"y": 2}
    # A kill fails later calls with ActorDiedError.
    rt.kill(one)
    with pytest.raises(ray_tpu_torch.ActorDiedError):
        rt.get(one.echo.remote(9), timeout=T)
    rt.kill(four)
    assert rt.failpoint("rl.rollout_step") is None
    with rt.memory_tag("rollout"):
        pass
    # The collective, tracing, metric and serve faces are bound.  With
    # serve not started, the driver is in no replica, there is no
    # controller, and a deployment handle cannot be had.
    assert isinstance(rt.tracing_enabled(), bool)
    rt.metric("counter", "paths_face_calls").inc()
    assert rt.get_rank("never-formed") == -1
    assert rt.replica_context() is None
    assert rt.controller() is None
    with pytest.raises(RuntimeError, match="serve is not running"):
        rt.deployment_handle("d", "a")


# ----------------------------------------------------------------- PPO
def _ppo():
    from ray_tpu_torch.rl import PPOConfig

    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=1)
           .training(lr=3e-4, train_batch_size=64, num_sgd_iter=1,
                     minibatch_size=32)
           .debugging(seed=0))
    cfg.hidden = 16
    return cfg


def _record(algo) -> list:
    batches = []
    update = algo.learner_group.update

    def rec(batch, *a, **k):
        batches.append(copy.deepcopy(batch))
        return update(batch, *a, **k)

    algo.learner_group.update = rec
    return batches


def _hand(algo, params: dict) -> None:
    rt = algo.runtime
    rt.get([ln.set_params.remote(params)
            for ln in algo.learner_group.learners], timeout=T)
    algo._params_np = algo.learner_group.get_params_numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_all_dead(ids: set) -> None:
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    deadline = time.monotonic() + 60
    alive = ids
    while time.monotonic() < deadline:
        reply, _ = core.call(core.controller_addr, "list_actors",
                             timeout=30.0)
        alive = {a["actor_id"] for a in reply["actors"]
                 if a["actor_id"] in ids and a["state"] != "DEAD"}
        if not alive:
            return
        time.sleep(0.2)
    raise AssertionError(f"actors still alive after cleanup: {alive}")


def test_ppo_on_the_port_runtime_matches_local_runtime(cluster):
    from ray_tpu_torch.serve.runtime import LocalRuntime

    local_rt = LocalRuntime()
    remote = _ppo().build(runtime=CappedRuntime(), device="cpu")
    local = _ppo().build(runtime=local_rt, device="cpu")
    handles = remote.env_runner_group.runners + remote.learner_group.learners
    ids = {h.actor_id for h in handles}
    try:
        assert len(ids) == 2
        got, want = _record(remote), _record(local)
        for step in range(2):
            _hand(local, remote._params_np)
            r_remote, r_local = remote.step(), local.step()
            assert len(got) == len(want) == step + 1
            for k, w in want[-1].items():
                np.testing.assert_array_equal(got[-1][k], w, err_msg=k)
            assert r_remote["num_env_steps_sampled_lifetime"] == \
                r_local["num_env_steps_sampled_lifetime"] == 64 * (step + 1)
            np.testing.assert_allclose(r_remote["learner/loss"],
                                       r_local["learner/loss"], **TOL4)
            mine = dict(_leaves(local._params_np))
            for path, v in _leaves(remote._params_np):
                np.testing.assert_allclose(v, mine[path], err_msg=path,
                                           **TOL4)
    finally:
        remote.cleanup()
        local.cleanup()
        local_rt.shutdown()
    _assert_all_dead(ids)


def test_cuda_learner_without_a_device_raises(cluster):
    """device="cuda" in a worker that sees no CUDA device raises, on a
    plain worker and on the device worker alike; nothing runs on the
    CPU in its place."""
    for gpus in (0, 1):
        cfg = _ppo().learners(num_gpus_per_learner=gpus)
        with pytest.raises(Exception, match="CUDA"):
            cfg.build(runtime=CappedRuntime(), device="cuda")


# ------------------------------------------------------- rollout actor
@pytest.fixture(scope="module")
def debug():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    np_params = jax.tree.map(np.array, jparams)
    return jcfg, jparams, tcfg, params_from_jax(np_params, tcfg,
                                                device="cpu")


def _greedy(w):
    try:
        return w.rollout(PROMPTS, group_size=4, max_new_tokens=5,
                         temperature=0.0)
    finally:
        w.stop()


def test_rollout_worker_actor_matches_in_process_and_reference(cluster,
                                                               debug):
    from ray_tpu.rl.rollout_llm import LLMRolloutWorker as JaxWorker
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    jcfg, jparams, tcfg, tparams = debug
    want = _greedy(JaxWorker(jcfg, params=jparams, seed=0,
                             engine=dict(ENGINE)))
    local = _greedy(LLMRolloutWorker(tcfg, params=tparams, seed=0,
                                     engine=dict(ENGINE), device="cpu"))
    class ByRef(LLMRolloutWorker):
        """Takes its params as a positional argument, which the runtime
        resolves from a ref before the constructor runs."""

        def __init__(self, model, params, **kw):
            super().__init__(model, params=params, **kw)

    rt = CappedRuntime()
    actor = rt.remote(ByRef).remote(tcfg, rt.put(tparams), seed=0,
                                    engine=dict(ENGINE), device="cpu")
    try:
        got = rt.get(actor.rollout.remote(PROMPTS, group_size=4,
                                          max_new_tokens=5,
                                          temperature=0.0))
    finally:
        rt.get(actor.stop.remote())
        rt.kill(actor)
    for key in ("tokens", "mask", "prompt_len", "total_len", "rewards"):
        np.testing.assert_array_equal(got[key], local[key], err_msg=key)
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["logprobs"], local["logprobs"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                               atol=1e-5, rtol=0)
