"""The port's RL algorithms' training loops on the ray_tpu runtime, on
the CPU.

The env runners and learners of ray_tpu_torch.rl run as ray_tpu actors
through the seam's binding (tests/torch_ray_runtime.py `RayTpuRuntime`),
each on one torch thread; no JAX runs here.  The runtime boots once for
the module and is shut down after it only if it booted here; every get
has a timeout.

- PPO, one env runner, two step()s: every batch equal bit for bit to the
  same algorithm's on a `LocalRuntime` handed the same params before each
  step, the params within 1e-4 after each;
- BC: the offline batch is put into the object store once and the
  updates take its ref;
- `cleanup()` leaves no actor of the algorithm alive."""
import copy
import time

import numpy as np
import pytest

from torch_ray_runtime import RayTpuRuntime

T = 120.0
TOL4 = dict(atol=1e-4, rtol=1e-4)


class CappedRuntime(RayTpuRuntime):
    """RayTpuRuntime whose actors run on one torch thread and whose gets
    wait at most T seconds."""

    def remote(self, cls):
        import ray_tpu

        class OneThread(cls):
            def __init__(self, *a, **kw):
                import torch as _torch

                _torch.set_num_threads(1)
                super().__init__(*a, **kw)

        return ray_tpu.remote(OneThread)

    def get(self, ref, timeout=None):
        return super().get(ref, timeout=T if timeout is None else timeout)


@pytest.fixture(scope="module")
def rt():
    import ray_tpu

    started = not ray_tpu.is_initialized()
    if started:
        ray_tpu.init(resources={"CPU": 6})
    yield ray_tpu
    if started:
        ray_tpu.shutdown()


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


def _actor_ids(algo) -> set:
    handles = algo.env_runner_group.runners + algo.learner_group.learners
    return {h.actor_id for h in handles}


def _assert_all_dead(ids: set) -> None:
    from ray_tpu.utils import state

    deadline = time.monotonic() + 60
    alive = ids
    while time.monotonic() < deadline:
        alive = {a["actor_id"] for a in state.list_actors()
                 if a["actor_id"] in ids and a["state"] != "DEAD"}
        if not alive:
            return
        time.sleep(0.2)
    raise AssertionError(f"actors still alive after cleanup: {alive}")


def test_ppo_on_the_cluster_matches_local_runtime(rt):
    from ray_tpu_torch.serve.runtime import LocalRuntime

    local_rt = LocalRuntime()
    remote = _ppo().build(runtime=CappedRuntime(), device="cpu")
    local = _ppo().build(runtime=local_rt, device="cpu")
    ids = _actor_ids(remote)
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
            np.testing.assert_array_equal(r_remote["episode_return_mean"],
                                          r_local["episode_return_mean"])
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


def test_bc_takes_its_offline_ref(rt):
    from ray_tpu import ObjectRef

    from ray_tpu_torch.rl import BCConfig

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(96, 4)).astype(np.float32)
    data = {"obs": obs, "actions": (obs[:, 2] > 0).astype(np.int64)}
    cfg = (BCConfig().environment("CartPole-v1")
           .training(lr=1e-2, num_sgd_iter=4, minibatch_size=32)
           .offline(offline_data=data).debugging(seed=0))
    cfg.hidden = 16
    cfg.eval_episodes = 1
    algo = cfg.build(runtime=CappedRuntime(), device="cpu")
    ids = _actor_ids(algo)
    try:
        assert isinstance(algo._offline_ref, ObjectRef)
        assert len(algo.env_runner_group.runners) == 1     # the eval runner
        first = algo.step()
        second = algo.step()
        assert second["num_env_steps_sampled_lifetime"] == 2 * 96
        assert second["env_runners"]["num_episodes"] >= 2
        assert second["learner/bc_loss"] < first["learner/bc_loss"]
        assert second["learner/action_accuracy"] > 0.5
    finally:
        algo.cleanup()
    _assert_all_dead(ids)
