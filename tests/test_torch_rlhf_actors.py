"""The port's RLHF actor topology on the ray_tpu runtime, on the CPU.

The classes of ray_tpu_torch.rl run as ray_tpu actors through the seam's
binding (tests/torch_ray_runtime.py `RayTpuRuntime`): two rollout
workers, the learner in an actor or in the trainer, the packed weight
broadcast over `ray_tpu.collective`.  The model is tests/test_rlhf_chaos.py's
(vocab 128, dim 64, 2 layers, f32) with the port's params from a seed, so
no JAX runs here.  The chaos arms are the reference suite's:

- `rl.rollout_step=nth:1+crash` on a rollout actor: the step completes
  on a regenerated group, `rollout_regens` is 1, the replacement carries
  the current policy, and no KV block leaks;
- `rl.weight_sync=nth:1+crash` on the learner actor: it resumes from the
  newest completed checkpoint, `learner_restarts` is 1 and `epoch` is at
  least 2.

Also the in-trainer learner, and `update_weights` with shard refs.  The
runtime boots once for the module and is shut down after it only if it
booted here; every get has a timeout."""
import os
import time

import numpy as np
import pytest
import torch

from torch_ray_runtime import RayTpuRuntime

T = 120.0
ENGINE = dict(max_batch=8, max_len=128, page_size=8, steps_per_sync=3)


@pytest.fixture(scope="module")
def rt():
    import ray_tpu

    started = not ray_tpu.is_initialized()
    if started:
        ray_tpu.init(resources={"CPU": 6})
    yield ray_tpu
    if started:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def small():
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq=256, remat=False, dtype=torch.float32)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(7))


def _classes():
    """Armable rollout and learner classes, shipped by value (defined in
    a function), on one torch thread each."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class ArmableWorker(LLMRolloutWorker):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

        def arm(self, site, action):
            import os as _os

            from ray_tpu._private import failpoints as fp

            fp.arm(site, action)
            return _os.getpid()

    class ArmableLearner(GRPOLearner):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

        def arm(self, site, action):
            import os as _os

            from ray_tpu._private import failpoints as fp

            fp.arm(site, action)
            return _os.getpid()

    return ArmableWorker, ArmableLearner


def _trainer(small, tmp_path, **kw):
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer

    cfg, params = small
    worker_cls, learner_cls = _classes()
    base = dict(model=cfg, params=params, seed=0, n_prompts=4,
                prompt_len=10, group_size=4, prompts_per_step=2,
                max_new_tokens=5, lr=1e-2, device="cpu",
                runtime=RayTpuRuntime(), num_rollout_workers=2,
                remote_learner=True, checkpoint_every=1,
                checkpoint_dir=str(tmp_path / "ckpt"),
                worker_cls=worker_cls, learner_cls=learner_cls,
                engine=dict(ENGINE))
    base.update(kw)
    return RLHFTrainer(RLHFConfig(**base))


def _wait_versions(rt, workers, want, timeout=60.0):
    """recv_weights returns at staging; the swap lands between windows."""
    deadline = time.monotonic() + timeout
    vs = []
    while time.monotonic() < deadline:
        vs = [rt.get(w.stats.remote(), timeout=T)["weight_version"]
              for w in workers]
        if vs == want:
            return vs
        time.sleep(0.1)
    return vs


def _wait_dead(pid: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.1)
    raise AssertionError(f"armed pid {pid} still alive: the failpoint "
                         "never fired")


def test_update_weights_multi_ref_shards(rt, small):
    """A push of refs to disjoint top-level slices of the param dict
    merges into the tree; non-dict shards are refused."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    cfg, params = small
    w = LLMRolloutWorker(cfg, params=params, engine=dict(ENGINE),
                         device="cpu", runtime=RayTpuRuntime())
    try:
        new = llama.init_params(cfg, torch.Generator().manual_seed(5))
        refs = [rt.put({k: new[k]}) for k in new]
        assert w.update_weights(refs, 4) == 4
        deadline = time.monotonic() + 30
        while w.stats()["weight_version"] < 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        for k in new:
            got = w.engine.params[k]
            leaves = got.values() if isinstance(got, dict) else [got]
            want = new[k].values() if isinstance(got, dict) else [new[k]]
            assert all(torch.equal(a, b) for a, b in zip(leaves, want)), k
        assert w.update_weights(rt.put(params), 5) == 5
        with pytest.raises(ValueError, match="dict shards"):
            w.update_weights([rt.put({"embed": new["embed"]}),
                              rt.put([1, 2])])
    finally:
        w.stop()


def test_actor_workers_with_in_driver_learner(rt, small, tmp_path):
    """Actor rollout workers and the learner in the trainer: the trainer
    is rank 0 of the broadcast group."""
    tr = _trainer(small, tmp_path, remote_learner=False,
                  checkpoint_every=0)
    try:
        ms = [tr.step() for _ in range(2)]
        assert [m["version"] for m in ms] == [1, 2]
        assert [m["epoch"] for m in ms] == [1, 1]
        assert tr.stats()["worker_versions"] == [2, 2]
        assert _wait_versions(rt, tr.workers, [2, 2]) == [2, 2]
        assert all(np.isfinite(m["loss"]) for m in ms)
    finally:
        tr.shutdown()


def test_rollout_actor_crash_regenerates_group(rt, small, tmp_path):
    tr = _trainer(small, tmp_path)
    try:
        assert tr.step()["version"] == 1
        pid = rt.get(tr.workers[0].arm.remote(
            "rl.rollout_step", "nth:1+crash"), timeout=T)
        m = tr.step()
        assert m["version"] == 2
        assert m["rollout_regens"] == 1 == tr.stats()["rollout_regens"]
        _wait_dead(pid)
        # The replacement booted at version 0 and was pushed the policy.
        assert _wait_versions(rt, tr.workers, [2, 2]) == [2, 2]
        m = tr.step()
        assert m["version"] == 3 and np.isfinite(m["loss"])
        assert m["rollout_regens"] == 1
        for w in tr.workers:
            assert rt.get(w.kv_check.remote(), timeout=T)["ok"]
    finally:
        tr.shutdown()


def test_learner_crash_resumes_from_newest_checkpoint(rt, small, tmp_path):
    tr = _trainer(small, tmp_path)
    try:
        tr.step()
        tr.step()
        newest = tr.flush_checkpoints()
        assert newest is not None and newest[0] == 2
        epoch_before = tr.stats()["epoch"]
        pid = rt.get(tr.learner.arm.remote("rl.weight_sync", "nth:1+crash"),
                     timeout=T)
        m = tr.step()             # update v3, the sync crashes, resume v2
        _wait_dead(pid)
        st = tr.stats()
        assert m["version"] == 3 and m["learner_restarts"] == 1
        assert st["learner_restarts"] == 1
        assert st["version"] == 2 and st["worker_versions"] == [2, 2]
        assert st["epoch"] > epoch_before and st["epoch"] >= 2
        m = tr.step()
        assert m["version"] == 3 and np.isfinite(m["loss"])
        assert tr.stats()["worker_versions"] == [3, 3]
        for w in tr.workers:
            assert rt.get(w.kv_check.remote(), timeout=T)["ok"]
    finally:
        tr.shutdown()
