"""The port's online RLHF loop on the CPU (ray_tpu_torch/rl/, with
train/checkpoint.py), against the JAX package in process.

tests/test_rlhf.py's `small` config (vocab 128, dim 64, 2 layers, f32)
and ENGINE_KW.  Across frameworks: group advantages and batch
concatenation to 1e-6; a greedy (temperature 0) rollout of 2 prompts x
group 4 equal to the JAX worker's in tokens, masks, lengths, rewards and
prefix-cache counts, logprobs to 1e-5; three learner updates on one
JAX-made temperature-1.0 batch with kl_coeff 0.1 (the later ones clip)
to 1e-5 in loss, policy loss, KL and ratio mean (relative above 1) and
1e-4 in params; and
`grpo_state_from_jax` continuing a JAX learner.  Within the port, the
reference's loop tests with their thresholds (learning, bit-identical
runs, frozen policy, config validation), and the port's own hazards:
async checkpoints snapshot before the next in-place update, a resumed
learner continues bitwise, a failed background write surfaces, and a
learner update after a sync never reaches the engine.  Every engine is
stopped in a `finally`; no test boots the ray_tpu runtime."""
import copy
import time
import types

import numpy as np
import pytest
import torch

ENGINE_KW = dict(max_batch=8, max_len=128, page_size=8,
                 steps_per_sync=3)
PROMPT = [(i * 7 + 3) % 127 + 1 for i in range(12)]
PROMPTS = [PROMPT[:10], [p % 120 + 1 for p in PROMPT[:10]]]
LOOP = dict(seed=0, n_prompts=4, prompt_len=10, group_size=4,
            prompts_per_step=2, max_new_tokens=5, temperature=1.0, lr=1e-2)


@pytest.fixture(scope="module")
def small():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    shape = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, ffn_dim=128, max_seq=256, remat=False)
    jcfg = jl.LlamaConfig(**shape, dtype=jnp.float32)
    tcfg = tl.LlamaConfig(**shape, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    np_params = jax.tree.map(np.array, jparams)
    return types.SimpleNamespace(
        jcfg=jcfg, jparams=jparams, tcfg=tcfg, np_params=np_params,
        tparams=params_from_jax(np_params, tcfg, device="cpu"))


def _jax_cfg(small, **kw):
    from ray_tpu.rl.rlhf import RLHFConfig

    return RLHFConfig(**{**LOOP, "model": small.jcfg,
                         "params": small.jparams,
                         "engine": dict(ENGINE_KW), **kw})


def _port_cfg(small, **kw):
    from ray_tpu_torch.rl.rlhf import RLHFConfig

    return RLHFConfig(**{**LOOP, "model": small.tcfg,
                         "params": small.tparams,
                         "engine": dict(ENGINE_KW), "device": "cpu", **kw})


def _np_tree(tree):
    """Host copies of a JAX tree (dicts, tuples and namedtuples kept)."""
    import jax

    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def ref(small):
    """The JAX side, run once: a greedy and a temperature-1.0 rollout of
    PROMPTS, then three updates of a JAX learner (kl_coeff 0.1) on the
    temperature-1.0 batch, with its params after each update and its
    whole state after the second."""
    from ray_tpu.rl.rlhf import GRPOLearner
    from ray_tpu.rl.rollout_llm import LLMRolloutWorker

    w = LLMRolloutWorker(small.jcfg, params=small.jparams, seed=0,
                         engine=dict(ENGINE_KW))
    try:
        greedy = w.rollout(PROMPTS, group_size=4, max_new_tokens=5,
                           temperature=0.0)
        batch = w.rollout(PROMPTS, group_size=4, max_new_tokens=5,
                          temperature=1.0)
    finally:
        w.stop()
    learner = GRPOLearner(_jax_cfg(small, kl_coeff=0.1))
    metrics, params, state2 = [], [], None
    for i in range(3):
        if i == 2:
            state2 = _np_tree({"params": learner.params,
                               "opt_state": learner.opt_state,
                               "version": np.asarray(learner.version)})
        m = learner.update(batch)
        metrics.append(m)
        params.append(_np_tree(learner.params))
    return types.SimpleNamespace(greedy=greedy, batch=batch,
                                 metrics=metrics, params=params,
                                 state2=state2)


def _leaves(tree):
    from ray_tpu_torch.train.step import param_leaves

    return [t.detach().numpy() if isinstance(t, torch.Tensor) else t
            for t in param_leaves(tree)]


def _assert_params_close(port, jax_tree, atol):
    for a, b in zip(_leaves(port), _leaves(jax_tree)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


# ------------------------------------------------------- across frameworks
def test_group_advantages_and_concat_match_reference():
    from ray_tpu.rl import rlhf as jr
    from ray_tpu_torch.rl import rlhf as tr

    rng = np.random.default_rng(0)
    r = rng.normal(size=24).astype(np.float32)
    r[8:12] = 0.5                          # degenerate groups: all equal
    r[16:20] = -2.0
    for eps in (1e-4, 1e-6):
        want = np.asarray(jr.group_advantages(r, 4, eps=eps))
        got = tr.group_advantages(r, 4, eps=eps)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[8:12], 0.0, atol=1e-6)
        t = tr.group_advantages(torch.from_numpy(r), 4, eps=eps)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_allclose(t.numpy(), want, atol=1e-6, rtol=0)
    # Two worker batches of different widths.
    trajs = []
    for k, (b, T) in enumerate(((4, 16), (8, 32))):
        trajs.append({
            "tokens": rng.integers(0, 128, (b, T)).astype(np.int32),
            "logprobs": -rng.random((b, T - 1)).astype(np.float32),
            "mask": (rng.random((b, T - 1)) > 0.5).astype(np.float32),
            "rewards": rng.random(b).astype(np.float32),
            "group_size": 4, "rollout_tokens": 10 * (k + 1),
            "weight_version": 3 - k})
    want, got = jr._concat_trajs(trajs), tr._concat_trajs(trajs)
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[key].dtype == v.dtype, key
            np.testing.assert_allclose(got[key], v, atol=1e-6, rtol=0)
        else:
            assert got[key] == v, key


def test_greedy_rollout_matches_jax_worker(small, ref):
    """Temperature 0: the JAX worker's trajectory, key for key."""
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    w = LLMRolloutWorker(small.tcfg, params=small.tparams, seed=0,
                         engine=dict(ENGINE_KW), device="cpu")
    try:
        got = w.rollout(PROMPTS, group_size=4, max_new_tokens=5,
                        temperature=0.0)
        w.kv_check()
    finally:
        w.stop()
    want = ref.greedy
    for key in ("tokens", "mask", "prompt_len", "total_len", "rewards"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("group_size", "weight_version", "rollout_tokens",
                "prefix_hit_tokens", "prefill_tokens"):
        assert got[key] == want[key], key
    assert got["logprobs"].dtype == np.float32
    np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                               atol=1e-5, rtol=0)
    # The group-sharing contract holds on the port too.
    assert got["prefix_hit_tokens"] >= 2 * 3 * 8
    assert got["prefill_tokens"] < 8 * 10


def test_learner_updates_match_jax(small, ref):
    """The same JAX-made temperature-1.0 batch three times, kl_coeff 0.1:
    the second and third updates run off-policy, so the ratio clips."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner

    learner = GRPOLearner(_port_cfg(small, kl_coeff=0.1))
    for i in range(3):
        m = learner.update(ref.batch)
        want = ref.metrics[i]
        assert m["version"] == want["version"] == i + 1
        np.testing.assert_allclose(m["advantages"], want["advantages"],
                                   atol=1e-6, rtol=0)
        for key in ("loss", "policy_loss", "kl", "ratio_mean"):
            # 1e-5, relative where the value passes 1 (the ratio mean is
            # about 4 once the policy has moved off the batch's).
            assert abs(m[key] - want[key]) \
                <= 1e-5 * max(1.0, abs(want[key])), (i, key, m[key],
                                                     want[key])
        for key in ("reward_mean", "reward_std", "rollout_tokens",
                    "batch_weight_version", "minibatches"):
            assert m[key] == pytest.approx(want[key], abs=1e-7), key
        _assert_params_close(learner.params, ref.params[i], 1e-4)
    # The later updates moved the ratio off 1: the clip is exercised.
    assert abs(ref.metrics[2]["ratio_mean"] - 1.0) > 1e-3


def test_grpo_state_from_jax_continues_jax_learner(small, ref):
    from ray_tpu_torch.models.convert import grpo_state_from_jax
    from ray_tpu_torch.rl.rlhf import GRPOLearner

    state = grpo_state_from_jax(ref.state2, small.tcfg, device="cpu")
    assert state["version"] == 2
    assert float(state["opt_state"]["count"]) == 2.0
    learner = GRPOLearner(_port_cfg(small, kl_coeff=0.1))
    assert learner.load_state(state) == 2
    m = learner.update(ref.batch)
    assert m["version"] == 3
    assert abs(m["loss"] - ref.metrics[2]["loss"]) <= 1e-5
    _assert_params_close(learner.params, ref.params[2], 1e-4)
    with pytest.raises(ValueError, match="Adam state"):
        grpo_state_from_jax({**ref.state2, "opt_state": ()}, small.tcfg,
                            device="cpu")


def test_idle_lanes_outlive_the_rope_table(small):
    """A lane left idle keeps advancing its position window after window
    (the loop's 12 updates leave lanes of a 32-slot engine idle that
    long): its RoPE lookup must clamp to the table, as JAX's gather does,
    and the busy lane decodes the JAX engine's greedy tokens.  Before the
    clamp the loop thread died with an IndexError here."""
    from ray_tpu.serve.llm import LLMEngine as JaxEngine
    from ray_tpu_torch.serve.llm import LLMEngine

    kw = dict(max_batch=4, max_len=32, page_size=8, steps_per_sync=4,
              seed=0)
    prompts = [[(i * 5 + k) % 120 + 1 for i in range(6)] for k in range(8)]
    out = {}
    for name, eng in (
            ("port", LLMEngine(small.tcfg, small.tparams, device="cpu",
                               **kw)),
            ("jax", JaxEngine(small.jcfg, small.jparams, paged=True,
                              **kw))):
        eng.start()
        try:
            # One request at a time: lanes 1-3 idle through 8 x 4
            # windows of 4 steps, 128 positions past a 32-row table.
            out[name] = [eng.generate(p, max_new_tokens=16)["tokens"]
                         for p in prompts]
        finally:
            eng.stop()
    assert out["port"] == out["jax"]


# ---------------------------------------------------------- the port's loop
def test_local_loop_learns(small):
    """Seeded learning test: 12 GRPO updates on the dense near-token
    reward must improve the mean reward (deterministic — if this flakes,
    fix determinism, don't loosen)."""
    from ray_tpu_torch.rl.rlhf import RLHFTrainer

    tr = RLHFTrainer(_port_cfg(
        small, group_size=8, prompts_per_step=4, max_new_tokens=6,
        lr=3e-2, engine=dict(ENGINE_KW, max_batch=32)))
    try:
        ms = tr.run(12)
        rs = [m["reward_mean"] for m in ms]
        first, last = np.mean(rs[:3]), np.mean(rs[-3:])
        assert last > first + 0.1, (
            f"GRPO failed to improve: first3={first:.3f} "
            f"last3={last:.3f} trajectory={np.round(rs, 3)}")
        # Weight sync really propagated every update.
        st = tr.stats()
        assert st["worker_versions"] == [12]
        assert st["workers"][0]["weight_version"] == 12
        assert st["workers"][0]["engine"]["weight_updates"] == 12
    finally:
        tr.shutdown()


def test_two_runs_bit_identical(small):
    """Same config, same seed -> bit-equal advantages and parameter
    hashes after N updates (shuffle from (seed, version), sampling keyed
    per request, no global RNG state in the loop)."""
    from ray_tpu_torch.rl.rlhf import RLHFTrainer

    def run():
        tr = RLHFTrainer(_port_cfg(small, seed=3, temperature=0.9,
                                   lr=5e-3, minibatch_size=4,
                                   max_new_tokens=4))
        try:
            ms = tr.run(3)
            assert all(m["minibatches"] == 2 for m in ms)
            advs = [np.asarray(m["advantages"]).tobytes() for m in ms]
            return advs, tr.learner.param_hash()
        finally:
            tr.shutdown()

    advs1, h1 = run()
    advs2, h2 = run()
    assert advs1 == advs2, "advantages diverged between identical runs"
    assert h1 == h2, f"param hashes diverged: {h1} vs {h2}"


def test_frozen_policy_ab_in_same_run(small, monkeypatch):
    """RAY_TPU_RL_WEIGHT_SYNC=0 mid-run freezes generation at the last
    synced policy while the learner keeps training."""
    from ray_tpu_torch.rl.rlhf import RLHFTrainer

    tr = RLHFTrainer(_port_cfg(small, max_new_tokens=4))
    try:
        tr.step()
        assert tr.stats()["worker_versions"] == [1]
        monkeypatch.setenv("RAY_TPU_RL_WEIGHT_SYNC", "0")
        tr.step()
        st = tr.stats()
        assert st["version"] == 2
        assert st["worker_versions"] == [1]      # frozen
        assert st["workers"][0]["engine"]["weight_syncs_skipped"] >= 1
        monkeypatch.delenv("RAY_TPU_RL_WEIGHT_SYNC")
        tr.step()
        assert tr.stats()["worker_versions"] == [3]   # thawed
    finally:
        tr.shutdown()


def test_config_validation(small):
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer, _reward_fn

    with pytest.raises(ValueError, match="unknown RLHF config"):
        RLHFTrainer(_port_cfg(small), frobnicate=1)
    cfg = _port_cfg(small, reward="no_such_reward")
    with pytest.raises(ValueError, match="unknown reward"):
        _reward_fn(cfg)
    with pytest.raises(ValueError, match="remote_learner"):
        RLHFTrainer(_port_cfg(small, remote_learner=True,
                              num_rollout_workers=0))
    assert RLHFConfig().group_size == 4


def test_actor_topology_not_implemented(small):
    """The actor topology needs a runtime that makes actors: without one
    (none, or the null ServeRuntime) the trainer raises ValueError naming
    LocalRuntime.  A mesh that is not a DeviceMesh raises TypeError naming
    what to pass (tests/test_torch_mesh_learner.py runs real meshes)."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner, RLHFTrainer
    from ray_tpu_torch.serve.runtime import ServeRuntime

    for kw in (dict(num_rollout_workers=2),
               dict(num_rollout_workers=2, remote_learner=True),
               dict(num_rollout_workers=1, runtime=ServeRuntime())):
        with pytest.raises(ValueError, match="LocalRuntime"):
            RLHFTrainer(_port_cfg(small, **kw))
    with pytest.raises(TypeError, match="DeviceMesh"):
        GRPOLearner(_port_cfg(small), mesh=object())


def test_entry_points_refuse_a_missing_cuda(small, ref):
    """Without device="cpu" the learner, the worker and the converter
    run on CUDA, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ray_tpu_torch.models.convert import grpo_state_from_jax
    from ray_tpu_torch.rl.rlhf import GRPOLearner
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    with pytest.raises(RuntimeError, match="CUDA"):
        GRPOLearner(_port_cfg(small, device=None))
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMRolloutWorker(small.tcfg, params=small.tparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        grpo_state_from_jax(ref.state2, small.tcfg)


# ------------------------------------------------------ checkpoints, sync
def _state_copy(learner):
    import jax

    return jax.tree.map(lambda t: t.detach().clone()
                        if isinstance(t, torch.Tensor) else np.array(t),
                        learner.state_tree())


def _assert_trees_equal(a, b):
    import jax

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_async_checkpoint_unchanged_by_next_update(small, ref, tmp_path):
    """save_async snapshots the state before it returns: the update right
    after it (in place) reaches neither the file nor a learner loaded
    from it."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner
    from ray_tpu_torch.train.checkpoint import Checkpoint

    learner = GRPOLearner(_port_cfg(small))
    learner.update(ref.batch)
    saved = _state_copy(learner)
    assert learner.save_async(str(tmp_path / "v1")) == 1
    learner.update(ref.batch)                # mutates params and moments
    assert learner.ckpt_wait() == (1, str(tmp_path / "v1"))
    assert learner.ckpt_wait() is None
    moved = _state_copy(learner)
    assert not torch.equal(moved["params"]["lm_head"],
                           saved["params"]["lm_head"])
    _assert_trees_equal(Checkpoint(str(tmp_path / "v1")).to_pytree(),
                        saved)
    fresh = GRPOLearner(_port_cfg(small))
    assert fresh.load(str(tmp_path / "v1")) == 1
    _assert_trees_equal(_state_copy(fresh), saved)


def test_resumed_learner_continues_bitwise(small, ref, tmp_path):
    """A learner loaded from a checkpoint takes the next update exactly as
    the uninterrupted one does (minibatch order keyed by the restored
    version included)."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner

    cfg = _port_cfg(small, minibatch_size=4, kl_coeff=0.1)
    a = GRPOLearner(cfg)
    a.update(ref.batch)
    a.save_async(str(tmp_path / "ck"))
    a.ckpt_wait()
    ma = a.update(ref.batch)
    b = GRPOLearner(cfg)
    b.load(str(tmp_path / "ck"))
    mb = b.update(ref.batch)
    assert b.param_hash() == a.param_hash()
    for key in ("loss", "policy_loss", "kl", "ratio_mean", "version"):
        assert ma[key] == mb[key], key
    _assert_trees_equal(_state_copy(a), _state_copy(b))


def test_flush_pending_writes_reraises_failed_write(tmp_path, monkeypatch):
    from ray_tpu_torch.train import checkpoint as ck

    def broken(*_a, **_k):
        raise OSError("disk full")

    monkeypatch.setattr(ck, "_write", broken)
    c = ck.Checkpoint.from_pytree_async({"w": torch.ones(3)},
                                        path=str(tmp_path / "bad"))
    with pytest.raises(OSError, match="disk full"):
        ck.flush_pending_writes()
    assert ck.flush_pending_writes() == 0     # observed once, then dropped
    with pytest.raises(OSError, match="disk full"):
        c.wait()
    monkeypatch.undo()
    ok = ck.Checkpoint.from_pytree_async({"w": torch.ones(3)},
                                         path=str(tmp_path / "ok"))
    assert ck.flush_pending_writes() in (0, 1)
    assert torch.equal(ok.to_pytree()["w"], torch.ones(3))


def test_update_after_sync_never_reaches_engine(small, monkeypatch):
    """The engine keeps the learner's tensors staged until its swap, so a
    sync returns only once the engine has swapped: a learner update right
    after it must not reach the engine under the synced version, however
    late the swap runs."""
    from ray_tpu_torch.rl.rlhf import RLHFTrainer

    tr = RLHFTrainer(_port_cfg(small, max_new_tokens=4))
    try:
        tr.step()
        worker = tr.workers[0]
        traj = worker.rollout(PROMPTS, group_size=4, max_new_tokens=4)
        eng = worker.engine
        swap = eng._maybe_swap_weights

        def late_swap():
            if eng._staged_weights is not None:
                time.sleep(0.3)
            swap()

        monkeypatch.setattr(eng, "_maybe_swap_weights", late_swap)
        tr.step()                            # learner v2, synced
        synced = copy.deepcopy(tr.learner.get_params_numpy())
        tr.learner.update(traj)              # v3, in place, not synced
        time.sleep(0.5)
        assert eng.stats()["weight_version"] == 2
        resident, version = eng.params_snapshot()
        assert version == 2
        for a, b in zip(_leaves(resident), _leaves(synced)):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(
            tr.learner.params["lm_head"].detach().numpy(),
            synced["lm_head"].numpy())
    finally:
        tr.shutdown()
