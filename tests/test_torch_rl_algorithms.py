"""The port's RL algorithms' training loops (rl/algorithm.py, env_runner.py,
learner.py `LearnerGroup`, connectors.py, multi_agent.py and the nine
algorithms' `training_step`s) against the JAX package's, on the CPU.

Both sides run in this process and no test boots the ray_tpu runtime:

- the reference is built with `ray_tpu.remote/put/get/kill` replaced by
  `_Shim` (an actor is its object, a call runs at once); its `EnvRunner`,
  `Learner` and `MultiAgentEnvRunner` are plain classes;
- the port runs on a `LocalRuntime` with device="cpu", and its learners
  take the reference's initial params through `set_params` (the target
  nets of APPO, SAC and CQL drifted off the online ones on both sides:
  while they are equal, APPO's KL gradient on `pi_t` is rounding noise).

For each of the nine algorithms, two `step()`s at small widths, each
after handing the port the reference's params: the sampled fragments and
every batch the learners get are equal bit for bit, the sample and
episode counts and the mean return equal, the learner metrics and the
params within 1e-4.  Updates are at most two Adam steps a `step()`,
except DQN's four (fixed in its training_step), whose lr is lower for
that reason: Adam's first steps move an element by about lr whatever the
size of its gradient, so the bound is on lr x steps.

Also: connector surgery, `LearnerGroup(num_learners=2)` mirroring
learner 0, checkpoints that the reference restores, the mapping errors
of `MultiAgentPPO`, the refusal without an actor runtime, a learner
that cannot get its device, and an env runner killed mid-run."""
import concurrent.futures
import copy
import importlib

import numpy as np
import pytest
import torch

import jax

TOL4 = dict(atol=1e-4, rtol=1e-4)
ALGOS = ["ppo", "impala", "appo", "dqn", "sac", "bc", "marwil", "cql",
         "multi_agent"]
CONFIGS = {"ppo": "PPOConfig", "impala": "IMPALAConfig",
           "appo": "APPOConfig", "dqn": "DQNConfig", "sac": "SACConfig",
           "bc": "BCConfig", "marwil": "MARWILConfig", "cql": "CQLConfig",
           "multi_agent": "MultiAgentPPOConfig"}


# ------------------------------------------------ the reference's runtime
class _Ref:
    def __init__(self, value):
        self.value = value


def _resolve(x):
    return x.value if isinstance(x, _Ref) else x


class _Method:
    def __init__(self, handle, name):
        self._handle, self._name = handle, name

    def remote(self, *args, **kwargs):
        if self._handle._dead:
            raise RuntimeError("actor was killed")
        fn = getattr(self._handle._obj, self._name)
        return _Ref(fn(*[_resolve(a) for a in args],
                       **{k: _resolve(v) for k, v in kwargs.items()}))


class _Handle:
    def __init__(self, obj):
        self._obj, self._dead = obj, False

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _Method(self, name)


class _Class:
    def __init__(self, cls):
        self._cls = cls

    def options(self, **_opts):
        return self

    def remote(self, *args, **kwargs):
        return _Handle(self._cls(*[_resolve(a) for a in args], **kwargs))


class _Shim:
    """ray_tpu's remote/put/get/kill in this process."""

    @staticmethod
    def remote(cls):
        return _Class(cls)

    @staticmethod
    def put(value):
        return _Ref(value)

    @staticmethod
    def get(ref, timeout=None):
        if isinstance(ref, list):
            return [_resolve(r) for r in ref]
        return _resolve(ref)

    @staticmethod
    def kill(handle):
        handle._dead = True


@pytest.fixture(scope="module")
def shim():
    import ray_tpu

    with pytest.MonkeyPatch.context() as mp:
        for name in ("remote", "put", "get", "kill"):
            mp.setattr(ray_tpu, name, getattr(_Shim, name))
        yield


@pytest.fixture(scope="module")
def local_rt():
    from ray_tpu_torch.serve.runtime import LocalRuntime

    rt = LocalRuntime()
    yield rt
    rt.shutdown()


# ---------------------------------------------------------------- set-up
def _expert_transitions(n_steps: int, seed: int = 3) -> dict:
    """Logged transitions of the lean-direction expert with 20 % random
    actions (tests/test_rl_extra.py's)."""
    from ray_tpu_torch.rl.env import CartPole

    rng = np.random.default_rng(seed)
    env = CartPole(seed=seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "dones")}
    obs = env.reset()
    for _ in range(n_steps):
        if rng.random() < 0.2:
            a = int(rng.integers(2))
        else:
            a = int(obs[2] + 0.3 * obs[3] > 0)
        nxt, r, term, trunc = env.step(a)
        for k, v in zip(cols, (obs.copy(), a, r, nxt.copy(), float(term))):
            cols[k].append(v)
        obs = env.reset() if (term or trunc) else nxt
    return {k: np.array(v, np.int64 if k == "actions" else np.float32)
            for k, v in cols.items()}


def _configure(cfg, algo: str):
    """Small widths and batches; learning_starts reached in step 1."""
    cfg = cfg.environment("MultiCartPole" if algo == "multi_agent"
                          else "CartPole-v1").debugging(seed=0)
    cfg.hidden = 16
    if algo == "ppo":
        return cfg.env_runners(num_env_runners=2).training(
            lr=3e-4, train_batch_size=64, num_sgd_iter=1, minibatch_size=32)
    if algo in ("impala", "appo"):
        cfg = cfg.env_runners(num_env_runners=2).training(
            lr=3e-4, train_batch_size=32)
        return cfg.training(tau=0.1) if algo == "appo" else cfg
    if algo == "dqn":
        return cfg.env_runners(num_env_runners=1).training(
            lr=5e-5, train_batch_size=64, learning_starts=64,
            sgd_batch_size=16, target_update_freq=64,
            epsilon_decay_steps=1000)
    if algo == "sac":
        return cfg.env_runners(num_env_runners=1).training(
            lr=3e-4, train_batch_size=64, learning_starts=64,
            sgd_batch_size=16, updates_per_step=2, tau=0.1)
    if algo == "multi_agent":
        return cfg.env_runners(num_env_runners=1).multi_agent(
            policies=["p0", "p1"],
            policy_mapping={"agent_0": "p0", "agent_1": "p1"}).training(
            lr=3e-4, train_batch_size=32, num_sgd_iter=1, minibatch_size=16)
    data = _expert_transitions(64)
    cfg = cfg.offline(offline_data=data).training(lr=3e-4)
    cfg.eval_episodes = 1
    if algo == "cql":
        return cfg.training(sgd_batch_size=16, updates_per_step=2, tau=0.1)
    return cfg.training(num_sgd_iter=1, minibatch_size=32)


def _config(pkg: str, algo: str):
    mod = importlib.import_module(f"{pkg}.rl.{algo}")
    return _configure(getattr(mod, CONFIGS[algo])(), algo)


def _groups(algo):
    """{policy: LearnerGroup} of an algorithm."""
    if hasattr(algo, "learner_groups"):
        return algo.learner_groups
    return {None: algo.learner_group}


def _params(algo) -> dict:
    return algo._params_np if hasattr(algo, "learner_groups") \
        else {None: algo._params_np}


def _hand(algo, params: dict, rt) -> None:
    """Set every learner of `algo` (and its numpy copy) to `params`
    ({policy: tree}); `rt` is the algorithm's runtime."""
    for pid, lg in _groups(algo).items():
        for ln in lg.learners:
            rt.get(ln.set_params.remote(copy.deepcopy(params[pid])))
        fresh = lg.get_params_numpy()
        if pid is None:
            algo._params_np = fresh
        else:
            algo._params_np[pid] = fresh


def _drift(params: dict) -> dict:
    """Target nets ("pi_t", "q1_t", ...) moved off the online ones."""
    rng = np.random.default_rng(99)
    return {k: jax.tree.map(lambda a: (a + 0.05 * rng.normal(
                size=a.shape)).astype(np.float32), v)
            if k.endswith("_t") else v for k, v in params.items()}


def _record(algo) -> dict:
    """Record the fragments each sample returns and every batch each
    learner group updates on (copies)."""
    log = {"fragments": [], "batches": []}
    if hasattr(algo, "env_runner_group"):
        group = algo.env_runner_group
        sample = group.sample

        def rec_sample(*a, **k):
            out = sample(*a, **k)
            log["fragments"].append(copy.deepcopy(out))
            return out

        group.sample = rec_sample
    for pid, lg in _groups(algo).items():
        update = lg.update

        def rec_update(batch, *a, _u=update, _pid=pid, **k):
            log["batches"].append((_pid, copy.deepcopy(_resolve(batch))))
            return _u(batch, *a, **k)

        lg.update = rec_update
    return log


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture(scope="module", params=ALGOS)
def run(request, shim, local_rt):
    """Both sides of one algorithm through two step()s: per step the
    recorded fragments and batches, the result, the params, and DQN's
    schedule."""
    algo_name = request.param
    ref = _config("ray_tpu", algo_name).build()
    port = _config("ray_tpu_torch", algo_name).build(runtime=local_rt,
                                                     device="cpu")
    try:
        start = {pid: _drift(p) for pid, p in _params(ref).items()}
        _hand(ref, start, _Shim)
        logs = {"ref": _record(ref), "port": _record(port)}
        steps = []
        for _ in range(2):
            _hand(port, _params(ref), local_rt)
            if algo_name == "dqn":
                port._target_params = ref._target_params
            for side in logs.values():
                side["fragments"].clear()
                side["batches"].clear()
            out = {}
            for label, algo in (("ref", ref), ("port", port)):
                res = algo.step()
                out[label] = {"result": res,
                              "fragments": logs[label]["fragments"][:],
                              "batches": logs[label]["batches"][:],
                              "params": copy.deepcopy(_params(algo))}
                if algo_name == "dqn":
                    out[label]["dqn"] = {
                        "epsilon": algo._epsilon(),
                        "buffer": len(algo.replay),
                        "last_sync": algo._last_target_sync,
                        "target": copy.deepcopy(algo._target_params)}
            steps.append(out)
        return algo_name, steps
    finally:
        ref.cleanup()
        port.cleanup()


def _assert_same_arrays(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("step", [0, 1])
def test_fragments_and_batches_equal_bit_for_bit(run, step):
    algo, steps = run
    ref, port = steps[step]["ref"], steps[step]["port"]
    assert len(port["fragments"]) == len(ref["fragments"])
    for i, (g, w) in enumerate(zip(port["fragments"], ref["fragments"])):
        assert len(g) == len(w)
        for j, (fg, fw) in enumerate(zip(g, w)):
            _assert_same_arrays(fg, fw, f"{algo} fragment {i}.{j}")
    assert ref["batches"], f"{algo}: no update in step {step + 1}"
    assert [p for p, _ in port["batches"]] == [p for p, _ in ref["batches"]]
    for i, ((_, g), (_, w)) in enumerate(zip(port["batches"],
                                             ref["batches"])):
        _assert_same_arrays(g, w, f"{algo} batch {i}")
    if algo in ("impala", "appo"):            # the V-trace [B, T] layout
        assert ref["batches"][0][1]["obs"].shape == (2, 16, 4)


@pytest.mark.parametrize("step", [0, 1])
def test_counts_and_returns_equal(run, step):
    algo, steps = run
    g, w = steps[step]["port"]["result"], steps[step]["ref"]["result"]
    assert g["num_env_steps_sampled_lifetime"] == \
        w["num_env_steps_sampled_lifetime"]
    assert g["env_runners"]["num_episodes"] == \
        w["env_runners"]["num_episodes"]
    np.testing.assert_array_equal(g["episode_return_mean"],
                                  w["episode_return_mean"])
    if algo == "dqn":
        gd, wd = steps[step]["port"]["dqn"], steps[step]["ref"]["dqn"]
        assert gd["epsilon"] == wd["epsilon"]
        assert gd["buffer"] == wd["buffer"]
        assert gd["last_sync"] == wd["last_sync"] == 64 * (step + 1)
        for (path, a), (_, b) in zip(_leaves(gd["target"]),
                                     _leaves(wd["target"])):
            np.testing.assert_allclose(a, b, err_msg=path, **TOL4)


@pytest.mark.parametrize("step", [0, 1])
def test_learner_metrics_and_params_within_tolerance(run, step):
    algo, steps = run
    g, w = steps[step]["port"]["result"], steps[step]["ref"]["result"]
    lg = {k: v for k, v in g.items() if k.startswith("learner/")}
    lw = {k: v for k, v in w.items() if k.startswith("learner/")}
    assert set(lg) == set(lw) and len(lw) > 1, (sorted(lg), sorted(lw))
    for k, v in lw.items():
        np.testing.assert_allclose(lg[k], v, err_msg=k, **TOL4)
    got = dict(_leaves(steps[step]["port"]["params"]))
    want = dict(_leaves(steps[step]["ref"]["params"]))
    assert set(got) == set(want)
    for path, v in want.items():
        assert got[path].dtype == v.dtype, path
        np.testing.assert_allclose(got[path], v, err_msg=path, **TOL4)
    start = dict(_leaves(steps[0]["ref"]["params"])) if step else None
    if start is not None:
        assert any(not np.array_equal(got[p], start[p]) for p in got)


# ------------------------------------------------------------- the parts
def test_connector_pipeline_surgery():
    """tests/test_rl_extra.py's connector case on the port's pieces."""
    from ray_tpu_torch.rl.connectors import (ConcatFragments, ConnectorCtx,
                                             ConnectorPipelineV2,
                                             FnConnector,
                                             RecordEpisodeMetrics,
                                             StackFragments)

    frags = [
        {"obs": np.ones((4, 3), np.float32),
         "episode_returns": np.array([10.0], np.float32)},
        {"obs": np.zeros((4, 3), np.float32),
         "episode_returns": np.array([], np.float32)},
    ]

    class Sink:
        _episode_returns = []
        _timesteps = 0

    ctx = ConnectorCtx(Sink)
    pipe = ConnectorPipelineV2(RecordEpisodeMetrics(), ConcatFragments())
    out = pipe([dict(f) for f in frags], ctx)
    assert out["obs"].shape == (8, 3)
    assert Sink._episode_returns == [10.0] and Sink._timesteps == 8
    stacked = ConnectorPipelineV2(StackFragments())(
        [{"obs": f["obs"]} for f in frags], ConnectorCtx())
    assert stacked["obs"].shape == (2, 4, 3)
    norm = FnConnector(lambda d, c: d, name="Norm")
    pipe.insert_before("ConcatFragments", norm)
    assert [p.name for p in pipe.pieces] == [
        "RecordEpisodeMetrics", "Norm", "ConcatFragments"]
    pipe.remove("Norm").append(norm).prepend(
        FnConnector(lambda d, c: d, name="First"))
    assert pipe.pieces[0].name == "First"
    assert pipe.pieces[-1].name == "Norm"
    pipe.insert_after("First", FnConnector(lambda d, c: d, name="Second"))
    assert pipe.pieces[1].name == "Second"
    with pytest.raises(ValueError, match="Missing"):
        pipe.insert_after("Missing", norm)


def test_compute_gae_matches_reference():
    from ray_tpu.rl.env_runner import compute_gae as jgae
    from ray_tpu_torch.rl import models
    from ray_tpu_torch.rl.env_runner import compute_gae as tgae

    params = models.to_numpy(models.policy_value_init(
        torch.Generator().manual_seed(1), 4, 2, hidden=8))
    rng = np.random.default_rng(5)
    n = 40
    batch = {"obs": rng.normal(size=(n, 4)).astype(np.float32),
             "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
             "rewards": rng.normal(size=n).astype(np.float32),
             "dones": (rng.random(n) < 0.1).astype(np.float32),
             "truncs": (rng.random(n) < 0.1).astype(np.float32)}
    _assert_same_arrays(tgae(params, batch, 0.97, 0.9),
                        jgae(params, batch, 0.97, 0.9), "gae")


def test_learner_group_mirrors_learner_zero(local_rt):
    from ray_tpu_torch.rl import PPOConfig

    algo = _configure(PPOConfig(), "ppo").learners(num_learners=2).build(
        runtime=local_rt, device="cpu")
    try:
        learners = algo.learner_group.learners
        assert len(learners) == 2
        before = algo._params_np
        # Learner 1 starts elsewhere: only the mirror brings it back.
        local_rt.get(learners[1].set_params.remote(
            jax.tree.map(lambda a: a + 1.0, before)))
        algo.step()
        trees = local_rt.get([ln.get_params_numpy.remote()
                              for ln in learners])
        moved = False
        for (path, a), (_, b) in zip(_leaves(trees[0]), _leaves(trees[1])):
            np.testing.assert_array_equal(a, b, err_msg=path)
            moved |= not np.array_equal(a, dict(_leaves(before))[path])
        assert moved
        states = local_rt.get([ln.get_state.remote() for ln in learners])
        assert [s["opt_state"]["count"] for s in states] == [2, 2]
    finally:
        algo.cleanup()


@pytest.mark.parametrize("algo_name", ["ppo", "appo", "multi_agent"])
def test_port_checkpoint_restores_into_reference_and_port(
        algo_name, shim, local_rt, tmp_path):
    port = _config("ray_tpu_torch", algo_name).build(runtime=local_rt,
                                                     device="cpu")
    port.step()
    port.save_checkpoint(str(tmp_path))
    want = _params(port)
    ref = _config("ray_tpu", algo_name).build()
    again = _config("ray_tpu_torch", algo_name).build(runtime=local_rt,
                                                      device="cpu")
    try:
        for algo in (ref, again):
            algo.load_checkpoint(str(tmp_path))
            assert algo._timesteps == port._timesteps > 0
            for (path, a), (_, b) in zip(_leaves(_params(algo)),
                                         _leaves(want)):
                np.testing.assert_array_equal(a, b, err_msg=path)
        # The restored learners hold the checkpoint's params.
        for pid, lg in _groups(again).items():
            for (path, a), (_, b) in zip(
                    _leaves(lg.get_params_numpy()),
                    _leaves(want if pid is None else want[pid])):
                np.testing.assert_array_equal(a, b, err_msg=path)
    finally:
        for algo in (port, ref, again):
            algo.cleanup()


def test_multi_agent_mapping_errors(local_rt):
    from ray_tpu_torch.rl import MultiAgentPPOConfig

    def build(**kw):
        cfg = MultiAgentPPOConfig().env_runners(num_env_runners=1)
        return cfg.multi_agent(**kw).build(runtime=local_rt, device="cpu")

    with pytest.raises(ValueError, match="unknown policies"):
        build(policies=["p0"], policy_mapping={"agent_0": "p0",
                                               "agent_1": "p9"})
    with pytest.raises(ValueError, match=r"\['agent_1'\] have no policy"):
        build(policies=["p0"], policy_mapping={"agent_0": "p0"})
    with pytest.raises(TypeError, match="not a MultiAgentEnv"):
        MultiAgentPPOConfig().environment("CartPole-v1").build(
            runtime=local_rt, device="cpu")


def test_without_an_actor_runtime_build_names_local_runtime():
    from ray_tpu_torch.rl import DQNConfig, MultiAgentPPOConfig
    from ray_tpu_torch.serve.runtime import ServeRuntime

    for cfg in (DQNConfig(), MultiAgentPPOConfig()):
        for kw in ({}, {"runtime": ServeRuntime()}):
            with pytest.raises(ValueError, match="LocalRuntime"):
                cfg.build(device="cpu", **kw)


def test_learner_without_its_device_fails_the_build(local_rt):
    from ray_tpu_torch.rl import PPOConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the learner gets it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOConfig().env_runners(num_env_runners=1).build(runtime=local_rt)


def test_killed_env_runner_raises_actor_died():
    from ray_tpu_torch.rl import PPOConfig
    from ray_tpu_torch.serve.runtime import ActorDiedError, LocalRuntime

    rt = LocalRuntime()
    algo = _configure(PPOConfig(), "ppo").build(runtime=rt, device="cpu")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        algo.step()
        rt.kill(algo.env_runner_group.runners[1])
        with pytest.raises(ActorDiedError, match="killed"):
            pool.submit(algo.step).result(timeout=60)
    finally:
        pool.shutdown(wait=False)
        algo.cleanup()
        rt.shutdown()
