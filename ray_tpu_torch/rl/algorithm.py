"""The RL training loop: the algorithms' common base and config builder
(port of ray_tpu/rl/algorithm.py `AlgorithmConfig`, `coerce_offline` and
`Algorithm`, with the plain-Python `Trainable` surface of
ray_tpu/tune/trainable.py it inherits).

`AlgorithmConfig` is a copy of the reference's builder: `environment`,
`env_runners`, `training`, `learners`, `debugging`, `to_dict`, `copy`,
`build`.  `build(**kwargs)` passes the port's two constructor arguments:

  - `runtime` (`serve/runtime.py`): a `LocalRuntime` (one process) or a
    binding to a cluster; every `ray_tpu.remote/put/get/kill` call of the
    reference goes through it.  The null runtime (None) makes no actors,
    so `setup` raises a ValueError naming LocalRuntime;
  - `device`: the learners' device, cuda unless the caller passes "cpu".
    Each learner actor resolves it and raises where it cannot get it;
    `setup` surfaces that error.  The env runners are numpy on the host.

`Algorithm(config, runtime=..., device=...)` runs `setup(config)`: an
`EnvRunnerGroup` and a `LearnerGroup` on the runtime, the env->learner
connector pipeline, and the learners' first params as numpy.  `step()`
runs one `training_step()` and returns the reference's result layout
(`env_runners/episode_return_mean`, `num_episodes`,
`num_env_steps_sampled_lifetime`, `time_this_iter_s`, `learner/<metric>`);
`train()` adds Tune's `training_iteration`, `time_total_s` and
`trial_id` as `Trainable.train` does.

`save_checkpoint` writes the reference's layout, `algorithm_state.pkl`
holding {"learner": {"params", "opt_state"}, "timesteps"} with numpy
leaves only, so the reference's `load_checkpoint` restores it.  The
reverse does not hold: the reference pickles optax state objects.  Tune's
`save` / `restore` and `Tuner(PPO, ...)` are not ported: the port has no
Tune.

DreamerV3's whole loop runs in process: it overrides `setup` and
`training_step` and makes no actors.
"""
from __future__ import annotations

import copy
import os
import pickle
import time
from typing import Any

import numpy as np

from ray_tpu_torch.rl.connectors import (ConcatFragments, ConnectorCtx,
                                         ConnectorPipelineV2,
                                         RecordEpisodeMetrics)
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.learner import LearnerGroup
from ray_tpu_torch.serve.runtime import makes_actors

NO_ACTORS = (
    "{who} runs its env runners and learners as actors: pass "
    "build(runtime=...) a LocalRuntime (serve/runtime.py; one process) or "
    "a binding to a cluster")


class AlgorithmConfig:
    """Builder: .environment().env_runners().training().resources()
    (ray: rllib/algorithms/algorithm_config.py)."""

    algo_class: type | None = None

    def __init__(self):
        self.env = "CartPole-v1"
        self.num_env_runners = 2
        self.rollout_fragment_length = 256
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_batch_size = 512
        self.num_sgd_iter = 4
        self.minibatch_size = 128
        self.hidden = 64
        self.seed = 0
        self.num_learners = 1
        self.num_gpus_per_learner = 0.0
        self.extra: dict[str, Any] = {}

    # -- builder steps ------------------------------------------------------
    def environment(self, env=None, **_kw) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        return self

    def env_runners(self, num_env_runners: int | None = None,
                    rollout_fragment_length: int | None = None,
                    **_kw) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, gamma=None, lr=None, train_batch_size=None,
                 num_sgd_iter=None, minibatch_size=None,
                 **kw) -> "AlgorithmConfig":
        for name, v in [("gamma", gamma), ("lr", lr),
                        ("train_batch_size", train_batch_size),
                        ("num_sgd_iter", num_sgd_iter),
                        ("minibatch_size", minibatch_size)]:
            if v is not None:
                setattr(self, name, v)
        self.extra.update({k: v for k, v in kw.items() if v is not None})
        return self

    def learners(self, num_learners: int | None = None,
                 num_gpus_per_learner: float | None = None,
                 **_kw) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def debugging(self, seed: int | None = None, **_kw) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "extra"}
        d.update(self.extra)
        return d

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self, **kwargs) -> "Algorithm":
        """ray: config.build_algo(); `kwargs` go to the algorithm's
        constructor (the port's `runtime` and `device`)."""
        if self.algo_class is None:
            raise ValueError("config has no algo_class bound")
        return self.algo_class(config=self.to_dict(), **kwargs)

    build_algo = build


def coerce_offline(data, keys: tuple) -> dict:
    """Offline data -> numpy column dict (anything with `to_numpy()`, such
    as a dataset, or a plain dict; shared by BC and CQL)."""
    if hasattr(data, "to_numpy"):
        data = data.to_numpy()
    dtypes = {"actions": np.int64}
    return {k: np.asarray(data[k], dtypes.get(k, np.float32))
            for k in keys}


class Algorithm:
    """Base RL algorithm; subclasses define loss_builder() and
    training_step() (ray: algorithm.py:898 step / :1674 training_step)."""

    _default_config: AlgorithmConfig | None = None
    params_builder = None
    post_update_builder = None

    def __init__(self, config: dict | None = None, runtime=None,
                 device=None):
        self.config = config or {}
        self.runtime = runtime
        self.device = device
        self._iteration = 0
        self._start = time.time()
        self._timesteps = 0
        self._episode_returns: list[float] = []
        self.setup(self.config)

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        cfg = (cls._default_config or AlgorithmConfig()).copy()
        cfg.algo_class = cls
        return cfg

    # -- Trainable hooks ----------------------------------------------------
    def _require_actors(self) -> None:
        if not makes_actors(self.runtime):
            raise ValueError(NO_ACTORS.format(who=type(self).__name__))

    def setup(self, config: dict) -> None:
        self._require_actors()
        defaults = type(self).get_default_config().to_dict()
        defaults.update(config or {})
        self.cfg = defaults
        probe = make_env(self.cfg["env"], seed=0)
        self.obs_dim = probe.obs_dim
        self.n_actions = probe.n_actions
        self.env_runner_group = EnvRunnerGroup(
            self.cfg["env"], num_env_runners=self.cfg["num_env_runners"],
            gamma=self.cfg["gamma"],
            gae_lambda=self.cfg.get("gae_lambda", 0.95),
            runtime=self.runtime)
        learner_cfg = type(self).learner_config(
            dict(self.cfg, obs_dim=self.obs_dim, n_actions=self.n_actions))
        self.learner_group = LearnerGroup(
            learner_cfg, type(self).loss_builder,
            num_learners=self.cfg["num_learners"],
            num_gpus_per_learner=self.cfg["num_gpus_per_learner"],
            runtime=self.runtime, device=self.device)
        # Learner 0's params; a learner that could not build (no such
        # device) raises here.
        self._params_np = self.learner_group.get_params_numpy()
        # Env->learner connector pipeline (ray: connector_v2.py:29);
        # subclasses override build_env_to_learner_pipeline() to change
        # the batch layout (e.g. V-trace [B,T] stacking).
        self.env_to_learner = self.build_env_to_learner_pipeline()

    def build_env_to_learner_pipeline(self):
        return ConnectorPipelineV2(RecordEpisodeMetrics(),
                                   ConcatFragments())

    def step(self) -> dict:
        t0 = time.perf_counter()
        metrics = self.training_step()
        recent = self._episode_returns[-100:]
        result = {
            "env_runners": {
                "episode_return_mean":
                    float(np.mean(recent)) if recent else float("nan"),
                "num_episodes": len(self._episode_returns),
            },
            "num_env_steps_sampled_lifetime": self._timesteps,
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in (metrics or {}).items()},
        }
        result["episode_return_mean"] = \
            result["env_runners"]["episode_return_mean"]
        return result

    def training_step(self) -> dict:
        raise NotImplementedError

    def _greedy_eval(self, want: int, fragment: int = 200) -> None:
        """Greedy (argmax) eval rollouts until `want` episodes complete:
        the offline algorithms' metric source (BC/CQL; no training data
        comes from these)."""
        done = 0
        for _ in range(max(1, want) * 4):
            if done >= want:
                break
            frags = self.env_runner_group.sample(
                self._params_np, fragment, epsilon=0.0)
            for b in frags:
                rets = b["episode_returns"].tolist()
                done += len(rets)
                self._episode_returns.extend(rets)

    def _collect(self, epsilon: float | None = None,
                 with_gae: bool = True) -> dict:
        per = max(1, self.cfg["train_batch_size"]
                  // self.cfg["num_env_runners"])
        batches = self.env_runner_group.sample(
            self._params_np, per, epsilon=epsilon, with_gae=with_gae)
        return self.env_to_learner(batches, ConnectorCtx(self))

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = self.learner_group.get_state()
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump({"learner": state, "timesteps": self._timesteps},
                        f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        for ln in self.learner_group.learners:
            self.runtime.get(
                ln.set_params.remote(state["learner"]["params"]))
        self._params_np = state["learner"]["params"]
        self._timesteps = state["timesteps"]

    def cleanup(self) -> None:
        self.env_runner_group.stop()
        self.learner_group.stop()

    # -- controller API (ray_tpu/tune/trainable.py Trainable) ---------------
    def train(self) -> dict:
        result = self.step()
        self._iteration += 1
        result.setdefault("training_iteration", self._iteration)
        result.setdefault("time_total_s", time.time() - self._start)
        result.setdefault("trial_id", getattr(self, "trial_id", ""))
        return result

    def stop(self) -> None:
        self.cleanup()

    # -- learner side -------------------------------------------------------
    @classmethod
    def learner_config(cls, config: dict) -> dict:
        """`config` with the algorithm's params_builder and
        post_update_builder set where it names none (the reference's
        setup's setdefault)."""
        config = dict(config)
        for key in ("params_builder", "post_update_builder"):
            builder = getattr(cls, key)
            if builder is not None:
                config.setdefault(key, builder)
        return config

    @staticmethod
    def loss_builder(config: dict):
        raise NotImplementedError
