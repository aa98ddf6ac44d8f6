"""The algorithms' common base and config builder (port of
ray_tpu/rl/algorithm.py `AlgorithmConfig` and the in-process parts of
`Algorithm`, with the plain-Python `Trainable` surface of
ray_tpu/tune/trainable.py it inherits).

`AlgorithmConfig` is a copy of the reference's builder: `environment`,
`env_runners`, `training`, `learners`, `debugging`, `to_dict`, `copy`,
`build`.  `Algorithm(config)` runs `setup(config)`; `step()` runs one
`training_step()` and returns the reference's result layout
(`env_runners/episode_return_mean`, `num_episodes`,
`num_env_steps_sampled_lifetime`, `time_this_iter_s`, `learner/<metric>`),
and `train()` adds Tune's `training_iteration`, `time_total_s` and
`trial_id` as `Trainable.train` does.

An algorithm whose whole loop runs in process (DreamerV3: in-process envs,
no EnvRunnerGroup, no LearnerGroup) overrides `setup` and
`training_step`.  The other eight carry their static `loss_builder(config)`
and the `params_builder` / `post_update_builder` defaults that the
reference's `setup` puts into the learner's config (`learner_config`
applies them); their driver (env runners, replay, LearnerGroup actors,
connectors, checkpoints) needs the runtime and is not ported yet, so
building one raises.  Tune's checkpoint hooks (`save`, `restore`) are not
ported: no in-process algorithm defines a checkpoint.
"""
from __future__ import annotations

import copy
import time
from typing import Any

import numpy as np

DRIVER_HALF = (
    "the Algorithm driver (training_step, env runners, replay, "
    "LearnerGroup actors) is not ported yet: ROADMAP.md queue 1 item 7, "
    "driver half; use rl.learner.Learner(Algo.learner_config(config), "
    "Algo.loss_builder)")


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
        self.num_tpus_per_learner = 0.0
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
                 num_tpus_per_learner: float | None = None,
                 **_kw) -> "AlgorithmConfig":
        if num_learners is not None:
            self.num_learners = num_learners
        if num_tpus_per_learner is not None:
            self.num_tpus_per_learner = num_tpus_per_learner
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
        constructor (the port's `device`)."""
        if self.algo_class is None:
            raise ValueError("config has no algo_class bound")
        return self.algo_class(config=self.to_dict(), **kwargs)

    build_algo = build


class Algorithm:
    """Base RL algorithm: subclasses define setup() and training_step()
    (ray: algorithm.py:898 step / :1674 training_step)."""

    _default_config: AlgorithmConfig | None = None
    params_builder = None
    post_update_builder = None

    def __init__(self, config: dict | None = None):
        self.config = config or {}
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
    def setup(self, config: dict) -> None:
        raise NotImplementedError(f"{type(self).__name__}: {DRIVER_HALF}")

    def training_step(self) -> dict:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass

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
