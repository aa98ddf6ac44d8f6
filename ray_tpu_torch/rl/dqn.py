"""DQN: off-policy Q-learning with replay and a target network (port of
ray_tpu/rl/dqn.py `DQNConfig`, `DQN`).  The "pi" head is the Q-network:
the env runners act epsilon-greedily on it, the algorithm computes the
double-DQN targets in numpy from the frozen target params (online net
picks, target net evaluates) and ships them in the batch."""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.replay import ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.replay_capacity = 50_000
        self.learning_starts = 1_000
        self.target_update_freq = 500       # env steps between target syncs
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 10_000
        self.train_batch_size = 256         # sampled per iteration
        self.sgd_batch_size = 64

    def training(self, *, replay_capacity=None, learning_starts=None,
                 target_update_freq=None, epsilon_decay_steps=None,
                 sgd_batch_size=None, **kw) -> "DQNConfig":
        for name, v in [("replay_capacity", replay_capacity),
                        ("learning_starts", learning_starts),
                        ("target_update_freq", target_update_freq),
                        ("epsilon_decay_steps", epsilon_decay_steps),
                        ("sgd_batch_size", sgd_batch_size)]:
            if v is not None:
                setattr(self, name, v)
        super().training(**kw)
        return self


class DQN(Algorithm):
    @staticmethod
    def loss_builder(config: dict):
        def loss_fn(params, batch):
            q = models.policy_logits(params, batch["obs"], torch)
            q_taken = torch.gather(q, -1,
                                   batch["actions"].long()[:, None])[:, 0]
            # Double-DQN targets (online net picks, target net evaluates)
            # arrive in the batch.
            target = batch["q_targets"]
            loss = ((q_taken - target) ** 2).mean()
            return loss, {"q_mean": q_taken.mean(),
                          "td_error": (q_taken - target).abs().mean()}
        return loss_fn

    def setup(self, config: dict) -> None:
        super().setup(config)
        self.replay = ReplayBuffer(self.cfg["replay_capacity"],
                                   seed=self.cfg["seed"])
        self._target_params = self._params_np
        self._last_target_sync = 0

    def _epsilon(self) -> float:
        frac = min(1.0, self._timesteps / self.cfg["epsilon_decay_steps"])
        return self.cfg["epsilon_initial"] + frac * (
            self.cfg["epsilon_final"] - self.cfg["epsilon_initial"])

    def training_step(self) -> dict:
        batch = self._collect(epsilon=self._epsilon())
        self.replay.add_batch(batch)
        if len(self.replay) < self.cfg["learning_starts"]:
            return {"buffer_size": float(len(self.replay))}
        metrics = {}
        for _ in range(4):
            sample = self.replay.sample(self.cfg["sgd_batch_size"])
            # Double-DQN targets with the frozen target net (numpy).
            q_next_online = models.policy_logits(self._params_np,
                                                 sample["next_obs"])
            best = np.argmax(q_next_online, axis=-1)
            q_next_target = models.policy_logits(self._target_params,
                                                 sample["next_obs"])
            q_sel = q_next_target[np.arange(len(best)), best]
            sample["q_targets"] = (
                sample["rewards"] + self.cfg["gamma"] *
                (1.0 - sample["dones"]) * q_sel).astype(np.float32)
            metrics = self.learner_group.update(sample, num_sgd_iter=1)
        self._params_np = self.learner_group.get_params_numpy()
        if self._timesteps - self._last_target_sync >= \
                self.cfg["target_update_freq"]:
            self._target_params = self._params_np
            self._last_target_sync = self._timesteps
        metrics["epsilon"] = self._epsilon()
        return metrics


DQN._default_config = DQNConfig()
DQNConfig.algo_class = DQN
