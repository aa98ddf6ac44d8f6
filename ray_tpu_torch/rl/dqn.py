"""DQN: Q-learning against targets computed outside the learner, learner
side (port of ray_tpu/rl/dqn.py `DQN.loss_builder`).  The "pi" head is
the Q-network.  The replay buffer, epsilon schedule and double-DQN
targets are the driver's and wait for the runtime (rl/algorithm.py)."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm


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
