"""BC: behaviour cloning from offline (obs, action) pairs, learner side
(port of ray_tpu/rl/bc.py `BC.loss_builder`).  Reading the offline data
and the greedy eval rollouts are the driver's and wait for the runtime
(rl/algorithm.py)."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm


def nll_and_accuracy(logits, actions):
    """(-log p(action) per row, the share of rows whose argmax is the
    action), the log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, actions.long()[:, None])[:, 0]
    acc = (logits.argmax(dim=-1) == actions).float().mean()
    return nll, acc


class BC(Algorithm):
    # Offline columns the loss consumes (MARWIL adds "returns").
    _offline_keys: tuple = ("obs", "actions")

    @staticmethod
    def loss_builder(config: dict):
        def loss_fn(params, batch):
            logits = models.policy_logits(params, batch["obs"], torch)
            nll, acc = nll_and_accuracy(logits, batch["actions"])
            loss = nll.mean()
            return loss, {"bc_loss": loss, "action_accuracy": acc}
        return loss_fn
