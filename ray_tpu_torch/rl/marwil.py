"""MARWIL: advantage re-weighted imitation from offline data, learner
side (port of ray_tpu/rl/marwil.py `discounted_returns`,
`MARWIL.loss_builder`).  beta 0 reduces it to BC.  The driver waits for
the runtime (rl/algorithm.py)."""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.bc import BC, nll_and_accuracy


def discounted_returns(rewards: np.ndarray, dones: np.ndarray,
                       gamma: float) -> np.ndarray:
    """Per-step discounted returns-to-go, resetting at episode ends."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        acc = rewards[t] + gamma * (1.0 - dones[t]) * acc
        out[t] = acc
    return out


class MARWIL(BC):
    _offline_keys = ("obs", "actions", "returns")

    @staticmethod
    def loss_builder(config: dict):
        beta = config.get("beta", 1.0)
        vf_coeff = config.get("vf_coeff", 1.0)
        w_clip = config.get("w_clip", 20.0)

        def loss_fn(params, batch):
            logits = models.policy_logits(params, batch["obs"], torch)
            nll, acc = nll_and_accuracy(logits, batch["actions"])
            v = models.value(params, batch["obs"], torch)
            adv = batch["returns"] - v
            vf_loss = (adv ** 2).mean()
            # exp(beta * normalised advantage), detached: the policy term
            # never trains the critic through the weight.
            adv_sg = adv.detach()
            norm = torch.sqrt((adv_sg ** 2).mean() + 1e-8)
            w = torch.clamp(torch.exp(beta * adv_sg / norm), max=w_clip)
            pi_loss = (w * nll).mean()
            total = pi_loss + vf_coeff * vf_loss
            return total, {"marwil_loss": pi_loss, "vf_loss": vf_loss,
                           "mean_weight": w.mean(),
                           "action_accuracy": acc}
        return loss_fn
