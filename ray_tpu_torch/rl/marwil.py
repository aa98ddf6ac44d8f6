"""MARWIL: advantage re-weighted imitation from offline data (port of
ray_tpu/rl/marwil.py `MARWILConfig`, `discounted_returns`, `MARWIL`).
beta 0 reduces it to BC.  The offline batch needs (obs, actions) and
either "returns" or (rewards, dones), from which `setup` derives the
discounted returns-to-go; the training loop is BC's."""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.bc import BC, BCConfig, nll_and_accuracy


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0             # 0 => plain BC
        self.vf_coeff = 1.0
        self.w_clip = 20.0          # cap on the exp advantage weight

    def training(self, *, beta=None, vf_coeff=None, w_clip=None,
                 **kw) -> "MARWILConfig":
        for name, v in [("beta", beta), ("vf_coeff", vf_coeff),
                        ("w_clip", w_clip)]:
            if v is not None:
                setattr(self, name, v)
        super().training(**kw)
        return self


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

    def setup(self, config: dict) -> None:
        config = dict(config or {})
        offline = config.get("offline_data")
        if offline is not None and not hasattr(offline, "to_numpy") \
                and "returns" not in offline:
            # Derive returns-to-go from logged rewards/dones.
            gamma = config.get("gamma", 0.99)
            offline = dict(offline)
            offline["returns"] = discounted_returns(
                np.asarray(offline["rewards"], np.float32),
                np.asarray(offline["dones"], np.float32), gamma)
            config["offline_data"] = offline
        super().setup(config)


MARWIL._default_config = MARWILConfig()
MARWILConfig.algo_class = MARWIL
