"""PPO: the clipped-surrogate policy gradient, learner side (port of
ray_tpu/rl/ppo.py `PPO.loss_builder`).  The algorithm's driver waits for
the runtime (rl/algorithm.py)."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm


class PPO(Algorithm):
    @staticmethod
    def loss_builder(config: dict):
        clip = config.get("clip_param", 0.2)
        vf_coeff = config.get("vf_loss_coeff", 0.5)
        ent_coeff = config.get("entropy_coeff", 0.01)

        def loss_fn(params, batch):
            logits = models.policy_logits(params, batch["obs"], torch)
            logp_all = logits - logits.amax(dim=-1, keepdim=True)
            logp_all = logp_all - torch.log(
                torch.exp(logp_all).sum(dim=-1, keepdim=True))
            logp = torch.gather(logp_all, -1,
                                batch["actions"].long()[:, None])[:, 0]
            ratio = torch.exp(logp - batch["logp"])
            adv = batch["advantages"]
            surrogate = torch.minimum(
                ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
            pi_loss = -surrogate.mean()
            v = models.value(params, batch["obs"], torch)
            vf_loss = ((v - batch["value_targets"]) ** 2).mean()
            entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1).mean()
            total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
            return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                           "entropy": entropy,
                           "mean_kl": (batch["logp"] - logp).mean()}
        return loss_fn
