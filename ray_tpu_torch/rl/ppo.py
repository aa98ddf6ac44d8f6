"""PPO: the clipped-surrogate policy gradient (port of ray_tpu/rl/ppo.py
`PPOConfig`, `PPO`): GAE batches from the env runners, the loss on the
learners' device."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.gae_lambda = 0.95

    def training(self, *, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, gae_lambda=None, **kw) -> "PPOConfig":
        for name, v in [("clip_param", clip_param),
                        ("vf_loss_coeff", vf_loss_coeff),
                        ("entropy_coeff", entropy_coeff),
                        ("gae_lambda", gae_lambda)]:
            if v is not None:
                setattr(self, name, v)
        super().training(**kw)
        return self


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

    def training_step(self) -> dict:
        batch = self._collect()
        metrics = self.learner_group.update(
            batch, num_sgd_iter=self.cfg["num_sgd_iter"],
            minibatch_size=self.cfg["minibatch_size"])
        self._params_np = self.learner_group.get_params_numpy()
        return metrics


PPO._default_config = PPOConfig()
PPOConfig.algo_class = PPO
