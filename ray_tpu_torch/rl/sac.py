"""SAC, discrete actions: the maximum-entropy actor-critic (port of
ray_tpu/rl/sac.py `sac_params_init`, `sac_post_update`, `SACConfig`,
`SAC`).  The critic, actor and temperature losses sum into one loss;
detach() stands exactly where the reference's stop_gradient does,
routing each term to its own sub-tree, and the target critics move only
by the polyak post-update.  The training loop fills a replay buffer from the
env runners' raw fragments and samples `updates_per_step` minibatches a
step."""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.replay import ReplayBuffer


def sac_params_init(generator, obs_dim: int, n_actions: int,
                    hidden: int = 64) -> dict:
    """Policy, twin Q, their frozen twin targets, log-temperature."""
    sizes = [obs_dim, hidden, hidden, n_actions]
    pi = models.mlp_init(generator, sizes)
    q1 = models.mlp_init(generator, sizes)
    q2 = models.mlp_init(generator, sizes)
    return {
        "pi": pi, "q1": q1, "q2": q2,
        # Targets start as copies; the loss gives them zero gradient and
        # they move only by the polyak post-update.
        "q1_t": {k: v.clone() for k, v in q1.items()},
        "q2_t": {k: v.clone() for k, v in q2.items()},
        "log_alpha": torch.zeros((), device=generator.device),
    }


def sac_post_update(config: dict):
    """Polyak averaging of the target critics, in place: t <- (1 - tau) t
    + tau l."""
    tau = config.get("tau", 0.005)

    def post(params):
        for live, tgt in (("q1", "q1_t"), ("q2", "q2_t")):
            for k, t in params[tgt].items():
                t.copy_((1.0 - tau) * t + tau * params[live][k])
        return params
    return post


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.tau = 0.005
        self.replay_capacity = 50_000
        self.learning_starts = 500
        self.train_batch_size = 256
        self.sgd_batch_size = 64
        self.target_entropy = None   # default: 0.98 * log(n_actions)
        self.updates_per_step = 4

    def training(self, *, tau=None, replay_capacity=None,
                 learning_starts=None, sgd_batch_size=None,
                 target_entropy=None, updates_per_step=None,
                 **kw) -> "SACConfig":
        for name, v in [("tau", tau), ("replay_capacity", replay_capacity),
                        ("learning_starts", learning_starts),
                        ("sgd_batch_size", sgd_batch_size),
                        ("target_entropy", target_entropy),
                        ("updates_per_step", updates_per_step)]:
            if v is not None:
                setattr(self, name, v)
        super().training(**kw)
        return self


def _q_of(params, name, obs, actions):
    """Q values of the taken actions under critic `name`."""
    q = models.mlp_apply(params[name], obs, torch)
    return torch.gather(q, -1, actions.long()[:, None])[:, 0]


class SAC(Algorithm):
    params_builder = staticmethod(sac_params_init)
    post_update_builder = staticmethod(sac_post_update)

    @staticmethod
    def loss_builder(config: dict):
        gamma = config.get("gamma", 0.99)
        n_actions = config["n_actions"]
        target_ent = config.get("target_entropy")
        if target_ent is None:
            target_ent = 0.98 * float(np.log(n_actions))

        def loss_fn(params, batch):
            obs, next_obs = batch["obs"], batch["next_obs"]
            alpha = torch.exp(params["log_alpha"])

            # Critic loss: targets from the frozen nets and the current
            # policy, cut from the graph whole.
            logp_next = torch.log_softmax(models.mlp_apply(
                params["pi"], next_obs, torch).float(), dim=-1)
            p_next = torch.exp(logp_next)
            q1_t = models.mlp_apply(params["q1_t"], next_obs, torch)
            q2_t = models.mlp_apply(params["q2_t"], next_obs, torch)
            v_next = (p_next * (torch.minimum(q1_t, q2_t)
                                - alpha * logp_next)).sum(dim=-1)
            target = (batch["rewards"] + gamma * (1.0 - batch["dones"])
                      * v_next).detach()
            q1 = _q_of(params, "q1", obs, batch["actions"])
            q2 = _q_of(params, "q2", obs, batch["actions"])
            critic_loss = 0.5 * (((q1 - target) ** 2).mean()
                                 + ((q2 - target) ** 2).mean())

            # Actor loss: the critics frozen.
            logp_pi = torch.log_softmax(models.mlp_apply(
                params["pi"], obs, torch).float(), dim=-1)
            p_pi = torch.exp(logp_pi)
            q_min = torch.minimum(
                models.mlp_apply(params["q1"], obs, torch),
                models.mlp_apply(params["q2"], obs, torch)).detach()
            actor_loss = (p_pi * (alpha.detach() * logp_pi - q_min)) \
                .sum(dim=-1).mean()

            # Temperature loss: the policy frozen.
            entropy = -(p_pi * logp_pi).detach().sum(dim=-1)
            alpha_loss = (params["log_alpha"]
                          * (entropy - target_ent).detach()).mean()

            total = critic_loss + actor_loss + alpha_loss
            return total, {"critic_loss": critic_loss,
                           "actor_loss": actor_loss, "alpha": alpha,
                           "entropy": entropy.mean()}
        return loss_fn

    def setup(self, config: dict) -> None:
        super().setup(config)
        self.replay = ReplayBuffer(self.cfg["replay_capacity"],
                                   seed=self.cfg["seed"])

    def training_step(self) -> dict:
        # Collection rides the shared env->learner connector pipeline
        # (RecordEpisodeMetrics + ConcatFragments), like PPO/DQN/IMPALA.
        batch = self._collect(with_gae=False)
        self.replay.add_batch(batch)
        if len(self.replay) < self.cfg["learning_starts"]:
            return {"buffer_size": float(len(self.replay))}
        metrics: dict = {}
        for _ in range(self.cfg.get("updates_per_step", 4)):
            sample = self.replay.sample(self.cfg["sgd_batch_size"])
            metrics = self.learner_group.update(sample, num_sgd_iter=1)
        self._params_np = self.learner_group.get_params_numpy()
        return metrics


SAC._default_config = SACConfig()
SACConfig.algo_class = SAC
