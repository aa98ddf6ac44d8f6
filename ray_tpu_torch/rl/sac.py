"""SAC, discrete actions: the maximum-entropy actor-critic, learner side
(port of ray_tpu/rl/sac.py `sac_params_init`, `sac_post_update`,
`SAC.loss_builder`).  The critic, actor and temperature losses sum into
one loss; detach() stands exactly where the reference's stop_gradient
does, routing each term to its own sub-tree, and the target critics move
only by the polyak post-update.  Replay and the driver wait for the
runtime (rl/algorithm.py)."""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm


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
