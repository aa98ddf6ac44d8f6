"""APPO: asynchronous PPO on the IMPALA trunk, learner side (port of
ray_tpu/rl/appo.py `appo_params_init`, `appo_post_update`,
`APPO.loss_builder`): the clipped PPO surrogate on V-trace advantages,
plus a KL term against a polyak-synced target policy.  As in the
reference, no stop-gradient stands on the target policy inside the KL, so
`pi_t` takes that term's gradient (and Adam steps it) before the polyak
sync.  The algorithm's driver waits for the runtime (rl/algorithm.py)."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.impala import IMPALA, _trunk, vtrace_config, \
    vtrace_returns


def appo_params_init(generator, obs_dim: int, n_actions: int,
                     hidden: int = 64) -> dict:
    """Online pi / vf and target copies (a flat tree, so the env runners'
    models.policy_logits(params) finds "pi" unchanged)."""
    p = models.policy_value_init(generator, obs_dim, n_actions,
                                 hidden=hidden)
    return {"pi": p["pi"], "vf": p["vf"],
            "pi_t": {k: v.clone() for k, v in p["pi"].items()},
            "vf_t": {k: v.clone() for k, v in p["vf"].items()}}


def appo_post_update(config: dict):
    """Polyak target sync after each minibatch, in place: t <- tau o +
    (1 - tau) t."""
    tau = config.get("tau", 0.05)

    def post(params):
        for live, tgt in (("pi", "pi_t"), ("vf", "vf_t")):
            for k, t in params[tgt].items():
                t.copy_(tau * params[live][k] + (1 - tau) * t)
        return params

    return post


class APPO(IMPALA):
    params_builder = staticmethod(appo_params_init)
    post_update_builder = staticmethod(appo_post_update)

    @staticmethod
    def loss_builder(config: dict):
        vt = vtrace_config(config)
        vf_coeff = config.get("vf_loss_coeff", 0.5)
        ent_coeff = config.get("entropy_coeff", 0.01)
        clip = config.get("clip_param", 0.4)
        use_kl = config.get("use_kl_loss", True)
        kl_coeff = config.get("kl_coeff", 0.2)

        def loss_fn(params, batch):
            flat, logp_all, logp, entropy, values, v_next = _trunk(params,
                                                                   batch)
            # Importance ratios against the behaviour policy that sampled.
            rhos = torch.exp(logp - batch["logp"])
            vs, pg_adv = vtrace_returns(batch, values, v_next,
                                        rhos.detach(), **vt)
            # Population std, as jnp.std.
            adv = (pg_adv - pg_adv.mean()) / (
                pg_adv.std(correction=0) + 1e-8)
            surrogate = torch.minimum(
                rhos * adv, torch.clamp(rhos, 1.0 - clip, 1.0 + clip) * adv)
            pi_loss = -surrogate.mean()
            vf_loss = 0.5 * ((vs - values) ** 2).mean()
            total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
            # KL(target || online): anchors the update to the slow net.
            target_logp_all = torch.log_softmax(models.mlp_apply(
                params["pi_t"], flat(batch["obs"]), torch).float(), dim=-1)
            kl = (torch.exp(target_logp_all)
                  * (target_logp_all - logp_all)).sum(dim=-1).mean()
            if use_kl:
                total = total + kl_coeff * kl
            return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                           "entropy": entropy, "mean_kl": kl,
                           "mean_rho": rhos.mean()}
        return loss_fn
