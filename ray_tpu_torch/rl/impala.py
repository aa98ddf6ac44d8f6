"""IMPALA: the importance-weighted actor-learner with V-trace (port of
ray_tpu/rl/impala.py `IMPALAConfig`, `vtrace_returns`, `IMPALA`).  The
reference's V-trace recursion is a lax.scan over time; here it is a loop
over the T steps of a [B, T] batch, batched over fragments.  The env
runners' fragments reach the learner stacked, one row per fragment
(`StackFragments`), and the behaviour log-probs shipped with each drive
the importance ratios."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.connectors import (ConnectorPipelineV2,
                                         RecordEpisodeMetrics,
                                         StackFragments)


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.vtrace_clip_rho = 1.0       # rho-bar (value-fit truncation)
        self.vtrace_clip_pg_rho = 1.0    # rho-bar for the policy gradient
        self.vtrace_lambda = 1.0
        self.num_sgd_iter = 1

    def training(self, *, vf_loss_coeff=None, entropy_coeff=None,
                 vtrace_clip_rho=None, vtrace_clip_pg_rho=None,
                 vtrace_lambda=None, **kw) -> "IMPALAConfig":
        for name, v in [("vf_loss_coeff", vf_loss_coeff),
                        ("entropy_coeff", entropy_coeff),
                        ("vtrace_clip_rho", vtrace_clip_rho),
                        ("vtrace_clip_pg_rho", vtrace_clip_pg_rho),
                        ("vtrace_lambda", vtrace_lambda)]:
            if v is not None:
                setattr(self, name, v)
        super().training(**kw)
        return self


def vtrace_returns(batch, values, v_next, rhos, gamma, rho_bar, pg_rho_bar,
                   lam):
    """V-trace corrected value targets and policy-gradient advantages.

    Shapes [B, T]; returns (vs, pg_adv), both detached.  Shared by IMPALA
    (plain PG surrogate) and APPO (clipped PPO surrogate)."""
    clipped_rho = torch.clamp(rhos, max=rho_bar)
    cs = lam * torch.clamp(rhos, max=1.0)
    discounts = gamma * (1.0 - batch["dones"])     # [B, T]
    # Any episode edge (terminal or truncation) stops the correction
    # carry: the recursion must not couple episodes.
    carry = 1.0 - torch.maximum(batch["dones"], batch["truncs"])
    deltas = clipped_rho * (batch["rewards"] + discounts * v_next - values)

    # Backward recursion: acc_t = delta_t + disc_t * c_t * carry_t *
    # acc_{t+1}.
    acc = torch.zeros_like(values[:, 0])
    rev = []
    for t in range(values.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + discounts[:, t] * cs[:, t] * carry[:, t] * acc
        rev.append(acc)
    vs = values + torch.stack(rev[::-1], dim=1)     # [B, T]

    # vs_{t+1}: the next row's corrected value within an episode, the raw
    # bootstrap V(next_obs) at edges and at the fragment end.
    vs_shift = torch.cat([vs[:, 1:], v_next[:, -1:]], dim=1)
    vs_tp1 = carry * vs_shift + (1.0 - carry) * v_next
    vs_tp1 = torch.cat([vs_tp1[:, :-1], v_next[:, -1:]], dim=1)
    pg_adv = (torch.clamp(rhos, max=pg_rho_bar)
              * (batch["rewards"] + discounts * vs_tp1 - values)).detach()
    return vs.detach(), pg_adv


def _trunk(params, batch):
    """(B, T, flat, logp_all [B*T, A], logp [B, T], entropy, values [B, T],
    v_next [B, T]) of a [B, T] fragment batch."""
    obs = batch["obs"]                              # [B, T, obs]
    B, T = obs.shape[:2]

    def flat(a):
        return a.reshape((B * T,) + tuple(a.shape[2:]))

    logits = models.policy_logits(params, flat(obs), torch)
    logp_all = torch.log_softmax(logits.float(), dim=-1)
    actions = flat(batch["actions"]).long()
    logp = torch.gather(logp_all, -1, actions[:, None])[:, 0].reshape(B, T)
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1).mean()
    values = models.value(params, flat(obs), torch).reshape(B, T)
    # Per-step successor values, not a shift of `values`: at an episode
    # edge inside a fragment the next row is a fresh episode's reset obs,
    # while next_obs[t] is the true successor state.
    v_next = models.value(params, flat(batch["next_obs"]),
                          torch).reshape(B, T)
    return flat, logp_all, logp, entropy, values, v_next


def vtrace_config(config: dict) -> dict:
    """The V-trace and loss coefficients of a config, with defaults."""
    return dict(gamma=config.get("gamma", 0.99),
                rho_bar=config.get("vtrace_clip_rho", 1.0),
                pg_rho_bar=config.get("vtrace_clip_pg_rho", 1.0),
                lam=config.get("vtrace_lambda", 1.0))


class IMPALA(Algorithm):
    @staticmethod
    def loss_builder(config: dict):
        vt = vtrace_config(config)
        vf_coeff = config.get("vf_loss_coeff", 0.5)
        ent_coeff = config.get("entropy_coeff", 0.01)

        def loss_fn(params, batch):
            _, _, logp, entropy, values, v_next = _trunk(params, batch)
            rhos = torch.exp(logp - batch["logp"])          # [B, T]
            vs, pg_adv = vtrace_returns(batch, values, v_next, rhos, **vt)
            pi_loss = -(logp * pg_adv).mean()
            vf_loss = 0.5 * ((vs - values) ** 2).mean()
            total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
            return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                           "entropy": entropy, "mean_rho": rhos.mean()}
        return loss_fn

    def build_env_to_learner_pipeline(self):
        # V-trace wants the [B,T] fragment layout, not flattened rows.
        return ConnectorPipelineV2(RecordEpisodeMetrics(),
                                   StackFragments())

    def training_step(self) -> dict:
        batch = self._collect(with_gae=False)
        metrics = self.learner_group.update(
            batch, num_sgd_iter=self.cfg.get("num_sgd_iter", 1))
        self._params_np = self.learner_group.get_params_numpy()
        return metrics


IMPALA._default_config = IMPALAConfig()
IMPALAConfig.algo_class = IMPALA
