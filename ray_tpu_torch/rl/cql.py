"""CQL: conservative Q-learning on logged transitions, learner side (port
of ray_tpu/rl/cql.py `CQL.loss_builder`): SAC's loss plus, per critic,
cql_alpha x mean(logsumexp over all actions - Q of the logged action),
exact over the categorical support.  The penalty reads the live critics
(the SAC terms keep their own detach()).  The offline sampling and the
driver wait for the runtime (rl/algorithm.py)."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.sac import SAC


class CQL(SAC):
    @staticmethod
    def loss_builder(config: dict):
        sac_loss = SAC.loss_builder(config)
        cql_alpha = config.get("cql_alpha", 1.0)

        def loss_fn(params, batch):
            total, metrics = sac_loss(params, batch)
            a = batch["actions"].long()[:, None]
            penalty = 0.0
            for qname in ("q1", "q2"):
                q = models.mlp_apply(params[qname], batch["obs"], torch)
                lse = torch.logsumexp(q.float(), dim=-1)
                q_data = torch.gather(q, -1, a)[:, 0]
                penalty = penalty + (lse - q_data).mean()
            total = total + cql_alpha * penalty
            metrics["cql_penalty"] = penalty
            return total, metrics

        return loss_fn
