"""CQL: conservative Q-learning on logged transitions (port of
ray_tpu/rl/cql.py `CQLConfig`, `CQL`): SAC's loss plus, per critic,
cql_alpha x mean(logsumexp over all actions - Q of the logged action),
exact over the categorical support.  The penalty reads the live critics
(the SAC terms keep their own detach()).  Training is offline: the algorithm
samples minibatches of the logged transitions with its own seeded rng,
and greedy eval rollouts give the episode metrics, as BC's do."""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, coerce_offline
from ray_tpu_torch.rl.sac import SAC, SACConfig


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.num_env_runners = 0        # offline: no sampling actors
        self.offline_data = None        # dataset | column dict
        self.cql_alpha = 1.0            # conservative-penalty weight
        self.eval_episodes = 2
        self.updates_per_step = 8

    def offline(self, offline_data=None, **_kw) -> "CQLConfig":
        if offline_data is not None:
            self.offline_data = offline_data
        return self

    def training(self, *, cql_alpha=None, **kw) -> "CQLConfig":
        if cql_alpha is not None:
            self.cql_alpha = cql_alpha
        super().training(**kw)
        return self


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

    def setup(self, config: dict) -> None:
        config = dict(config or {})
        offline = config.pop("offline_data", None)
        if offline is None:
            raise ValueError("CQL requires offline_data "
                             "(config.offline(offline_data=...))")
        self._offline = coerce_offline(
            offline, ("obs", "actions", "rewards", "next_obs", "dones"))
        # One eval runner for greedy rollouts unless explicitly set.
        if config.get("num_env_runners", 0) == 0 and \
                config.get("eval_episodes", 2) > 0:
            config["num_env_runners"] = 1
        Algorithm.setup(self, config)
        self._rng = np.random.default_rng(self.cfg["seed"])
        self._n_offline = len(self._offline["obs"])

    def training_step(self) -> dict:
        metrics: dict = {}
        bs = self.cfg["sgd_batch_size"]
        for _ in range(self.cfg.get("updates_per_step", 8)):
            idx = self._rng.integers(0, self._n_offline, bs)
            sample = {k: v[idx] for k, v in self._offline.items()}
            metrics = self.learner_group.update(sample, num_sgd_iter=1)
        self._params_np = self.learner_group.get_params_numpy()
        self._timesteps += bs * self.cfg.get("updates_per_step", 8)
        self._greedy_eval(self.cfg.get("eval_episodes", 2))
        return metrics


CQL._default_config = CQLConfig()
CQLConfig.algo_class = CQL
