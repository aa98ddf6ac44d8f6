"""BC: behaviour cloning from offline (obs, action) pairs (port of
ray_tpu/rl/bc.py `BCConfig`, `BC`): supervised policy learning from
logged data, no env interaction during training.  The offline batch goes
to the runtime once (`runtime.put`) and every update passes that ref;
greedy eval rollouts on the env runners give the episode metrics."""
from __future__ import annotations

import torch

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig, \
    coerce_offline


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.num_env_runners = 0        # offline: no sampling actors
        self.offline_data = None        # a dataset (to_numpy) | dict
        self.eval_episodes = 2          # rollouts per step() for metrics

    def offline(self, offline_data=None, **_kw) -> "BCConfig":
        if offline_data is not None:
            self.offline_data = offline_data
        return self


def nll_and_accuracy(logits, actions):
    """(-log p(action) per row, the share of rows whose argmax is the
    action), the log-softmax in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, actions.long()[:, None])[:, 0]
    acc = (logits.argmax(dim=-1) == actions).float().mean()
    return nll, acc


class BC(Algorithm):
    # Offline columns the loss consumes (MARWIL adds "returns").
    _offline_keys: tuple = ("obs", "actions")

    @staticmethod
    def loss_builder(config: dict):
        def loss_fn(params, batch):
            logits = models.policy_logits(params, batch["obs"], torch)
            nll, acc = nll_and_accuracy(logits, batch["actions"])
            loss = nll.mean()
            return loss, {"bc_loss": loss, "action_accuracy": acc}
        return loss_fn

    def setup(self, config: dict) -> None:
        config = dict(config or {})
        offline = config.pop("offline_data", None)
        if offline is None:
            raise ValueError("BC requires offline_data "
                             "(config.offline(offline_data=...))")
        batch = coerce_offline(offline, type(self)._offline_keys)
        # Default ONE eval runner when eval is on (none when off), but an
        # explicit .env_runners() choice wins.
        cfg_eval = dict(config)
        if "num_env_runners" not in config or \
                config.get("num_env_runners", 0) == 0:
            cfg_eval["num_env_runners"] = \
                1 if config.get("eval_episodes", 2) > 0 else 0
        super().setup(cfg_eval)
        # Ship the offline batch to the object plane ONCE; updates pass
        # the ref, not the arrays, and the algorithm keeps no second copy
        # (ray: offline data rides the object store).
        self._offline_ref = self.runtime.put(batch)
        self._n_offline = len(batch["obs"])

    def training_step(self) -> dict:
        metrics = self.learner_group.update(
            self._offline_ref,
            num_sgd_iter=self.cfg["num_sgd_iter"],
            minibatch_size=self.cfg["minibatch_size"])
        self._params_np = self.learner_group.get_params_numpy()
        self._timesteps += self._n_offline
        self._greedy_eval(self.cfg.get("eval_episodes", 2))
        return metrics


BC._default_config = BCConfig()
BCConfig.algo_class = BC
