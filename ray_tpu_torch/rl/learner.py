"""The RL learner: one algorithm's loss over a dict parameter tree, updated
in place with Adam (port of ray_tpu/rl/learner.py `Learner`).

The reference jits `loss -> grads -> optax.adam -> post_update` into one
program per minibatch; here the same four run eagerly on `device` (CUDA
unless the caller asks for the CPU):

  - the loss builder's `loss_fn(params, batch) -> (loss, metrics)` on
    tensors, its gradients by autograd;
  - `torch.optim.Adam` at optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8 outside the square root) over EVERY leaf of the tree, as optax
    steps every leaf: a leaf the loss does not reach gets a zero gradient
    (so every leaf shares one update count and bias correction);
  - the optional `post_update_builder(config)(params)` (polyak target
    sync) in place, under no_grad, after each minibatch.

The minibatch order comes from `np.random.default_rng(seed + 17)`, as in
the reference, so both learners see the same minibatches.  A batch keeps
the keys whose values are numpy arrays of the batch's length; floating
arrays become f32 (as jax.numpy makes them without x64) and integer
arrays int64 (torch's gather takes int64 indices).

Differences from the reference: `get_state()["opt_state"]` is torch's
Adam state laid out as trees, {"mu", "nu", "count"}, not optax's chain
state; `set_params` copies into the learner's own tensors in place (the
optimizer keeps its moments, as the reference keeps its opt_state).
`LearnerGroup`, the learners as runtime actors, comes with the
algorithms' driver half (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import as_tensor
from ray_tpu_torch.parallel.sharding import tree_map
from ray_tpu_torch.rl import models
from ray_tpu_torch.train.step import param_leaves

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)     # optax.adam's defaults


def _default_params(generator, obs_dim, n_actions, hidden):
    return models.policy_value_init(generator, obs_dim, n_actions,
                                    hidden=hidden)


class Learner:
    """Holds params and the optimizer state; `update(batch)` runs SGD over
    it.  Algorithms with other param trees (SAC's twin Q and temperature,
    APPO's target nets) ship a `params_builder(generator, obs_dim,
    n_actions, hidden)` in the config dict."""

    def __init__(self, config: dict, loss_builder: Callable, device=None):
        self.config = config
        self.device = resolve_device(device, "Learner")
        seed = config.get("seed", 0)
        # Own seeded generator for minibatch shuffling, the reference's.
        self._np_rng = np.random.default_rng(seed + 17)
        builder = config.get("params_builder") or _default_params
        params = builder(torch.Generator(device=self.device).manual_seed(
            seed), config["obs_dim"], config["n_actions"],
            config.get("hidden", 64))
        self.params = tree_map(
            lambda t: torch.as_tensor(t).detach().to(
                self.device, copy=True).requires_grad_(True), params)
        self.opt = torch.optim.Adam(param_leaves(self.params),
                                    lr=config.get("lr", 3e-4), **ADAM)
        self._loss_fn = loss_builder(config)
        post = config.get("post_update_builder")
        self._post_fn = post(config) if post else None

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.is_floating_point():
            t = t.float()
        elif t.dtype != torch.bool:
            t = t.long()
        return t.to(self.device)

    def _update(self, batch: dict):
        """One minibatch: loss, gradients of every leaf, Adam, post."""
        leaves = param_leaves(self.params)
        loss, metrics = self._loss_fn(self.params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p, g in zip(leaves, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.opt.step()
        if self._post_fn is not None:
            with torch.no_grad():
                self._post_fn(self.params)
        return loss, metrics

    def update(self, batch: dict, num_sgd_iter: int = 1,
               minibatch_size: int | None = None) -> dict:
        """Run SGD over the batch; returns the last minibatch's metrics
        (ray: Learner.update)."""
        n = len(batch["obs"])
        mb = minibatch_size or n
        idx_all = np.arange(n)
        last_metrics: dict = {}
        for _epoch in range(num_sgd_iter):
            self._np_rng.shuffle(idx_all)
            for s in range(0, n, mb):
                idx = idx_all[s:s + mb]
                mbatch = {k: self._tensor(v[idx]) for k, v in batch.items()
                          if isinstance(v, np.ndarray) and len(v) == n}
                loss, metrics = self._update(mbatch)
                last_metrics = {k: float(torch.as_tensor(v).detach())
                                for k, v in metrics.items()}
                last_metrics["loss"] = float(loss.detach())
        return last_metrics

    def get_params_numpy(self) -> dict:
        return models.to_numpy(self.params)

    def set_params(self, params_np: dict) -> None:
        """Copy a tree (numpy or tensor leaves, the learner's keys and
        shapes) into the learner's tensors."""
        def put(p, src):
            src = as_tensor(src)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"set_params: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src)

        with torch.no_grad():
            tree_map(put, self.params, params_np)

    def get_state(self) -> dict:
        """Checkpointable state (ray: Learner.get_state): the params and
        Adam's moments "mu" / "nu" (zeros before the first update) and
        update "count", as numpy."""
        def moment(key):
            return tree_map(lambda p: models.to_numpy(
                self.opt.state.get(p, {}).get(key, torch.zeros_like(p))),
                self.params)

        first = self.opt.state.get(param_leaves(self.params)[0], {})
        return {"params": self.get_params_numpy(),
                "opt_state": {"mu": moment("exp_avg"),
                              "nu": moment("exp_avg_sq"),
                              "count": int(first.get("step", 0))}}
