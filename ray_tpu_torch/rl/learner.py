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

`LearnerGroup` holds one or more `Learner`s as actors of a runtime
(`serve/runtime.py`: a `LocalRuntime`, or a binding to a cluster), each on
the algorithm's device; learner 0 is authoritative and the others mirror
it after every update.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.convert import as_tensor
from ray_tpu_torch.parallel.sharding import tree_map
from ray_tpu_torch.rl import models
from ray_tpu_torch.serve.runtime import ServeRuntime
from ray_tpu_torch.train.step import param_leaves

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)     # optax.adam's defaults


def batch_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A batch column on `device`: floating arrays f32 (as jax.numpy makes
    them without x64), integer arrays int64, bools as they are."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_floating_point():
        t = t.float()
    elif t.dtype != torch.bool:
        t = t.long()
    return t.to(device)


def copy_params(params: dict, src: dict) -> None:
    """Copy a tree (numpy or tensor leaves, `params`' keys and shapes)
    into `params`' tensors in place."""
    def put(p, x):
        x = as_tensor(x)
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"set_params: shape {tuple(x.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(x)

    with torch.no_grad():
        tree_map(put, params, src)


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
        return batch_tensor(a, self.device)

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
        copy_params(self.params, params_np)

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


class LearnerGroup:
    """One or more Learner actors of `runtime` (ray: learner_group.py:83),
    each `Learner(config, loss_builder, device=device)`.  Learner 0 is
    authoritative: with num_learners > 1 the others run the same update
    and then take learner 0's params (data-parallel learning would shard
    the batch over a mesh inside ONE learner instead).  The null runtime
    makes no actors: building a group on it raises, naming LocalRuntime;
    a learner that cannot get its device raises, and nothing falls back
    to the CPU."""

    def __init__(self, config: dict, loss_builder: Callable,
                 num_learners: int = 1, num_gpus_per_learner: float = 0,
                 runtime=None, device=None):
        self.runtime = runtime or ServeRuntime()
        cls = self.runtime.remote(Learner)
        opts = {"num_cpus": 1}
        if num_gpus_per_learner:
            opts["num_gpus"] = num_gpus_per_learner
        self.learners = [cls.options(**opts).remote(config, loss_builder,
                                                    device=device)
                         for _ in range(max(1, num_learners))]

    def update(self, batch, **kw) -> dict:
        """`batch` (a dict of numpy columns, or the runtime's ref to one)
        through every learner's `update`; learner 0's metrics."""
        rt = self.runtime
        metrics = rt.get([ln.update.remote(batch, **kw)
                          for ln in self.learners])
        if len(self.learners) > 1:
            sync = self.learners[0].get_params_numpy.remote()
            rt.get([ln.set_params.remote(sync) for ln in self.learners[1:]])
        return metrics[0]

    def get_params_numpy(self) -> dict:
        return self.runtime.get(self.learners[0].get_params_numpy.remote())

    def get_state(self) -> dict:
        return self.runtime.get(self.learners[0].get_state.remote())

    def stop(self) -> None:
        for ln in self.learners:
            try:
                self.runtime.kill(ln)
            except Exception:  # noqa: BLE001
                pass
