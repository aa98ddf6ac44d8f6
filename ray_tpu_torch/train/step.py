"""Single-device training step (port of ray_tpu/train/step.py:29-89).

`make_train_step(cfg, optimizer)(state, batch) -> (state, metrics)`: loss
and gradients through the model's autograd (the flash kernels on CUDA),
the pre-clip global gradient norm, a global-norm clip and AdamW under a
warmup-cosine schedule.  `default_optimizer` reproduces the reference's
optax chain (clip_by_global_norm -> adamw) exactly:

  - the schedule is read at the update count BEFORE the update, as optax's
    scale_by_schedule does, so the first update runs at lr 0 and leaves
    the parameters unchanged;
  - the clip scales by max_norm / |g| only when |g| >= max_norm, with no
    epsilon added to the norm (written out here, not clip_grad_norm_);
  - AdamW decays every leaf (no mask), eps 1e-8 outside the square root,
    and keeps its moments in the parameter dtype (torch.optim.AdamW does
    all of that).

Unlike the reference's pure step, the port updates parameters and
optimizer state IN PLACE: the returned state is the same object.
Entry points run on CUDA unless the caller passes device="cpu".
Sharded training (`sharded_train_step`) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama

ADAM_EPS = 1e-8          # optax.adamw's default, outside the square root


def model_module(cfg: llama.LlamaConfig):
    """Model family for a config; the port has the llama family only."""
    if not isinstance(cfg, llama.LlamaConfig):
        raise TypeError(f"no ported model family for {type(cfg).__name__}")
    return llama


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The parameter tree's tensors in a fixed order (sorted key paths)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [params]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: torch.optim.AdamW
    step: int


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """AdamW + warmup-cosine schedule + global-norm clip: the reference's
    Llama pretrain recipe (see the module docstring for its semantics)."""
    lr: float
    weight_decay: float
    warmup: int
    total_steps: int
    b1: float
    b2: float
    grad_clip: float

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup,
        max(total_steps, warmup + 1), end_value=lr * 0.1) at `count`."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay = max(self.total_steps, self.warmup + 1) - self.warmup
        t = min(count - self.warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
        alpha = 0.1                        # end_value / peak_value
        return self.lr * ((1 - alpha) * cosine + alpha)

    def init(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(param_leaves(params), lr=0.0,
                                 betas=(self.b1, self.b2), eps=ADAM_EPS,
                                 weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.AdamW, params: dict) -> torch.Tensor:
        """Clip the gradients held in `.grad` and take one AdamW step, in
        place.  Returns the pre-clip global norm (f32, on the device; no
        host sync)."""
        leaves = param_leaves(params)
        grads = [p.grad for p in leaves]
        gnorm = global_norm(grads)
        scale = torch.where(gnorm < self.grad_clip, torch.ones_like(gnorm),
                            self.grad_clip / gnorm)
        for g in grads:
            g.mul_(scale)
        state = opt.state.get(leaves[0])
        count = int(state["step"]) if state else 0
        for group in opt.param_groups:
            group["lr"] = self.schedule(count)
        opt.step()
        return gnorm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10000,
                      b1: float = 0.9, b2: float = 0.95,
                      grad_clip: float = 1.0) -> ClippedAdamW:
    """AdamW + cosine schedule + global-norm clip (the Llama pretrain
    recipe)."""
    return ClippedAdamW(lr=lr, weight_decay=weight_decay, warmup=warmup,
                        total_steps=total_steps, b1=b1, b2=b2,
                        grad_clip=grad_clip)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


def create_train_state(seed: int, cfg: llama.LlamaConfig,
                       optimizer: ClippedAdamW, device=None,
                       params: dict | None = None) -> TrainState:
    """A fresh TrainState on `device` (cuda by default): parameters from
    `init_params` with a generator seeded by `seed`, or copies of `params`
    when given, as leaves that require gradients."""
    device = resolve_device(device, "create_train_state")

    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return t.detach().to(device=device, dtype=cfg.dtype, copy=True)

    if params is None:
        params = model_module(cfg).init_params(
            cfg, torch.Generator(device=device).manual_seed(seed))
    else:
        params = copy(params)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def make_train_step(cfg: llama.LlamaConfig, optimizer: ClippedAdamW,
                    loss_fn: Callable | None = None,
                    device=None) -> Callable:
    """Returns step(state, batch) -> (state, metrics).  The batch's arrays
    move to `device` (cuda by default); the state must live there.
    Metrics: "loss", the pre-clip "grad_norm" (device scalars) and "step".
    Parameters and optimizer state update in place."""
    loss_fn = loss_fn or model_module(cfg).loss_fn
    device = resolve_device(device, "make_train_step")

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        for p in param_leaves(state.params):
            p.grad = None
        loss = loss_fn(state.params, batch, cfg)
        loss.backward()
        gnorm = optimizer.update(state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return step
