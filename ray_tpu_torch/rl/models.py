"""Policy/value networks as plain functions over dict parameter trees
(port of ray_tpu/rl/models.py).

The apply functions take an array module, `xp`: numpy on the env runners'
side (host arrays, no device) and torch on the learner's, as the
reference's take numpy or jax.numpy.  Initialisers draw from an explicit
`torch.Generator` on its device; their values differ from the reference's
threefry draws, so parity tests move one tree to both sides.
"""
from __future__ import annotations

import numpy as np
import torch


def mlp_init(generator: torch.Generator, sizes: list[int]) -> dict:
    """He-init MLP params as a dict tree: w{i} normal x sqrt(2 / fan_in),
    b{i} zeros, f32 on the generator's device."""
    device = generator.device
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn(
            (fan_in, fan_out), generator=generator,
            device=device) * float(np.sqrt(2.0 / fan_in))
        params[f"b{i}"] = torch.zeros((fan_out,), device=device)
    return params


def mlp_apply(params: dict, x, xp=np):
    """Forward pass; `xp` = numpy (env runners) or torch (learner)."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = xp.tanh(h)
    return h


def policy_value_init(generator: torch.Generator, obs_dim: int,
                      n_actions: int, hidden: int = 64) -> dict:
    """Separate policy and value MLPs (rllib default fcnet)."""
    return {
        "pi": mlp_init(generator, [obs_dim, hidden, hidden, n_actions]),
        "vf": mlp_init(generator, [obs_dim, hidden, hidden, 1]),
    }


def policy_logits(params: dict, obs, xp=np):
    return mlp_apply(params["pi"], obs, xp)


def value(params: dict, obs, xp=np):
    return mlp_apply(params["vf"], obs, xp)[..., 0]


def to_numpy(params) -> dict:
    """Device -> host copy for shipping to env runners."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().to("cpu", copy=True).numpy()
    return np.asarray(params)


def sample_action(logits: np.ndarray, rng: np.random.Generator) -> tuple:
    """Categorical sample + log-prob (numpy, env-runner side)."""
    z = logits - logits.max(axis=-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=-1, keepdims=True)
    if logits.ndim == 1:
        a = rng.choice(len(p), p=p)
        return int(a), float(np.log(p[a] + 1e-8))
    acts = np.array([rng.choice(p.shape[-1], p=row) for row in p])
    logp = np.log(p[np.arange(len(acts)), acts] + 1e-8)
    return acts, logp
