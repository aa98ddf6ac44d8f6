"""RL environments: gym-style API with in-repo numpy dynamics (a copy of
ray_tpu/rl/env.py, which the port may not import).

Byte for byte in behaviour: the same numpy dynamics and seeding, so the
same seed gives the same episodes as the reference's environments.
"""
from __future__ import annotations

import numpy as np


class CartPole:
    """CartPole-v1 dynamics (4-dim obs, 2 actions, 500-step cap)."""

    obs_dim = 4
    n_actions = 2
    max_steps = 500

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.length = 0.5          # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.x_threshold = 2.4
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.state = None
        self.t = 0

    def reset(self) -> np.ndarray:
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.t = 0
        return self.state.astype(np.float32)

    def step(self, action: int) -> tuple[np.ndarray, float, bool, bool]:
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.t += 1
        terminated = bool(
            abs(x) > self.x_threshold or abs(theta) > self.theta_threshold)
        truncated = self.t >= self.max_steps
        return self.state.astype(np.float32), 1.0, terminated, truncated


_ENVS = {"CartPole-v1": CartPole}


def register_env(name: str, ctor) -> None:
    """ray: tune.register_env / rllib env registry."""
    _ENVS[name] = ctor


def make_env(name: str, seed: int = 0):
    if callable(name):
        return name(seed=seed) if _accepts_seed(name) else name()
    if name not in _ENVS:
        raise ValueError(f"unknown env {name!r}; registered: {list(_ENVS)}")
    return _ENVS[name](seed=seed)


def _accepts_seed(ctor) -> bool:
    import inspect

    try:
        return "seed" in inspect.signature(ctor).parameters
    except (TypeError, ValueError):
        return False
