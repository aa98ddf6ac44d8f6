"""The algorithms' common base, learner side only (port of the parts of
ray_tpu/rl/algorithm.py `Algorithm` that a Learner needs).

Each algorithm class carries its static `loss_builder(config)` and the
`params_builder` / `post_update_builder` defaults that the reference's
`setup` puts into the learner's config; `learner_config(config)` applies
them.  The driver half (the `Algorithm` loop: training_step, env runners,
replay, LearnerGroup actors, checkpoints) is not ported yet, so building
an algorithm raises.
"""
from __future__ import annotations

DRIVER_HALF = (
    "the Algorithm driver (training_step, env runners, replay, "
    "LearnerGroup actors) is not ported yet: ROADMAP.md queue 1 item 7, "
    "driver half; use rl.learner.Learner(Algo.learner_config(config), "
    "Algo.loss_builder)")


class Algorithm:
    params_builder = None
    post_update_builder = None

    def __init__(self, config: dict | None = None):
        raise NotImplementedError(f"{type(self).__name__}: {DRIVER_HALF}")

    @classmethod
    def learner_config(cls, config: dict) -> dict:
        """`config` with the algorithm's params_builder and
        post_update_builder set where it names none (the reference's
        setup's setdefault)."""
        config = dict(config)
        for key in ("params_builder", "post_update_builder"):
            builder = getattr(cls, key)
            if builder is not None:
                config.setdefault(key, builder)
        return config

    @staticmethod
    def loss_builder(config: dict):
        raise NotImplementedError
