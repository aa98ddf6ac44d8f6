"""Run configuration the port's train modules need (copy of the jax-free
`CheckpointConfig` of ray_tpu/train/config.py:64)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CheckpointConfig:
    """Bound + rank persisted checkpoints (ray: CheckpointConfig)."""

    num_to_keep: int | None = None
    checkpoint_score_attribute: str | None = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
