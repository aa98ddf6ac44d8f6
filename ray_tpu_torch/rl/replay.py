"""Replay buffers for off-policy algorithms (a copy of
ray_tpu/rl/replay.py `ReplayBuffer`, which the port may not import).

A flat uniform-sampling transition buffer in numpy, seeded as the
reference's, so the same adds and seed give the same samples.
"""
from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 50_000, seed: int = 0):
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self._storage: dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0

    def add_batch(self, batch: dict) -> None:
        n = len(batch["obs"])
        if not self._storage:
            # Schema follows the first batch (algorithms differ: DQN/SAC
            # store next_obs, DreamerV3 stores sequence flags instead).
            for k, v in batch.items():
                v = np.asarray(v)
                shape = (self.capacity,) + tuple(v.shape[1:])
                self._storage[k] = np.zeros(shape, v.dtype)
        for i in range(n):
            j = self._next
            for k, arr in self._storage.items():
                arr[j] = batch[k][i]
            self._next = (self._next + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, batch_size: int) -> dict:
        idx = self.rng.integers(0, self._size, size=batch_size)
        return {k: arr[idx] for k, arr in self._storage.items()}

    def storage(self) -> dict:
        """Time-ordered view of the live region (sequence samplers slice
        contiguous windows from this; valid until the ring wraps)."""
        return {k: arr[:self._size] for k, arr in self._storage.items()}

    def __len__(self) -> int:
        return self._size
