"""Device discovery for a worker (port of ray_tpu/api.py `get_tpu_ids`,
:418).

`get_gpu_ids()` answers what the reference's `get_tpu_ids()` answers, for
CUDA devices: only the per-host device worker (the process the runtime
starts with RAY_TPU_IS_DEVICE_WORKER=1, which holds the accelerator
lease) sees any; it gets the ordinals of the CUDA devices visible to it
(`torch.cuda.device_count()`, after CUDA_VISIBLE_DEVICES) in place of
`jax.devices()` ids.  Every other process gets [].  The reference's own
`get_gpu_ids` (:411) always returns [], since it schedules TPUs.
"""
from __future__ import annotations

import os

import torch


def get_gpu_ids() -> list[int]:
    if os.environ.get("RAY_TPU_IS_DEVICE_WORKER") != "1":
        return []
    if not torch.cuda.is_available():
        return []
    return list(range(torch.cuda.device_count()))
