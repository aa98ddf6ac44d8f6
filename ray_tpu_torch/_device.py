"""The one device rule of the port's entry points: they run on CUDA unless
the caller asks for the CPU, and raise where there is no CUDA device
rather than fall back quietly."""
from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """torch.device for an entry point's `device` argument (None = cuda)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on CUDA and no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return device
