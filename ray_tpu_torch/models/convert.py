"""Move a JAX-package parameter tree into the port.

The caller turns each leaf into a numpy array (`np.asarray(leaf)`), so
this module needs no JAX.  Keys, shapes and the stacked layer axis stay
as they are; leaves are cast to the config's dtype on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.models.llama import LlamaConfig, param_shapes


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)                     # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bf16: reinterpret
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(tree: dict, cfg: LlamaConfig, device="cuda") -> dict:
    """The port's parameter tree from the reference's (numpy leaves)."""
    def convert(src, shapes, path):
        if isinstance(shapes, dict):
            if not isinstance(src, dict) or set(src) != set(shapes):
                got = sorted(src) if isinstance(src, dict) else type(src)
                raise ValueError(f"{path or 'params'}: keys {got} != "
                                 f"{sorted(shapes)}")
            return {k: convert(src[k], shapes[k], f"{path}/{k}")
                    for k in shapes}
        t = _tensor(src)
        if tuple(t.shape) != tuple(shapes):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(shapes)}")
        return t.to(device=device, dtype=cfg.dtype)

    return convert(tree, param_shapes(cfg), "")
