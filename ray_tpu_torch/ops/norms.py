"""Normalization ops with f32 accumulation (port of ray_tpu/ops/norms.py).

Like the reference, RMSNorm has no hand-written kernel: it is a small
memory-bound pass next to the projections, and attention is where a
kernel pays."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * scale.float() + bias.float()).to(x.dtype)
