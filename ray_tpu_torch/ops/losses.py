"""Shared loss functions (port of ray_tpu/ops/losses.py): one f32 softmax
cross entropy for every model family, so the numerics policy lives in one
place."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token / classification CE over [..., n_classes] logits and
    [...] int targets, log-softmax in f32.  With a mask (pad tokens 0) the
    mean runs over the unmasked positions; an all-zero mask gives 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()
