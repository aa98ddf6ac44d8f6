"""Rotary position embeddings (RoPE), Llama-3 style: split-half rotation
taken in f32, cast back to the input dtype (port of ray_tpu/ops/rope.py)."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 500000.0,
                     dtype=torch.float32, device=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute cos/sin tables [max_seq, head_dim//2]."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate q/k.  x: [batch, seq, heads, head_dim]; tables [max_seq, hd/2].

    positions: optional [batch, seq] absolute positions (decode-time cache
    offsets); defaults to arange(seq)."""
    s = x.shape[1]
    if positions is None:
        cos_s = cos[:s][None, :, None, :]
        sin_s = sin[:s][None, :, None, :]
    else:
        cos_s = cos[positions.long()][:, :, None, :]
        sin_s = sin[positions.long()][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s],
                    dim=-1)
    return out.to(x.dtype)
