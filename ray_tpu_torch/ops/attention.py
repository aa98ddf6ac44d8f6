"""Attention dispatcher (port of ray_tpu/ops/attention.py).

On CUDA tensors, causal self-attention (q_len == k_len, no offset) with
head_dim 32, 64 or 128 goes through the flash autograd Function (forward
kernel; dQ and dK/dV kernels in the backward) at any sequence length: the
kernels mask the ragged edge, so the TPU's seq % 128 and head_dim % 128
tiling gates do not apply.  Any other CUDA call raises.  CPU tensors take
the plain version, `xla_attention`, as the reference does off-TPU; both
paths carry gradients.
"""
from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_attention

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  q_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """Plain attention: f32 softmax, GQA, causal mask; probabilities cast
    to the value dtype before the PV product, as in the reference.

    q: [b, sq, hq, d]; k/v: [b, skv, hkv, d].  q_offset shifts query
    positions relative to kv positions (decode with a cache)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where((qpos >= kpos)[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              q_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """Multi-head attention with GQA: the flash kernel on CUDA, the plain
    version on the CPU."""
    if not q.is_cuda:
        return xla_attention(q, k, v, causal=causal, q_offset=q_offset)
    if (causal and q.shape[1] == k.shape[1] and q.shape[-1] in HEAD_DIMS
            and isinstance(q_offset, int) and q_offset == 0):
        return flash_attention(q, k, v, causal=True)
    raise ValueError(
        "attention on CUDA takes causal self-attention (q_len == k_len, "
        f"q_offset 0) with head_dim in {HEAD_DIMS}; got q {tuple(q.shape)}, "
        f"k {tuple(k.shape)}, causal={causal}, q_offset={q_offset!r}")
