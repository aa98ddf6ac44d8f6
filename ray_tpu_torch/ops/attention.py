"""Attention dispatcher (port of ray_tpu/ops/attention.py).

On CUDA tensors, causal self-attention (q_len == k_len, no offset) with
head_dim 32, 64 or 128 goes through the flash autograd Function (forward
kernel; dQ and dK/dV kernels in the backward) at any sequence length: the
kernels mask the ragged edge, so the TPU's seq % 128 and head_dim % 128
tiling gates do not apply.  Any other CUDA call raises.  CPU tensors take
the plain version, `xla_attention`, as the reference does off-TPU; both
paths carry gradients.

DTensor inputs (the sharded train step) that split batch and heads only
are a whole attention problem on every shard: the local shards go through
the same dispatch (the flash kernels on CUDA) and the result is wrapped
back on the mesh with q's placements, so no rank gathers q, k or v.  A
sequence split over the "seq" axis is gathered first (what GSPMD does to
the reference's plain attention); ring attention (parallel/ring.py)
attends over the split instead.
"""
from __future__ import annotations

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

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
    version on the CPU, on the local shards for DTensors."""
    if isinstance(q, DTensor):
        return _local_attention(q, k, v, causal, q_offset)
    if not q.is_cuda:
        return xla_attention(q, k, v, causal=causal, q_offset=q_offset)
    if (causal and q.shape[1] == k.shape[1] and q.shape[-1] in HEAD_DIMS
            and isinstance(q_offset, int) and q_offset == 0):
        return flash_attention(q, k, v, causal=True)
    raise ValueError(
        "attention on CUDA takes causal self-attention (q_len == k_len, "
        f"q_offset 0) with head_dim in {HEAD_DIMS}; got q {tuple(q.shape)}, "
        f"k {tuple(k.shape)}, causal={causal}, q_offset={q_offset!r}")


def _local_attention(q, k, v, causal, q_offset):
    """attention() on each rank's shards.  q, k and v must carry the same
    placements, each Replicate or a Shard of the batch (0), sequence (1)
    or heads (2) dim; a split sequence is gathered for the call and split
    again after it."""
    place = tuple(q.placements)
    if tuple(k.placements) != place or tuple(v.placements) != place:
        raise ValueError(f"attention: q, k and v placements differ: {place}, "
                         f"{tuple(k.placements)}, {tuple(v.placements)}")
    if not all(p == Replicate() or p in (Shard(0), Shard(1), Shard(2))
               for p in place):
        raise NotImplementedError(
            f"attention on placements {place}: only the batch, sequence "
            "and heads dims may be sharded")
    if Shard(1) in place:
        mesh = q.device_mesh
        whole = tuple(Replicate() if p == Shard(1) else p for p in place)
        o = _local_attention(*(t.redistribute(mesh, whole)
                               for t in (q, k, v)), causal, q_offset)
        return o.redistribute(mesh, place)
    o = attention(q.to_local(), k.to_local(), v.to_local(), causal,
                  q_offset)
    return DTensor.from_local(o.contiguous(), q.device_mesh, place,
                              run_check=False, shape=q.shape,
                              stride=q.stride())
