"""Ring attention: sequence parallelism over the mesh's "seq" axis (port
of ray_tpu/parallel/ring.py).

Each rank holds a contiguous chunk of the sequence.  K/V chunks rotate
around the seq axis's process group (`comm.ring_shift`, the counterpart
of `lax.ppermute`, differentiable: its backward rotates the other way)
while each rank accumulates its queries' attention in streaming-softmax
form (running max, normaliser and output in f32), so the full [s, s]
score matrix never exists.  With contiguous chunks, causality lets a rank
skip the chunks that lie wholly in its future.

The block products are the reference's einsums, plain matmuls in f32 (a
bf16 product of the reference's with f32 output, `preferred_element_type`,
is the same product of the inputs widened to f32).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.ops.attention import NEG_INF, _repeat_kv, attention
from ray_tpu_torch.parallel.comm import keep_in_graph, ring_shift
from ray_tpu_torch.parallel.sharding import mesh_axis_size, mesh_of


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """Blockwise ring attention on this rank's chunk.

    q: [b, s_loc, hq, d]; k/v: [b, s_loc, hkv, d] -> [b, s_loc, hq, d].
    `group` is the sequence axis's process group; group rank i holds
    chunk i of the sequence (tokens [i * s_loc, (i + 1) * s_loc))."""
    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    b, s_loc, hq, d = q.shape
    n_rep = hq // k.shape[2]
    scale = d ** -0.5
    dev = q.device
    qpos = my_idx * s_loc + torch.arange(s_loc, device=dev)[:, None]
    m = torch.full((b, hq, s_loc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, s_loc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, s_loc, d), dtype=torch.float32, device=dev)
    qf = q.float()
    # K and V travel as one tensor: one message, one autograd node a step.
    kv = torch.cat([k, v], dim=-1)
    for t in range(n):
        src = (my_idx - t) % n                           # origin of kv
        # Chunks strictly in the future are fully masked: skip compute.
        if not (causal and src > my_idx):
            k_t, v_t = kv.split(d, dim=-1)
            kk = _repeat_kv(k_t, n_rep).float()
            vv = _repeat_kv(v_t, n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kk) * scale
            if causal:
                kpos = src * s_loc + torch.arange(s_loc, device=dev)[None, :]
                s = torch.where((qpos >= kpos)[None, None], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vv.dtype).float(), vv.float())
            m = m_new
        # Rotate KV to the next rank (i -> i + 1); the reference's last
        # rotation returns every chunk home unread, so it is not sent.
        if t < n - 1:
            kv = ring_shift(kv, group)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).to(q.dtype)               # [b, h, sq, d]
    # A rank that skipped the last chunk (it lies in its future) reads
    # the last rotation's kv nowhere; keep it in the graph so the
    # rotation's backward runs on every rank.
    return keep_in_graph(out, kv).transpose(1, 2)


def ring_attention_gspmd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         seq_axis: str = "seq",
                         causal: bool = True) -> torch.Tensor:
    """Ring attention on DTensors: q, k and v are laid out with the
    sequence split over `seq_axis` (Shard(1) on that mesh dim; batch and
    heads keep their splits), the ring runs on each rank's local chunks
    over that dim's process group, and the output comes back with q's
    layout.  With no mesh, or a seq axis of size 1, this is
    `ops.attention.attention` (the flash kernels on CUDA)."""
    mesh = mesh_of(q)
    n = mesh_axis_size(mesh, seq_axis)
    if n <= 1:
        return attention(q, k, v, causal=causal)
    names = list(mesh.mesh_dim_names)
    place = list(q.placements)
    place[names.index(seq_axis)] = Shard(1)
    place = tuple(place)
    if not all(p == Replicate() or p in (Shard(0), Shard(1), Shard(2))
               for p in place):
        raise NotImplementedError(
            f"ring attention on placements {place}: only batch (0), "
            "sequence (1) and heads (2) may be split")
    if q.shape[1] % n or k.shape[1] != q.shape[1]:
        raise ValueError(f"ring attention: sequence {q.shape[1]} (keys "
                         f"{k.shape[1]}) does not split into {n} equal "
                         "chunks")
    q, k, v = (t if tuple(t.placements) == place
               else t.redistribute(mesh, place) for t in (q, k, v))
    o = ring_attention(q.to_local(), k.to_local(), v.to_local(),
                       mesh.get_group(seq_axis), causal)
    return DTensor.from_local(o.contiguous(), mesh, place, run_check=False,
                              shape=q.shape, stride=q.stride())
