"""Flash-attention forward: the CUDA kernel (csrc/flash_fwd.cu) and its
plain PyTorch version (port of ray_tpu/ops/flash_attention.py's forward).

The public layout is the reference's: q [b, sq, hq, d], k/v [b, skv, hkv,
d], o like q; the kernel also emits the f32 lse [b, hq, sq] that the
backward kernels (a later port) read.  A CUDA tensor launches the kernel
or raises; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _kernels

HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse; b, sq, skv, hq, hkv, d, causal; sm_scale; dtype; stream
_ARGTYPES = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _P]


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: float | None = None):
    """Plain version of the kernel: f32 scores and softmax, P rounded to
    the value dtype before the PV product (the Pallas kernel's cast), the
    normaliser summed from unrounded P, fully masked rows -> zeros.
    Returns (o [b, sq, hq, d], lse [b, hq, sq] f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    n_rep = hq // hkv
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~(qpos >= kpos), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd: q, k, v must be on one CUDA "
                         "device")
    if (q.dtype not in _kernels.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError("flash_attention_fwd takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)}"
                         f" v {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             "contiguous and 16-byte aligned")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: float | None = None):
    """(o, lse) from the CUDA kernel for CUDA tensors, from the plain
    version for CPU tensors.  `flash_attention_fwd.launches` counts kernel
    launches."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal, sm_scale)
    _check(q, k, v)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = _kernels.function("flash_fwd", "rt_flash_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
             float(sm_scale), _kernels.DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None):
    """Flash attention with GQA.  q: [b, sq, hq, d]; k/v: [b, skv, hkv, d];
    returns o [b, sq, hq, d] (layout matches ops.attention)."""
    return flash_attention_fwd(q, k, v, causal, sm_scale)[0]
