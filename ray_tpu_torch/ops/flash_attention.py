"""Flash attention, forward and backward: the CUDA kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu), their plain PyTorch versions, and
the autograd Function that joins them (port of
ray_tpu/ops/flash_attention.py and its custom_vjp).

The public layout is the reference's: q [b, sq, hq, d], k/v [b, skv, hkv,
d], o like q; the forward also emits the f32 lse [b, hq, sq] that the
backward reads.  A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version.  The autograd Function is the same on both
devices, so the CPU tests run its wiring.

The forward, dQ and dK/dV each have two kernels, chosen by dtype in the
C entry (`ROUTES`): bf16 runs on the tensor cores (wgmma, TMA), f32 keeps
the FMA loops, since the tensor cores would round f32 to TF32.
`<wrapper>.launches` counts every launch, `<wrapper>.launches_by_route`
each kernel's (ops/counters.py).

The forward is registered as the custom op `ray_tpu_torch::flash_fwd`
(`FLASH_FWD_OP`): a kernel launched through ctypes is invisible to
PyTorch's dispatcher, and a selective-checkpoint policy
(models/llama.remat_policy) can save only what the dispatcher sees.
Saving the op's (o, lse) keeps the backward from re-running the forward
kernel, as the reference's "flash_o" / "flash_lse" names do.
"""
from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.ops import counters

HEAD_DIMS = (32, 64, 128)
# The kernel each dtype launches in the forward, dQ and dK/dV C entries.
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fma"}
_P, _I = ctypes.c_void_p, ctypes.c_int
# q, k, v, o, lse; b, sq, skv, hq, hkv, d, causal; sm_scale; dtype; stream
_ARGTYPES = [_P] * 5 + [_I] * 7 + [ctypes.c_float, _I, _P]
# q, k, v, do, lse, delta, dq; b, sq, skv, hq, hkv, d, causal; sm_scale;
# dtype; stream
_DQ_ARGTYPES = [_P] * 7 + [_I] * 7 + [ctypes.c_float, _I, _P]
# q, k, v, do, lse, delta, dk, dv; the same scalars
_DKV_ARGTYPES = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P]


def _scale(q, sm_scale):
    return q.shape[-1] ** -0.5 if sm_scale is None else sm_scale


def _admit(sq: int, skv: int, device) -> torch.Tensor:
    """Causal mask [sq, skv]: query i sees keys j <= i."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(skv, device=device)[None, :])


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: float | None = None):
    """Plain version of the kernel: f32 scores and softmax, P rounded to
    the value dtype before the PV product (the Pallas kernel's cast), the
    normaliser summed from unrounded P, fully masked rows -> zeros.
    Returns (o [b, sq, hq, d], lse [b, hq, sq] f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    sm_scale = _scale(q, sm_scale)
    n_rep = hq // hkv
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    if causal:
        s = s.masked_fill(~_admit(sq, skv, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _check(q, k, v, what: str = "flash_attention_fwd") -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v must be on one CUDA device")
    if (q.dtype not in _kernels.DTYPE_CODES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"{what} takes float32 or bfloat16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
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
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")


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
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    fn = _kernels.function("flash_fwd", "rt_flash_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
             float(_scale(q, sm_scale)), _kernels.DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _kernels.check(err, "flash_attention_fwd")
    counters.count(flash_attention_fwd, ROUTES[q.dtype])
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_route = dict.fromkeys(ROUTES.values(), 0)


# ----------------------------------------------------------------- backward
def attention_delta(o, do) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [b, hq, sq] (the reference leaves this
    elementwise pass to XLA outside the kernels)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q, k, v, do, lse, delta, causal, sm_scale):
    """(P, dS, repeated K in f32): P = exp(S - lse) with masked pairs at 0,
    dS = P * (dO V^T - delta) * scale, all f32 [b, hq, sq, skv]."""
    sq, hq = q.shape[1], q.shape[2]
    skv, n_rep = k.shape[1], hq // k.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=2)
    vf = v.float().repeat_interleave(n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_admit(sq, skv, q.device), p, torch.zeros_like(p))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds, kf


def _dq_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """Plain version of the dQ kernel: dS rounded to K's dtype before
    dS K (the Pallas kernel's cast)."""
    _, ds, kf = _probs(q, k, v, do, lse, delta, causal, sm_scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf)
    return dq.to(q.dtype)


def _dkv_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """Plain version of the dK/dV kernel: P and dS rounded to the value and
    query dtypes before P^T dO and dS^T Q (the bf16 kernel's tensor cores
    take bf16; a no-op in f32, where the Pallas kernel's f32 P and dS are
    kept); each kv head sums over its n_rep query heads."""
    p, ds, _ = _probs(q, k, v, do, lse, delta, causal, sm_scale)
    b, skv, hkv, d = k.shape
    n_rep = q.shape[2] // hkv
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(b, skv, hkv, n_rep, d).sum(3)
    dv = dv.reshape(b, skv, hkv, n_rep, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  sm_scale: float | None = None):
    """Plain version of both backward kernels, the same formulas and casts
    written out (not autograd of the forward).  Returns (dq, dk, dv)."""
    sm_scale = _scale(q, sm_scale)
    delta = attention_delta(o, do)
    return (_dq_plain(q, k, v, do, lse, delta, causal, sm_scale),
            *_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale))


def _check_bwd(q, k, v, do, lse, delta, what: str) -> None:
    _check(q, k, v, what)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{what}: do {tuple(do.shape)} {do.dtype} must "
                         f"match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, hq, sq) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{what}: {name} must be f32 [b, hq, sq] = "
                             f"{(b, hq, sq)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")


def _bwd_scalars(q, k, causal, sm_scale):
    b, sq, hq, d = q.shape
    return (b, sq, k.shape[1], hq, k.shape[2], d, int(causal),
            float(_scale(q, sm_scale)), _kernels.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           sm_scale: float | None = None):
    """dQ from the CUDA kernel for CUDA tensors, from the plain version for
    CPU tensors.  `flash_attention_bwd_dq.launches` counts kernel launches,
    `.launches_by_route` those of each dtype route."""
    if not q.is_cuda:
        return _dq_plain(q, k, v, do, lse, delta, causal,
                         _scale(q, sm_scale))
    _check_bwd(q, k, v, do, lse, delta, "flash_attention_bwd_dq")
    dq = torch.empty_like(q)
    fn = _kernels.function("flash_bwd", "rt_flash_bwd_dq", _DQ_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_bwd_scalars(q, k, causal, sm_scale))
    _kernels.check(err, "flash_attention_bwd_dq")
    counters.count(flash_attention_bwd_dq, ROUTES[q.dtype])
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_by_route = dict.fromkeys(ROUTES.values(), 0)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            sm_scale: float | None = None):
    """(dk, dv) from the CUDA kernel for CUDA tensors, from the plain
    version for CPU tensors.  `flash_attention_bwd_dkv.launches` counts
    kernel launches."""
    if not q.is_cuda:
        return _dkv_plain(q, k, v, do, lse, delta, causal,
                          _scale(q, sm_scale))
    _check_bwd(q, k, v, do, lse, delta, "flash_attention_bwd_dkv")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _kernels.function("flash_bwd", "rt_flash_bwd_dkv", _DKV_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_bwd_scalars(q, k, causal, sm_scale))
    _kernels.check(err, "flash_attention_bwd_dkv")
    counters.count(flash_attention_bwd_dkv, ROUTES[q.dtype])
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_by_route = dict.fromkeys(ROUTES.values(), 0)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: float | None = None):
    """(dq, dk, dv): delta in plain torch, then the two kernels (or their
    plain versions on CPU tensors)."""
    do = do.contiguous()
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------- autograd
@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, sm_scale: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal, sm_scale)


FLASH_FWD_OP = torch.ops.ray_tpu_torch.flash_fwd.default


class FlashAttention(torch.autograd.Function):
    """The reference's custom_vjp (flash_attention.py:344-362): the forward
    saves (q, k, v, o, lse); the backward runs the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = FLASH_FWD_OP(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None):
    """Differentiable flash attention with GQA.  q: [b, sq, hq, d]; k/v:
    [b, skv, hkv, d]; returns o [b, sq, hq, d] (layout matches
    ops.attention)."""
    return FlashAttention.apply(q, k, v, causal, float(_scale(q, sm_scale)))
