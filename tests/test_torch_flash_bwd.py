"""The port's flash-attention backward against the JAX package's, on the CPU.

The JAX gradients come from jax.grad through the Pallas flash kernels in
interpret mode (the custom_vjp's dQ and dK/dV kernels) and through
xla_attention.  The port's side is its autograd Function on CPU tensors,
whose compute takes the plain versions of its CUDA kernels
(chip_smoke.py holds the kernels to those plain versions on the card).
Tolerance 1e-5, the rule for ops: both sides compute in f32 and differ
only in summation order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _inputs(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, s, hq, d)).astype(f),
            rng.normal(size=(b, s, hkv, d)).astype(f),
            rng.normal(size=(b, s, hkv, d)).astype(f),
            rng.normal(size=(b, s, hq, d)).astype(f))     # the cotangent


def _jax_grads(attn, q, k, v, do):
    def f(q, k, v):
        return (attn(q, k, v) * do).sum()
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(q, k, v, do, causal=True):
    from ray_tpu_torch.ops.flash_attention import flash_attention

    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*ts, causal=causal) * torch.from_numpy(do)).sum() \
        .backward()
    return [t.grad for t in ts]


def test_flash_bwd_plain_matches_pallas_interpret():
    """Several 128-row blocks and the diagonal are crossed (s 256, blocks
    of 128), GQA 4 / 2, head_dim 128."""
    from ray_tpu.ops.flash_attention import flash_attention as jflash
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference, flash_attention_fwd)

    q, k, v, do = _inputs(0, 1, 256, 4, 2, 128)
    want = _jax_grads(lambda q, k, v: jflash(q, k, v, causal=True,
                                             block_q=128, block_k=128),
                      q, k, v, do)
    got = _port_grads(q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_fwd(tq, tk, tv)
    ref = flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo)
    for g, w in zip(ref, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_xla_grad_at_ragged_length(causal):
    """No seq % 128 gate: the backward takes any length, MQA included."""
    from ray_tpu.ops.attention import xla_attention as jx

    for shape in ((2, 77, 8, 2, 64), (1, 45, 4, 1, 32)):
        q, k, v, do = _inputs(1, *shape)
        want = _jax_grads(lambda q, k, v: jx(q, k, v, causal=causal),
                          q, k, v, do)
        got = _port_grads(q, k, v, do, causal=causal)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_flash_bwd_wrappers_take_the_plain_versions_on_cpu():
    """The dQ and dK/dV wrappers on CPU tensors give the plain version's
    numbers, and the kernels' launch counters do not move."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 1, 40, 4, 2, 32))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    assert delta.shape == (1, 4, 40) and delta.dtype == torch.float32
    n0 = (fa.flash_attention_bwd_dq.launches,
          fa.flash_attention_bwd_dkv.launches)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    for g, w in zip((dq, dk, dv), ref):
        assert torch.equal(g, w)
    assert (fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == n0


def test_dkv_plain_rounds_p_and_ds_to_bf16():
    """The bf16 dK/dV kernel feeds P and dS to the tensor cores in bf16, and
    its plain version rounds them the same way before P^T dO and dS^T Q
    (in f32 the cast is a no-op, so the test above still holds the plain
    version to the Pallas kernels at 1e-5)."""
    from ray_tpu_torch.ops import flash_attention as fa

    bf = torch.bfloat16
    q, k, v, do = (torch.from_numpy(a).to(bf)
                   for a in _inputs(3, 1, 50, 4, 2, 32))
    scale = 32 ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    dk, dv = fa._dkv_plain(q, k, v, do, lse, delta, True, scale)
    assert dk.dtype == bf and dv.dtype == bf

    p, ds, _ = fa._probs(q, k, v, do, lse, delta, True, scale)

    def per_kv_head(x):            # [b, s, hq, d] -> sum over each group
        return x.reshape(1, 50, 2, 2, 32).sum(3).to(bf)

    def products(p, ds):
        return (per_kv_head(torch.einsum("bhqk,bqhd->bkhd", ds, q.float())),
                per_kv_head(torch.einsum("bhqk,bqhd->bkhd", p, do.float())))

    want_dk, want_dv = products(p.to(bf).float(), ds.to(bf).float())
    assert torch.equal(dk, want_dk) and torch.equal(dv, want_dv)
    f32_dk, f32_dv = products(p, ds)          # without the cast
    assert not torch.equal(dk, f32_dk) and not torch.equal(dv, f32_dv)


def test_dtype_routes_and_cpu_counts():
    """bf16 takes the tensor-core kernels and f32 the FMA kernels on the
    card; CPU tensors launch neither, so no route count moves."""
    from ray_tpu_torch.ops import flash_attention as fa

    assert fa.ROUTES == {torch.bfloat16: "wgmma", torch.float32: "fma"}
    before = (dict(fa.flash_attention_fwd.launches_by_route),
              dict(fa.flash_attention_bwd_dkv.launches_by_route))
    assert set(before[0]) == set(before[1]) == {"wgmma", "fma"}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.from_numpy(a).to(dtype)
                       for a in _inputs(4, 1, 20, 2, 1, 64))
        o, lse = fa.flash_attention_fwd(q, k, v)
        fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                   fa.attention_delta(o, do))
    assert (fa.flash_attention_fwd.launches_by_route,
            fa.flash_attention_bwd_dkv.launches_by_route) == before


def test_dq_routes_and_cpu_counts():
    """dQ has a route per dtype like the forward and dK/dV: bf16 on the
    tensor cores (wgmma), f32 on the FMA kernel.  CPU tensors launch
    neither, so no dQ count moves, and the CPU result is the plain
    version's in both dtypes."""
    from ray_tpu_torch.ops import flash_attention as fa

    dq_fn = fa.flash_attention_bwd_dq
    before = (dq_fn.launches, dict(dq_fn.launches_by_route))
    assert set(before[1]) == {"wgmma", "fma"}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.from_numpy(a).to(dtype)
                       for a in _inputs(5, 1, 33, 4, 2, 32))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(o, do)
        dq = dq_fn(q, k, v, do, lse, delta)
        assert dq.dtype == dtype
        assert torch.equal(dq, fa._dq_plain(q, k, v, do, lse, delta, True,
                                            32 ** -0.5))
    assert (dq_fn.launches, dq_fn.launches_by_route) == before
