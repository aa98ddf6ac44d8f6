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
