"""The port's ops (ray_tpu_torch.ops) against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both.  The Pallas
kernels run in interpret mode off-TPU, as the JAX package's own tests run
them; the port's CUDA kernels cannot run here, so its wrappers take their
plain versions on CPU tensors (chip_smoke.py holds the kernels to those
plain versions on the card)."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("with_positions", [False, True])
def test_rope_matches_jax(with_positions):
    from ray_tpu.ops import rope as jr
    from ray_tpu_torch.ops import rope as tr

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 60, size=(2, 8)) if with_positions else None
    jc, js = jr.rope_frequencies(32, 64, 500000.0)
    tc, ts = tr.rope_frequencies(32, 64, 500000.0)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=ATOL)
    want = jr.apply_rope(jnp.asarray(x), jc, js,
                         None if pos is None else jnp.asarray(pos))
    got = tr.apply_rope(_t(x), tc, ts,
                        None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_norms_match_jax():
    from ray_tpu.ops import norms as jn
    from ray_tpu_torch.ops import norms as tn

    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tn.rmsnorm(_t(x), _t(w)).numpy(),
        _np(jn.rmsnorm(jnp.asarray(x), jnp.asarray(w))), atol=ATOL)
    np.testing.assert_allclose(
        tn.layernorm(_t(x), _t(w), _t(bias)).numpy(),
        _np(jn.layernorm(jnp.asarray(x), jnp.asarray(w),
                         jnp.asarray(bias))), atol=ATOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tn.rmsnorm(xb, _t(w)).dtype == torch.bfloat16


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal,q_offset,sq,skv", [
    (True, 0, 12, 12),          # GQA causal self-attention
    (True, 5, 4, 9),            # decode-style offset queries
    (False, 0, 6, 10),
])
def test_xla_attention_matches_jax(causal, q_offset, sq, skv):
    from ray_tpu.ops.attention import xla_attention as jx
    from ray_tpu_torch.ops.attention import xla_attention as tx

    q, k, v = _qkv(2, 2, sq, skv, 4, 2, 16)
    want = jx(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              causal=causal, q_offset=q_offset)
    got = tx(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def test_attention_dispatcher_takes_plain_version_on_cpu():
    from ray_tpu_torch.ops.attention import attention, xla_attention

    q, k, v = _qkv(3, 1, 7, 7, 4, 2, 16)
    np.testing.assert_array_equal(
        attention(_t(q), _t(k), _t(v)).numpy(),
        xla_attention(_t(q), _t(k), _t(v)).numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(causal):
    """The port's plain flash forward (o and lse) against the Pallas
    forward kernel in interpret mode."""
    from ray_tpu.ops.flash_attention import _flash_fwd, flash_attention
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd

    q, k, v = _qkv(4, 1, 128, 128, 4, 2, 32)
    o, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    want_o = flash_attention(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), _np(want_o), atol=ATOL)
    _, want_lse = _flash_fwd(jnp.asarray(q).transpose(0, 2, 1, 3),
                             jnp.asarray(k).transpose(0, 2, 1, 3),
                             jnp.asarray(v).transpose(0, 2, 1, 3),
                             32 ** -0.5, causal, 128, 128)
    assert lse.shape == (1, 4, 128) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _np(want_lse), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_xla_at_ragged_length(causal):
    """No seq % 128 gate: the port's flash forward takes any length."""
    from ray_tpu.ops.attention import xla_attention as jx
    from ray_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = _qkv(5, 2, 77, 77, 8, 2, 64)
    want = jx(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              causal=causal)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


def _paged_case(seed, B, kvh, rep, hd, kt, page, n_pages, maxp):
    rng = np.random.default_rng(seed)
    f = np.float32
    arrs = [rng.normal(size=(B, kvh, rep, hd)).astype(f),
            rng.normal(size=(n_pages, kvh, page, hd)).astype(f),
            rng.normal(size=(n_pages, kvh, page, hd)).astype(f),
            rng.normal(size=(B, kvh, kt, hd)).astype(f),
            rng.normal(size=(B, kvh, kt, hd)).astype(f)]
    table = np.arange(1, 1 + B * maxp, dtype=np.int32).reshape(B, maxp)
    return arrs, table


def _both(arrs, table, pos, ts):
    """(port args, jax args) for one paged-decode call."""
    ints = [table, np.asarray(pos, np.int32), np.asarray(ts, np.int32)]
    t_args = [_t(a) for a in arrs] + [torch.from_numpy(i) for i in ints]
    j_args = [jnp.asarray(a) for a in arrs] + [jnp.asarray(i) for i in ints]
    return t_args, j_args


@pytest.mark.parametrize("page", [8, 16])
def test_paged_plain_matches_pallas_across_page_counts(page):
    """tests/test_paged_attention.py:15's case: tail starts spanning 0..4
    pages, boundaries included."""
    from ray_tpu.ops.paged_attention import (paged_decode_attention as jk,
                                             paged_decode_reference as jr)
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    arrs, table = _paged_case(0, 4, 2, 2, 32, 4, page, 20, 4)
    ts = np.asarray([0, page - 1, page, 3 * page + 3])
    t_args, j_args = _both(arrs, table, ts + 2, ts)
    got = paged_decode_attention(*t_args).numpy()
    np.testing.assert_allclose(got, _np(jk(*j_args)), atol=ATOL)
    np.testing.assert_allclose(got, _np(jr(*j_args)), atol=ATOL)


def test_paged_merge_roundtrip_matches_jax():
    """tests/test_paged_attention.py:45's case: merging a window's tail and
    attending it from the pages == attending it from the tail."""
    from ray_tpu.ops import paged_attention as jp
    from ray_tpu_torch.ops import paged_attention as tp

    arrs, _ = _paged_case(1, 2, 2, 1, 16, 4, 8, 10, 2)
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    ts = np.asarray([3, 6])
    t_args, j_args = _both(arrs, table, ts + 3, ts)
    o_in = tp.paged_decode_attention(*t_args)
    np.testing.assert_allclose(o_in.numpy(),
                               _np(jp.paged_decode_attention(*j_args)),
                               atol=ATOL)
    q, kp, vp, ktl, vtl, tab, pos, tst = t_args
    kp2 = tp.merge_tail_pages(kp.clone(), ktl, tab, tst, 4)
    vp2 = tp.merge_tail_pages(vp.clone(), vtl, tab, tst, 4)
    jkp2 = jp.merge_tail_pages(j_args[1], j_args[3], j_args[5], j_args[7], 4)
    np.testing.assert_array_equal(kp2.numpy(), _np(jkp2))
    empty = torch.zeros_like(ktl)
    o_next = tp.paged_decode_attention(q, kp2, vp2, empty, empty, tab, pos,
                                       pos + 1)
    np.testing.assert_allclose(o_in.numpy(), o_next.numpy(), atol=ATOL)


def test_paged_runaway_idle_slot():
    """tests/test_paged_attention.py:76's case: an idle slot whose pos ran
    far past the table stays finite, and the live slot still matches."""
    from ray_tpu.ops.paged_attention import paged_decode_attention as jk
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    B, kvh, rep, hd, kt, page, n_pages, maxp = 2, 1, 1, 16, 2, 8, 4, 2
    rng = np.random.default_rng(2)
    arrs = [np.ones((B, kvh, rep, hd), np.float32),
            rng.normal(size=(n_pages, kvh, page, hd)).astype(np.float32),
            rng.normal(size=(n_pages, kvh, page, hd)).astype(np.float32),
            np.ones((B, kvh, kt, hd), np.float32),
            np.ones((B, kvh, kt, hd), np.float32)]
    table = np.zeros((B, maxp), np.int32)
    ts = np.asarray([3, 10_000])
    t_args, j_args = _both(arrs, table, ts + 1, ts)
    got = paged_decode_attention(*t_args).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[0], _np(jk(*j_args))[0], atol=ATOL)


def test_paged_plain_zero_for_slot_with_nothing_admitted():
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    arrs, table = _paged_case(3, 2, 2, 2, 32, 4, 8, 10, 2)
    t_args, _ = _both(arrs, table, [-1, 5], [0, 5])
    out = paged_decode_attention(*t_args).numpy()
    assert np.all(out[0] == 0.0) and np.all(np.isfinite(out))


def test_merge_and_gather_pages_match_jax():
    from ray_tpu.ops import paged_attention as jp
    from ray_tpu_torch.ops import paged_attention as tp

    arrs, table = _paged_case(4, 3, 2, 1, 16, 4, 8, 12, 3)
    _, pages, _, tail, _ = arrs
    # Slot 1's window runs past its allocation; slot 2 is short (n_rows).
    ts = np.asarray([5, 21, 0], np.int32)
    want = jp.merge_tail_pages(jnp.asarray(pages), jnp.asarray(tail),
                               jnp.asarray(table), jnp.asarray(ts), 3)
    got = tp.merge_tail_pages(_t(pages), _t(tail), torch.from_numpy(table),
                              torch.from_numpy(ts), 3)
    # Page 0 is the trash page: which duplicate write lands is unspecified.
    np.testing.assert_array_equal(got.numpy()[1:], _np(want)[1:])
    np.testing.assert_array_equal(
        tp.gather_pages(got, torch.from_numpy(table)).numpy(),
        _np(jp.gather_pages(want, jnp.asarray(table))))


def test_kernel_build_is_keyed_by_sources_and_flags(monkeypatch, tmp_path):
    """Libraries land in the git-ignored _build/<hash>/ directory, the hash
    changes with the flags, and a machine without nvcc gets a clear error
    (the kernels build only where the CUDA toolkit is)."""
    from ray_tpu_torch import _kernels

    src, out_dir, so = _kernels._paths("paged_decode")
    assert src.endswith("csrc/paged_decode.cu") and os.path.exists(src)
    assert os.path.dirname(out_dir).endswith("ray_tpu_torch/_build")
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ["-G"])
    assert _kernels._paths("paged_decode")[1] != out_dir
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._nvcc()


def test_launch_counts_defer_per_thread_and_credit():
    """Counts made inside `deferred()` on this thread go to its Counter,
    not to the wrapper; another thread's count lands at once; `credit`
    adds the Counter per replay."""
    import threading

    from ray_tpu_torch.ops import counters

    def fn():
        pass

    fn.launches = 0
    fn.launches_by_route = {"wgmma": 0, "fma": 0}
    counters.count(fn, "fma")
    with counters.deferred() as rec:
        counters.count(fn, "wgmma")
        counters.count(fn, "wgmma")
        t = threading.Thread(target=counters.count, args=(fn, "fma"))
        t.start()
        t.join()
    assert fn.launches == 2 and fn.launches_by_route == {"wgmma": 0,
                                                         "fma": 2}
    assert rec == {(fn, None): 2, (fn, "wgmma"): 2}
    counters.credit(rec)
    counters.credit(rec)
    assert fn.launches == 6 and fn.launches_by_route == {"wgmma": 4,
                                                         "fma": 2}
    counters.count(fn)                    # outside the block: counted
    assert fn.launches == 7
