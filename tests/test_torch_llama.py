"""The port's Llama-3 serving surface against the JAX package's, on the CPU.

The `debug` preset in float32 with one parameter tree: the JAX tree goes
to the port through models.convert.params_from_jax.  Tolerances are 1e-4
(absolute and relative): XLA on the CPU and PyTorch on the CPU sum the
projections in different orders."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jl, tl, jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_params_from_jax_roundtrips_keys_and_shapes(models):
    jl, tl, jcfg, tcfg, jparams, tparams = models
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        np.testing.assert_array_equal(got[k].numpy(), _np(v))
    assert got["/layers/wq"].shape[0] == tcfg.n_layers


def test_params_from_jax_bf16_and_bad_trees(models):
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = jl.llama_configs()["debug"]                 # bf16
    tcfg = tl.llama_configs()["debug"]
    tree = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(1),
                                                   jcfg))
    got = params_from_jax(tree, tcfg, device="cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({k: v for k, v in tree.items() if k != "embed"},
                        tcfg, device="cpu")


def test_init_params_layout_and_seed(models):
    jl, tl, jcfg, tcfg, jparams, tparams = models
    a = tl.init_params(tcfg, torch.Generator().manual_seed(3))
    b = tl.init_params(tcfg, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(_leaves(a), _leaves(b)):
        assert ka == kb and torch.equal(va, vb)
    assert {k: tuple(v.shape) for k, v in _leaves(a)} == \
        {k: tuple(v.shape) for k, v in _leaves(tparams)}


def test_prefill_matches_jax(models):
    jl, tl, jcfg, tcfg, jparams, tparams = models
    toks = np.random.default_rng(0).integers(1, 256, size=(2, 20))
    jh, jk, jv = jl.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg)
    th, tk, tv = tl.prefill(tparams, torch.from_numpy(toks), tcfg)
    for got, want in ((th, jh), (tk, jk), (tv, jv)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def _pools(seed, cfg, n_pages, page, jl, tl, tcfg):
    """Random page pools, identical on both sides."""
    rng = np.random.default_rng(seed)
    shape = (n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    k = [rng.normal(size=shape).astype(np.float32)
         for _ in range(cfg.n_layers)]
    v = [rng.normal(size=shape).astype(np.float32)
         for _ in range(cfg.n_layers)]
    jc = jl.init_paged_kv_cache(cfg, 2, n_pages, page)
    jc = {"k": [jnp.asarray(a) for a in k], "v": [jnp.asarray(a) for a in v],
          "pos": jc["pos"]}
    tc = tl.init_paged_kv_cache(tcfg, 2, n_pages, page, "cpu")
    for li in range(cfg.n_layers):
        tc["k"][li].copy_(torch.from_numpy(k[li]))
        tc["v"][li].copy_(torch.from_numpy(v[li]))
    return jc, tc


@pytest.mark.parametrize("P,aligned", [
    (8, True),       # one partial page per wave member
    (32, True),      # whole pages
    (24, True),      # neither: coordinate form
    (24, False),     # forced coordinate form (suffix waves)
])
def test_scatter_prefill_pages_matches_jax(models, P, aligned):
    jl, tl, jcfg, tcfg, jparams, tparams = models
    page, n_pages, W = 16, 9, 2
    jc, tc = _pools(1, jcfg, n_pages, page, jl, tl, tcfg)
    rng = np.random.default_rng(2)
    kv_shape = (jcfg.n_layers, W, P, jcfg.n_kv_heads, jcfg.head_dim)
    ks = rng.normal(size=kv_shape).astype(np.float32)
    vs = rng.normal(size=kv_shape).astype(np.float32)
    table = np.asarray([[3, 5, 0, 0], [7, 2, 0, 0]], np.int32)
    apos = np.arange(P)
    page_ids = table[:, apos // page].astype(np.int32)
    rows = np.tile((apos % page).astype(np.int32), (W, 1))
    slots = np.asarray([0, 1], np.int32)
    lens = np.asarray([P - 3, P], np.int32)
    want = jl.scatter_prefill_pages(
        jc, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(page_ids),
        jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(lens), aligned)
    got = tl.scatter_prefill_pages(
        tc, torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(page_ids), torch.from_numpy(rows),
        torch.from_numpy(slots), torch.from_numpy(lens), aligned)
    for li in range(jcfg.n_layers):
        for kk in ("k", "v"):
            np.testing.assert_array_equal(got[kk][li].numpy()[1:],
                                          _np(want[kk][li])[1:])
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


def test_prefill_with_prefix_matches_jax(models):
    jl, tl, jcfg, tcfg, jparams, tparams = models
    page, n_pages = 16, 9
    jc, tc = _pools(3, jcfg, n_pages, page, jl, tl, tcfg)
    toks = np.random.default_rng(4).integers(1, 256, size=(2, 12))
    pos0 = np.asarray([16, 32], np.int32)
    table = np.asarray([[4, 1, 0], [6, 8, 2]], np.int32)
    want = jl.prefill_with_prefix(jparams, jnp.asarray(toks, jnp.int32),
                                  jnp.asarray(pos0), jcfg, jc["k"], jc["v"],
                                  jnp.asarray(table))
    got = tl.prefill_with_prefix(tparams, torch.from_numpy(toks),
                                 torch.from_numpy(pos0), tcfg, tc["k"],
                                 tc["v"], torch.from_numpy(table))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_decode_step_paged_matches_jax_across_a_tail_merge(models):
    """Two K-step windows with the tail merged between them, the way the
    engine drives decode: logits agree at every step."""
    from ray_tpu.ops import paged_attention as jp
    from ray_tpu_torch.ops import paged_attention as tp

    jl, tl, jcfg, tcfg, jparams, tparams = models
    page, n_pages, K, B = 8, 9, 3, 2
    jc, tc = _pools(5, jcfg, n_pages, page, jl, tl, tcfg)
    table = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    ts = np.asarray([5, 13], np.int32)
    toks = np.asarray([7, 99], np.int32)
    tshape = (B, jcfg.n_kv_heads, K, jcfg.head_dim)
    jt_tab, tt_tab = jnp.asarray(table), torch.from_numpy(table)
    jpos, tpos = jnp.asarray(ts), torch.from_numpy(ts)
    jtok, ttok = jnp.asarray(toks), torch.from_numpy(toks)
    for _window in range(2):
        jts, tts = jpos, tpos.clone()
        jtails = {kk: [jnp.zeros(tshape, jnp.float32)
                       for _ in range(jcfg.n_layers)] for kk in "kv"}
        ttails = {kk: [torch.zeros(tshape) for _ in range(jcfg.n_layers)]
                  for kk in "kv"}
        for j in range(K):
            jlog, jtails = jl.decode_step_paged(
                jparams, {"k": jc["k"], "v": jc["v"]}, jtails, jtok, jpos,
                jts, j, jt_tab, jcfg)
            tlog, ttails = tl.decode_step_paged(
                tparams, {"k": tc["k"], "v": tc["v"]}, ttails, ttok, tpos,
                tts, j, tt_tab, tcfg)
            np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
            nxt = np.array(jnp.argmax(jlog, axis=-1), np.int32)
            jtok, ttok = jnp.asarray(nxt), torch.from_numpy(nxt)
            jpos, tpos = jpos + 1, tpos + 1
        for kk in "kv":
            jc[kk] = [jp.merge_tail_pages(jc[kk][li], jtails[kk][li],
                                          jt_tab, jts, K)
                      for li in range(jcfg.n_layers)]
            for li in range(jcfg.n_layers):
                tp.merge_tail_pages(tc[kk][li], ttails[kk][li], tt_tab, tts,
                                    K)
