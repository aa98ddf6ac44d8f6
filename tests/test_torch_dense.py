"""The dense engine (paged=False) of the port against the JAX package's, on
the CPU.

`debug` preset in float32, one parameter tree on both sides
(`params_from_jax`), inputs from numpy seeds, `device="cpu"`.  The dense
model functions (`_decode_layer`, `init_kv_cache_leaves`,
`decode_step_unrolled`, `init_kv_cache`, `decode_step`) agree with the
reference to 1e-4 (XLA and PyTorch on the CPU sum in other orders); the
port writes its cache in place where the reference returns a new one.
The engine and the server give the reference's greedy tokens (token
identity at temperature 0), and within the port the dense engine draws
the paged engine's tokens at temperature 0 and 0.8.

No test boots the ray_tpu runtime, and every wait has a timeout (`T`
seconds)."""
import asyncio
import concurrent.futures
import dataclasses
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

T = 120.0
TOL = dict(atol=1e-4, rtol=1e-4)
# Six requests for four slots: the last two wait for a slot to free.
PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
           for k, n in ((7, 21), (5, 13), (11, 30), (3, 9), (13, 40),
                        (17, 5))]
NEW = [9, 6, 12, 7, 5, 10]
ENGINE = dict(max_batch=4, max_len=128, steps_per_sync=4, seed=0)
# stats() keys the port's engine has and the reference's does not (as in
# tests/test_torch_server.py).
PORT_ONLY_KEYS = {"adapter_loads", "adapter_evictions", "decode_windows",
                  "graph_replays", "graph_captures", "graph_capture_s"}


@pytest.fixture(scope="module")
def m():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    new = jax.tree.map(np.asarray,
                       jl.init_params(jax.random.PRNGKey(99), jcfg))
    return types.SimpleNamespace(
        jl=jl, tl=tl, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
        np_params=np_params, new=new,
        tparams=params_from_jax(np_params, tcfg, device="cpu"))


def _within(fn, *args):
    """fn(*args) on a daemon thread, waited for at most T seconds."""
    fut = concurrent.futures.Future()

    def run():
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    return fut.result(timeout=T)


def _np(x):
    return np.asarray(x, np.float32)


def _cache_state(m, b, max_len, seed):
    """Random dense K/V rows and per-sequence positions (one sequence at
    max_len - 1, one past the end, whose write clamps to the last row)."""
    rng = np.random.default_rng(seed)
    cfg = m.tcfg
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    k = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    pos = np.array([5, 17, max_len - 1, max_len + 2][:b], np.int32)
    toks = rng.integers(1, cfg.vocab_size, size=(b,)).astype(np.int32)
    return k, v, pos, toks


def _port_leaves(k, v, pos):
    return {"k": [torch.from_numpy(x.copy()) for x in k],
            "v": [torch.from_numpy(x.copy()) for x in v],
            "pos": torch.from_numpy(pos.copy())}


# ------------------------------------------------------- model functions
def test_init_kv_caches_match_jax(m):
    for fn in ("init_kv_cache_leaves", "init_kv_cache"):
        got = getattr(m.tl, fn)(m.tcfg, 3, 16, device="cpu")
        want = getattr(m.jl, fn)(m.jcfg, 3, 16)
        assert set(got) == set(want) == {"k", "v", "pos"}, fn
        for key in ("k", "v"):
            g = got[key] if isinstance(got[key], list) else [got[key]]
            w = want[key] if isinstance(want[key], list) else [want[key]]
            assert [tuple(t.shape) for t in g] == [t.shape for t in w], fn
            assert all(t.dtype == torch.float32 and not t.any() for t in g)
        assert got["pos"].dtype == torch.int32 and not got["pos"].any()
        assert tuple(got["pos"].shape) == want["pos"].shape


def test_decode_layer_matches_jax(m):
    """One layer: the hidden state out, and the cache rows it wrote."""
    cfg, b, max_len = m.tcfg, 4, 24
    k, v, pos, _ = _cache_state(m, b, max_len, 1)
    x = np.random.default_rng(2).normal(size=(b, 1, cfg.dim)) \
        .astype(np.float32)
    mask = np.arange(max_len)[None, :] <= pos[:, None]
    jcos, jsin = m.jl.rope_frequencies(cfg.head_dim, max_len,
                                       cfg.rope_theta)
    lp = jax.tree.map(lambda a: a[0], m.jparams["layers"])
    jx, jk, jv = m.jl._decode_layer(
        jnp.asarray(x), lp, jnp.asarray(k[0]), jnp.asarray(v[0]),
        jnp.asarray(pos), jcos, jsin, jnp.asarray(mask), m.jcfg)
    ck, cv = torch.from_numpy(k[0].copy()), torch.from_numpy(v[0].copy())
    cos, sin = m.tl.rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta)
    tx = m.tl._decode_layer(torch.from_numpy(x), m.tl._layer(m.tparams, 0),
                            ck, cv, torch.from_numpy(pos), cos, sin,
                            torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(tx.numpy(), _np(jx), **TOL)
    np.testing.assert_allclose(ck.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(cv.numpy(), _np(jv), **TOL)
    assert not np.array_equal(ck.numpy(), k[0])        # written in place


def test_decode_step_unrolled_matches_jax(m):
    """Three steps over per-layer leaves: logits, every leaf, pos."""
    b, max_len = 4, 24
    k, v, pos, toks = _cache_state(m, b, max_len, 3)
    jc = {"k": [jnp.asarray(x) for x in k], "v": [jnp.asarray(x) for x in v],
          "pos": jnp.asarray(pos)}
    tc = _port_leaves(k, v, pos)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    for _ in range(3):
        jlog, jc = m.jl.decode_step_unrolled(m.jparams, jc, jt, m.jcfg)
        tlog, out = m.tl.decode_step_unrolled(m.tparams, tc, tt, m.tcfg)
        assert out is tc
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
        jt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        tt = tlog.argmax(dim=-1).to(torch.int32)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
    for key in ("k", "v"):
        for g, w in zip(tc[key], jc[key]):
            np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_step_matches_jax_and_the_unrolled_step(m):
    """The stacked [L, ...] cache: the reference's logits and cache, and
    the port's unrolled step on the same state bit for bit."""
    b, max_len = 4, 24
    k, v, pos, toks = _cache_state(m, b, max_len, 4)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos.copy())}
    uc = _port_leaves(k, v, pos)
    jt = jnp.asarray(toks)
    tt = torch.from_numpy(toks)
    for _ in range(2):
        jlog, jc = m.jl.decode_step(m.jparams, jc, jt, m.jcfg)
        tlog, out = m.tl.decode_step(m.tparams, tc, tt, m.tcfg)
        ulog, _ = m.tl.decode_step_unrolled(m.tparams, uc, tt, m.tcfg)
        assert out is tc
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), **TOL)
        assert torch.equal(tlog, ulog)
        tt = tlog.argmax(dim=-1).to(torch.int32)
        jt = jnp.asarray(tt.numpy())
    np.testing.assert_allclose(tc["k"].numpy(), _np(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), _np(jc["v"]), **TOL)
    assert torch.equal(tc["k"], torch.stack(uc["k"]))
    assert torch.equal(tc["v"], torch.stack(uc["v"]))
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ------------------------------------------------------------- the engine
def _port_engine(m, tree=None, **kw):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.serve.llm import LLMEngine

    params = m.tparams if tree is None else params_from_jax(
        tree, m.tcfg, device="cpu")
    return LLMEngine(m.tcfg, params, device="cpu",
                     **{**ENGINE, "paged": False, **kw})


def _jax_engine(m, **kw):
    from ray_tpu.serve.llm import LLMEngine

    return LLMEngine(m.jcfg, m.jparams, **{**ENGINE, "paged": False, **kw})


def _wave(eng, temperature=0.0):
    """All of PROMPTS submitted at once; their tokens."""
    eng.start()
    try:
        futs = [eng.submit(p, max_new_tokens=n, temperature=temperature)
                for p, n in zip(PROMPTS, NEW)]
        return [f.result(timeout=T)["tokens"] for f in futs]
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_tokens(m):
    """The JAX dense engine's greedy tokens for the wave, per K."""
    return {k: _wave(_jax_engine(m, steps_per_sync=k)) for k in (1, 4, 8)}


@pytest.mark.parametrize("k", [1, 4, 8])
def test_dense_engine_tokens_match_jax(m, jax_tokens, k):
    eng = _port_engine(m, steps_per_sync=k)
    got = _wave(eng)
    assert got == jax_tokens[k]
    assert [len(t) for t in got] == NEW
    st = eng.stats()
    assert st["completed"] == len(PROMPTS) and st["preemptions"] == 0
    assert not st["prefix_cache"] and not st["kv_preempt"]
    # On the CPU every window is eager: no graph is captured.
    assert st["decode_windows"] > 0 and st["graph_captures"] == 0


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_dense_equals_paged_engine(m, temp):
    """Same params, seed and submission order: the dense engine draws the
    paged engine's tokens (sampling keys on engine seed, request seed and
    token index, not on the cache layout)."""
    dense = _wave(_port_engine(m), temp)
    paged = _wave(_port_engine(m, paged=True, page_size=8), temp)
    assert dense == paged
    assert [len(t) for t in dense] == NEW


def test_dense_update_weights_matches_jax(m):
    """A swap staged while a request decodes: the request keeps its budget
    and the next request decodes the JAX dense engine's tokens after the
    same update."""
    def run(eng, wait):
        eng.start()
        try:
            fut = eng.submit(PROMPTS[0], max_new_tokens=20)
            assert eng.update_weights(m.new, 3) == 3
            assert len(fut.result(timeout=T)["tokens"]) == 20
            deadline = time.time() + T
            while wait(eng) != 3 and time.time() < deadline:
                time.sleep(0.01)
            assert wait(eng) == 3
            return eng.generate(PROMPTS[2], max_new_tokens=8)["tokens"]
        finally:
            eng.stop()

    eng = _port_engine(m, tree=m.np_params)
    got = run(eng, lambda e: e.stats()["weight_version"])
    want = run(_jax_engine(m), lambda e: e.stats()["weight_version"])
    assert got == want
    np.testing.assert_array_equal(eng.params["final_norm"].numpy(),
                                  m.new["final_norm"])
    fresh = _wave(_port_engine(m, tree=m.new))
    assert got == fresh[2][:8]


def test_dense_rejections_match_jax(m):
    """The reference's four refusals of a dense engine, message for
    message."""
    errs = []
    for build in (_jax_engine, _port_engine):
        with pytest.raises(ValueError) as e:
            build(m, lora_slots=2, lora_rank=4)
        errs.append(str(e.value))
        eng = build(m)
        calls = (
            lambda: eng.submit(PROMPTS[0], max_new_tokens=2,
                               prefill_only=True),
            lambda: eng.kv_import(PROMPTS[0], [5], np.zeros((1,)),
                                  kv_len=len(PROMPTS[0])),
            lambda: eng.kv_graft(PROMPTS[0][:16], np.zeros((1,)),
                                 kv_len=16))
        for call in calls:
            with pytest.raises(ValueError) as e:
                call()
            errs.append(str(e.value))
        eng.stop()
    assert errs[:4] == errs[4:]
    assert "lora_slots > 0 requires a paged engine" in errs[0]
    assert errs[1].startswith("prefill_only requires a paged engine")
    assert errs[2] == "kv_import requires a paged engine"
    assert errs[3] == "kv_graft requires a paged engine"


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(f"{prefix}{k}")
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}/")
    return out


def test_dense_kv_check_and_stats_match_jax(m):
    port, ref = _port_engine(m), _jax_engine(m)
    for eng in (port, ref):
        eng.start()
        try:
            assert eng.generate(PROMPTS[3], max_new_tokens=3)["tokens"]
            assert eng.kv_check() == {"ok": True, "paged": False}
        finally:
            eng.stop()
    pk, rk = _keys(port.stats()), _keys(ref.stats())
    assert rk <= pk, sorted(rk - pk)
    assert pk - rk == PORT_ONLY_KEYS, sorted(pk - rk)
    assert "kv" not in pk and "prefix_hits" not in pk


def test_dense_controls(m, jax_tokens):
    """warmup, set_sync_window and abort_pending on a dense engine: a
    window change mid-request leaves the tokens as they were (sampling
    keys on the token index), and a stopped engine's queued work fails."""
    eng = _port_engine(m)
    eng.start()
    try:
        eng.warmup([8, 32])
        assert eng.stats()["completed"] == 3
        fut = eng.submit(PROMPTS[0], max_new_tokens=NEW[0])
        assert eng.set_sync_window(2) == 2
        assert fut.result(timeout=T)["tokens"] == jax_tokens[4][0]
        assert eng.stats()["sync_window"] == 2
        assert eng.set_sync_window(None) == 4
    finally:
        eng.stop()
    fut = eng.submit(PROMPTS[1], max_new_tokens=4)
    eng.abort_pending(RuntimeError("aborted"))
    with pytest.raises(RuntimeError, match="aborted"):
        fut.result(timeout=T)


# ------------------------------------------------------------- the server
def _port_server(m, **kw):
    from ray_tpu_torch.serve.llm import LLMServer

    return LLMServer(m.tcfg, params=m.tparams, device="cpu",
                     **{**ENGINE, "paged": False, **kw})


def _gather(srv, reqs):
    async def go():
        return await asyncio.gather(*(srv(r) for r in reqs))

    return _within(asyncio.run, go())


REQS = [{"prompt": p, "max_new_tokens": n} for p, n in zip(PROMPTS, NEW)]


def test_dense_server_matches_jax_server(m, jax_tokens):
    """Concurrent calls and a stream on LLMServer(paged=False), against
    the JAX dense server."""
    from ray_tpu.serve.llm import LLMServer as JaxServer

    port = _port_server(m)
    ref = JaxServer(m.jcfg, params=m.jparams, **{**ENGINE, "paged": False})
    try:
        got = [r["tokens"] for r in _gather(port, REQS)]
        want = [r["tokens"] for r in _gather(ref, REQS)]
        assert got == want == jax_tokens[4]
        req = REQS[2]
        streamed = _within(list, port.stream(req))
        assert streamed == _within(list, ref.stream(req)) == want[2]
        assert port.kv_check() == {"ok": True, "paged": False}
        st = port.stats()
        assert st["pd"]["role"] == "unified"
        assert st["prefix_store"] == {"enabled": False}
        assert not port.engine.paged
    finally:
        port.shutdown()
        ref.shutdown()


def test_reconfigure_paged_to_dense_and_back(m, jax_tokens):
    from ray_tpu_torch.serve.llm import LLMServer

    srv = LLMServer(m.tcfg, params=m.tparams, device="cpu", page_size=8,
                    **ENGINE)
    try:
        assert srv.engine.paged
        paged = [r["tokens"] for r in _gather(srv, REQS)]
        old = srv.engine
        srv.reconfigure({"paged": False})
        assert not srv.engine.paged and srv.engine is not old
        assert not old._thread.is_alive()
        dense = [r["tokens"] for r in _gather(srv, REQS)]
        assert srv.kv_check() == {"ok": True, "paged": False}
        srv.reconfigure({"paged": True})
        assert srv.engine.paged
        again = [r["tokens"] for r in _gather(srv, REQS)]
        assert paged == dense == again == jax_tokens[4]
        assert srv.kv_check()["ok"]
    finally:
        srv.shutdown()
