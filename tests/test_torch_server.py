"""LLMServer in the port against the JAX LLMServer, on the CPU.

`debug` preset in float32, page 8, max_batch 4, steps_per_sync 4, one
parameter tree on both sides (`params_from_jax`), `device="cpu"`.  Against
the JAX server with the same params and seed: the greedy tokens of
concurrent calls, a stream against its call, the recursive key set of
`stats()`, the role errors and a rejected `reconfigure` (as in
tests/test_pd_disagg.py), adapter requests through an in-process
AdapterDirectory and the not-resident resubmit (tests/test_lora.py), and
the overload ladder driven by an injected clock (tests/test_serve_slo.py).
Within the port: PD through an in-process handle, each PD fallback, a JAX
export decoded by the port's `kv_decode`, a prefix demoted and grafted
through a StoreDirectory, `update_weights` through a fake runtime's refs.

Tolerance: token identity at temperature 0.  No test boots the ray_tpu
runtime, and every wait has a timeout (`T` seconds)."""
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

from ray_tpu_torch.serve.runtime import LocalHandle, ServeRuntime

T = 120.0
PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
           for k, n in ((7, 21), (5, 13), (11, 30), (3, 9))]
PROMPT = PROMPTS[0]                       # 2 full pages + 5
SERVER = dict(max_batch=4, max_len=128, page_size=8, steps_per_sync=4,
              seed=0)
# stats() keys the port's engine has and the reference's does not: the
# captured-window counters and the engine-level adapter counters.
PORT_ONLY_KEYS = {"adapter_loads", "adapter_evictions", "decode_windows",
                  "graph_replays", "graph_captures", "graph_capture_s"}


@pytest.fixture(scope="module")
def m():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import (lora_adapter_from_jax,
                                              params_from_jax)

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    jads = {mid: jl.init_lora_adapter(jax.random.PRNGKey(k), jcfg, 4)
            for mid, k in (("t/a", 1), ("t/b", 2))}
    tads = {mid: lora_adapter_from_jax(jax.tree.map(np.asarray, a), tcfg,
                                       device="cpu")
            for mid, a in jads.items()}
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams, np_params=np_params,
        tparams=params_from_jax(np_params, tcfg, device="cpu"),
        jads=jads, tads=tads)


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


def _run(coro):
    return _within(asyncio.run, coro)


def _gather(srv, reqs):
    async def go():
        return await asyncio.gather(*(srv(r) for r in reqs))

    return _run(go())


def _port(m, **kw):
    from ray_tpu_torch.serve.llm import LLMServer

    return LLMServer(m.tcfg, params=m.tparams, device="cpu",
                     **{**SERVER, **kw})


def _jax(m, **kw):
    from ray_tpu.serve.llm import LLMServer

    return LLMServer(m.jcfg, params=m.jparams, **{**SERVER, **kw})


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(f"{prefix}{k}")
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}/")
    return out


def _assert_same_stats_keys(port, ref):
    pk, rk = _keys(port.stats()), _keys(ref.stats())
    assert rk <= pk, sorted(rk - pk)
    assert pk - rk == PORT_ONLY_KEYS, sorted(pk - rk)


@pytest.fixture(scope="module")
def unified(m):
    """One unified server of each package for the module."""
    port, ref = _port(m), _jax(m)
    try:
        yield port, ref
    finally:
        port.shutdown()
        ref.shutdown()


@pytest.fixture(scope="module")
def want(unified):
    """The JAX server's greedy tokens for each of PROMPTS, 6 new."""
    return [r["tokens"] for r in _gather(
        unified[1], [{"prompt": p, "max_new_tokens": 6} for p in PROMPTS])]


class _Ref:
    def __init__(self, i):
        self.i = i


class _FakeRuntime(ServeRuntime):
    """A runtime over an in-process object table, with deployment names
    bound to handles (`handles`)."""

    def __init__(self):
        self.objects, self.gets, self.handles = {}, 0, {}

    def put(self, value):
        ref = _Ref(len(self.objects))
        self.objects[ref.i] = value
        return ref

    def get(self, ref, timeout=None):
        self.gets += 1
        return self.objects[ref.i]

    def is_ref(self, x):
        return isinstance(x, _Ref)

    def deployment_handle(self, name, app):
        return self.handles[name]


class _Handle:
    """A LocalHandle whose methods in `fail` raise."""

    def __init__(self, local, fail=(), method_name="__call__"):
        self._h = local.options(method_name=method_name)
        self._fail, self._method = set(fail), method_name

    def options(self, *, method_name="__call__"):
        return _Handle(self._h, self._fail, method_name)

    def remote(self, *args, **kwargs):
        if self._method in self._fail:
            raise RuntimeError(f"decode pool down ({self._method})")
        return self._h.remote(*args, **kwargs)


# ------------------------------------------------- against the JAX server
def test_concurrent_calls_match_jax_server(unified, want):
    port, _ = unified
    got = _gather(port, [{"prompt": p, "max_new_tokens": 6}
                         for p in PROMPTS])
    assert [r["tokens"] for r in got] == want
    assert all(len(t) == 6 for t in want)
    assert all(r["ttft_s"] > 0 for r in got)
    port.kv_check()


def test_stream_matches_call_and_jax_server(unified):
    port, ref = unified
    req = {"prompt": PROMPTS[2], "max_new_tokens": 7}
    streamed = _within(list, port.stream(req))
    assert len(streamed) == 7
    assert streamed == _run(port(req))["tokens"]
    assert streamed == _within(list, ref.stream(req))
    # The {"body": ...} form of a proxied stream request.
    assert _within(list, port.stream({"body": req})) == streamed


def test_stats_key_set_matches_jax_server(unified):
    port, ref = unified
    for srv in unified:
        _run(srv({"prompt": PROMPT, "max_new_tokens": 3}))
    _assert_same_stats_keys(port, ref)
    st = port.stats()
    assert st["pd"]["role"] == "unified" and st["overload"]["level"] == 0
    assert st["slo"]["ttft_ms"]["n"] >= 1 and st["slo"]["decode_ms"]["n"]
    assert st["prefix_store"]["enabled"] is True


def test_role_errors_match_jax_server(m):
    for kw in (dict(role="shard"), dict(role="prefill"),
               dict(role="prefill", decode_deployment="d", paged=False),
               dict(decode_deployment="d")):
        with pytest.raises(ValueError) as ref_err:
            _jax(m, **kw)
        with pytest.raises(ValueError) as port_err:
            _port(m, **kw)
        assert str(port_err.value) == str(ref_err.value), kw
    # Past the role checks, a dense server builds and serves.
    dense = _port(m, paged=False)
    try:
        assert not dense.engine.paged
        assert len(_run(dense({"prompt": PROMPT,
                               "max_new_tokens": 3}))["tokens"]) == 3
    finally:
        dense.shutdown()


def test_rejected_reconfigure_leaves_server_as_it_was(unified):
    port, ref = unified
    errors = []
    for srv in (port, ref):
        eng = srv.engine
        for cfg in ({"role": "prefill", "decode_deployment": "d",
                     "paged": False},
                    {"role": "prefill"}, {"kv_blockz": 4},
                    {"decode_deployment": "d"}):
            with pytest.raises(ValueError) as e:
                srv.reconfigure(cfg)
            errors.append(str(e.value))
            assert srv._role == "unified" and srv._decode_dep is None
            assert srv.engine is eng and srv._engine_kwargs["paged"]
    assert errors[:4] == errors[4:]
    # A dense reconfigure is accepted (it rebuilds the engine), and the
    # way back restores the configuration the server was built with.
    eng = port.engine
    port.reconfigure({"paged": False, "max_batch": 2})
    assert port.engine is not eng and not port.engine.paged
    assert len(_run(port({"prompt": PROMPT,
                          "max_new_tokens": 3}))["tokens"]) == 3
    port.reconfigure({"paged": True, "max_batch": 4})
    assert port.engine.paged and port._engine_kwargs["max_batch"] == 4
    assert len(_run(port({"prompt": PROMPT,
                          "max_new_tokens": 3}))["tokens"]) == 3


@pytest.fixture(scope="module")
def lora_pair(m):
    """A banked server of each package (2 slots, rank 4) on its own
    in-process AdapterDirectory holding the same two adapters."""
    from ray_tpu.serve import lora as jlora
    from ray_tpu_torch.serve import lora as tlora

    jd, td = jlora.AdapterDirectory(), tlora.AdapterDirectory()
    for mid in ("t/a", "t/b"):
        assert jlora.LoraClient(directory=jd).publish(
            mid, m.jads[mid]) == tlora.LoraClient(directory=td).publish(
            mid, m.tads[mid])
    port = _port(m, lora_slots=2, lora_rank=4, lora_directory=td)
    ref = _jax(m, lora_slots=2, lora_rank=4, lora_directory=jd)
    try:
        yield port, ref
    finally:
        port.shutdown()
        ref.shutdown()


def test_adapter_requests_match_jax_server(lora_pair, want):
    port, ref = lora_pair
    reqs = [{"prompt": p, "max_new_tokens": 6, "model_id": mid}
            for p, mid in zip(PROMPTS, (None, "t/a", "t/b", "t/a"))]
    got = [r["tokens"] for r in _gather(port, reqs)]
    assert got == [r["tokens"] for r in _gather(ref, reqs)]
    assert got[0] == want[0]                  # the base row
    assert got[1] != want[1] and got[2] != want[2]
    assert _within(list, port.stream(reqs[1])) == got[1]
    assert port.engine.adapter_resident("t/a", 1)
    _assert_same_stats_keys(port, ref)
    from ray_tpu_torch.serve.lora import AdapterLoadError

    with pytest.raises(AdapterLoadError) as e:
        _run(port({"prompt": PROMPT, "model_id": "ghost"}))
    assert e.value.reason == "not_published"
    assert port.stats()["lora"]["load_errors"] == 1


def _evicting_race(srv, load_other):
    """tests/test_lora.py's admission race: the other tenant's load takes
    the one slot between the server's page-in of t/b and its admission."""
    eng = srv.engine
    real_submit = eng.submit
    req = {"prompt": PROMPT, "max_new_tokens": 4, "model_id": "t/b"}
    first = _run(srv(req))["tokens"]
    srv._lora_seen.clear()
    raced = []

    def submit(*a, **kw):
        if kw.get("model_id") == "t/b" and not raced:
            raced.append(1)
            load_other()
        return real_submit(*a, **kw)

    eng.submit = submit
    try:
        out = _run(srv(req))["tokens"]
    finally:
        eng.submit = real_submit
    assert eng.adapter_resident("t/b") and not eng.adapter_resident("t/a")
    return first, out, srv.stats()["lora"]["admit_retries"]


def test_adapter_not_resident_resubmits_like_jax_server(m):
    from ray_tpu.serve import lora as jlora
    from ray_tpu_torch.serve import lora as tlora

    jd, td = jlora.AdapterDirectory(), tlora.AdapterDirectory()
    jlora.LoraClient(directory=jd).publish("t/b", m.jads["t/b"])
    tlora.LoraClient(directory=td).publish("t/b", m.tads["t/b"])
    port = _port(m, lora_slots=1, lora_rank=4, lora_directory=td)
    ref = _jax(m, lora_slots=1, lora_rank=4, lora_directory=jd)
    try:
        got = _evicting_race(port, lambda: port.engine.load_adapter(
            "t/a", m.tads["t/a"]))
        assert got == _evicting_race(ref, lambda: ref.engine.load_adapter(
            "t/a", m.jads["t/a"]))
        assert got[0] == got[1] and got[2] == 1
        port.kv_check()
    finally:
        port.shutdown()
        ref.shutdown()


class _Exploding:
    """Decode handle stand-in: any use fails the test."""

    def __getattr__(self, name):
        raise AssertionError("decode pool touched while shed to unified")


def _shed(srv):
    """tests/test_serve_slo.py's shed-to-unified ladder on an injected
    clock: sustained depth enters level 2, a request serves unified,
    sustained calm restores level 0."""
    t = [0.0]
    srv._overload._clock = lambda: t[0]
    depth = [99]
    orig = srv.engine._waiting.qsize
    srv.engine._waiting.qsize = lambda: depth[0]
    try:
        levels = [srv._update_pressure()]
        t[0] = 0.3
        levels.append(srv._update_pressure())
        window = srv.engine._k_live
        out = _run(srv({"prompt": PROMPTS[1], "max_new_tokens": 6}))
        st = srv.stats()
        depth[0] = 0
        t[0] = 0.6
        levels.append(srv._update_pressure())
        t[0] = 1.7
        levels.append(srv._update_pressure())
    finally:
        srv.engine._waiting.qsize = orig
    return (levels, window, srv.engine._k_live, out["tokens"],
            st["overload"]["level"], st["pd"]["migrations"],
            srv.stats()["overload"])


def test_overload_sheds_to_unified_like_jax_server(m, want):
    port = _port(m, role="prefill", decode_deployment=_Exploding())
    ref = _jax(m, role="prefill", decode_deployment=_Exploding())
    try:
        got = _shed(port)
        assert got == _shed(ref)
    finally:
        port.shutdown()
        ref.shutdown()
    levels, window, restored, tokens, level, migrations, overload = got
    assert levels == [0, 2, 2, 0] and window == 2 and restored == 4
    assert tokens == want[1] and level == 2 and migrations == 0
    assert overload == {"level": 0, "sheds": 1, "restores": 1}


def _shrink(srv):
    """tests/test_serve_slo.py's window ladder: severe depth shrinks the
    sync window to 2, calm restores it."""
    t = [0.0]
    srv._overload._clock = lambda: t[0]
    depth = [1000]
    orig = srv.engine._waiting.qsize
    srv.engine._waiting.qsize = lambda: depth[0]
    try:
        seen = [srv._update_pressure()]
        t[0] = 0.3
        seen += [srv._update_pressure(), srv.engine._k_live]
        depth[0] = 0
        seen.append(srv._update_pressure())
        t[0] = 2.0
        seen += [srv._update_pressure(), srv.engine._k_live]
    finally:
        srv.engine._waiting.qsize = orig
        srv._overload._clock = time.monotonic
    return seen


def test_overload_shrinks_and_restores_window_like_jax_server(unified,
                                                              monkeypatch):
    port, ref = unified
    got = _shrink(port)
    assert got == _shrink(ref) == [0, 2, 2, 2, 0, 4]
    assert port.stats()["sync_window_shrinks"] >= 1
    # The kill switch pins level 0.
    monkeypatch.setenv("RAY_TPU_SERVE_DEGRADE", "0")
    assert port._update_pressure() == 0


# ----------------------------------------------------------- port only
@pytest.fixture(scope="module")
def pd(m):
    """A decode server and a prefill server linked through a fake runtime
    that resolves the name "decode" to an in-process handle."""
    rt = _FakeRuntime()
    dec = _port(m, role="decode", runtime=rt)
    handle = rt.handles["decode"] = LocalHandle(dec)
    pre = _port(m, role="prefill", decode_deployment="decode", runtime=rt)
    try:
        yield pre, dec, rt
    finally:
        pre.shutdown()
        dec.shutdown()
        handle.close()


def test_pd_through_local_handle_matches_unified(pd, want):
    pre, dec, rt = pd
    outs = _gather(pre, [{"prompt": p, "max_new_tokens": 6}
                         for p in PROMPTS])
    assert [o["tokens"] for o in outs] == want
    assert all(o.get("disagg") for o in outs)
    sp, sd = pre.stats()["pd"], dec.stats()["pd"]
    assert sp["migrations"] == len(PROMPTS) and sp["fallbacks"] == 0
    assert sp["kv_migrate_bytes"] == sd["kv_pull_bytes"] > 0
    assert rt.gets == len(PROMPTS)          # each pull went through get
    assert pre.engine.kv_exports == dec.engine.kv_imports == len(PROMPTS)
    # A single-token request never migrates.
    one = _run(pre({"prompt": PROMPT, "max_new_tokens": 1}))
    assert one["tokens"] == want[0][:1] and pre.stats()["pd"][
        "migrations"] == len(PROMPTS)
    pre.kv_check()
    dec.kv_check()


def test_pd_fallbacks_in_turn(pd, want, monkeypatch):
    pre, dec, rt = pd
    local = rt.handles["decode"]
    req = {"prompt": PROMPT, "max_new_tokens": 6}

    def fallback():
        out = _run(pre(req))
        assert out["tokens"] == want[0]
        return out.get("pd_fallback")

    # An export that fails on the prefill engine: unified, locally.
    calls = []

    def broken_gather(ids):
        calls.append(ids)
        raise RuntimeError("injected export fault")

    monkeypatch.setattr(pre.engine, "_gather_kv", broken_gather)
    assert fallback() == "export_failed" and calls
    monkeypatch.undo()
    # A decode pool whose kv_decode fails: the whole request re-runs on it.
    imports = dec.engine.kv_imports
    pre.reconfigure({"decode_deployment": _Handle(local, {"kv_decode"})})
    assert fallback() == "full_reprefill"
    assert dec.engine.kv_imports == imports
    # A decode pool that is gone: served locally.
    pre.reconfigure({"decode_deployment": _Handle(local, {"kv_decode",
                                                          "__call__"})})
    assert fallback() == "local"
    assert pre.stats()["pd"]["fallbacks"] == 3
    pre.reconfigure({"decode_deployment": "decode"})
    assert _run(pre(req)).get("disagg") is True
    pre.kv_check()
    dec.kv_check()


def test_unresolvable_decode_name_falls_back_locally(m, want):
    # The null runtime cannot resolve a deployment name.
    pre = _port(m, role="prefill", decode_deployment="decode")
    try:
        out = _run(pre({"prompt": PROMPT, "max_new_tokens": 6}))
        assert out["tokens"] == want[0] and out["pd_fallback"] == "local"
        st = pre.stats()["pd"]
        assert st["migrations"] == 1 and st["fallbacks"] == 1
        assert st["kv_migrate_bytes"] > 0
        pre.kv_check()
    finally:
        pre.shutdown()


def test_jax_export_decodes_in_port_kv_decode(unified, pd, want):
    _, ref = unified
    _, dec, _ = pd
    pre = ref.engine.submit(PROMPT, max_new_tokens=1,
                            prefill_only=True).result(timeout=T)
    exp = pre["kv_export"]
    meta = {"prompt": PROMPT, "tokens": exp["tokens"], "kv_len": exp["len"],
            "page": exp["page"], "sample_seed": exp["sample_seed"],
            "max_new_tokens": 6, "temperature": 0.0, "eos_id": None}
    out = _within(dec.kv_decode, meta, np.asarray(exp["kv"]))
    assert out["tokens"] == want[0] and out["migrated"] is True
    dec.kv_check()


def _wait_for(cond, what):
    deadline = time.monotonic() + T
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


def test_prefix_store_demote_graft_and_leak_check(m, want):
    from ray_tpu_torch.serve.prefix_store import StoreDirectory

    d = StoreDirectory()
    cfg = dict(directory=d, min_idle=0, period_s=0.01, watermark_frac=0.0,
               limit=4, max_inflight=4, migrate_ms=0.0, bw_gbps=1e6)
    a = _port(m, prefix_store=cfg)
    b = _port(m, prefix_store=dict(cfg, min_idle=10 ** 9))
    try:
        assert _run(a({"prompt": PROMPT,
                       "max_new_tokens": 6}))["tokens"] == want[0]
        _wait_for(lambda: a.stats()["prefix_store"]["published"] >= 1,
                  "no demotion published")
        assert d.stats()["entries"] >= 1
        out = _run(b({"prompt": PROMPT, "max_new_tokens": 6}))
        assert out["tokens"] == want[0]
        st = b.stats()
        assert st["prefix_store"]["grafts"] == 1 and st["kv_grafts"] == 1
        assert st["prefix_hit_tokens"] >= 16
        # A request that opts out never consults the store.
        lookups = d.stats()["lookups"]
        _run(b({"prompt": PROMPTS[2], "max_new_tokens": 2,
                "prefix_store": False}))
        assert d.stats()["lookups"] == lookups
        assert a.kv_check()["prefix_store_objects"] >= 1
    finally:
        a.shutdown()
        b.shutdown()
    assert a.kv_check()["prefix_store_objects"] == 0
    assert d.stats()["entries"] == 0
    a._prefix_client._objects[1] = (None, 0, 0)       # a leaked object
    with pytest.raises(AssertionError, match="leaked after shutdown"):
        a.kv_check()


def test_update_weights_resolves_refs_through_runtime(m):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.serve.llm import LLMEngine

    rng = np.random.default_rng(3)
    new = jax.tree.map(
        lambda x: (x + 0.05 * rng.standard_normal(x.shape)).astype(
            x.dtype), m.np_params)
    fresh = LLMEngine(m.tcfg, params_from_jax(new, m.tcfg, device="cpu"),
                      device="cpu", **SERVER)
    try:
        want_new = fresh.generate(PROMPT, max_new_tokens=6)["tokens"]
    finally:
        fresh.stop()
    rt = _FakeRuntime()
    srv = _port(m, runtime=rt)
    req = {"prompt": PROMPT, "max_new_tokens": 6}
    try:
        before = _run(srv(req))["tokens"]
        assert srv.update_weights(rt.put(new)) == 1
        assert _run(srv(req))["tokens"] == want_new != before
        # Dict shards, one ref each, merge into the tree.
        shards = [rt.put({k: m.np_params[k] for k in ("embed", "layers")}),
                  rt.put({k: m.np_params[k]
                          for k in ("final_norm", "lm_head")})]
        assert srv.update_weights(shards, version=7) == 7
        assert _run(srv(req))["tokens"] == before
        assert rt.gets == 3 and srv.stats()["weight_version"] == 7
        with pytest.raises(ValueError, match="dict shards"):
            srv.update_weights([rt.put(1), rt.put(2)])
    finally:
        srv.shutdown()


def test_server_without_device_raises_when_cuda_is_absent(m):
    from ray_tpu_torch.serve.llm import LLMServer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default server runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServer(m.tcfg, params=m.tparams, **SERVER)
