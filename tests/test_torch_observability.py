"""The port's engine, server and rollout observability against the JAX
package's, on the CPU.

`debug` in f32, greedy, page 8, max_batch 4, K 4, one parameter tree on
both sides.  The reference engine runs with `ray_tpu.tracing` on in this
process, as tests/test_flight_recorder.py runs it; the port's engine runs
with `runtime=RayTpuRuntime()` (tests/torch_ray_runtime.py), whose
tracing, metrics and memory-ledger faces are ray_tpu's own process-local
span ring, metric registry and providers, so no cluster boots:

- each trace's span names in order and their integer attrs, for a
  unified request, a PD migration (llm.kv_export, llm.kv_import) and an
  adapter request through the server (serve.adapter_load,
  serve.adapter_apply);
- the serve_llm_* metrics by `engine` tag after stats(), as
  tests/test_prefix_cache.py reads them, the histograms' stage sets and
  counts, and the memory provider rows' block fields;
- the same-run A/B of test_engine_kill_switch_same_run;
- each of the six serve.* failpoints, armed `nth:1+error` (or `error`)
  through `ray_tpu._private.failpoints`, with the outcome the reference's
  test of that site asserts;
- the rollout metrics after one rollout, against the reference worker's.

Within the port: `LocalRuntime`'s recorder gives the spans and metrics
`RayTpuRuntime` gives for one wave, the server's serve.kv_put (with its
memory tag), serve.kv_pull and serve.shed / serve.restore land in it,
and the null runtime records nothing and makes the loop take no
timestamp.  Every engine is stopped in a `finally`; every wait has a
timeout."""
import asyncio
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

T = 120.0
ENGINE = dict(max_batch=4, max_len=128, page_size=8, steps_per_sync=4,
              seed=0)
PROMPT = [(i * 7 + 3) % 250 + 1 for i in range(21)]       # 2 pages + 5
SHARED = [(i * 5 + 1) % 250 + 1 for i in range(16)]       # 2 full pages
PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
           for k, n in ((7, 21), (5, 13), (11, 30))]
# Counters and gauges of _engine_metrics, compared by engine tag.
SERVE_METRICS = ("serve_llm_prefill_tokens", "serve_llm_prefix_hit_tokens",
                 "serve_llm_decode_tokens", "serve_llm_preemptions",
                 "serve_llm_kv_evictions", "serve_llm_requests_completed",
                 "serve_llm_weight_updates", "serve_llm_batch_occupancy",
                 "serve_llm_queue_depth", "serve_llm_kv_free_blocks",
                 "serve_llm_prefix_hit_rate", "serve_llm_weight_version")
HISTOGRAMS = ("serve_request_ttft_ms", "serve_request_tpot_ms",
              "serve_request_stage_ms")
BLOCK_FIELDS = ("tag", "tier", "blocks_used", "blocks_total",
                "blocks_cached")


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
            for mid, k in (("t/a", 1), ("t/b", 2), ("t/c", 3))}
    tads = {mid: lora_adapter_from_jax(jax.tree.map(np.asarray, a), tcfg,
                                       device="cpu")
            for mid, a in jads.items()}
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams, np_params=np_params,
        tparams=params_from_jax(np_params, tcfg, device="cpu"),
        jads=jads, tads=tads)


@pytest.fixture(autouse=True)
def tracing_on():
    """ray_tpu's recorder on and its failpoints disarmed around every
    test."""
    from ray_tpu._private import failpoints
    from ray_tpu._private import spans as impl

    was = impl.ENABLED
    impl.set_enabled(True)
    yield
    failpoints.reset()
    impl.set_enabled(was)


def NoClusterRuntime():
    """`RayTpuRuntime` for a process outside any cluster: its tracing,
    metrics, memory-ledger and failpoint faces (all process-local), with
    the null runtime's object plane."""
    from ray_tpu_torch.serve.runtime import ServeRuntime
    from torch_ray_runtime import RayTpuRuntime

    class NoCluster(RayTpuRuntime):
        put = ServeRuntime.put
        get = ServeRuntime.get
        is_ref = ServeRuntime.is_ref
        controller = ServeRuntime.controller

    return NoCluster()


def _ref_engine(m, name, **kw):
    from ray_tpu.serve.llm import LLMEngine

    eng = LLMEngine(m.jcfg, m.jparams, name=name, **{**ENGINE, **kw})
    eng.start()
    return eng


def _port_engine(m, name, runtime="ray", **kw):
    from ray_tpu_torch.serve.llm import LLMEngine

    rt = NoClusterRuntime() if runtime == "ray" else runtime
    eng = LLMEngine(m.tcfg, m.tparams, name=name, device="cpu", runtime=rt,
                    **{**ENGINE, **kw})
    eng.start()
    return eng


def _gen(eng, prompt, n=8):
    return eng.submit(prompt, max_new_tokens=n).result(timeout=T)


def _ray_trace(fn):
    """Run fn() under a ray_tpu span; (fn's result, the trace's spans in
    the order they were recorded)."""
    from ray_tpu import tracing
    from ray_tpu._private import spans as impl

    with tracing.span("t.request"):
        ctx = tracing.current()
        out = fn()
    return out, impl.snapshot(ctx[0])


def _anatomy(recs):
    """(name, integer attrs) of each span; timings dropped."""
    return [(r["name"], {k: v for k, v in sorted(r["attrs"].items())
                         if isinstance(v, int) and not isinstance(v, bool)})
            for r in recs]


def _values(name, tag_key, tag):
    from ray_tpu.utils import metrics as um

    with um._registry_lock:
        metric = um._registry.get(name)
    if metric is None:
        return None
    snap = metric.snapshot()
    return {tuple(sorted(v["tags"].items())): v["value"]
            for v in snap["values"] if v["tags"].get(tag_key) == tag}


def _by_tag(snap, tag_key, tag):
    return {tuple(sorted((k, v) for k, v in v_["tags"].items()
                         if k != tag_key)): v_["value"]
            for v_ in snap["values"] if v_["tags"].get(tag_key) == tag}


def _registry(name):
    from ray_tpu.utils import metrics as um

    with um._registry_lock:
        return um._registry[name].snapshot()


def _hist_counts(name, engine):
    """{stage or "": observation count} of a histogram by engine tag."""
    snap = _registry(name)
    return {c["tags"].get("stage", ""): sum(c["counts"])
            for c in snap["counts"] if c["tags"].get("engine") == engine}


# ----------------------------------------------------------------- spans
def test_request_spans_match_reference(m):
    """A unified greedy request: llm.queue, llm.prefill (prompt_tokens),
    llm.first_token, then one llm.decode_window per window (steps,
    weight_version), in the reference's order with its attrs."""
    ref = _ref_engine(m, "sp_ref")
    port = _port_engine(m, "sp_port")
    try:
        want_out, want = _ray_trace(lambda: _gen(ref, PROMPT))
        got_out, got = _ray_trace(lambda: _gen(port, PROMPT))
    finally:
        ref.stop()
        port.stop()
    assert got_out["tokens"] == want_out["tokens"]
    assert _anatomy(got) == _anatomy(want)
    names = [r["name"] for r in got]
    assert names[:3] == ["llm.queue", "llm.prefill", "llm.first_token"]
    assert names.count("llm.decode_window") == 2
    pre = next(r for r in got if r["name"] == "llm.prefill")
    assert pre["attrs"]["prompt_tokens"] == len(PROMPT)


def test_migration_spans_match_reference(m):
    """A prefill-only export and its import on a second engine, in one
    trace: llm.kv_export (bytes, kv_len, pages) and llm.kv_import (kv_len,
    pages) beside the request spans, as in the reference."""
    def migrate(a, b):
        def run():
            pre = a.submit(PROMPT, max_new_tokens=1,
                           prefill_only=True).result(timeout=T)
            exp = pre["kv_export"]
            kv = np.asarray(exp["kv"]) if not isinstance(
                exp["kv"], torch.Tensor) else exp["kv"]
            return b.kv_import(PROMPT, exp["tokens"], kv,
                               kv_len=exp["len"], max_new_tokens=6,
                               sample_seed=exp["sample_seed"]
                               ).result(timeout=T)
        return _ray_trace(run)

    ra, rb = _ref_engine(m, "mg_ref_a"), _ref_engine(m, "mg_ref_b")
    pa, pb = _port_engine(m, "mg_port_a"), _port_engine(m, "mg_port_b")
    try:
        want_out, want = migrate(ra, rb)
        got_out, got = migrate(pa, pb)
    finally:
        for e in (ra, rb, pa, pb):
            e.stop()
    assert got_out["tokens"] == want_out["tokens"]
    assert _anatomy(got) == _anatomy(want)
    assert {"llm.kv_export", "llm.kv_import"} <= {r["name"] for r in got}


def test_adapter_request_spans_match_reference(m):
    """An adapter request through the server: serve.adapter_load under the
    caller's context, then serve.adapter_apply beside the request spans;
    an eviction emits serve.adapter_swap (deployment, slot, loaded,
    evicted)."""
    from ray_tpu.serve import lora as jlora
    from ray_tpu.serve.llm import LLMServer as JaxServer
    from ray_tpu_torch.serve import lora as tlora
    from ray_tpu_torch.serve.llm import LLMServer

    jd, td = jlora.AdapterDirectory(), tlora.AdapterDirectory()
    for mid in ("t/a", "t/b"):
        jlora.LoraClient(directory=jd).publish(mid, m.jads[mid])
        tlora.LoraClient(directory=td).publish(mid, m.tads[mid])
    ref = JaxServer(m.jcfg, params=m.jparams, lora_slots=1, lora_rank=4,
                    lora_directory=jd, **ENGINE)
    port = LLMServer(m.tcfg, params=m.tparams, lora_slots=1, lora_rank=4,
                     lora_directory=td, device="cpu",
                     runtime=NoClusterRuntime(), **ENGINE)

    def call(srv, mid):
        req = {"prompt": PROMPT, "max_new_tokens": 5, "model_id": mid}
        return asyncio.run(asyncio.wait_for(srv(req), T))

    try:
        got, want = [], []
        for mid in ("t/a", "t/b"):
            want.append(_ray_trace(lambda: call(ref, mid)))
            got.append(_ray_trace(lambda: call(port, mid)))
    finally:
        ref.shutdown()
        port.shutdown()
    for (go, gs), (wo, ws) in zip(got, want):
        assert go["tokens"] == wo["tokens"]
        assert _anatomy(gs) == _anatomy(ws)
        assert [r["name"] for r in gs][:2] == ["serve.adapter_load",
                                               "llm.queue"]
    from ray_tpu._private import spans as impl

    swaps = [r for r in impl.snapshot() if r["name"] == "serve.adapter_swap"
             and r["attrs"].get("deployment") == "llm"]
    assert [(r["attrs"]["loaded"], r["attrs"]["evicted"])
            for r in swaps[-2:]] == [("t/b", "t/a")] * 2


# ------------------------------------------------ metrics and providers
def _wave(eng):
    """A first request, then two that share its two full pages."""
    _gen(eng, SHARED + [3], 4)
    for tail in ([4], [5, 6]):
        _gen(eng, SHARED + tail, 4)
    return eng.stats()


@pytest.fixture(scope="module")
def metered(m):
    """The same wave on a reference engine and a port engine
    (RayTpuRuntime), both still running: (reference, port)."""
    ref = _ref_engine(m, "mt_ref")
    port = _port_engine(m, "mt_port")
    try:
        rs, ps = _wave(ref), _wave(port)
    except BaseException:
        ref.stop()
        port.stop()
        raise
    yield types.SimpleNamespace(ref=ref, port=port, ref_stats=rs,
                                port_stats=ps)
    ref.stop()
    port.stop()


def test_engine_metrics_match_reference(metered):
    """Every serve_llm_* counter and gauge by engine tag after stats(),
    read from the registry as tests/test_prefix_cache.py reads it."""
    for name in SERVE_METRICS:
        want = _by_tag(_registry(name), "engine", "mt_ref")
        got = _by_tag(_registry(name), "engine", "mt_port")
        assert got == want, name
    prefill = _by_tag(_registry("serve_llm_prefill_tokens"), "engine",
                      "mt_port")[()]
    assert prefill == metered.port_stats["prefill_tokens"]
    assert _by_tag(_registry("serve_llm_prefix_hit_tokens"), "engine",
                   "mt_port")[()] == metered.port_stats["prefix_hit_tokens"]
    assert metered.port_stats["prefix_hit_tokens"] > 0


def test_histograms_match_reference(metered):
    """serve_request_ttft_ms / _tpot_ms / _stage_ms: the same stages and
    observation counts; the reference's buckets."""
    for name in HISTOGRAMS:
        want = _hist_counts(name, "mt_ref")
        assert _hist_counts(name, "mt_port") == want, name
        assert want
    assert set(_hist_counts("serve_request_stage_ms", "mt_port")) == {
        "queue", "prefill", "decode"}
    from ray_tpu_torch.serve.llm import _MS_BUCKETS

    assert _registry("serve_request_ttft_ms")["boundaries"] == \
        list(_MS_BUCKETS)


def test_memory_provider_rows_match_reference(metered):
    """The hbm_kv row of each engine's provider: the block fields equal,
    and the port's pool bytes are its cache tensors' bytes."""
    from ray_tpu._private import memledger

    def rows(eng):
        key = f"llm:{eng.name}:{id(eng):x}"
        return memledger._providers[key]()

    want, got = rows(metered.ref), rows(metered.port)
    assert [{k: r[k] for k in BLOCK_FIELDS} for r in got] == \
        [{k: r[k] for k in BLOCK_FIELDS} for r in want]
    c = metered.port.cache
    assert got[0]["pool_bytes"] == sum(
        t.numel() * t.element_size() for t in c["k"] + c["v"] + [c["pos"]])
    assert got[0]["pool_bytes"] == want[0]["pool_bytes"]
    assert got[0]["size"] == want[0]["size"] > 0


def test_provider_unregistered_at_stop(m):
    from ray_tpu._private import memledger

    eng = _port_engine(m, "mt_stop", lora_slots=1, lora_rank=4)
    key = f"llm:mt_stop:{id(eng):x}"
    try:
        rows = memledger._providers[key]()
        assert [r["tag"] for r in rows] == ["hbm_kv", "lora_banks"]
        banks = eng._lora_banks.values()
        assert rows[1]["size"] == sum(t.numel() * t.element_size()
                                      for b in banks for t in b.values())
    finally:
        eng.stop()
    assert key not in memledger._providers


# -------------------------------------------------------- kill switch
def test_kill_switch_same_run(m):
    """Requests served with the recorder off emit no span; turned back on
    in the same run, they do."""
    from ray_tpu import tracing
    from ray_tpu._private import spans as impl

    eng = _port_engine(m, "ks_port")
    try:
        impl.set_enabled(False)
        n0 = impl.stats()["emitted"]
        with tracing.span("t.off"):
            _gen(eng, PROMPT, 4)
        assert impl.stats()["emitted"] == n0
        impl.set_enabled(True)
        _, recs = _ray_trace(lambda: _gen(eng, PROMPT[:12], 4))
        assert any(r["name"] == "llm.decode_window" for r in recs)
    finally:
        eng.stop()


# ----------------------------------------------------------- failpoints
def _clean(eng):
    eng._mgr.check()
    assert eng._mgr.available() == eng._mgr.n_blocks


def test_kv_export_failpoint_releases_blocks(m):
    from ray_tpu._private import failpoints

    eng = _port_engine(m, "fp_export")
    try:
        failpoints.configure("serve.kv_export=nth:1+error")
        fut = eng.submit(PROMPT, max_new_tokens=1, prefill_only=True)
        with pytest.raises(failpoints.FailpointError):
            fut.result(timeout=T)
        _clean(eng)
        assert len(_gen(eng, PROMPT, 3)["tokens"]) == 3
    finally:
        eng.stop()


def test_kv_import_failpoint_fires_at_entry(m):
    from ray_tpu._private import failpoints

    eng = _port_engine(m, "fp_import")
    try:
        failpoints.configure("serve.kv_import=nth:1+error")
        with pytest.raises(failpoints.FailpointError):
            eng.kv_import(PROMPT, [5], np.zeros((2, 2, 3, 2, 8, 32),
                                                np.float32),
                          kv_len=len(PROMPT), max_new_tokens=4)
        _clean(eng)
    finally:
        eng.stop()


def test_graft_failpoint_engine_survives(m):
    from ray_tpu._private import failpoints

    eng = _port_engine(m, "fp_graft")
    try:
        failpoints.configure("serve.prefix_graft=nth:1+error")
        L, kvh, hd = m.tcfg.n_layers, m.tcfg.n_kv_heads, m.tcfg.head_dim
        kv = np.zeros((2, L, 2, kvh, 8, hd), np.float32)
        fut = eng.kv_graft(PROMPT[:16], kv, kv_len=16)
        with pytest.raises(failpoints.FailpointError):
            fut.result(timeout=T)
        _clean(eng)
        assert len(_gen(eng, PROMPT, 3)["tokens"]) == 3
    finally:
        eng.stop()


def test_demote_failpoint_releases_pins(m):
    """The publish leg faults mid-demotion: the pins drop, tier 1 keeps
    the leaf (nothing was stored), the engine keeps serving."""
    from ray_tpu._private import failpoints

    eng = _port_engine(m, "fp_demote")
    try:
        _gen(eng, PROMPT, 4)
        cached = eng._mgr.cached_count()
        assert cached >= 2
        failpoints.configure("serve.prefix_demote=error")
        seen = []
        eng.set_prefix_store(lambda e: seen.append(e) or True,
                             min_idle=0, period_s=0.01, watermark_frac=0.0)
        eng._wake.set()
        deadline = time.time() + 30
        while eng.demote_failures == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert eng.demote_failures >= 1
        assert not seen
        eng.set_prefix_store(None)
        deadline = time.time() + 10
        while eng._demote_inflight and time.time() < deadline:
            time.sleep(0.02)
        eng._mgr.check()
        assert eng._mgr.cached_count() == cached
        assert eng._mgr.demotions == 0
        assert len(_gen(eng, PROMPT, 3)["tokens"]) == 3
    finally:
        eng.stop()


def _lora_server(m, mids, slots):
    from ray_tpu_torch.serve import lora as tlora
    from ray_tpu_torch.serve.llm import LLMServer

    td = tlora.AdapterDirectory()
    for mid in mids:
        tlora.LoraClient(directory=td).publish(mid, m.tads[mid])
    return LLMServer(m.tcfg, params=m.tparams, lora_slots=slots,
                     lora_rank=4, lora_directory=td, device="cpu",
                     runtime=NoClusterRuntime(), **ENGINE)


def _call(srv, **req):
    return asyncio.run(asyncio.wait_for(srv({"prompt": PROMPT, **req}), T))


def test_adapter_load_fault_degrades_to_rejection(m):
    from ray_tpu._private import failpoints
    from ray_tpu_torch.serve.lora import AdapterLoadError

    srv = _lora_server(m, ("t/a",), 2)
    try:
        failpoints.configure("serve.adapter_load=nth:1+error")
        with pytest.raises(AdapterLoadError) as ei:
            _call(srv, model_id="t/a")
        assert ei.value.reason == "load_failed"
        assert srv.adapter_load_errors == 1
        assert _call(srv, max_new_tokens=3)["tokens"]
        assert _call(srv, max_new_tokens=3, model_id="t/a")["tokens"]
        srv.engine._mgr.check()
    finally:
        srv.shutdown()
    srv.kv_check()


def test_adapter_swap_fault_leaves_resident_set_intact(m):
    from ray_tpu._private import failpoints
    from ray_tpu_torch.serve.lora import AdapterLoadError

    srv = _lora_server(m, ("t/a", "t/b", "t/c"), 2)
    try:
        for mid in ("t/a", "t/b"):
            _call(srv, max_new_tokens=2, model_id=mid)
        failpoints.configure("serve.adapter_swap=error")
        with pytest.raises(AdapterLoadError):
            _call(srv, max_new_tokens=2, model_id="t/c")
        eng = srv.engine
        assert eng.adapter_resident("t/a") and eng.adapter_resident("t/b")
        assert not eng.adapter_resident("t/c")
        failpoints.reset()
        assert _call(srv, max_new_tokens=2, model_id="t/c")["tokens"]
        assert eng.adapter_resident("t/c")
    finally:
        srv.shutdown()
    srv.kv_check()


# --------------------------------------------------------- rollouts
def test_rollout_metrics_match_reference(m):
    """rl_rollout_groups, rl_rollout_tokens and
    rl_rollout_prefix_hit_rate by worker tag after one greedy rollout."""
    from ray_tpu.rl.rollout_llm import LLMRolloutWorker as JaxWorker
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    kw = dict(max_batch=8, max_len=128, page_size=8, steps_per_sync=3)
    prompts = [p[:10] for p in PROMPTS[:2]]
    ref = JaxWorker(m.jcfg, params=m.jparams, engine=dict(kw),
                    name="ro_ref")
    port = LLMRolloutWorker(m.tcfg, params=m.tparams, engine=dict(kw),
                            name="ro_port", device="cpu",
                            runtime=NoClusterRuntime())
    try:
        want = ref.rollout(prompts, group_size=4, max_new_tokens=5,
                           temperature=0.0)
        got = port.rollout(prompts, group_size=4, max_new_tokens=5,
                           temperature=0.0)
    finally:
        ref.stop()
        port.stop()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    for name in ("rl_rollout_groups", "rl_rollout_tokens",
                 "rl_rollout_prefix_hit_rate"):
        w = _by_tag(_registry(name), "worker", "ro_ref")
        assert _by_tag(_registry(name), "worker", "ro_port") == w, name
        assert w
    assert _by_tag(_registry("rl_rollout_groups"), "worker",
                   "ro_port")[()] == 2


# ------------------------------------------------- within the port
def test_local_runtime_recorder_matches_ray_tpu_runtime(m):
    """One wave on an engine with LocalRuntime's recorder and one with
    RayTpuRuntime: the same spans per trace and the same metric values."""
    from ray_tpu_torch.serve.runtime import LocalRuntime

    rt = LocalRuntime()
    local = _port_engine(m, "lr_local", runtime=rt)
    ray = _port_engine(m, "lr_ray")
    try:
        with rt.span("t.request"):
            ctx = rt.trace_current()
            _gen(local, PROMPT)
        got = rt.recorder.spans(ctx[0])
        _, want = _ray_trace(lambda: _gen(ray, PROMPT))
        local.stats()
        ray.stats()
        rows = rt.recorder.memory_rows()
    finally:
        local.stop()
        ray.stop()
    assert _anatomy(got) == _anatomy(want)
    snap = rt.recorder.metrics()
    for name in SERVE_METRICS:
        assert _by_tag(snap[name], "engine", "lr_local") == \
            _by_tag(_registry(name), "engine", "lr_ray"), name
    for name in SERVE_METRICS + HISTOGRAMS:
        assert snap[name]["type"] == _registry(name)["type"]
    for name in HISTOGRAMS:
        counts = {c["tags"].get("stage", ""): sum(c["counts"])
                  for c in snap[name]["counts"]}
        assert counts == _hist_counts(name, "lr_ray"), name
    assert [r["tag"] for r in rows] == ["hbm_kv"]
    assert rt.recorder.memory_rows() == []


def test_server_spans_and_memory_tag_on_local_runtime(m):
    """A PD pair on one LocalRuntime: serve.kv_put (bytes, under the
    request's trace, inside the "kv_export" memory tag) on the prefill
    side, serve.kv_pull with the same bytes on the decode side; the
    overload ladder emits serve.shed and serve.restore."""
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.runtime import LocalHandle, LocalRuntime

    rt = LocalRuntime()
    dec = LLMServer(m.tcfg, params=m.tparams, device="cpu", runtime=rt,
                    role="decode", **ENGINE)
    handle = LocalHandle(dec)
    pre = LLMServer(m.tcfg, params=m.tparams, device="cpu", runtime=rt,
                    role="prefill", decode_deployment=handle, **ENGINE)
    try:
        with rt.span("t.request"):
            ctx = rt.trace_current()
            out = _call(pre, max_new_tokens=6)
        assert out.get("disagg") is True
        names = [r["name"] for r in rt.recorder.spans(ctx[0])]
        for want in ("llm.queue", "llm.prefill", "llm.first_token",
                     "llm.kv_export", "serve.kv_put"):
            assert want in names, names
        put = next(r for r in rt.recorder.spans(ctx[0])
                   if r["name"] == "serve.kv_put")
        pull = [r for r in rt.recorder.spans() if r["name"] ==
                "serve.kv_pull"]
        assert [r["attrs"]["bytes"] for r in pull] == [put["attrs"]["bytes"]]
        assert rt.recorder.memory_tags() == {
            ("kv_export", "serve/llm.py kv_export"): 1}
        # The ladder's level changes, forced: shed to level 2, restore.
        levels = iter([(2, 0), (0, 2)])
        pre._overload = types.SimpleNamespace(
            level=0, update=lambda depth: next(levels))
        pre._update_pressure()
        pre._update_pressure()
        ladder = [(r["name"], r["attrs"]["level"], r["attrs"]["from"])
                  for r in rt.recorder.spans()
                  if r["name"] in ("serve.shed", "serve.restore")]
        assert ladder == [("serve.shed", 2, 0), ("serve.restore", 0, 2)]
    finally:
        pre.shutdown()
        dec.shutdown()
        handle.close()


def test_null_runtime_records_nothing(m, monkeypatch):
    """The default runtime: no span, no metric series, no provider; and
    the loop takes no wall-clock timestamp (tracing off adds nothing per
    window, let alone per step)."""
    from ray_tpu._private import memledger
    from ray_tpu._private import spans as impl
    from ray_tpu_torch.serve import llm
    from ray_tpu_torch.serve.runtime import NULL_METRIC

    calls = []

    class Clock:
        def __getattr__(self, name):
            return getattr(time, name)

        def time(self):
            calls.append(1)
            return time.time()

    monkeypatch.setattr(llm, "time", Clock())
    eng = llm.LLMEngine(m.tcfg, m.tparams, name="null_eng", device="cpu",
                        **ENGINE)
    eng.start()
    try:
        n0 = impl.stats()["emitted"]
        out, recs = _ray_trace(lambda: _gen(eng, PROMPT))
        eng.stats()
        assert len(out["tokens"]) == 8
        assert impl.stats()["emitted"] == n0 + 1       # the test's span
        assert [r["name"] for r in recs] == ["t.request"]
        assert calls == []
        assert all(v is NULL_METRIC for v in eng._metrics_table().values())
        assert _values("serve_llm_decode_tokens", "engine",
                       "null_eng") in (None, {})
        assert not [k for k in memledger._providers if "null_eng" in k]
    finally:
        eng.stop()
