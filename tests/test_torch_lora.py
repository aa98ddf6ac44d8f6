"""Multi-LoRA in the port against the JAX package, on the CPU.

`debug` preset in float32, page 8, max_batch 4, steps_per_sync 4, one
parameter tree on both sides; the adapters are the reference's
`init_lora_adapter` draws (keys 1-3) moved over with
`lora_adapter_from_jax`.  The model functions agree with the reference to
1e-4 on a batch that mixes bank slots; the banked engine gives the JAX
engine's greedy tokens; within the port the banked engine matches a
merged-weights engine at temperatures 0.0 and 0.8, base rows are
untouched and their KV is keyed apart, and the slot LRU, rank padding and
typed rejections behave as in the reference (tests/test_lora.py)."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = [(i * 7 + 3) % 250 + 1 for i in range(12)]
ENGINE = dict(max_batch=4, max_len=128, page_size=8, steps_per_sync=4,
              seed=0)


@pytest.fixture(scope="module")
def models():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import (lora_adapter_from_jax,
                                              params_from_jax)

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jads = {"t/a": jl.init_lora_adapter(jax.random.PRNGKey(1), jcfg, 4),
            "t/b": jl.init_lora_adapter(jax.random.PRNGKey(2), jcfg, 4),
            "t/c": jl.init_lora_adapter(jax.random.PRNGKey(3), jcfg, 2,
                                        targets=("wq", "wv"))}
    tads = {k: lora_adapter_from_jax(jax.tree.map(np.asarray, a), tcfg,
                                     device="cpu")
            for k, a in jads.items()}
    return jl, tl, jcfg, tcfg, jparams, tparams, jads, tads


def _banks(adapters, cfg, dims, rank):
    """Numpy banks [L, slots+1, din, r] / [L, slots+1, r, dout]: slot 0
    zeros, slot i+1 adapter i, zero padded to `rank`."""
    ns = len(adapters) + 1
    banks = {t: {"a": np.zeros((cfg.n_layers, ns, din, rank), np.float32),
                 "b": np.zeros((cfg.n_layers, ns, rank, dout), np.float32)}
             for t, (din, dout) in dims.items()}
    for s, ad in enumerate(adapters, 1):
        for t, ab in ad["targets"].items():
            r = ab["a"].shape[2]
            banks[t]["a"][:, s, :, :r] = np.asarray(ab["a"])
            banks[t]["b"][:, s, :r] = np.asarray(ab["b"])
    return banks


def _both_loras(models, idx):
    jl, tl, jcfg, tcfg, _, _, jads, _ = models
    banks = _banks(list(jads.values()), jcfg, jl.lora_target_dims(jcfg), 4)
    jlora = {"idx": jnp.asarray(idx, jnp.int32),
             "banks": jax.tree.map(jnp.asarray, banks)}
    tlora = {"idx": torch.tensor(idx, dtype=torch.int32),
             "banks": {t: {k: torch.from_numpy(v) for k, v in ab.items()}
                       for t, ab in banks.items()}}
    return jlora, tlora


def _pools(seed, jcfg, tcfg, jl, tl, n_pages, page):
    rng = np.random.default_rng(seed)
    shape = (n_pages, jcfg.n_kv_heads, page, jcfg.head_dim)
    arrs = {kk: [rng.normal(size=shape).astype(np.float32)
                 for _ in range(jcfg.n_layers)] for kk in "kv"}
    tc = tl.init_paged_kv_cache(tcfg, 2, n_pages, page, "cpu")
    for kk in "kv":
        for li, a in enumerate(arrs[kk]):
            tc[kk][li].copy_(torch.from_numpy(a))
    return {kk: [jnp.asarray(a) for a in arrs[kk]] for kk in "kv"}, tc


@pytest.mark.parametrize("fn", ["prefill", "prefill_with_prefix",
                                "decode_step_paged"])
def test_lora_model_functions_match_jax(models, fn):
    """Each serving function with a batch whose rows use bank slots 0-3
    (base, two rank-4 adapters, a rank-2 adapter on wq/wv only)."""
    jl, tl, jcfg, tcfg, jparams, tparams, _, _ = models
    rng = np.random.default_rng(3)
    if fn == "prefill":
        toks = rng.integers(1, 256, size=(4, 12))
        jlora, tlora = _both_loras(models, [0, 1, 2, 3])
        want = jl.prefill(jparams, jnp.asarray(toks, jnp.int32), jcfg, jlora)
        got = tl.prefill(tparams, torch.from_numpy(toks), tcfg, tlora)
    elif fn == "prefill_with_prefix":
        page = 8
        jc, tc = _pools(4, jcfg, tcfg, jl, tl, 9, page)
        toks = rng.integers(1, 256, size=(2, 10))
        pos0 = np.asarray([8, 16], np.int32)
        table = np.asarray([[4, 1, 0], [6, 8, 2]], np.int32)
        jlora, tlora = _both_loras(models, [3, 1])
        want = jl.prefill_with_prefix(
            jparams, jnp.asarray(toks, jnp.int32), jnp.asarray(pos0), jcfg,
            jc["k"], jc["v"], jnp.asarray(table), jlora)
        got = tl.prefill_with_prefix(
            tparams, torch.from_numpy(toks), torch.from_numpy(pos0), tcfg,
            tc["k"], tc["v"], torch.from_numpy(table), tlora)
    else:
        page, K = 8, 4
        jc, tc = _pools(5, jcfg, tcfg, jl, tl, 9, page)
        table = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
        ts = np.asarray([5, 13], np.int32)
        toks = np.asarray([7, 99], np.int32)
        tshape = (2, jcfg.n_kv_heads, K, jcfg.head_dim)
        jlora, tlora = _both_loras(models, [2, 0])
        want = jl.decode_step_paged(
            jparams, jc, {kk: [jnp.zeros(tshape, jnp.float32)] * 2
                          for kk in "kv"},
            jnp.asarray(toks), jnp.asarray(ts), jnp.asarray(ts), 0,
            jnp.asarray(table), jcfg, jlora)
        got = tl.decode_step_paged(
            tparams, tc, {kk: [torch.zeros(tshape) for _ in range(2)]
                          for kk in "kv"},
            torch.from_numpy(toks), torch.from_numpy(ts),
            torch.from_numpy(ts), 0, torch.from_numpy(table), tcfg, tlora)
        want = (want[0], *[want[1][kk][li] for kk in "kv"
                           for li in range(2)])
        got = (got[0], *[got[1][kk][li] for kk in "kv" for li in range(2)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **TOL)
    if fn == "prefill":     # slot 0 rows are exact, adapter rows move
        plain = tl.prefill(tparams, torch.from_numpy(toks), tcfg)[0]
        assert torch.equal(plain[0], got[0][0])
        assert not torch.allclose(plain[1], got[0][1])


def _port(models, **kw):
    from ray_tpu_torch.serve.llm import LLMEngine

    tcfg, tparams = models[3], models[5]
    params = kw.pop("params", tparams)
    eng = LLMEngine(tcfg, params, device="cpu", **{**ENGINE, **kw})
    eng.start()
    return eng


def test_banked_engine_greedy_tokens_match_jax(models):
    """One base and one adapter request in one wave, on both engines."""
    from ray_tpu.serve.llm import LLMEngine as JaxEngine

    jcfg, jparams, jads, tads = models[2], models[4], models[6], models[7]
    ref = JaxEngine(jcfg, jparams, paged=True, lora_slots=2, lora_rank=4,
                    **ENGINE)
    port = _port(models, lora_slots=2, lora_rank=4)
    ref.start()
    try:
        ref.load_adapter("t/a", jads["t/a"])
        port.load_adapter("t/a", tads["t/a"])
        outs = []
        for eng in (ref, port):
            futs = [eng.submit(PROMPT, max_new_tokens=10, model_id="t/a"),
                    eng.submit(PROMPT[:7], max_new_tokens=10)]
            outs.append([f.result(timeout=300)["tokens"] for f in futs])
        assert outs[1] == outs[0]
        assert outs[1][0] != port.generate(PROMPT, 10)["tokens"]
        assert port.stats()["adapter_loads"] == 1
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_banked_equals_merged(models, temp):
    from ray_tpu_torch.models import llama as tl

    tcfg, tparams, tads = models[3], models[5], models[7]
    e1 = _port(models, lora_slots=2, lora_rank=4)
    e2 = _port(models, params=tl.merge_lora(tparams, tads["t/a"], tcfg))
    try:
        e1.load_adapter("t/a", tads["t/a"])
        a = e1.submit(PROMPT, max_new_tokens=8, temperature=temp,
                      model_id="t/a").result(timeout=300)
        b = e2.submit(PROMPT, max_new_tokens=8,
                      temperature=temp).result(timeout=300)
        assert a["tokens"] == b["tokens"]
    finally:
        e1.stop()
        e2.stop()


def test_mixed_batch_base_unaffected_and_salted_kv(models):
    tads = models[7]
    eng = _port(models, lora_slots=2, lora_rank=4)
    try:
        base_before = eng.generate(PROMPT, 5)["tokens"]
        eng.load_adapter("t/a", tads["t/a"])
        salt = eng.adapter_salt_of("t/a")
        assert salt and eng.adapter_resident("t/a", 1)
        assert not eng.adapter_resident("t/a", 2)
        futs = [eng.submit(PROMPT, max_new_tokens=5, model_id="t/a"),
                eng.submit(PROMPT, max_new_tokens=5)]
        adapted, base_after = [f.result(timeout=300)["tokens"]
                               for f in futs]
        assert base_after == base_before
        assert adapted != base_before
        m_salted = eng._mgr.match(PROMPT, salt=salt)
        m_base = eng._mgr.match(PROMPT, salt=0)
        assert m_salted and m_base
        assert set(m_salted).isdisjoint(m_base)
        eng._mgr.release(m_salted)
        eng._mgr.release(m_base)
        eng.kv_check()
    finally:
        eng.stop()


def test_slot_lru_eviction_and_in_use_protection(models):
    from ray_tpu_torch.serve.lora import AdapterLoadError

    tads = models[7]
    eng = _port(models, lora_slots=2, lora_rank=4)
    try:
        s_a = eng.load_adapter("t/a", tads["t/a"])
        s_b = eng.load_adapter("t/b", tads["t/b"])
        assert {s_a, s_b} == {1, 2}
        assert eng.load_adapter("t/a", tads["t/a"]) == s_a
        eng._lora_meta["t/a"]["last_used"] = time.monotonic()
        eng._lora_meta["t/b"]["last_used"] = 0.0
        s_c = eng.load_adapter("t/c", tads["t/c"])
        assert s_c == s_b
        assert not eng.adapter_resident("t/b")
        assert eng.adapter_resident("t/a") and eng.adapter_resident("t/c")
        assert eng.adapter_evictions == 1
        # The evicted rows were rewritten: wk of the rank-2 wq/wv adapter
        # is all zeros in its slot.
        assert not eng._lora_banks["wk"]["a"][:, s_c].any()
        eng._adapters = np.asarray([s_a, s_c, 0, 0], np.int32)
        with pytest.raises(AdapterLoadError) as ei:
            eng.load_adapter("t/b", tads["t/b"])
        assert ei.value.reason == "no_free_slot"
        assert eng.adapter_resident("t/a") and eng.adapter_resident("t/c")
    finally:
        eng._adapters[:] = 0
        eng.stop()


def test_narrow_adapter_zero_pads_to_bank_rank(models):
    from ray_tpu_torch.models import llama as tl

    tcfg, tparams, tads = models[3], models[5], models[7]
    e1 = _port(models, lora_slots=1, lora_rank=4)
    e2 = _port(models, params=tl.merge_lora(tparams, tads["t/c"], tcfg))
    try:
        e1.load_adapter("t/c", tads["t/c"])
        a = e1.submit(PROMPT, max_new_tokens=5,
                      model_id="t/c").result(timeout=300)
        b = e2.submit(PROMPT, max_new_tokens=5).result(timeout=300)
        assert a["tokens"] == b["tokens"]
    finally:
        e1.stop()
        e2.stop()


def test_engine_load_rejections_are_typed(models):
    from ray_tpu_torch.serve.lora import AdapterLoadError

    tads = models[7]
    eng = _port(models, lora_slots=1, lora_rank=2)
    try:
        with pytest.raises(AdapterLoadError) as ei:
            eng.load_adapter("t/a", tads["t/a"])       # rank 4 > 2
        assert ei.value.reason == "rank_overflow"
        with pytest.raises(AdapterLoadError) as ei:
            eng.load_adapter("x", {"targets": {}})
        assert ei.value.reason == "empty"
        bad = {"targets": {"w_up": tads["t/a"]["targets"]["wq"]}}
        with pytest.raises(AdapterLoadError) as ei:
            eng.load_adapter("x", bad)
        assert ei.value.reason == "bad_target"
        with pytest.raises(AdapterLoadError) as ei:
            eng.submit(PROMPT, model_id="x").result(timeout=60)
        assert ei.value.reason == "not_resident"
        assert eng.generate(PROMPT, 3)["tokens"]      # the loop survived
    finally:
        eng.stop()
    dense = _port(models)
    try:
        with pytest.raises(AdapterLoadError) as ei:
            dense.submit(PROMPT, model_id="t/a")
        assert ei.value.reason == "lora_slots=0"
    finally:
        dense.stop()
    with pytest.raises(ValueError, match="lora_rank"):
        _port(models, lora_slots=2)


def test_lora_helpers_match_the_reference():
    """The port's copies of the jax-free helpers: the same salts as the
    reference (radix keys agree across the two packages), the same
    validation, and the kill switches read per call."""
    from ray_tpu.serve import lora as jlora
    from ray_tpu_torch.serve import kv_router, lora

    for mid, v in (("tenant/model", 1), ("tenant/model", 2), ("x", 7)):
        assert lora.adapter_salt(mid, v) == jlora.adapter_salt(mid, v)
    ad = {"rank": 2, "targets": {"wq": {"a": torch.zeros(2, 128, 2),
                                        "b": torch.zeros(2, 2, 128)}}}
    assert lora._validate_adapter(ad) == 2
    assert lora._adapter_nbytes(ad) == 2 * 2 * 128 * 2 * 4
    with pytest.raises(ValueError, match="no targets"):
        lora._validate_adapter({"targets": {}})
    with pytest.raises(ValueError, match="declared"):
        lora._validate_adapter({**ad, "rank": 4})
    err = lora.AdapterLoadError("m", model_id="a", reason="empty")
    import pickle
    again = pickle.loads(pickle.dumps(err))
    assert (again.model_id, again.reason) == ("a", "empty")
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in (("RAY_TPU_PD_DISAGG", kv_router.pd_disagg_on),
                         ("RAY_TPU_PREFIX_STORE", kv_router.prefix_store_on),
                         ("RAY_TPU_LORA", kv_router.lora_on),
                         ("RAY_TPU_LORA_ROUTER", kv_router.lora_router_on)):
            mp.delenv(name, raising=False)
            assert fn()
            mp.setenv(name, "0")
            assert not fn()


def test_concurrent_loads_never_touch_a_slot_in_use(models):
    """Four threads load three adapters into two slots and submit under
    them, with a short switch interval: every request either gives its
    adapter's merged-weights tokens or fails typed; none decodes with a
    slot rewritten under it."""
    import sys
    import threading

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.serve.lora import AdapterLoadError

    tcfg, tparams, tads = models[3], models[5], models[7]
    want = {}
    for mid, ad in tads.items():
        ref = _port(models, params=tl.merge_lora(tparams, ad, tcfg))
        try:
            want[mid] = ref.generate(PROMPT, 6)["tokens"]
        finally:
            ref.stop()
    eng = _port(models, lora_slots=2, lora_rank=4)
    got, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(w):
            for i in range(6):
                mid = list(tads)[(w + i) % 3]
                try:
                    eng.load_adapter(mid, tads[mid])
                    out = eng.submit(PROMPT, max_new_tokens=6,
                                     model_id=mid).result(timeout=120)
                    got.append((mid, out["tokens"]))
                except AdapterLoadError as e:
                    errors.append(e.reason)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert got, errors
    assert all(tokens == want[mid] for mid, tokens in got)
    assert set(errors) <= {"no_free_slot", "not_resident"}
    assert len(got) + len(errors) == 24
    assert eng.adapter_evictions > 0
    eng.kv_check()
    assert not eng._adapters.any()
