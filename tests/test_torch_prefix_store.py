"""The tier-2 prefix store in the port (demotion and grafts), against the
JAX package on the CPU.

`debug` preset in float32, page 8, max_batch 4, steps_per_sync 4.  A
prefix the JAX engine demoted, grafted into the port, makes the next
request hit the prefix cache and give JAX's greedy tokens.  Within the
port, demote-then-graft keeps the tokens of a cold prefill at
temperatures 0.0 and 0.8, the min_idle and watermark knobs gate
demotion, a stale weight version never grafts, and a failed graft fails
only its own future (the ports of tests/test_prefix_store.py)."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

PROMPT = [(i * 7 + 3) % 250 + 1 for i in range(21)]   # 2 full pages + 5
ENGINE = dict(max_batch=4, max_len=128, page_size=8, steps_per_sync=4,
              seed=0)
FAST = dict(min_idle=0, period_s=0.01, watermark_frac=0.0, limit=4,
            max_inflight=4)


@pytest.fixture(scope="module")
def models():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _port(models, **kw):
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(models[1], models[3], device="cpu", **{**ENGINE, **kw})
    eng.start()
    return eng


def _clean(eng):
    eng.kv_check()
    assert eng._mgr.available() == eng._mgr.n_blocks


def _demote_all(eng, timeout=30.0, **knobs):
    """Install a capturing callback; wait until something demoted."""
    store = {}

    def cb(entry):
        store[entry["hashes"][-1]] = entry
        return True

    eng.set_prefix_store(cb, **{**FAST, **knobs})
    eng._wake.set()
    deadline = time.time() + timeout
    while not store and time.time() < deadline:
        time.sleep(0.02)
    return store


def test_graft_of_jax_demoted_prefix_matches_jax(models):
    from ray_tpu.serve.llm import LLMEngine as JaxEngine

    jcfg, _, jparams, _ = models
    a = JaxEngine(jcfg, jparams, paged=True, **ENGINE)
    a.start()
    try:
        ref = a.generate(PROMPT, max_new_tokens=6)["tokens"]
        store = _demote_all(a)
        assert store, "the JAX engine demoted nothing"
    finally:
        a.stop()
    entry = max(store.values(), key=lambda e: e["depth"])
    b = _port(models)
    try:
        out = b.kv_graft(entry["tokens"], np.asarray(entry["kv"]),
                         kv_len=entry["depth"] * 8,
                         weight_version=0).result(timeout=120)
        assert out["grafted"] == entry["depth"]
        r = b.generate(PROMPT, max_new_tokens=6)["tokens"]
        assert r == ref
        assert b._mgr.hit_tokens >= 16
        assert b.prefill_tokens < len(PROMPT)
        st = b.stats()
        assert st["kv_grafts"] == 1
        assert st["graft_tokens"] == entry["depth"] * 8
        _clean(b)
    finally:
        b.stop()


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_demote_graft_token_parity(models, temp):
    a = _port(models)
    try:
        ref = a.generate(PROMPT, max_new_tokens=6, temperature=temp)
        store = _demote_all(a)
        assert store, "no demotion happened"
        deadline = time.time() + 30
        while a.stats()["demote_published"] < len(store) \
                and time.time() < deadline:
            time.sleep(0.02)
        a.kv_check()
        assert a._mgr.demotions >= 1
        assert a.stats()["demote_published"] >= 1
    finally:
        a.stop()
    entry = max(store.values(), key=lambda e: e["depth"])
    assert entry["weight_version"] == 0 and entry["page"] == 8
    assert tuple(entry["kv"].shape) == (2, 2, entry["depth"], 2, 8, 32)
    b = _port(models)
    try:
        out = b.kv_graft(entry["tokens"], entry["kv"],
                         kv_len=entry["depth"] * 8,
                         weight_version=0).result(timeout=120)
        assert out["grafted"] == entry["depth"]
        r = b.generate(PROMPT, max_new_tokens=6, temperature=temp)
        assert r["tokens"] == ref["tokens"]
        assert b._mgr.hit_tokens >= 16
        assert b.prefill_tokens < len(PROMPT)
        _clean(b)
    finally:
        b.stop()


def test_min_idle_and_watermark_gate_demotion(models):
    """A leaf younger than min_idle stays in tier 1 while the pool has
    room; a watermark above the free pool demotes it at once."""
    eng = _port(models, kv_pages=17)
    try:
        eng.generate(PROMPT, max_new_tokens=4)
        none = _demote_all(eng, timeout=0.5, min_idle=10**6)
        assert none == {} and eng._mgr.demotions == 0
        got = _demote_all(eng, min_idle=10**6, watermark_frac=1.0)
        assert got
        eng.kv_check()
    finally:
        eng.stop()


def test_kv_graft_validation(models):
    eng = _port(models)
    try:
        with pytest.raises(ValueError, match="multiple"):
            eng.kv_graft(PROMPT[:13], np.zeros(1), kv_len=13)
        with pytest.raises(ValueError, match="cover exactly"):
            eng.kv_graft(PROMPT[:13], np.zeros((2, 2, 2, 2, 8, 32),
                                               np.float32), kv_len=16)
        with pytest.raises(ValueError, match="shape"):
            eng.kv_graft(PROMPT[:16], np.zeros((2, 2, 2, 2, 4, 32),
                                               np.float32), kv_len=16)
        _clean(eng)
    finally:
        eng.stop()


def test_stale_weight_version_never_grafts(models):
    eng = _port(models)
    try:
        kv = np.zeros((2, 2, 2, 2, 8, 32), np.float32)
        out = eng.kv_graft(PROMPT[:16], kv, kv_len=16,
                           weight_version=7).result(timeout=120)
        assert out == {"grafted": 0, "reason": "stale_version"}
        assert eng._mgr.cached_count() == 0
        _clean(eng)
    finally:
        eng.stop()


def test_failed_graft_scatter_fails_its_future_only(models, monkeypatch):
    eng = _port(models)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected graft fault")

        monkeypatch.setattr(eng, "_scatter_kv", boom)
        kv = np.zeros((2, 2, 2, 2, 8, 32), np.float32)
        fut = eng.kv_graft(PROMPT[:16], kv, kv_len=16)
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=120)
        monkeypatch.undo()
        _clean(eng)
        assert eng._mgr.cached_count() == 0
        assert len(eng.generate(PROMPT, max_new_tokens=3)["tokens"]) == 3
    finally:
        eng.stop()
