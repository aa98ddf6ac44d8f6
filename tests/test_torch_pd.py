"""PD disaggregation in the port (prefill on one engine, decode on
another), against the JAX package on the CPU.

`debug` preset in float32, page 8, max_batch 4, steps_per_sync 4.  A
`kv_export` array from the JAX prefill-only engine, imported into the
port, continues to JAX's greedy tokens.  Within the port, a migrated
request draws the tokens of an uninterrupted run at temperatures 0.0 and
0.8, block accounting ends clean on both engines, kv_import validates its
arguments, and a failed export fails only its own request and leaks no
block (the ports of tests/test_pd_disagg.py that need no failpoint or
server: the failures are raised from the engine's own steps)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

PROMPT = [(i * 7 + 3) % 250 + 1 for i in range(21)]   # 2 full pages + 5
ENGINE = dict(max_batch=4, max_len=128, page_size=8, steps_per_sync=4,
              seed=0)


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


def test_jax_export_imports_into_port(models):
    from ray_tpu.serve.llm import LLMEngine as JaxEngine

    jcfg, _, jparams, _ = models
    ref = JaxEngine(jcfg, jparams, paged=True, **ENGINE)
    ref.start()
    try:
        pre = ref.submit(PROMPT, max_new_tokens=1,
                         prefill_only=True).result(timeout=300)
        want = ref.generate(PROMPT, max_new_tokens=10,
                            _cache_ok=False)["tokens"]
    finally:
        ref.stop()
    exp = pre["kv_export"]
    assert exp["len"] == len(PROMPT)
    dec = _port(models)
    try:
        out = dec.kv_import(PROMPT, exp["tokens"], np.asarray(exp["kv"]),
                            kv_len=exp["len"], max_new_tokens=10,
                            sample_seed=exp["sample_seed"]).result(timeout=300)
        assert out["tokens"] == want
        assert dec.kv_imports == 1 and dec.stats()["kv_imports"] == 1
        _clean(dec)
    finally:
        dec.stop()


def _migrate(models, prompt, temp, new_tokens=10):
    pre_e, dec_e = _port(models, name="pre"), _port(models, name="dec")
    pre = pre_e.submit(prompt, max_new_tokens=1, temperature=temp,
                       prefill_only=True).result(timeout=300)
    exp = pre["kv_export"]
    assert exp["len"] == len(prompt) and exp["page"] == 8
    assert tuple(exp["kv"].shape) == (2, 2, -(-len(prompt) // 8), 2, 8, 32)
    out = dec_e.kv_import(
        prompt, exp["tokens"], exp["kv"], kv_len=exp["len"],
        max_new_tokens=new_tokens, temperature=temp,
        sample_seed=exp["sample_seed"]).result(timeout=300)
    return out, pre_e, dec_e


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_migrated_decode_token_parity(models, temp):
    single = _port(models)
    try:
        ref = single.generate(PROMPT, max_new_tokens=10, temperature=temp)
    finally:
        single.stop()
    out, pre_e, dec_e = _migrate(models, PROMPT, temp)
    try:
        assert out["tokens"] == ref["tokens"]
        assert pre_e.kv_exports == 1 and dec_e.kv_imports == 1
        assert pre_e.stats()["kv_exports"] == 1
    finally:
        pre_e.stop()
        dec_e.stop()


def test_migration_block_accounting_clean(models):
    out, pre_e, dec_e = _migrate(models, PROMPT, 0.0)
    try:
        assert len(out["tokens"]) == 10
        for eng in (pre_e, dec_e):
            _clean(eng)
        # The prefill side committed the prompt's full blocks.
        pre_e.generate(PROMPT, max_new_tokens=2)
        assert pre_e._mgr.hit_tokens >= 16
    finally:
        pre_e.stop()
        dec_e.stop()


def test_kv_import_validation(models):
    eng = _port(models)
    try:
        kv_ok = np.zeros((2, 2, 3, 2, 8, 32), np.float32)
        with pytest.raises(ValueError, match="kv_len"):
            eng.kv_import(PROMPT, [5], kv_ok, kv_len=7, max_new_tokens=4)
        with pytest.raises(ValueError, match="shape"):
            eng.kv_import(PROMPT, [5], np.zeros((2, 2, 3, 2, 4, 32),
                                                np.float32),
                          kv_len=len(PROMPT), max_new_tokens=4)
        with pytest.raises(ValueError, match="first "):
            eng.kv_import(PROMPT, [], kv_ok, kv_len=len(PROMPT))
        with pytest.raises(ValueError, match="max_len"):
            eng.kv_import(PROMPT, [5], kv_ok, kv_len=len(PROMPT),
                          max_new_tokens=1000)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.kv_import(PROMPT, [5, 6, 7], kv_ok, kv_len=len(PROMPT) + 2,
                          max_new_tokens=2)
        _clean(eng)
    finally:
        eng.stop()


@pytest.mark.parametrize("where", ["export_blocks", "gather"])
def test_failed_export_releases_blocks(models, where, monkeypatch):
    """An export that fails inside or before its pinned window fails its
    own future; the loop survives and no block leaks."""
    eng = _port(models)
    try:
        def boom(*a, **k):
            raise RuntimeError(f"injected {where} fault")

        if where == "gather":
            monkeypatch.setattr(eng, "_gather_kv", boom)
        else:
            monkeypatch.setattr(eng._mgr, "export_blocks", boom)
        fut = eng.submit(PROMPT, max_new_tokens=1, prefill_only=True)
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=300)
        monkeypatch.undo()
        _clean(eng)
        assert len(eng.generate(PROMPT, max_new_tokens=3)["tokens"]) == 3
        assert eng.kv_exports == 0
    finally:
        eng.stop()


def test_prefill_only_eos_skips_export(models):
    eng = _port(models)
    try:
        t0 = eng.generate(PROMPT, max_new_tokens=1)["tokens"][0]
        out = eng.submit(PROMPT, max_new_tokens=1, eos_id=t0,
                         prefill_only=True).result(timeout=300)
        assert out["tokens"] == [t0] and "kv_export" not in out
        assert eng.kv_exports == 0
        eng.kv_check()
    finally:
        eng.stop()
