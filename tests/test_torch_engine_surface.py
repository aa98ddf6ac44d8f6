"""The port's engine controls on the CPU: live weight updates, the
sync-window knob, warmup, abort_pending and stats.

`debug` preset in float32, page 8, max_batch 4, steps_per_sync 4, with a
parameter tree from the JAX package.  After update_weights the engine
decodes the JAX engine's greedy tokens after the same update, and those
of a fresh engine built on the new tree; the radix tree is flushed, the
kill switch drops updates and a bad tree is rejected (the ports of
tests/test_rlhf.py's engine tests).  The engine updates its own copy of
the weights, never the caller's tree, and an engine sharing the caller's
tree refuses updates.  A request draws the same tokens at every window
size, and greedy ones are the JAX engine's at that size
(tests/test_serve_slo.py)."""
import dataclasses
import queue
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

PROMPT = [(i * 7 + 3) % 250 + 1 for i in range(21)]
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
    new = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(99),
                                                  jcfg))
    return tcfg, jax.tree.map(np.asarray, jparams), new, jcfg, jparams


def _jax(models):
    from ray_tpu.serve.llm import LLMEngine as JaxEngine

    ref = JaxEngine(models[3], models[4], paged=True, **ENGINE)
    ref.start()
    return ref


def _port(models, tree=None, **kw):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.serve.llm import LLMEngine

    tcfg = models[0]
    params = params_from_jax(models[1] if tree is None else tree, tcfg,
                             device="cpu")
    eng = LLMEngine(tcfg, params, device="cpu", **{**ENGINE, **kw})
    eng.start()
    return eng


def _wait_version(eng, v, timeout=30.0):
    deadline = time.time() + timeout
    while eng.stats()["weight_version"] != v and time.time() < deadline:
        time.sleep(0.01)
    assert eng.stats()["weight_version"] == v


def test_update_weights_swaps_between_windows_without_drain(models):
    """A swap staged mid-decode: the request still gets its whole budget,
    the version flips, the resident tensors hold the new tree, and greedy
    decode after it equals the JAX engine's after the same update, and a
    fresh engine's on that tree.  params_snapshot is a copy that a later
    swap leaves alone."""
    new = models[2]
    eng = _port(models)
    try:
        resident = eng.params["final_norm"]
        fut = eng.submit(PROMPT, max_new_tokens=30)
        assert eng.update_weights(new, 7) == 7
        assert len(fut.result(timeout=300)["tokens"]) == 30
        _wait_version(eng, 7)
        st = eng.stats()
        assert st["weight_updates"] == 1 and st["last_weight_sync_ms"] > 0
        # Copied into the resident tensor, not rebound.
        assert eng.params["final_norm"] is resident
        np.testing.assert_array_equal(resident.numpy(), new["final_norm"])
        got = eng.generate(PROMPT, max_new_tokens=6)["tokens"]
    finally:
        eng.stop()
    ref = _jax(models)
    try:
        ref.generate(PROMPT, max_new_tokens=30)
        assert ref.update_weights(new, 7) == 7
        _wait_version(ref, 7)
        want = ref.generate(PROMPT, max_new_tokens=6)["tokens"]
    finally:
        ref.stop()
    assert got == want
    fresh = _port(models, tree=new)
    try:
        assert got == fresh.generate(PROMPT, max_new_tokens=6)["tokens"]
    finally:
        fresh.stop()
    params, version = eng.params_snapshot()
    assert version == 7 and params["final_norm"] is not resident
    np.testing.assert_array_equal(params["final_norm"].numpy(),
                                  new["final_norm"])
    eng.start()
    try:
        eng.update_weights(models[1], 8)
        _wait_version(eng, 8)
    finally:
        eng.stop()
    np.testing.assert_array_equal(params["final_norm"].numpy(),
                                  new["final_norm"])


def test_update_weights_leaves_the_callers_tree(models):
    """The engine decodes with its own copy: an update never reaches the
    tree it was built from.  An engine built with share_params decodes
    with the caller's tensors and refuses updates."""
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.serve.llm import LLMEngine

    tcfg, old, new = models[:3]
    tree = params_from_jax(old, tcfg, device="cpu")
    eng = LLMEngine(tcfg, tree, device="cpu", **ENGINE)
    shared = LLMEngine(tcfg, tree, device="cpu", share_params=True,
                       **ENGINE)
    assert eng.params["final_norm"] is not tree["final_norm"]
    assert shared.params["final_norm"] is tree["final_norm"]
    eng.start()
    try:
        eng.update_weights(new, 1)
        _wait_version(eng, 1)
    finally:
        eng.stop()
    np.testing.assert_array_equal(tree["final_norm"].numpy(),
                                  old["final_norm"])
    with pytest.raises(ValueError, match="share_params"):
        shared.update_weights(new)
    with pytest.raises(ValueError, match="share_params"):
        LLMEngine(tcfg, old, device="cpu", share_params=True, **ENGINE)


def test_update_weights_flushes_the_radix_tree(models):
    old = models[1]
    eng = _port(models)
    try:
        eng.generate(PROMPT, max_new_tokens=4)
        h0 = eng._mgr.hit_tokens
        eng.generate(PROMPT, max_new_tokens=4)
        assert eng._mgr.hit_tokens > h0 and eng._mgr.cached_count() > 0
        v = eng.update_weights(old)         # same shapes, same values
        assert v == 1
        _wait_version(eng, 1)
        assert eng._mgr.cached_count() == 0
        h1 = eng._mgr.hit_tokens
        eng.generate(PROMPT, max_new_tokens=4)
        assert eng._mgr.hit_tokens == h1    # a miss after the flush
        eng.kv_check()
    finally:
        eng.stop()


def test_update_weights_kill_switch_freezes_policy(models, monkeypatch):
    new = models[2]
    eng = _port(models)
    try:
        before = eng.params["final_norm"].clone()
        monkeypatch.setenv("RAY_TPU_RL_WEIGHT_SYNC", "0")
        assert eng.update_weights(new, 3) == 0
        assert eng.weight_syncs_skipped == 1
        eng.generate(PROMPT, max_new_tokens=2)
        assert eng.stats()["weight_version"] == 0
        assert torch.equal(eng.params["final_norm"], before)
        monkeypatch.delenv("RAY_TPU_RL_WEIGHT_SYNC")
        assert eng.update_weights(new) == 1
    finally:
        eng.stop()


def test_update_weights_validates_tree(models):
    old = models[1]
    eng = _port(models)
    try:
        with pytest.raises(ValueError, match="structure"):
            eng.update_weights({"nope": np.zeros(3, np.float32)})
        bad = dict(old, final_norm=np.zeros((3,), np.float32))
        with pytest.raises(ValueError, match="shape"):
            eng.update_weights(bad)
        assert eng.stats()["weight_version"] == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_sync_window_sizes_draw_identical_tokens(models, temp):
    """K in {1, 2, 4}: one fresh engine each, so every request is its
    engine's first (the same sample seed).  Greedy, each K's tokens are
    the JAX engine's at the same K."""
    outs = {}
    for k in (4, 2, 1):
        eng = _port(models)
        try:
            assert eng.set_sync_window(k) == k
            outs[k] = eng.generate(PROMPT, max_new_tokens=10,
                                   temperature=temp)["tokens"]
            st = eng.stats()
            assert st["sync_window"] == k
            assert st["sync_window_shrinks"] == (k < 4)
            assert eng.set_sync_window(None) == 4
            assert eng.set_sync_window(99) == 4
        finally:
            eng.stop()
    assert outs[1] == outs[2] == outs[4]
    if temp:            # JAX samples with threefry: only greedy agrees
        return
    ref = _jax(models)
    try:
        for k in (4, 2, 1):
            assert ref.set_sync_window(k) == k
            assert ref.generate(PROMPT, max_new_tokens=10,
                                _cache_ok=False)["tokens"] == outs[k], k
    finally:
        ref.stop()


def test_warmup_bypasses_the_prefix_cache(models):
    eng = _port(models)
    try:
        eng.warmup()
        st = eng.stats()
        assert st["completed"] == 3 + 1          # buckets 32, 64, 128
        assert eng._mgr.cached_count() == 0 and st["prefix_hits"] == 0
        eng.kv_check()
    finally:
        eng.stop()


def test_abort_pending_fails_queued_work(models):
    eng = _port(models)
    eng.stop()
    q = queue.Queue()
    futs = [eng.submit(PROMPT, max_new_tokens=4, token_queue=q)
            for _ in range(2)]
    graft = eng.kv_graft(PROMPT[:16], np.zeros((2, 2, 2, 2, 8, 32),
                                               np.float32), kv_len=16)
    eng.abort_pending(RuntimeError("replica reconfigured"))
    for f in futs + [graft]:
        with pytest.raises(RuntimeError, match="reconfigured"):
            f.result(timeout=10)
    assert q.get(timeout=10) is None


def test_stats_carry_the_reference_keys(models):
    eng = _port(models)
    try:
        eng.generate(PROMPT, max_new_tokens=5)
        st = eng.stats()
    finally:
        eng.stop()
    for key in ("weight_version", "weight_updates", "last_weight_sync_ms",
                "kv_exports", "kv_imports", "kv_grafts", "graft_tokens",
                "demote_published", "demote_failures", "adapter_loads",
                "adapter_evictions", "sync_window", "sync_window_shrinks",
                "graph_replays", "graph_captures", "graph_capture_s"):
        assert key in st, key
    # On the CPU every window runs eagerly: nothing is captured.
    assert st["decode_windows"] == 1 and st["graph_replays"] == 0
