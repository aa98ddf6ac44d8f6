"""The port's paged LLMEngine against the JAX package's, on the CPU.

`debug` preset in float32, one parameter tree on both sides, page_size
16, max_batch 4.  Greedy tokens must be identical for plain paged decode,
a prefix-hit suffix, a whole-prompt hit (copy-on-write) and a pool small
enough to preempt.  Within the port, a seeded temperature-0.8 workload
draws the same tokens whether or not it was preempted."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

SHARED = [(i * 7 + 3) % 250 + 1 for i in range(32)]      # 2 full pages


@pytest.fixture(scope="module")
def models():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(11), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(models, **kw):
    from ray_tpu.serve.llm import LLMEngine as JaxEngine
    from ray_tpu_torch.serve.llm import LLMEngine

    jcfg, tcfg, jparams, tparams = models
    kw = {"max_batch": 4, "max_len": 128, "page_size": 16, "seed": 0, **kw}
    return (JaxEngine(jcfg, jparams, paged=True, **kw),
            LLMEngine(tcfg, tparams, device="cpu", **kw))


def _run(eng, prompts, max_new_tokens, temperature=0.0):
    """Submit everything before the loop starts, so wave composition (and
    any preemption schedule) does not depend on timing."""
    eng.stop()
    futs = [eng.submit(p, max_new_tokens=max_new_tokens,
                       temperature=temperature) for p in prompts]
    eng.start()
    try:
        return [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        eng.stop()


def test_plain_paged_decode_tokens_match_jax(models):
    ref, port = _engines(models)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(20, 43)), [2, 4]]
    want = _run(ref, prompts, 20)
    got = _run(port, prompts, 20)
    assert got == want
    assert all(len(t) == 20 for t in got)
    port.kv_check()


def test_prefix_hit_suffix_tokens_match_jax(models):
    ref, port = _engines(models)
    for eng in (ref, port):
        eng.start()
    try:
        for tail in ([40, 41, 42], [50, 51], [60]):
            p = SHARED + tail
            assert port.generate(p, max_new_tokens=10)["tokens"] == \
                ref.generate(p, max_new_tokens=10)["tokens"], p
        s_ref, s_port = ref.stats(), port.stats()
        assert s_port["prefix_hit_tokens"] == s_ref["prefix_hit_tokens"]
        assert s_port["prefix_hit_tokens"] >= 2 * len(SHARED)
        assert s_port["prefill_tokens"] == s_ref["prefill_tokens"]
    finally:
        ref.stop()
        port.stop()


def test_whole_prompt_hit_cow_tokens_match_jax(models):
    ref, port = _engines(models)
    for eng in (ref, port):
        eng.start()
    try:
        first = port.generate(SHARED, max_new_tokens=8)["tokens"]
        again = port.generate(SHARED, max_new_tokens=8)["tokens"]
        want = [ref.generate(SHARED, max_new_tokens=8)["tokens"]
                for _ in range(2)]
        assert [first, again] == want
        assert port.stats()["cow_copies"] >= 1
        assert port.stats()["cow_copies"] == ref.stats()["cow_copies"]
        port.kv_check()
    finally:
        ref.stop()
        port.stop()


def test_preempting_pool_tokens_match_jax(models):
    # 6 usable blocks of 16 tokens; each request spans 3 blocks at full
    # length, so four cannot all run to the end without preemption.
    ref, port = _engines(models, kv_pages=7, prefix_cache=False,
                         kv_preempt=True)
    prompts = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(0, 40, 10)]
    want = _run(ref, prompts, 38)
    got = _run(port, prompts, 38)
    assert port.preemptions > 0
    assert got == want
    assert port.completed == 4
    port.kv_check()


def test_temperature_sampling_survives_preemption(models):
    """Seeded temperature-0.8 sampling: a pool-starved (preempting) run
    draws the same tokens as an uninterrupted one."""
    from ray_tpu_torch.serve.llm import LLMEngine

    _, tcfg, _, tparams = models
    prompts = [[i + 1, i + 2, i + 3, i + 4] for i in range(4)]
    starved = LLMEngine(tcfg, tparams, device="cpu", max_batch=4,
                        max_len=128, page_size=16, kv_pages=7,
                        kv_preempt=True, seed=5)
    roomy = LLMEngine(tcfg, tparams, device="cpu", max_batch=4,
                      max_len=128, page_size=16, seed=5)
    got = _run(starved, prompts, 38, temperature=0.8)
    want = _run(roomy, prompts, 38, temperature=0.8)
    assert starved.preemptions > 0 and roomy.preemptions == 0
    assert got == want
    # Sampling really is random: a different engine seed draws otherwise.
    other = LLMEngine(tcfg, tparams, device="cpu", max_batch=4,
                      max_len=128, page_size=16, seed=6)
    assert _run(other, prompts, 38, temperature=0.8) != want


def test_eos_and_streaming_match_jax(models):
    """eos_id stops a request early, trimming the window's overshoot, in
    both engines; the streamed tokens are the returned ones."""
    import queue

    ref, port = _engines(models)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    full = _run(port, [prompt], 20)[0]
    eos = full[5]
    want = _run(ref, [prompt], 20)[0]
    assert full == want
    port.start()
    ref.start()
    try:
        q = queue.Queue()
        fut = port.submit(prompt, max_new_tokens=20, eos_id=eos,
                          token_queue=q)
        got = fut.result(timeout=300)["tokens"]
        streamed = []
        while (tok := q.get(timeout=60)) is not None:
            streamed.append(tok)
        assert got == full[:full.index(eos) + 1] == streamed
        assert got == ref.generate(prompt, max_new_tokens=20,
                                   eos_id=eos)["tokens"]
    finally:
        port.stop()
        ref.stop()
