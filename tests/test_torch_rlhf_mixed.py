"""The port's RLHF actor topology against the reference's, on the ray_tpu
runtime (the seam's binding: tests/torch_ray_runtime.py), on the CPU.

tests/test_rlhf_chaos.py's model (vocab 128, dim 64, 2 layers, f32) and
loop (2 rollout workers, the learner in an actor, 4 prompts of 10 tokens,
groups of 4, 2 prompts a step, 5 new tokens, lr 1e-2), at temperature 0
with kl_coeff 0.1: greedy groups give every completion of a prompt the
same reward, so the advantages are zero and the KL term is what moves the
params.  From one parameter tree (`params_from_jax`), after each of two
steps the port's params and metrics are within 1e-4 of the reference's;
the second step's rollouts ran on the weights each side's broadcast
delivered.

A mixed broadcast: a JAX `GRPOLearner` actor at rank 0 calls
`ray_tpu.collective.broadcast_pytree`, a port rollout actor at rank 1
receives it with `recv_weights`; its engine's weights then equal the
JAX learner's bit for bit.  And the port's packed bytes equal a JAX
tree's leaves in `tree_flatten` order, in f32 and bf16.

The runtime boots once for the module and is shut down after it only if
it booted here; every get has a timeout."""
import dataclasses
import time
import types
import uuid

import numpy as np
import pytest
import torch

from torch_ray_runtime import RayTpuRuntime

T = 180.0
TOL = 1e-4
ENGINE = dict(max_batch=8, max_len=128, page_size=8, steps_per_sync=3)
LOOP = dict(seed=0, n_prompts=4, prompt_len=10, group_size=4,
            prompts_per_step=2, max_new_tokens=5, lr=1e-2, kl_coeff=0.1,
            temperature=0.0, num_rollout_workers=2, remote_learner=True)
METRICS = ("loss", "policy_loss", "kl", "ratio_mean", "reward_mean",
           "reward_std")


@pytest.fixture(scope="module")
def rt():
    import ray_tpu

    started = not ray_tpu.is_initialized()
    if started:
        ray_tpu.init(resources={"CPU": 6})
    yield ray_tpu
    if started:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def small():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    shape = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, ffn_dim=128, max_seq=256, remat=False)
    jcfg = jl.LlamaConfig(**shape, dtype=jnp.float32)
    tcfg = tl.LlamaConfig(**shape, dtype=torch.float32)
    jparams = jax.tree.map(np.array,
                           jl.init_params(jax.random.PRNGKey(7), jcfg))
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jparams=jparams,
        tparams=params_from_jax(jparams, tcfg, device="cpu"))


def _port_classes():
    """The port's classes on one torch thread each, shipped by value."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class Worker(LLMRolloutWorker):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

        def engine_params(self):
            from ray_tpu_torch.parallel.sharding import tree_map

            return tree_map(lambda t: t.detach().numpy().copy(),
                            self.engine.params)

    class Learner(GRPOLearner):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

    return Worker, Learner


def _leaves(tree):
    from ray_tpu_torch.train.session import flatten

    out: list = []
    flatten(tree, out)
    return [x.detach().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in out]


def _run(trainer, rt, steps):
    out = []
    try:
        for _ in range(steps):
            m = trainer.step()
            params = rt.get(trainer.learner.get_params_numpy.remote(),
                            timeout=T)
            out.append((m, _leaves(params),
                        list(trainer.stats()["worker_versions"])))
    finally:
        trainer.shutdown()
    return out


def test_actor_topology_matches_reference(rt, small):
    from ray_tpu.rl import rlhf as jr
    from ray_tpu_torch.rl import rlhf as tr

    worker, learner = _port_classes()
    ref = _run(jr.RLHFTrainer(jr.RLHFConfig(
        model=small.jcfg, params=small.jparams, engine=dict(ENGINE),
        **LOOP)), rt, 2)
    port = _run(tr.RLHFTrainer(tr.RLHFConfig(
        model=small.tcfg, params=small.tparams, engine=dict(ENGINE),
        device="cpu", runtime=RayTpuRuntime(), worker_cls=worker,
        learner_cls=learner, **LOOP)), rt, 2)
    p0 = _leaves(small.jparams)
    for step, ((rm, rp, rv), (pm, pp, pv)) in enumerate(zip(ref, port)):
        for k in METRICS:
            np.testing.assert_allclose(pm[k], rm[k], atol=TOL, rtol=TOL,
                                       err_msg=f"step {step}: {k}")
        np.testing.assert_allclose(pm["advantages"], rm["advantages"],
                                   atol=TOL, rtol=0)
        for k in ("version", "rollout_tokens", "batch_weight_version",
                  "weight_syncs", "rollout_regens", "learner_restarts"):
            assert pm[k] == rm[k], (step, k, pm[k], rm[k])
        assert pv == rv == [step + 1] * 2
        assert len(pp) == len(rp)
        for a, b in zip(pp, rp):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0,
                                       err_msg=f"step {step}")
    # The KL term moved the params, on both sides.
    assert max(float(np.abs(a - b).max())
               for a, b in zip(port[-1][1], p0)) > 1e-3


def test_jax_learner_broadcast_reaches_port_worker_bit_for_bit(rt, small):
    import jax

    from ray_tpu.collective import destroy_collective_group
    from ray_tpu.models import llama as jl
    from ray_tpu.rl import rlhf as jr

    worker_cls, _ = _port_classes()
    # The JAX learner holds other weights than the worker's.
    other = jax.tree.map(np.array, jl.init_params(jax.random.PRNGKey(11),
                                                  small.jcfg))
    learner = rt.remote(jr.GRPOLearner).options(num_cpus=1).remote(
        jr.RLHFConfig(model=small.jcfg, params=other))
    worker = rt.remote(worker_cls).options(
        num_cpus=1, max_concurrency=4).remote(
            small.tcfg, params=small.tparams, engine=dict(ENGINE),
            device="cpu", runtime=RayTpuRuntime())
    name = f"mixed:{uuid.uuid4().hex[:8]}"
    try:
        rt.get([learner.init_collective_group.remote(2, 0, "object_store",
                                                     name),
                worker.init_collective_group.remote(2, 1, "object_store",
                                                    name)], timeout=T)
        recv = worker.recv_weights.remote(7, name)
        assert rt.get(learner.broadcast_weights.remote(name),
                      timeout=T) == 0
        assert rt.get(recv, timeout=T) == 7
        deadline = time.monotonic() + 60
        while rt.get(worker.stats.remote(),
                     timeout=T)["weight_version"] != 7:
            assert time.monotonic() < deadline, "the swap never landed"
            time.sleep(0.05)
        got = _leaves(rt.get(worker.engine_params.remote(), timeout=T))
        want = jax.tree_util.tree_leaves(rt.get(
            learner.get_params_numpy.remote(), timeout=T))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == np.ascontiguousarray(b).tobytes()
        assert any(not np.array_equal(a, b) for a, b in zip(
            want, _leaves(small.jparams)))
    finally:
        destroy_collective_group(name, reason="test done")
        for a in (learner, worker):
            rt.kill(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_bytes_follow_tree_flatten_order(small, dtype):
    import jax
    import jax.numpy as jnp

    from ray_tpu_torch.collective.collective import pack, unpack
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.train.session import flatten

    jtree = jax.tree.map(lambda a: np.asarray(jnp.asarray(
        a, getattr(jnp, dtype))), small.jparams)
    want = np.concatenate([np.ascontiguousarray(x).reshape(-1).view(
        np.uint8) for x in jax.tree_util.tree_leaves(jtree)])
    tcfg = dataclasses.replace(small.tcfg, dtype=getattr(torch, dtype))
    ttree = params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                         jtree), tcfg, device="cpu")
    leaves: list = []
    flatten(ttree, leaves)
    got = pack(leaves)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    back = unpack(want, leaves)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(back, leaves))
