"""The RLHF actor topology on the port's own runtime (`ClusterRuntime`),
on the CPU.

tests/test_torch_rlhf_mixed.py's model (vocab 128, dim 64, 2 layers, f32)
and loop (2 rollout workers, the learner in an actor, 4 prompts of 10
tokens, groups of 4, 2 prompts a step, 5 new tokens, lr 1e-2, temperature
0, kl_coeff 0.1) with `device="cpu"`, from one parameter tree on
`ClusterRuntime` and on `LocalRuntime`:

- after each of two steps the params and metrics are within 1e-4 of each
  other, and every engine carries the version the packed broadcast (over
  the port's collectives) delivered;
- the harvest holds the `rl.weight_sync` spans, each connected to the
  `collective.broadcast:0` spans of its members, and the
  `rl_rollout_tokens` counter the workers flushed to the controller's KV
  equals the tokens generated;
- `rl.rollout_step=nth:1+crash` armed on one worker: the third step
  recovers (`rollout_regens` 1), and after shutdown no rendezvous actor
  is left behind.

The anchor to the reference is tests/test_torch_rlhf_mixed.py, which
holds the same loop on the seam's binding to `ray_tpu` against
`ray_tpu.rl.rlhf`'s trainer over two steps; here, besides, the cluster
learner's first update is held against the reference's `GRPOLearner`
run in this process on the same batch.

One cluster (`ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})`) boots
for the module and is shut down after it; every get and wait has a
deadline of 60 s or less.  Also: with `device` left to CUDA, the actors
ask for a share of "GPU", land in the device worker, and raise there for
want of a CUDA device instead of building on the CPU."""
import json
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch

T = 60.0
TOL = 1e-4
ENGINE = dict(max_batch=8, max_len=128, page_size=8, steps_per_sync=3)
LOOP = dict(seed=0, n_prompts=4, prompt_len=10, group_size=4,
            prompts_per_step=2, max_new_tokens=5, lr=1e-2, kl_coeff=0.1,
            temperature=0.0, num_rollout_workers=2, remote_learner=True)
METRICS = ("loss", "policy_loss", "kl", "ratio_mean", "reward_mean",
           "reward_std")


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def small():
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq=256, remat=False, dtype=torch.float32)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(7))


def _classes():
    """Rollout and learner classes on one torch thread each, whose
    failpoints a test can arm, shipped by value."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class Worker(LLMRolloutWorker):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)

        def arm(self, site, action):
            import os as _os

            from ray_tpu_torch._private import failpoints as fp

            fp.arm(site, action)
            return _os.getpid()

        def worker_id(self):
            import ray_tpu_torch as _rt

            return _rt.get_runtime_context().get_worker_id()

    class Learner(GRPOLearner):
        def __init__(self, *a, **kw):
            import torch as _torch

            _torch.set_num_threads(1)
            super().__init__(*a, **kw)
            self.first_trajs = None

        def update(self, trajs):
            rt = self._runtime
            trajs = [rt.get(t, timeout=60.0) if rt.is_ref(t) else t
                     for t in (trajs if isinstance(trajs, (list, tuple))
                               else [trajs])]
            if self.first_trajs is None:
                self.first_trajs = trajs
            return super().update(trajs)

        def get_first_trajs(self):
            return self.first_trajs

    return Worker, Learner


def _leaves(tree):
    from ray_tpu_torch.train.step import param_leaves

    return [t.detach().numpy().copy() for t in param_leaves(tree)]


def _versions(rt, workers, want, timeout=T):
    """recv_weights returns at staging; the swap lands between windows."""
    deadline = time.monotonic() + timeout
    while True:
        vs = [rt.get(w.stats.remote(), timeout=T)["weight_version"]
              for w in workers]
        if vs == want or time.monotonic() > deadline:
            return vs
        time.sleep(0.05)


def _rdv_actors() -> list:
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "list_actors", {},
                         timeout=T)
    return [a["name"] for a in reply["actors"]
            if (a.get("name") or "").startswith("collective_rdv:")
            and a["state"] != "DEAD"]


def _rollout_tokens_flushed() -> float:
    """rl_rollout_tokens summed over every process's last flush."""
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "kv_keys",
                         {"ns": "metrics"}, timeout=T)
    total = 0.0
    for key in reply["keys"]:
        r, blobs = core.call(core.controller_addr, "kv_get",
                             {"ns": "metrics", "key": key}, timeout=T)
        if not r["found"]:
            continue
        for m in json.loads(bytes(blobs[0]))["metrics"]:
            if m["name"] == "rl_rollout_tokens":
                total += sum(v["value"] for v in m["values"])
    return total


@pytest.fixture(scope="module")
def runs(cluster, small):
    """The loop's first two steps on LocalRuntime and on ClusterRuntime,
    then a third, crashed, step on the cluster."""
    from ray_tpu_torch import tracing
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer
    from ray_tpu_torch.serve.runtime import ClusterRuntime, LocalRuntime

    cfg, params = small
    worker, learner = _classes()
    out = {}
    local = LocalRuntime()
    tr = RLHFTrainer(RLHFConfig(model=cfg, params=params,
                                engine=dict(ENGINE), device="cpu",
                                runtime=local, **LOOP))
    try:
        out["local"] = []
        for _ in range(2):
            m = tr.step()
            p = local.get(tr.learner.get_params_numpy.remote(), timeout=T)
            out["local"].append((m, _leaves(p)))
    finally:
        tr.shutdown()
        local.shutdown()
    rt = ClusterRuntime()
    tr = RLHFTrainer(RLHFConfig(model=cfg, params=params,
                                engine=dict(ENGINE), device="cpu",
                                runtime=rt, worker_cls=worker,
                                learner_cls=learner, **LOOP))
    try:
        out["cluster"] = []
        for step in range(2):
            m = tr.step()
            p = rt.get(tr.learner.get_params_numpy.remote(), timeout=T)
            out["cluster"].append((m, _leaves(p), _versions(
                rt, tr.workers, [step + 1] * 2)))
        tokens = sum(int(m["rollout_tokens"]) for m, *_ in out["cluster"])
        deadline = time.monotonic() + 20.0
        while _rollout_tokens_flushed() < tokens and \
                time.monotonic() < deadline:
            time.sleep(0.25)
        out["tokens"] = (tokens, _rollout_tokens_flushed())
        out["first_trajs"] = rt.get(tr.learner.get_first_trajs.remote(),
                                    timeout=T)
        out["spans"] = tracing.harvest(timeout=T)
        out["pids"] = rt.get([tr.learner.pid.remote()]
                             + [w.pid.remote() for w in tr.workers],
                             timeout=T)
        pid = rt.get(tr.workers[0].arm.remote("rl.rollout_step",
                                              "nth:1+crash"), timeout=T)
        m = tr.step()
        out["crash"] = (pid, m, tr.stats(), _versions(rt, tr.workers,
                                                      [3, 3]))
    finally:
        tr.shutdown()
    deadline = time.monotonic() + 20.0
    while _rdv_actors() and time.monotonic() < deadline:
        time.sleep(0.25)
    out["rdv_after"] = _rdv_actors()
    return out


def test_cluster_topology_matches_local_runtime(runs, small):
    p0 = _leaves(small[1])
    for step, ((lm, lp), (cm, cp, cv)) in enumerate(zip(runs["local"],
                                                        runs["cluster"])):
        for k in METRICS:
            np.testing.assert_allclose(cm[k], lm[k], atol=TOL, rtol=TOL,
                                       err_msg=f"step {step}: {k}")
        np.testing.assert_allclose(cm["advantages"], lm["advantages"],
                                   atol=TOL, rtol=0)
        for k in ("version", "rollout_tokens", "batch_weight_version",
                  "weight_syncs", "rollout_regens", "learner_restarts",
                  "epoch"):
            assert cm[k] == lm[k], (step, k, cm[k], lm[k])
        assert cv == [step + 1] * 2
        assert len(cp) == len(lp)
        for a, b in zip(cp, lp):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0,
                                       err_msg=f"step {step}")
    # The KL term moved the params.
    assert max(float(np.abs(a - b).max())
               for a, b in zip(runs["cluster"][-1][1], p0)) > 1e-3
    # Three actors, each in a plain worker of its own (device="cpu").
    assert len(set(runs["pids"])) == 3 and os.getpid() not in runs["pids"]


def test_first_update_matches_reference_learner(runs, small):
    """The cluster learner's first update against the reference's
    `GRPOLearner` in this process, on the batch the cluster's rollout
    actors made, from the same params: the metrics and the advantages
    agree within 1e-4."""
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.rl import rlhf as jr

    cfg, params = small

    def as_numpy(tree):
        return {k: as_numpy(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree.detach().numpy().copy()

    jcfg = jl.LlamaConfig(
        vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        ffn_dim=cfg.ffn_dim, max_seq=cfg.max_seq, remat=False,
        dtype=jnp.float32)
    ref = jr.GRPOLearner(jr.RLHFConfig(model=jcfg, params=as_numpy(params),
                                       engine=dict(ENGINE), **LOOP))
    want = ref.update(runs["first_trajs"])
    got = runs["cluster"][0][0]
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["advantages"], want["advantages"],
                               atol=TOL, rtol=0)


def test_weight_sync_spans_and_rollout_counter(runs):
    from ray_tpu_torch import tracing

    spans = runs["spans"]
    syncs = [s for s in spans if s["name"] == "rl.weight_sync"]
    assert len(syncs) == 2 and all(s["attrs"]["mode"] == "remote_learner"
                                   for s in syncs)
    for s in syncs:
        trace = [x for x in spans if x["tid"] == s["tid"]]
        bcast = [x for x in trace if x["name"] == "collective.broadcast:0"]
        # The learner and both workers record their half of the op.
        assert len(bcast) == 3, [x["name"] for x in trace]
        assert {x["attrs"]["rank"] for x in bcast} == {0, 1, 2}
        assert tracing.connected(spans, s["tid"])
    tokens, flushed = runs["tokens"]
    assert tokens > 0 and flushed == tokens


def test_rollout_crash_recovers_and_leaves_no_rendezvous(runs):
    pid, m, st, versions = runs["crash"]
    assert m["version"] == 3 and np.isfinite(m["loss"])
    assert m["rollout_regens"] == 1 == st["rollout_regens"]
    assert versions == [3, 3]
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    assert runs["rdv_after"] == []


def test_cuda_config_asks_for_the_device_worker_and_raises_there(
        cluster, small):
    """`device` left to CUDA: the learner asks for a share of "GPU", so
    it lands in the device worker (a plain worker sees no CUDA device);
    with no CUDA device there either, it raises naming why instead of
    building on the CPU."""
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer
    from ray_tpu_torch.serve.runtime import ClusterRuntime

    cfg, params = small
    placed = []

    class Recording(ClusterRuntime):
        def remote(self, cls):
            outer = super().remote(cls)

            class Opts:
                def options(self, **kw):
                    placed.append(kw)
                    return outer.options(**kw)

            return Opts()

    with pytest.raises(Exception, match="no CUDA device is available"):
        RLHFTrainer(RLHFConfig(model=cfg, params=params,
                               engine=dict(ENGINE), runtime=Recording(),
                               **LOOP))
    assert placed == [{"num_cpus": 1, "num_gpus": 1 / 6}]
