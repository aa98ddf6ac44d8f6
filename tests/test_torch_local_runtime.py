"""The runtime seam's actor and collective faces (ray_tpu_torch/serve/
runtime.py) on the CPU, without a cluster.

The null `ServeRuntime` makes no actors and forms no groups (each raises,
naming LocalRuntime) and its hooks do nothing.  `LocalRuntime`: an actor
runs `max_concurrency` calls at once and one at a time by default; a
kill makes its pending and later calls raise `ActorDiedError`; a ref
argument resolves before the method runs; a broadcast reaches every
rank; a destroy unparks a waiter with its reason, and a wait with no
source ends at its deadline; a crash failpoint kills the actor it fires
in; launch counts stay exact under many threads.  Then the RLHF actor
topology on a LocalRuntime (2 workers, the
learner in an actor, `debug`-sized f32 model of tests/test_rlhf_chaos.py,
temperature 0, kl_coeff 0.1): after each of three steps its params equal
the in-process loop's from the same seed, a `broadcast_pytree` round trip
is bit for bit, and both chaos arms recover with the stated counters.
Every wait has a timeout."""
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.serve.runtime import (ActorDiedError,
                                         CollectiveGroupError,
                                         LocalRuntime, ServeRuntime)

T = 30.0
ENGINE = dict(max_batch=8, max_len=128, page_size=8, steps_per_sync=3)


class Sleeper:
    def __init__(self):
        self.lock = threading.Lock()
        self.running = self.peak = 0
        self.gate = threading.Event()

    def hold(self, s):
        with self.lock:
            self.running += 1
            self.peak = max(self.peak, self.running)
        self.gate.wait(s)
        with self.lock:
            self.running -= 1
        return self.peak

    def echo(self, x):
        return x

    def peak_seen(self):
        return self.peak


def test_null_runtime_makes_no_actors_and_its_hooks_do_nothing():
    rt = ServeRuntime()
    for call in (lambda: rt.remote(Sleeper), lambda: rt.kill(object()),
                 lambda: rt.init_collective_group(2, 0, "g"),
                 lambda: rt.deregister_collective_group("g"),
                 lambda: rt.destroy_collective_group("g", "r"),
                 lambda: rt.broadcast_async(np.zeros(1), 0, "g")):
        with pytest.raises(RuntimeError, match="LocalRuntime"):
            call()
    assert rt.get_rank("g") == -1
    assert rt.failpoint("rl.rollout_step") is None
    with rt.span("rl.weight_sync", {"version": 1}) as sp:
        assert sp == {}


def test_max_concurrency_and_ref_arguments():
    rt = LocalRuntime()
    try:
        four = rt.remote(Sleeper).options(num_cpus=1,
                                          max_concurrency=4).remote()
        refs = [four.hold.remote(0.3) for _ in range(4)]
        assert max(rt.get(refs, timeout=T)) == 4
        one = rt.remote(Sleeper).remote()
        assert max(rt.get([one.hold.remote(0.05) for _ in range(3)],
                          timeout=T)) == 1
        # A top-level ref argument resolves before the method runs; a
        # nested one is handed over as it is.
        ref = one.echo.remote({"a": 1})
        assert rt.get(one.echo.remote(ref), timeout=T) == {"a": 1}
        nested = rt.get(one.echo.remote([ref]), timeout=T)
        assert rt.is_ref(nested[0]) and rt.get(nested, timeout=T) == [
            {"a": 1}]
    finally:
        rt.shutdown()


def test_kill_fails_pending_and_later_calls():
    rt = LocalRuntime()
    a = rt.remote(Sleeper).remote()
    running = a.hold.remote(10.0)          # occupies the one thread
    queued = [a.echo.remote(i) for i in range(3)]
    time.sleep(0.1)
    rt.kill(a)
    for r in [running] + queued + [a.echo.remote(9)]:
        with pytest.raises(ActorDiedError, match="killed"):
            rt.get(r, timeout=T)
    rt.kill(a)                              # idempotent
    rt.shutdown()


def test_broadcast_destroy_and_deadline():
    rt = LocalRuntime()

    class Member:
        def join(self, world, rank, name):
            rt.init_collective_group(world, rank, name)
            return rt.get_rank(name)

        def recv(self, name, timeout=None):
            return rt.broadcast_async(None, 0, name).wait(timeout)

    try:
        members = [rt.remote(Member).remote() for _ in range(2)]
        assert rt.get([m.join.remote(3, r + 1, "g")
                       for r, m in enumerate(members)], timeout=T) == [1, 2]
        rt.init_collective_group(3, 0, "g")     # the driver is rank 0
        assert rt.get_rank("g") == 0
        recv = [m.recv.remote("g", T) for m in members]
        payload = np.arange(10, dtype=np.uint8)
        assert rt.broadcast_async(payload, 0, "g").wait(T) is payload
        for r in recv:
            np.testing.assert_array_equal(rt.get(r, timeout=T), payload)
        # A waiter parked on a group that is then destroyed raises with
        # the destroyer's reason.
        parked = [m.recv.remote("g", T) for m in members]
        time.sleep(0.1)
        rt.destroy_collective_group("g", reason="epoch 1 abandoned")
        for r in parked:
            with pytest.raises(CollectiveGroupError,
                               match="epoch 1 abandoned"):
                rt.get(r, timeout=T)
        # No source: the wait ends at its deadline.
        rt.get([m.join.remote(3, r + 1, "h")
                for r, m in enumerate(members)], timeout=T)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="not received"):
            rt.get(members[0].recv.remote("h", 0.5), timeout=T)
        assert time.monotonic() - t0 < 5.0
        with pytest.raises(RuntimeError, match="not initialized"):
            rt.broadcast_async(payload, 0, "h")
        rt.deregister_collective_group("h")
    finally:
        rt.shutdown()


def test_crash_failpoint_kills_its_actor():
    rt = LocalRuntime()

    class Site:
        def hit(self):
            rt.failpoint("x.site")
            return "passed"

    try:
        a, b = (rt.remote(Site).remote() for _ in range(2))
        rt.arm("x.site", "nth:2+crash", actor=a)
        assert rt.get(b.hit.remote(), timeout=T) == "passed"
        assert rt.get(a.hit.remote(), timeout=T) == "passed"
        with pytest.raises(ActorDiedError, match="x.site"):
            rt.get(a.hit.remote(), timeout=T)
        with pytest.raises(ActorDiedError):
            rt.get(a.hit.remote(), timeout=T)
        assert rt.get(b.hit.remote(), timeout=T) == "passed"   # disarmed
        rt.arm("x.site", "raise")
        with pytest.raises(RuntimeError, match="injected"):
            rt.get(b.hit.remote(), timeout=T)
        with pytest.raises(ValueError, match="failpoint action"):
            rt.arm("x.site", "sometimes")
    finally:
        rt.shutdown()


def test_launch_counts_are_exact_across_threads():
    """Engines and a learner of one process launch from several threads:
    no count may be lost (16 threads, a short switch interval)."""
    import collections
    import sys

    from ray_tpu_torch.ops import counters

    class Wrapper:
        """A wrapper whose count is a property: the getter and setter are
        Python calls, where the interpreter may switch threads."""

        def __init__(self):
            self._n = 0
            self.launches_by_route = collections.Counter()

        @property
        def launches(self):
            return self._n

        @launches.setter
        def launches(self, v):
            self._n = v

    fn = Wrapper()
    n, per = 16, 2000
    go = threading.Barrier(n)

    def launch():
        go.wait(T)
        for _ in range(per):
            counters.count(fn, "fma")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert fn.launches == n * per == fn.launches_by_route["fma"]


# ---------------------------------------------------- the RLHF topology
@pytest.fixture(scope="module")
def small():
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=128, max_seq=256, remat=False, dtype=torch.float32)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(7))


def _cfg(small, **kw):
    from ray_tpu_torch.rl.rlhf import RLHFConfig

    cfg, params = small
    return RLHFConfig(**{**dict(
        model=cfg, params=params, seed=0, n_prompts=4, prompt_len=10,
        group_size=4, prompts_per_step=2, max_new_tokens=5, lr=1e-2,
        kl_coeff=0.1, temperature=0.0, device="cpu", engine=dict(ENGINE)),
        **kw})


def _params_worker():
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class ParamsWorker(LLMRolloutWorker):
        def engine_params(self):
            return self.engine.params_snapshot()[0]

    return ParamsWorker


def _leaves(tree):
    from ray_tpu_torch.train.step import param_leaves

    return [t.detach() for t in param_leaves(tree)]


def test_local_runtime_topology_equals_in_process_loop(small):
    from ray_tpu_torch.collective.collective import broadcast_pytree
    from ray_tpu_torch.rl.rlhf import RLHFTrainer

    rt = LocalRuntime()
    loc = RLHFTrainer(_cfg(small))
    act = RLHFTrainer(_cfg(small, num_rollout_workers=2,
                           remote_learner=True, runtime=rt,
                           worker_cls=_params_worker()))
    try:
        p0 = _leaves(small[1])
        for step in range(3):
            a, b = loc.step(), act.step()
            assert a["version"] == b["version"] == step + 1
            np.testing.assert_allclose(b["loss"], a["loss"], atol=1e-6)
            got = _leaves(rt.get(act.learner.get_params_numpy.remote(),
                                 timeout=T))
            for x, y in zip(got, _leaves(loc.learner.params)):
                torch.testing.assert_close(x, y, atol=1e-4, rtol=0)
            assert act.stats()["worker_versions"] == [step + 1] * 2
            assert b["epoch"] == 1 and b["rollout"]["rollout_tokens"] == \
                a["rollout"]["rollout_tokens"]
        assert max(float((x - y).abs().max())
                   for x, y in zip(got, p0)) > 1e-3
        # A packed round trip through the trainer's own group: the
        # driver joins a fresh group with one worker and gets its tree.
        rt.init_collective_group(2, 0, "rt")
        w = act.workers[0]
        rt.get(w.init_collective_group.remote(2, 1, "object_store", "rt"),
               timeout=T)
        tree = loc.learner.params_tree()
        recv = w.recv_weights.remote(9, "rt")
        assert broadcast_pytree(tree, 0, "rt", runtime=rt,
                                timeout=T) is tree
        assert rt.get(recv, timeout=T) == 9
        deadline = time.monotonic() + T
        while rt.get(w.stats.remote(), timeout=T)["weight_version"] != 9:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        got = _leaves(rt.get(w.engine_params.remote(), timeout=T))
        for x, y in zip(got, _leaves(tree)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    finally:
        loc.shutdown()
        act.shutdown()
        rt.shutdown()


def test_local_runtime_chaos_arms(small):
    from ray_tpu_torch.rl.rlhf import RLHFTrainer

    rt = LocalRuntime()
    tr = RLHFTrainer(_cfg(small, num_rollout_workers=2,
                          remote_learner=True, runtime=rt,
                          checkpoint_every=1,
                          checkpoint_dir=tempfile.mkdtemp()))
    try:
        tr.step()
        rt.arm("rl.rollout_step", "nth:1+crash", actor=tr.workers[0])
        m = tr.step()
        assert m["version"] == 2 and m["rollout_regens"] == 1
        assert tr.stats()["worker_versions"] == [2, 2]
        tr.step()
        newest = tr.flush_checkpoints()
        assert newest[0] == 3
        rt.arm("rl.weight_sync", "nth:1+crash", actor=tr.learner)
        m = tr.step()
        st = tr.stats()
        assert m["version"] == 4 and st["learner_restarts"] == 1
        assert st["version"] == 3 and st["epoch"] >= 2
        assert st["worker_versions"] == [3, 3]
        assert tr.step()["version"] == 4
        for w in tr.workers:
            assert rt.get(w.kv_check.remote(), timeout=T)["ok"]
    finally:
        tr.shutdown()
        rt.shutdown()
