"""Collectives over the object plane on the port's runtime
(ray_tpu_torch/collective), on the CPU.

One cluster of the port (`ray_tpu_torch.init(resources={"CPU": 4,
"GPU": 1})`) boots for the module and is shut down after it.  Every get,
wait and collective has a deadline of 60 s or less; the exchange-deadline
test sets the group's timeout to 3 s.

The scenarios of tests/test_collective_ring.py (less its three-node test
and its legacy gather path, which the port does not have), on torch
tensors: the ring and the tree (chosen by tensor sizes on each side of
`ring.RING_MIN_BYTES`) equal numpy's
reduction for sum, min and max on integer-valued data in f32, f64, int32
and bf16 with the dtype kept; reducescatter, allgather, broadcast and
send/recv; async ordering across two concurrent groups; the tracer's sent
bytes equal to 2*N*(world-1)/world; an exchange deadline that names the
missing rank; destroy from the driver.  Besides: two members of one group
in the device worker keep their own ranks and sequence numbers, a thread
one of them starts is taken for neither, and a
`broadcast_pytree` through `ClusterRuntime` packs a JAX tree's leaves in
`tree_flatten` order."""
import time
import uuid

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import collective as col
from ray_tpu_torch.collective import collective as col_impl
from ray_tpu_torch.collective import ring as col_ring

T = 60.0
DTYPES = [torch.float32, torch.float64, torch.int32, torch.bfloat16]


def _elems(path: str, dtype: torch.dtype, base: int) -> int:
    """An element count whose tensor takes `path`: `base` elements (under
    the ring threshold) for the tree, `base` more than the threshold
    holds for the ring."""
    n = base if path == "tree" else \
        col_ring.RING_MIN_BYTES // torch.empty(0, dtype=dtype).itemsize + base
    nbytes = n * torch.empty(0, dtype=dtype).itemsize
    assert col_impl._pick_schedule(nbytes) == path
    return n


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def members(cluster):
    """Three members in plain workers, ranks 0-2 of group "main", built
    once for the module (each is a process of its own)."""
    member = cluster.remote(_member_cls())
    ws = [member.options(num_cpus=0.5).remote() for _ in range(3)]
    col.create_collective_group(ws, 3, [0, 1, 2], group_name="main",
                                timeout=T)
    yield ws
    _cleanup(cluster, ws, "main")


def _member_cls():
    """A group member, shipped by value (defined in a function)."""
    class Member:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name, timeout_s=30.0):
            from ray_tpu_torch import collective as c

            c.init_collective_group(world_size, rank, backend, group_name,
                                    timeout_s=timeout_s)
            self.rank = rank
            return rank

        def run(self, fn, *args, **kw):
            """collective.<fn>(*args, **kw)."""
            from ray_tpu_torch import collective as c

            return getattr(c, fn)(*args, **kw)

        def traced_allreduce(self, group, x):
            from ray_tpu_torch import collective as c
            from ray_tpu_torch import profiling

            with profiling.collective_trace() as rec:
                out = c.allreduce(x, group_name=group)
            return out, profiling.collective_breakdown_us(rec)

        def async_burst(self, groups, n_ops):
            """Interleaved async allreduces over several groups: op i
            carries (i+1)*(rank+1), so each result names its op."""
            from ray_tpu_torch import collective as c

            works = {g: [c.allreduce_async(
                torch.full((256,), float(i + 1) * (self.rank + 1)),
                group_name=g) for i in range(n_ops)] for g in groups}
            return {g: [float(w.wait(60.0)[0]) for w in ws]
                    for g, ws in works.items()}

        def fails(self, fn, *args, **kw):
            """repr of what `run(fn, ...)` raised, None if it did not."""
            try:
                self.run(fn, *args, **kw)
                return None
            except Exception as e:  # noqa: BLE001
                return repr(e)

        def where(self, group):
            """(pid, actor id, rank, seq) of this member in `group`."""
            import os as _os

            from ray_tpu_torch.collective import collective as c
            from ray_tpu_torch.runtime_context import get_runtime_context

            me = get_runtime_context().get_actor_id()
            g = c._registry.get((group, me))
            return (_os.getpid(), me, c.get_rank(group),
                    None if g is None else g.seq)

        def from_own_thread(self, group, reduce):
            """(actor id, rank in `group`, what an allreduce raised when
            `reduce`) as seen from a thread this actor starts itself."""
            import threading

            from ray_tpu_torch import collective as c
            from ray_tpu_torch.runtime_context import get_runtime_context

            out = []

            def probe():
                err = None
                try:
                    if reduce:
                        c.allreduce(torch.ones(2), group_name=group)
                except Exception as e:  # noqa: BLE001
                    err = repr(e)
                out.append((get_runtime_context().get_actor_id(),
                            c.get_rank(group), err))

            t = threading.Thread(target=probe)
            t.start()
            t.join(30.0)
            return out[0]

    return Member


def _cleanup(cluster, ws, *names):
    for w in ws:
        cluster.kill(w)
    for name in names:
        col.destroy_collective_group(name)


def _reduce(arrs, op):
    stack = np.stack([a.double().numpy() for a in arrs])
    return {"sum": stack.sum(0), "min": stack.min(0),
            "max": stack.max(0)}[op]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ring_and_tree_equal_numpy_reduction(cluster, members, dtype):
    """Integer-valued data: exact under any reduction order, so the ring
    and the tree equal numpy's reduction bit for bit, in the input's
    dtype."""
    for op in ("sum", "min", "max"):
        for path in ("ring", "tree"):
            n = _elems(path, dtype, 777)
            arrs = [(torch.arange(n) % 5 + r + 1).to(dtype)
                    for r in range(3)]
            want = _reduce(arrs, op)
            outs = cluster.get(
                [w.run.remote("allreduce", arrs[r],
                              group_name="main", op=op)
                 for r, w in enumerate(members)], timeout=T)
            for o in outs:
                assert isinstance(o, torch.Tensor), path
                assert o.dtype == dtype, (path, o.dtype)
                np.testing.assert_array_equal(
                    o.double().numpy(), want,
                    err_msg=f"{dtype} {op} {path}")
    # numpy in, numpy out.
    outs = cluster.get(
        [w.run.remote("allreduce",
                      np.full(_elems("ring", torch.float32, 100), r + 1,
                              np.float32), group_name="main")
         for r, w in enumerate(members)], timeout=T)
    assert all(isinstance(o, np.ndarray) and o.dtype == np.float32
               and (o == 6).all() for o in outs)


def test_reducescatter_allgather_broadcast_send_recv(cluster, members):
    ws = members
    for path in ("ring", "tree"):
        x = torch.arange(_elems(path, torch.float64, 10),
                         dtype=torch.float64)
        want = torch.tensor_split(3 * x, 3)
        rs = cluster.get([w.run.remote("reducescatter", x,
                                       group_name="main") for w in ws],
                         timeout=T)
        for r in range(3):
            assert torch.equal(rs[r], want[r]), (path, r)
        n = _elems(path, torch.float32, 300)
        ag = cluster.get(
            [w.run.remote("allgather", torch.full((n,), float(r)),
                          group_name="main")
             for r, w in enumerate(ws)], timeout=T)
        for per in ag:
            assert [int(p[0]) for p in per] == [0, 1, 2], path
            assert [int(p[-1]) for p in per] == [0, 1, 2], path
        for src in (0, 2):
            # bf16 by ref above the ring threshold, inline below it;
            # receivers learn dtype and shape from the message.
            side = 64 if path == "tree" else 512
            big = torch.arange(side * side).reshape(side, side).to(
                torch.bfloat16)
            assert col_impl._pick_schedule(big.nbytes) == path
            bc = cluster.get(
                [w.run.remote("broadcast", big if r == src else None,
                              src_rank=src, group_name="main")
                 for r, w in enumerate(ws)], timeout=T)
            assert all(b.dtype == torch.bfloat16 and torch.equal(b, big)
                       for b in bc), (path, src)
    sent = cluster.get([
        ws[0].run.remote("send", np.arange(5), 2, group_name="main"),
        ws[2].run.remote("recv", 0, group_name="main")],
        timeout=T)
    assert sent[0] is None and sent[1].tolist() == [0, 1, 2, 3, 4]
    assert cluster.get(ws[1].run.remote(
        "get_collective_group_size", "main"), timeout=T) == 3


def test_async_ordering_concurrent_groups(cluster, members):
    """Async ops run in submission (seq) order per group, and two groups
    over the same actors do not cross-talk."""
    ws = members[:2]
    col.create_collective_group(ws, 2, [0, 1], group_name="ga", timeout=T)
    col.create_collective_group(ws, 2, [0, 1], group_name="gb", timeout=T)
    try:
        res = cluster.get([w.async_burst.remote(["ga", "gb"], 5)
                           for w in ws], timeout=T)
        want = [float((i + 1) * 3) for i in range(5)]
        for per_rank in res:
            assert per_rank == {"ga": want, "gb": want}
    finally:
        _cleanup(cluster, [], "ga", "gb")


def test_tracer_byte_schedule(cluster, members):
    """The ring moves 2*N*(world-1)/world bytes per rank, in 4 hops at
    world 3 (two reduce-scatter and two allgather swaps)."""
    x = torch.ones(3 << 16)                    # 768 KiB
    n = x.nbytes
    outs = cluster.get([w.traced_allreduce.remote("main", x)
                        for w in members], timeout=T)
    for out, br in outs:
        assert float(out[0]) == 3.0
        assert br["schedule"] == "ring" and br["world"] == 3
        assert br["sent_bytes"] == 2 * n * 2 // 3, br
        assert br["recv_bytes"] == 2 * n * 2 // 3, br
        assert br["hops"] == 4, br


def test_exchange_deadline_names_missing_rank(cluster, members):
    """A rank whose peer never arrives gets an error naming the missing
    rank within the group's deadline (3 s here), not a hang."""
    w = members[0]
    try:
        assert cluster.get(w.init_collective_group.remote(
            2, 0, "object_store", "lone", timeout_s=3.0), timeout=T) == 0
        t0 = time.monotonic()
        err = cluster.get(w.fails.remote("barrier", "lone"), timeout=T)
        assert err is not None and "missing ranks [1]" in err, err
        err = cluster.get(w.fails.remote(
            "allreduce", torch.ones(_elems("ring", torch.float32, 0)),
            group_name="lone"), timeout=T)
        assert err is not None and "timed out" in err, err
        assert time.monotonic() - t0 < 30.0
    finally:
        _cleanup(cluster, [], "lone")


def test_destroy_from_driver(cluster, members):
    """The driver, whose registry never saw the group, drains and kills
    the detached rendezvous actor."""
    ws = members[1:]
    col.create_collective_group(ws, 2, [0, 1], group_name="dstr",
                                timeout=T)
    cluster.get([w.run.remote("allreduce", torch.ones(4),
                              group_name="dstr") for w in ws], timeout=T)
    assert cluster.get_actor("collective_rdv:dstr") is not None
    col.destroy_collective_group("dstr")
    with pytest.raises(Exception):
        cluster.get_actor("collective_rdv:dstr")


def test_two_members_in_the_device_worker_keep_their_ranks(cluster,
                                                           members):
    """Two "GPU" actors share the device worker's process; as members of
    one group (with a third in a plain worker) each keeps its own rank
    and sequence numbers, and their collectives are right."""
    member = cluster.remote(_member_cls())
    gpu = [member.options(num_cpus=0, num_gpus=0.25).remote()
           for _ in range(2)]
    ws = [gpu[0], members[1], gpu[1]]
    name = "devw"
    col.create_collective_group(ws, 3, [0, 1, 2], group_name=name,
                                timeout=T)
    try:
        for i in range(3):
            n = _elems("ring" if i % 2 else "tree", torch.float32, 4096)
            outs = cluster.get(
                [w.run.remote("allreduce", torch.full((n,), float(r + 1)),
                              group_name=name)
                 for r, w in enumerate(ws)], timeout=T)
            assert all(float(o.min()) == float(o.max()) == 6.0
                       for o in outs)
        where = cluster.get([w.where.remote(name) for w in ws], timeout=T)
        pids = [p for p, *_ in where]
        assert pids[0] == pids[2] != pids[1]
        assert where[0][1] != where[2][1]                # two actors
        assert [r for _, _, r, _ in where] == [0, 1, 2]
        assert [s for *_, s in where] == [3, 3, 3]
        bc = cluster.get([w.run.remote("broadcast",
                                       torch.arange(6) if r == 2 else None,
                                       src_rank=2, group_name=name)
                          for r, w in enumerate(ws)], timeout=T)
        assert all(b.tolist() == list(range(6)) for b in bc)
        assert [s for *_, s in cluster.get(
            [w.where.remote(name) for w in ws], timeout=T)] == [4, 4, 4]
    finally:
        _cleanup(cluster, gpu, name)


def test_broadcast_pytree_through_cluster_runtime_packs_jax_leaves(
        cluster):
    """The driver (rank 0) broadcasts a tree through ClusterRuntime's
    collective face to an actor (rank 1); the bytes the actor receives
    are a JAX tree's leaves in tree_flatten order, f32 and bf16."""
    import jax
    import jax.numpy as jnp

    from ray_tpu_torch.collective.collective import broadcast_pytree, pack
    from ray_tpu_torch.serve.runtime import ClusterRuntime
    from ray_tpu_torch.train.session import flatten

    rng = np.random.default_rng(0)
    jtree = {"b": {"z": jnp.asarray(rng.standard_normal((3, 5)),
                                    jnp.bfloat16),
                   "a": jnp.asarray(rng.standard_normal(7), jnp.float32)},
             "a": [jnp.asarray(rng.standard_normal((2, 2)), jnp.float32),
                   jnp.asarray(rng.standard_normal(4), jnp.bfloat16)]}
    want = np.concatenate([np.asarray(x).reshape(-1).view(np.uint8)
                           for x in jax.tree_util.tree_leaves(jtree)])

    def as_torch(x):
        x = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())

    tree = jax.tree.map(as_torch, jtree)

    class Receiver:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name):
            from ray_tpu_torch.serve.runtime import ClusterRuntime as CR

            CR().init_collective_group(world_size, rank, group_name)

        def receive(self, template, group_name):
            from ray_tpu_torch.collective.collective import (
                broadcast_pytree as bp, pack as pk)
            from ray_tpu_torch.serve.runtime import ClusterRuntime as CR
            from ray_tpu_torch.train.session import flatten as fl

            got = bp(template, 0, group_name, runtime=CR(), timeout=60.0)
            leaves: list = []
            fl(got, leaves)
            return pk(leaves)

    rt = ClusterRuntime()
    name = f"bpt:{uuid.uuid4().hex[:6]}"
    recv = cluster.remote(Receiver).options(num_cpus=0.5).remote()
    try:
        rt.init_collective_group(2, 0, name)
        cluster.get(recv.init_collective_group.remote(2, 1, "object_store",
                                                      name), timeout=T)
        assert rt.get_rank(name) == 0
        template = jax.tree.map(
            lambda t: torch.empty(t.shape, dtype=t.dtype), tree)
        ref = recv.receive.remote(template, name)
        assert broadcast_pytree(tree, 0, name, runtime=rt,
                                timeout=T) is tree
        got = cluster.get(ref, timeout=T)
        leaves: list = []
        flatten(tree, leaves)
        assert pack(leaves).tobytes() == want.tobytes()
        assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    finally:
        cluster.kill(recv)
        rt.destroy_collective_group(name, reason="test done")


def test_thread_of_a_device_worker_actor_is_taken_for_no_member(
        cluster, members):
    """A thread that an actor starts itself cannot be told apart from the
    other actors' in the device worker: it is no actor's there, so a
    collective from it raises instead of using another member's rank.  In
    a plain worker, which hosts one actor, it is that actor's, as in the
    reference."""
    member = cluster.remote(_member_cls())
    gpu = [member.options(num_cpus=0, num_gpus=0.25).remote()
           for _ in range(2)]
    ws = [gpu[0], gpu[1], members[1]]
    name = "thr"
    col.create_collective_group(ws, 3, [0, 1, 2], group_name=name,
                                timeout=T)
    try:
        where = cluster.get([w.where.remote(name) for w in ws], timeout=T)
        assert where[0][0] == where[1][0] != where[2][0]
        for w in gpu:
            me, rank, err = cluster.get(
                w.from_own_thread.remote(name, True), timeout=T)
            assert (me, rank) == (None, -1)
            assert err is not None and "not initialized" in err, err
        me, rank, _ = cluster.get(
            members[1].from_own_thread.remote("main", False), timeout=T)
        assert (me, rank) == (where[2][1], 1)
    finally:
        _cleanup(cluster, gpu, name)


def test_schedule_threshold_and_pipeline_constants():
    """The schedule is picked from the tensor's size against one constant
    threshold, so every member of a group picks the same; a ring hop is
    split into at most PIPELINE_CHUNKS sub-chunks of at least
    PIPELINE_MIN_BYTES."""
    from ray_tpu_torch.serve.runtime import COLLECTIVE_TIMEOUT_S

    lo = col_ring.RING_MIN_BYTES
    assert (col_impl._pick_schedule(lo - 1), col_impl._pick_schedule(lo),
            col_impl._pick_schedule(1 << 30)) == ("tree", "ring", "ring")
    assert col_ring._bcast_by_ref(lo) and not col_ring._bcast_by_ref(lo - 1)
    mb = col_ring.PIPELINE_MIN_BYTES
    for nbytes, parts in ((0, 1), (100, 1), (mb * 3 // 2, 1),
                          (2 * mb, 2), (64 * mb, col_ring.PIPELINE_CHUNKS)):
        subs = col_ring._split_subchunks(
            torch.zeros(nbytes, dtype=torch.uint8))
        assert len(subs) == parts, nbytes
        assert sum(s.numel() for s in subs) == nbytes
    assert COLLECTIVE_TIMEOUT_S == 120.0
