"""The port's trainer stack (ray_tpu_torch/train/backend.py,
train/session.py `host_broadcast`, data/iterator.py
`iter_device_batches`, api.py `get_gpu_ids`) on the CPU.

The trainer run boots the ray_tpu runtime once for the module and drives
the reference's own `DataParallelTrainer` with the port's
`ProcessGroupBackend` on two CPU train workers: gloo, a `file://` store
under the test's temporary directory (no port test takes a TCP port), a
60 s group timeout, and the seam's binding to the runtime
(tests/torch_ray_runtime.py, a timeout on every wait), which lives with
the tests, as the runtime seam requires.  Each rank
builds its state from its own seed; `host_broadcast` must give every rank
rank 0's; batches come through `iter_device_batches(device="cpu")` from a
seeded numpy iterator (no runtime Dataset: its streaming executor is one
of ROADMAP queue 3's stallers); two `sharded_train_step`s run on a data=2
mesh of the `debug` preset in f32.  Both ranks' first loss and grad norm,
and the second loss, must be within 1e-4 of the single-device
`make_train_step` on the whole batch in this process (which
tests/test_torch_train.py holds to the JAX step).  The fit runs on a
thread joined with a deadline.

Without the runtime: `host_broadcast` at world size 1 copies,
`iter_device_batches` keeps order and casts, the backend re-forms its
group at an epoch change through an in-process worker group, and
`get_gpu_ids` answers [] with the device-worker gate off."""
import dataclasses
import threading

import numpy as np
import pytest
import torch

TOL = 1e-4
OPT = dict(lr=1e-3, warmup=1, total_steps=100)
FIT_DEADLINE_S = 240.0


def _cfg():
    from ray_tpu_torch.models import llama

    return dataclasses.replace(llama.llama_configs()["debug"],
                               dtype=torch.float32)


def _batches(seed: int = 7, n: int = 2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"tokens": rng.integers(0, 256, size=(8, 33)).astype(np.int32)}


@pytest.fixture(scope="module")
def rt():
    """The runtime for this module; shut down after it if it booted here,
    so no later test file on the same worker finds it running."""
    import ray_tpu

    started = not ray_tpu.is_initialized()
    if started:
        ray_tpu.init(resources={"CPU": 4})
    yield ray_tpu
    if started:
        ray_tpu.shutdown()


def _train_loop(config):
    """One rank (runs in a train worker; imports inside, pickled by
    value)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu.train import report
    from ray_tpu_torch.data.iterator import iter_device_batches
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import tree_map
    from ray_tpu_torch.train.session import host_broadcast
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, param_leaves,
                                          reshard_state, sharded_train_step)

    torch.set_num_threads(1)
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    opt = default_optimizer(**config["opt"])
    own = create_train_state(rank, cfg, opt, device="cpu")
    params = host_broadcast(tree_map(torch.Tensor.detach, own.params))
    seed0 = create_train_state(0, cfg, opt, device="cpu").params
    equal0 = all(torch.equal(a, b) for a, b in zip(
        param_leaves(params), param_leaves(seed0)))
    own_equal0 = all(torch.equal(a, b) for a, b in zip(
        param_leaves(own.params), param_leaves(seed0)))
    # Leaves of every kind, packed per dtype: rank 0's values everywhere.
    mixed = host_broadcast({"bf16": torch.full((3,), rank + 0.5,
                                               dtype=torch.bfloat16),
                            "int": [torch.arange(4) + rank, None],
                            "np": np.full((2, 2), rank, np.float32),
                            "step": rank})
    mixed_ok = (torch.equal(mixed["bf16"], torch.full(
                    (3,), 0.5, dtype=torch.bfloat16))
                and torch.equal(mixed["int"][0], torch.arange(4))
                and mixed["int"][1] is None
                and isinstance(mixed["np"], np.ndarray)
                and not mixed["np"].any() and int(mixed["step"]) == 0)
    mesh = create_mesh(MeshConfig(data=world), device_type="cpu")
    state = reshard_state(
        create_train_state(0, cfg, opt, device="cpu", params=params),
        cfg, opt, mesh)
    step = sharded_train_step(cfg, opt, mesh)

    def batches():
        rng = np.random.default_rng(config["seed"])
        for _ in range(config["steps"]):
            yield {"tokens": rng.integers(0, 256, size=(8, 33)).astype(
                np.int32)}

    metrics = []
    for batch in iter_device_batches(batches(), device="cpu",
                                     dtypes={"tokens": np.int64}):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    mine = {"rank": rank, "world": world, "metrics": metrics,
            "broadcast_is_rank0s": equal0, "own_is_rank0s": own_equal0,
            "mixed_is_rank0s": mixed_ok,
            "backend": dist.get_backend()}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    report({"ranks": ranks})


def test_trainer_backend_broadcast_and_feed_match_the_single_device_step(
        rt, tmp_path):
    from ray_tpu.train import FailureConfig, RunConfig, ScalingConfig
    from ray_tpu.train.trainer import DataParallelTrainer
    from torch_ray_runtime import RayTpuRuntime

    from ray_tpu_torch.train.backend import ProcessGroupBackend
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    store = f"file://{tmp_path}/store"

    class Backend(ProcessGroupBackend):
        def __init__(self):
            super().__init__(device="cpu", init_method=store,
                             runtime=RayTpuRuntime(), timeout_s=60.0)

    class PortTrainer(DataParallelTrainer):
        _backend_cls = Backend

    trainer = PortTrainer(
        _train_loop,
        train_loop_config={"opt": OPT, "seed": 7, "steps": 2},
        scaling_config=ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(name="port_trainer",
                             storage_path=str(tmp_path / "results"),
                             failure_config=FailureConfig(max_failures=0)))
    box = {}
    fit = threading.Thread(target=lambda: box.setdefault(
        "result", trainer.fit()), daemon=True)
    fit.start()
    fit.join(FIT_DEADLINE_S)
    assert not fit.is_alive(), f"fit() still running after {FIT_DEADLINE_S}s"
    result = box["result"]
    assert result.error is None, result.error
    ranks = result.metrics["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in ranks)
    assert all(r["broadcast_is_rank0s"] and r["mixed_is_rank0s"]
               for r in ranks)
    assert [r["own_is_rank0s"] for r in ranks] == [True, False]

    cfg, opt = _cfg(), default_optimizer(**OPT)
    state = create_train_state(0, cfg, opt, device="cpu")
    step = make_train_step(cfg, opt, device="cpu")
    want = []
    for batch in _batches():
        state, m = step(state, {"tokens": batch["tokens"].astype(np.int64)})
        want.append((float(m["loss"]), float(m["grad_norm"])))
    for r in ranks:
        (loss0, norm0), (loss1, _) = r["metrics"]
        np.testing.assert_allclose([loss0, norm0, loss1],
                                   [want[0][0], want[0][1], want[1][0]],
                                   rtol=TOL, err_msg=f"rank {r['rank']}")


# ------------------------------------------------------- without runtime
def test_host_broadcast_at_world_size_one_is_a_copy():
    import torch.distributed as dist

    from ray_tpu_torch.train.session import host_broadcast

    if dist.is_initialized():
        pytest.skip("this process already has a default process group")
    int64 = torch.zeros(2, dtype=torch.int64)
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "layers": [np.ones(3, np.float32), (int64, None)], "step": 5}
    out = host_broadcast(tree)
    assert out["w"] is not tree["w"] and torch.equal(out["w"], tree["w"])
    assert out["w"].data_ptr() != tree["w"].data_ptr()
    assert isinstance(out["layers"], list)
    assert isinstance(out["layers"][1], tuple)
    assert out["layers"][1][1] is None
    arr = out["layers"][0]
    assert isinstance(arr, np.ndarray) and not np.shares_memory(
        arr, tree["layers"][0])
    assert isinstance(out["step"], np.ndarray) and out["step"] == 5
    out["w"].add_(1)
    assert tree["w"][0, 0] == 0


def test_host_broadcast_over_a_group_of_one_and_epoch_reform(tmp_path):
    """The backend through an in-process worker group: on_start forms a
    gloo group of one, host_broadcast over it returns copies of every kind
    of leaf, on_epoch_start re-forms the group on a fresh store,
    on_shutdown leaves it."""
    import torch.distributed as dist

    from ray_tpu_torch.train.backend import (LocalWorkerGroup,
                                             ProcessGroupBackend)
    from ray_tpu_torch.train.session import host_broadcast

    if dist.is_initialized():
        pytest.skip("this process already has a default process group")
    group = LocalWorkerGroup()
    backend = ProcessGroupBackend(device="cpu",
                                  init_method=f"file://{tmp_path}/store",
                                  timeout_s=30.0)
    try:
        backend.on_start(group)
        assert dist.is_initialized() and dist.get_world_size() == 1
        first = dist.group.WORLD
        tree = {"a": torch.randn(3, 4, dtype=torch.bfloat16),
                "b": torch.randn(5), "c": torch.arange(4),
                "d": np.full((2, 2), 3.0, np.float32)}
        out = host_broadcast(tree)
        for k in ("a", "b", "c"):
            assert out[k].dtype == tree[k].dtype
            assert torch.equal(out[k], tree[k]) and out[k] is not tree[k]
        np.testing.assert_array_equal(out["d"], tree["d"])
        backend.on_epoch_start(group.workers, epoch=1)
        assert dist.is_initialized() and dist.group.WORLD is not first
        assert backend.formations == 2
        t = torch.ones(3)
        dist.all_reduce(t)
        assert torch.equal(t, torch.ones(3))
    finally:
        backend.on_shutdown(group)
    assert not dist.is_initialized()


def test_iter_device_batches_keeps_order_and_casts():
    from ray_tpu_torch.data.iterator import iter_device_batches

    src = [{"x": np.full((2, 3), i, np.float64), "y": np.arange(4) + i}
           for i in range(5)]
    out = list(iter_device_batches(iter(src), device="cpu",
                                   dtypes={"x": np.float32,
                                           "y": torch.int32}))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b["x"].dtype == torch.float32 and b["y"].dtype == torch.int32
        assert b["x"].device.type == "cpu" and not b["x"].is_pinned()
        np.testing.assert_array_equal(b["x"].numpy(), src[i]["x"])
        np.testing.assert_array_equal(b["y"].numpy(), src[i]["y"])
    same = next(iter_device_batches(iter(src[:1]), device="cpu"))
    assert same["x"].dtype == torch.float64
    with pytest.raises(ValueError, match="prefetch"):
        next(iter_device_batches(iter(src), device="cpu", prefetch=0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(iter_device_batches(iter(src)))


def test_get_gpu_ids_follows_the_device_worker_gate(monkeypatch):
    from ray_tpu_torch.api import get_gpu_ids

    monkeypatch.delenv("RAY_TPU_TORCH_IS_DEVICE_WORKER", raising=False)
    assert get_gpu_ids() == []
    monkeypatch.setenv("RAY_TPU_TORCH_IS_DEVICE_WORKER", "1")
    want = list(range(torch.cuda.device_count())) \
        if torch.cuda.is_available() else []
    assert get_gpu_ids() == want


def test_backend_rendezvous_and_local_ranks():
    from ray_tpu_torch.train.backend import (Backend, BackendConfig,
                                             LocalWorker, ProcessGroupBackend,
                                             local_ranks)

    assert local_ranks(["a", "b", "a", "a", "b"]) == (
        [0, 0, 1, 2, 1], [3, 2, 3, 3, 2])
    assert BackendConfig().backend_cls is Backend
    tcp = ProcessGroupBackend(device="cpu")
    addr = tcp._rendezvous(LocalWorker())
    assert addr.startswith("tcp://") and int(addr.rsplit(":", 1)[1]) > 0
    fixed = ProcessGroupBackend(device="cpu", init_method="env://")
    assert [fixed._rendezvous(None) for _ in range(2)] == ["env://"] * 2
    assert ProcessGroupBackend().device_type == "cuda"
