"""Sharded training in the port against the JAX package's, on the CPU.

The mesh rules (`MeshConfig.resolve`, `logical_spec`) are compared with
the reference's in process.  Training runs in one spawned group of four
gloo ranks (a FileStore under the test's temporary directory, a timeout
on the group, every child joined with a deadline and killed on failure),
the `debug` preset in float32, batch 8 x 32 tokens from a numpy seed, the
reference test's optimizer (tests/test_train_step.py).  The ranks start
from the JAX `sharded_init` state (its host tree, or the TrainState
`train_state_from_jax` makes of it, laid out by `reshard_state`) on data
4, data 2 x fsdp 2, fsdp 4 and data 2 x tensor 2, while this process runs the JAX
`sharded_train_step` on the same layouts over `jax.devices()[:4]`:

- each rank's local shards equal JAX's addressable shard on the device
  at the same mesh position (data 2 x fsdp 2 and data 2 x tensor 2);
- three steps agree across layouts to rtol 2e-3 (the reference test's
  tolerance), and each layout's losses, pre-clip grad norms and final
  params agree with the JAX step on that layout to 1e-4 (params 5e-5 +
  1e-4 relative, as tests/test_torch_train.py explains);
- `sharded_init` gives bitwise `create_train_state`'s tensors on every
  layout, and a state taken under fsdp 4 and resharded onto data 2 x
  tensor 2 has bitwise the same full tensors and continues as the run
  that stayed on fsdp 4;
- what still raises: a stage mesh with seq or expert > 1, and the MoE
  family on a stage mesh (tests/test_torch_parallel_trunks.py holds the
  three axes themselves).

No test boots the ray_tpu runtime."""
import dataclasses
import datetime
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

WORLD = 4
JOIN_S = 300.0
LAYOUTS = {"data4": dict(data=4),
           "data2_fsdp2": dict(data=2, fsdp=2),
           "fsdp4": dict(data=1, fsdp=4),
           "data2_tensor2": dict(data=2, tensor=2)}
SHARD_LAYOUTS = ("data2_fsdp2", "data2_tensor2")
N_STEPS = 3
LOSS_TOL = dict(rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
OPT = dict(lr=1e-3, warmup=1, total_steps=100)


def _tokens():
    return np.random.default_rng(7).integers(0, 256, size=(8, 33)) \
        .astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ----------------------------------------------------------- mesh rules
@pytest.mark.parametrize("kw,n", [
    ({}, 8), ({"data": 2, "fsdp": 4}, 8), ({"data": -1, "tensor": 2}, 8),
    ({"data": 1, "fsdp": -1}, 4), ({"data": 2, "seq": 2, "stage": 2}, 8),
    ({"data": 3}, 8), ({"data": -1, "fsdp": -1}, 8), ({"data": -1,
                                                       "fsdp": 3}, 8),
    ({"data": 2, "expert": 2}, 4)])
def test_mesh_config_resolve_matches_jax(kw, n):
    from ray_tpu.parallel.mesh import MeshConfig as JaxConfig, \
        mesh_shape_for as jax_shape
    from ray_tpu_torch.parallel.mesh import AXES, MeshConfig, mesh_shape_for
    from ray_tpu.parallel.mesh import AXES as JAX_AXES

    assert AXES == JAX_AXES
    try:
        want = JaxConfig(**kw).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshConfig(**kw).resolve(n)
        assert str(got.value) == str(e)
        return
    assert MeshConfig(**kw).resolve(n) == want
    assert mesh_shape_for(n, MeshConfig(**kw)) == jax_shape(
        n, JaxConfig(**kw))


def _model_axes():
    """Every logical-axes tuple the model and the step use: the params',
    the trunk's constraints, the batch's, attention's."""
    from ray_tpu.models import llama as jl

    axes = {ax for _, ax in _leaves(
        jl.param_logical_axes(jl.llama_configs()["debug"]))}
    return sorted(axes | {("batch", "seq", None), ("batch", "seq", "mlp"),
                          ("batch", "seq", "vocab"), ("batch", "seq"),
                          ("batch", "seq", "heads", None),
                          ("embed", "embed"), ("batch", "batch", "seq")},
                  key=str)


@pytest.mark.parametrize("stage_rules", [False, True])
def test_logical_spec_matches_jax(stage_rules):
    from ray_tpu.parallel import sharding as js
    from ray_tpu_torch.parallel import sharding as ts

    assert ts.LOGICAL_RULES == js.LOGICAL_RULES
    rules = {**js.LOGICAL_RULES, "layers": "stage"} if stage_rules else None
    for ax in _model_axes():
        assert ts.logical_spec(ax, rules) == tuple(
            js.logical_spec(ax, rules)), ax


def test_create_mesh_needs_a_process_group():
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import create_mesh

    if dist.is_initialized():
        pytest.skip("this process already has a default process group")
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_mesh()


# --------------------------------------------------------- the gloo ranks
def _full_np(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().cpu().numpy().copy()      # not a view of the state


def _state_np(state):
    """Every leaf of a port TrainState as full numpy (collective)."""
    from ray_tpu_torch.train.step import param_leaves

    leaves = param_leaves(state.params)
    slots = [state.opt_state.state[p] for p in leaves]
    return {"params": [_full_np(p) for p in leaves],
            "mu": [_full_np(s["exp_avg"]) for s in slots],
            "nu": [_full_np(s["exp_avg_sq"]) for s in slots],
            "count": float(slots[0]["step"]), "step": state.step}


def _run_layout(cfg, opt, mesh, tree, tokens, on_step2=None):
    """reshard_state(tree) on `mesh`, then N_STEPS steps; the metrics, the
    local shards after resharding, the full params at the end, and the
    full state after two steps, which `on_step2` also gets.  `tree` is the
    host tree itself, or the TrainState train_state_from_jax makes of it."""
    from ray_tpu_torch.train import step as ts

    state = ts.reshard_state(tree, cfg, opt, mesh)
    out = {"shards": {}, "placements_match": True}
    for path, p in _leaves(state.params):
        out["shards"][path] = p.to_local().detach().numpy().copy()
        s = state.opt_state.state[p]
        out["placements_match"] &= (s["exp_avg"].placements == p.placements
                                    == s["exp_avg_sq"].placements)
    from torch.distributed.tensor import distribute_tensor

    b = ts.batch_shardings(mesh)
    out["shards"]["batch"] = distribute_tensor(
        torch.from_numpy(tokens), b.mesh, b.placements).to_local().numpy()
    step = ts.sharded_train_step(cfg, opt, mesh)
    out["metrics"] = []
    for i in range(N_STEPS):
        if i == 2 and on_step2 is not None:
            out["snapshot_np"] = _state_np(state)
            on_step2(state)
        state, m = step(state, {"tokens": tokens})
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    out["final"] = _state_np(state)
    return out


def _raised(fn):
    """fn()'s NotImplementedError message, or None if it did not raise."""
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def _rank_main(rank, store, tree_path, out_dir):
    """One gloo rank: every scenario in turn; results (or the traceback)
    pickled to out_dir/rank<r>.pkl, its output written to
    out_dir/rank<r>.log.  The test module imports no JAX at its top, so
    a rank loads torch and the port only, and runs on one thread."""
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    import torch.distributed as dist

    res = {}
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=WORLD,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.convert import train_state_from_jax
        from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
        from ray_tpu_torch.parallel.sharding import (logical_axis_size,
                                                     shard_params, tree_map,
                                                     with_sharding_constraint)
        from ray_tpu_torch.train import step as ts

        with open(tree_path, "rb") as f:
            tree, tokens = pickle.load(f)
        cfg = dataclasses.replace(llama.llama_configs()["debug"],
                                  dtype=torch.float32)
        opt = ts.default_optimizer(**OPT)
        single = ts.create_train_state(0, cfg, opt, device="cpu")
        meshes = {n: create_mesh(MeshConfig(**kw), "cpu")
                  for n, kw in LAYOUTS.items()}
        for name, mesh in meshes.items():
            init = ts.sharded_init(0, cfg, opt, mesh)
            res[f"init_equal/{name}"] = all(
                np.array_equal(_full_np(a), b.detach().numpy())
                for a, b in zip(ts.param_leaves(init.params),
                                ts.param_leaves(single.params)))
            del init
            def move(snap, cfg=cfg, opt=opt, tokens=tokens):
                # Taken under fsdp 4 after two steps; laid onto data 2 x
                # tensor 2 and stepped once.
                moved = ts.reshard_state(snap, cfg, opt,
                                         meshes["data2_tensor2"])
                res["resharded"] = _state_np(moved)
                _, m = ts.sharded_train_step(cfg, opt, meshes[
                    "data2_tensor2"])(moved, {"tokens": tokens})
                res["resharded_step"] = (float(m["loss"]),
                                         float(m["grad_norm"]))
                res["resharded_final"] = _state_np(moved)

            start = tree if name in SHARD_LAYOUTS else \
                train_state_from_jax(tree, cfg, opt, device="cpu")
            res[name] = _run_layout(cfg, opt, mesh, start, tokens,
                                    move if name == "fsdp4" else None)
        # Remat (flash_resid) under checkpoint on the DTensor trunk.
        remat = dataclasses.replace(cfg, remat=True)
        st = ts.reshard_state(tree, remat, opt, meshes["data2_fsdp2"])
        step = ts.sharded_train_step(remat, opt, meshes["data2_fsdp2"])
        res["remat"] = [tuple(float(v) for v in (m["loss"], m["grad_norm"]))
                        for _, m in (step(st, {"tokens": tokens})
                                     for _ in range(2))]
        mesh = meshes["data2_tensor2"]
        res["axis_sizes"] = {a: logical_axis_size(a, mesh)
                             for a in ("vocab", "batch", "embed", "layers")}
        laid = shard_params(tree_map(torch.Tensor.detach, single.params),
                            llama.param_logical_axes(cfg), mesh)
        init = ts.sharded_init(0, cfg, opt, mesh)
        res["shard_params_equal_sharded_init"] = all(
            a.placements == b.placements and torch.equal(a.to_local(),
                                                         b.to_local())
            for a, b in zip(ts.param_leaves(laid),
                            ts.param_leaves(init.params)))
        res["plain_passes"] = with_sharding_constraint(
            torch.ones(2), ("batch",)) is not None
        # What still raises, as in the reference: a stage mesh with seq or
        # expert > 1, and MoE (no pipelined trunk) on a stage mesh.  Every
        # other entry point takes those meshes.
        from ray_tpu_torch.models import moe

        moe_cfg = dataclasses.replace(moe.moe_configs()["moe-debug"],
                                      dtype=torch.float32)
        res["unported"] = {}
        for case, kw, c in (("seq", dict(data=1, stage=2, seq=2), cfg),
                            ("expert", dict(data=1, stage=2, expert=2), cfg),
                            ("stage", dict(data=2, stage=2), moe_cfg)):
            m = create_mesh(MeshConfig(**kw), "cpu")
            init = ts.sharded_init(0, c, opt, m)
            res["unported"][case] = [_raised(fn) for fn in (
                lambda: ts.state_shardings(c, m, opt),
                lambda: ts.sharded_init(0, c, opt, m),
                lambda: ts.reshard_state(init, c, opt, m),
                lambda: ts.sharded_train_step(c, opt, m)(
                    init, {"tokens": tokens % c.vocab_size}))]
    except BaseException:  # noqa: BLE001 - reported to the parent
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_tree(state):
    """A JAX TrainState as the host tree reshard_state takes."""
    import jax

    adam = state.opt_state[1][0]            # chain(clip, adamw)[1][0]
    return {"params": jax.tree.map(np.asarray, state.params),
            "mu": jax.tree.map(np.asarray, adam.mu),
            "nu": jax.tree.map(np.asarray, adam.nu),
            "count": np.asarray(adam.count), "step": np.asarray(state.step)}


def _jax_setup():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.train import step as js

    cfg = dataclasses.replace(jl.llama_configs()["debug"],
                              dtype=jnp.float32)
    meshes = {n: create_mesh(MeshConfig(**kw), devices=jax.devices()[:WORLD])
              for n, kw in LAYOUTS.items()}
    return js, cfg, js.default_optimizer(**OPT), meshes


def _jax_side(init, tokens):
    """The JAX sharded step on every layout over jax.devices()[:4], from
    the data-4 sharded_init state laid out by reshard_state."""
    import jax
    import jax.numpy as jnp

    js, cfg, opt, meshes = _jax_setup()
    host = jax.tree.map(np.asarray, init)

    def run(name):
        mesh = meshes[name]
        state = js.reshard_state(host, cfg, opt, mesh)
        flat = list(mesh.devices.flat)
        got = {"shards": {}}
        if name in SHARD_LAYOUTS:
            batch = jax.device_put(jnp.asarray(tokens),
                                   js.batch_shardings(mesh))
            for path, leaf in list(_leaves(state.params)) + [("batch",
                                                                 batch)]:
                by_dev = {s.device: np.array(s.data)
                          for s in leaf.addressable_shards}
                got["shards"][path] = [by_dev[d] for d in flat]
        fn = js.sharded_train_step(cfg, opt, mesh)
        got["metrics"] = []
        with jax.set_mesh(mesh):
            for _ in range(N_STEPS):
                state, m = fn(state, {"tokens": jnp.asarray(tokens)})
                got["metrics"].append((float(m["loss"]),
                                       float(m["grad_norm"])))
        got["final"] = [np.asarray(p) for _, p in _leaves(state.params)]
        return got

    return {name: run(name) for name in LAYOUTS}


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the JAX side, each rank's results): the ranks run while this
    process runs the JAX side."""
    import jax

    tmp = tmp_path_factory.mktemp("gloo")
    tokens = _tokens()
    js, cfg, opt, meshes = _jax_setup()
    init = js.sharded_init(jax.random.PRNGKey(0), cfg, opt, meshes["data4"])
    tree_path = tmp / "tree.pkl"
    with open(tree_path, "wb") as f:
        pickle.dump((_jax_tree(init), tokens), f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, str(tmp / "store"), str(tree_path),
                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = _jax_side(init, tokens)
        deadline = time.monotonic() + JOIN_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        ranks = []
        for r in range(WORLD):
            path = tmp / f"rank{r}.pkl"
            ranks.append(pickle.load(open(path, "rb")) if path.exists()
                         else {"error": "no result"})
    finally:
        _kill(procs)
    errors = {r: res["error"] for r, res in enumerate(ranks)
              if "error" in res}
    logs = {r: (tmp / f"rank{r}.log").read_text()[-2000:]
            for r in range(WORLD) if (tmp / f"rank{r}.log").exists()}
    assert not hung and not errors, (hung, errors, logs)
    assert [p.exitcode for p in procs] == [0] * WORLD
    return jax_out, ranks


@pytest.mark.parametrize("layout", SHARD_LAYOUTS)
def test_local_shards_match_jax_addressable_shards(world, layout):
    jax_out, ranks = world
    want = jax_out[layout]["shards"]
    assert set(want) == set(ranks[0][layout]["shards"])
    for r, res in enumerate(ranks):
        for path, shards in want.items():
            np.testing.assert_array_equal(
                res[layout]["shards"][path], shards[r],
                err_msg=f"rank {r} {path}")
        assert res[layout]["placements_match"]


def test_sharded_init_equals_create_train_state(world):
    _, ranks = world
    for res in ranks:
        assert all(res[f"init_equal/{n}"] for n in LAYOUTS)


def test_layouts_agree(world):
    _, ranks = world
    ref = ranks[0]["data4"]["metrics"]
    for name in LAYOUTS:
        for res in ranks:
            np.testing.assert_allclose(res[name]["metrics"], ref,
                                       rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_steps_match_jax(world, layout):
    jax_out, ranks = world
    want = jax_out[layout]
    got = ranks[0][layout]
    np.testing.assert_allclose(got["metrics"], want["metrics"], **LOSS_TOL)
    assert want["metrics"][1][1] > 1.0           # the clip engaged
    for g, w in zip(got["final"]["params"], want["final"]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   **PARAM_TOL)
    assert got["final"]["step"] == N_STEPS
    assert got["final"]["count"] == N_STEPS


def test_reshard_fsdp4_onto_data2_tensor2_continues(world):
    _, ranks = world
    for res in ranks:
        snap, moved = res["fsdp4"]["snapshot_np"], res["resharded"]
        for key in ("params", "mu", "nu"):
            for a, b in zip(snap[key], moved[key]):
                np.testing.assert_array_equal(a, b)
        assert (snap["count"], snap["step"]) == (moved["count"],
                                                 moved["step"]) == (2, 2)
        np.testing.assert_allclose(res["resharded_step"],
                                   res["fsdp4"]["metrics"][2], **LOSS_TOL)
        for a, b in zip(res["resharded_final"]["params"],
                        res["fsdp4"]["final"]["params"]):
            np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_remat_trunk_matches_plain_trunk(world):
    _, ranks = world
    for res in ranks:
        np.testing.assert_allclose(res["remat"],
                                   res["data2_fsdp2"]["metrics"][:2],
                                   rtol=1e-5)


def test_layout_helpers(world):
    _, ranks = world
    assert ranks[0]["axis_sizes"] == {"vocab": 2, "batch": 2, "embed": 1,
                                      "layers": 1}
    assert ranks[0]["plain_passes"]
    assert all(res["shard_params_equal_sharded_init"] for res in ranks)


STILL_RAISES = {
    "seq": "pipeline meshes compose with data/fsdp/tensor; axes ['seq'] > 1 "
           "are not supported inside the pipelined trunk yet",
    "expert": "pipeline meshes compose with data/fsdp/tensor; axes "
              "['expert'] > 1 are not supported inside the pipelined trunk "
              "yet",
    "stage": "ray_tpu_torch.models.moe has no pipelined trunk; pipeline "
             "meshes (stage>1) currently support the llama family"}


@pytest.mark.parametrize("axis", ["stage", "seq", "expert"])
def test_unported_axes_raise(world, axis):
    """What still raises, with the reference's messages: a stage mesh with
    seq ("seq") or expert ("expert") > 1, and the MoE family, which has no
    pipelined trunk, on a stage mesh ("stage").  state_shardings,
    sharded_init and reshard_state lay those meshes out; the error comes
    from sharded_train_step or its first step."""
    _, ranks = world
    for res in ranks:
        # state_shardings, sharded_init, reshard_state, the step
        msgs = res["unported"][axis]
        assert msgs == [None, None, None, STILL_RAISES[axis]]
