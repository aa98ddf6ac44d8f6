"""The expert, sequence (ring attention) and stage (pipeline) mesh axes of
the port against the JAX package's, on the CPU.

One spawned group of four gloo ranks for the module (a FileStore under
the test's temporary directory, a timeout on the group, every child
joined with a deadline and killed on failure, one thread each, no JAX in
the children, their output in files), while this process runs the JAX
side on the same layouts over `jax.devices()[:4]`.  Every scenario starts
from the same JAX-made parameters or `sharded_init` state:

- expert 2 x data 2: the `moe-debug` step (f32) against the JAX sharded
  step, three steps to 1e-4; each rank's expert shards equal JAX's
  addressable shards; the sharded step equals the port's unsharded one
  (expert parallel == replicated);
- seq 2 x data 2: `ring_attention_gspmd` and its gradients against the
  reference's to 1e-5, and plain `attention` on the split sequence (it
  gathers) against the same output; the `debug` step with `use_ring_attention`
  against the JAX sharded step and against the unsharded step to 1e-4;
- stage 4: `pipeline_apply` (params from `stack_stage_params`, laid out
  by `stage_sharding`) and its gradients against the stages run in
  sequence, to 1e-5;
- stage 2 x data 2 and stage 2 x fsdp 2: `pipelined_loss_fn` and its
  gradients against the reference's on the same layout to 1e-4 (the
  reference test's model and batch), and three pipelined steps on stage
  2 x data 2 against the JAX sharded step;
- the reference's rejections (stage with seq, stage with expert, MoE on
  a stage mesh) with the reference's messages.

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
JOIN_S = 240.0
N_STEPS = 3
RING_TOL = dict(rtol=1e-5, atol=1e-5)
# As in tests/test_torch_sharded.py: Adam's first normalised steps magnify
# summation-order noise of gradient elements near zero.
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
OPT = dict(lr=1e-3, warmup=1, total_steps=100)
LAYOUTS = {"moe": dict(data=2, expert=2),
           "ring": dict(data=2, seq=2),
           "pipe4": dict(data=1, stage=4),
           "pp_data": dict(stage=2, data=2),
           "pp_fsdp": dict(data=1, stage=2, fsdp=2),
           "stage_seq": dict(data=1, stage=2, seq=2),
           "stage_expert": dict(data=1, stage=2, expert=2)}
PP_MESHES = ("pp_data", "pp_fsdp")
REJECTIONS = ("stage_seq", "stage_expert", "moe_stage")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _pp_cfg(llama, dtype):
    """The reference test's pipelined model (tests/test_moe_pipeline.py)."""
    return llama.LlamaConfig(vocab_size=128, dim=64, n_layers=4, n_heads=4,
                             n_kv_heads=2, ffn_dim=128, max_seq=32,
                             remat=False, dtype=dtype)


def _inputs():
    rng = np.random.default_rng(11)
    ring = rng.integers(0, 256, size=(8, 33))
    return {
        "moe_batch": {"tokens": rng.integers(0, 2048, size=(8, 33))},
        # inputs / targets of 32: the sequence splits evenly over seq 2
        "ring_batch": {"inputs": ring[:, :-1].copy(),
                       "targets": ring[:, 1:].copy()},
        "pp_batch": {"tokens": rng.integers(0, 128, size=(8, 33))},
        # q, k, v, and the output's cotangent for the ring attention op
        "qkvg": [rng.normal(size=s).astype(np.float32) for s in
                 ((2, 16, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32),
                  (2, 16, 4, 32))],
        # pipeline_apply: 4 stages of tanh(x @ w + b) on [8, 4, 16]
        "pipe": (rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.3,
                 rng.normal(size=(4, 16)).astype(np.float32) * 0.1,
                 rng.normal(size=(8, 4, 16)).astype(np.float32)),
    }


# --------------------------------------------------------- the gloo ranks
def _full_np(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().cpu().numpy().copy()      # not a view of the state


def _steps(ts, step, state, batch):
    metrics = []
    for _ in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, [_full_np(p) for p in ts.param_leaves(state.params)]


def _raised(fn):
    """fn()'s NotImplementedError message, or None if it did not raise."""
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return None


def _rank_main(rank, store, in_path, out_dir):
    """One gloo rank: every scenario in turn; results (or the traceback)
    pickled to out_dir/rank<r>.pkl, its output written to
    out_dir/rank<r>.log.  The module imports no JAX at its top."""
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
        from torch.distributed.tensor import Shard, distribute_tensor

        from ray_tpu_torch.models import llama, moe
        from ray_tpu_torch.models.convert import (params_from_jax,
                                                  train_state_from_jax)
        from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
        from ray_tpu_torch.ops.attention import attention
        from ray_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                     stack_stage_params,
                                                     stage_sharding)
        from ray_tpu_torch.parallel.ring import ring_attention_gspmd
        from ray_tpu_torch.parallel.sharding import shard_params, tree_map
        from ray_tpu_torch.train import step as ts

        with open(in_path, "rb") as f:
            inp = pickle.load(f)
        meshes = {n: create_mesh(MeshConfig(**kw), "cpu")
                  for n, kw in LAYOUTS.items()}
        opt = ts.default_optimizer(**OPT)

        # expert 2 x data 2: the MoE step, sharded and unsharded.
        mcfg = dataclasses.replace(moe.moe_configs()["moe-debug"],
                                   dtype=torch.float32)
        mesh = meshes["moe"]
        state = ts.reshard_state(inp["moe_tree"], mcfg, opt, mesh)
        res["moe_shard"] = state.params["layers"]["we_gate"].to_local() \
            .detach().numpy().copy()
        res["moe_placements"] = tuple(
            state.params["layers"]["we_gate"].placements)
        res["moe"] = _steps(ts, ts.sharded_train_step(mcfg, opt, mesh),
                            state, inp["moe_batch"])
        res["moe_replicated"] = _steps(
            ts, ts.make_train_step(mcfg, opt, device="cpu"),
            train_state_from_jax(inp["moe_tree"], mcfg, opt, device="cpu"),
            inp["moe_batch"])

        # seq 2 x data 2: the ring op, then the ring step.
        mesh = meshes["ring"]
        place = (Shard(0), Shard(1))
        q, k, v, g = (distribute_tensor(torch.from_numpy(a), mesh, place)
                      for a in inp["qkvg"])
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        o = ring_attention_gspmd(q, k, v)
        (o * g).sum().backward()
        res["ring_op"] = [_full_np(t) for t in (o, q.grad, k.grad, v.grad)]
        # Plain attention on the same split: the sequence is gathered.
        res["seq_gather"] = _full_np(attention(q, k, v))
        rcfg = dataclasses.replace(llama.llama_configs()["debug"],
                                   dtype=torch.float32,
                                   use_ring_attention=True)
        state = ts.reshard_state(inp["ring_tree"], rcfg, opt, mesh)
        res["ring"] = _steps(ts, ts.sharded_train_step(rcfg, opt, mesh),
                             state, inp["ring_batch"])
        res["ring_unsharded"] = _steps(
            ts, ts.make_train_step(rcfg, opt, device="cpu"),
            train_state_from_jax(inp["ring_tree"], rcfg, opt, device="cpu"),
            inp["ring_batch"])

        # stage 4: pipeline_apply against the stages in sequence.
        mesh = meshes["pipe4"]
        w, b, xs = (torch.from_numpy(a) for a in inp["pipe"])

        def stage_fn(p, x):
            return torch.tanh(x @ p["w"] + p["b"])

        stacked = stack_stage_params([{"w": w[i], "b": b[i]}
                                      for i in range(4)])
        sh = stage_sharding(mesh)
        wd, bd = (distribute_tensor(stacked[n], sh.mesh, sh.placements)
                  .detach().requires_grad_() for n in ("w", "b"))
        x1 = xs.clone().requires_grad_()
        y = pipeline_apply(stage_fn, {"w": wd, "b": bd}, x1, mesh)
        (y * xs).sum().backward()
        w2, b2, x2 = (t.clone().requires_grad_() for t in (w, b, xs))
        ref = x2
        for i in range(4):
            ref = stage_fn({"w": w2[i], "b": b2[i]}, ref)
        (ref * xs).sum().backward()
        res["pipe4"] = [(_full_np(a), _full_np(b_)) for a, b_ in (
            (y, ref), (wd.grad, w2.grad), (bd.grad, b2.grad),
            (x1.grad, x2.grad))]

        # stage 2 x (data | fsdp) 2: the pipelined loss and its gradients.
        pcfg = _pp_cfg(llama, torch.float32)
        params = params_from_jax(inp["pp_params"], pcfg, device="cpu")
        for name in PP_MESHES:
            mesh = meshes[name]
            sp = tree_map(lambda t: t.detach().requires_grad_(),
                          shard_params(params, llama.param_logical_axes(pcfg),
                                       mesh, rules=ts._rules_for(mesh)))
            bsh = ts.batch_shardings(mesh)
            batch = {"tokens": distribute_tensor(
                torch.from_numpy(inp["pp_batch"]["tokens"]), bsh.mesh,
                bsh.placements)}
            loss = llama.pipelined_loss_fn(sp, batch, pcfg, mesh, n_micro=2)
            loss.backward()
            res[name] = (float(_full_np(loss)),
                         [_full_np(p.grad) for p in ts.param_leaves(sp)])
        state = ts.reshard_state(inp["pp_tree"], pcfg, opt,
                                 meshes["pp_data"])
        res["pp_step"] = _steps(
            ts, ts.sharded_train_step(pcfg, opt, meshes["pp_data"],
                                      n_micro=2),
            state, inp["pp_batch"])

        # The reference's rejections.
        res["rejections"] = {
            n: _raised(lambda n=n: ts.sharded_train_step(pcfg, opt,
                                                         meshes[n]))
            for n in ("stage_seq", "stage_expert")}
        state = ts.sharded_init(0, mcfg, opt, meshes["pp_data"])
        step = ts.sharded_train_step(mcfg, opt, meshes["pp_data"])
        res["rejections"]["moe_stage"] = _raised(
            lambda: step(state, inp["moe_batch"]))
    except BaseException:  # noqa: BLE001 - reported to the parent
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


# ----------------------------------------------------------- the JAX side
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
    from ray_tpu.models import moe as jm
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.train import step as js

    cfgs = {"moe": dataclasses.replace(jm.moe_configs()["moe-debug"],
                                       dtype=jnp.float32),
            "ring": dataclasses.replace(jl.llama_configs()["debug"],
                                        dtype=jnp.float32,
                                        use_ring_attention=True),
            "pp": _pp_cfg(jl, jnp.float32)}
    meshes = {n: create_mesh(MeshConfig(**kw), devices=jax.devices()[:WORLD])
              for n, kw in LAYOUTS.items()}
    return js, cfgs, js.default_optimizer(**OPT), meshes


def _jax_inits(inp):
    """The JAX states and params every scenario starts from."""
    import jax

    from ray_tpu.models import llama as jl

    js, cfgs, opt, meshes = _jax_setup()
    states = {n: js.sharded_init(jax.random.PRNGKey(0), cfgs[n], opt,
                                 meshes[m])
              for n, m in (("moe", "moe"), ("ring", "ring"),
                           ("pp", "pp_data"))}
    pp_params = jl.init_params(jax.random.PRNGKey(3), cfgs["pp"])
    trees = {f"{n}_tree": _jax_tree(s) for n, s in states.items()}
    return states, pp_params, {**inp, **trees,
                               "pp_params": jax.tree.map(np.asarray,
                                                         pp_params)}


def _jax_side(states, pp_params, inp):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel.ring import ring_attention_gspmd
    from ray_tpu.parallel.sharding import shard_params

    js, cfgs, opt, meshes = _jax_setup()
    out = {}

    def steps(name, mesh, state, batch, **kw):
        fn = js.sharded_train_step(cfgs[name], opt, mesh, **kw)
        batch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        metrics = []
        with jax.set_mesh(mesh):
            for _ in range(N_STEPS):
                state, m = fn(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, [np.asarray(p) for _, p in _leaves(state.params)]

    mesh = meshes["moe"]
    leaf = states["moe"].params["layers"]["we_gate"]
    by_dev = {s.device: np.array(s.data) for s in leaf.addressable_shards}
    out["moe_shards"] = [by_dev[d] for d in mesh.devices.flat]
    out["moe"] = steps("moe", mesh, states["moe"], inp["moe_batch"])

    mesh = meshes["ring"]
    q, k, v, g = (jnp.asarray(a) for a in inp["qkvg"])
    spec = NamedSharding(mesh, P(("data",), "seq"))
    q, k, v, g = (jax.device_put(t, spec) for t in (q, k, v, g))

    def ring_loss(q, k, v):
        o = ring_attention_gspmd(q, k, v)
        return (o * g).sum(), o

    with jax.set_mesh(mesh):
        (_, o), grads = jax.jit(jax.value_and_grad(
            ring_loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    out["ring_op"] = [np.asarray(t) for t in (o, *grads)]
    out["ring"] = steps("ring", mesh, states["ring"], inp["ring_batch"])

    batch = {"tokens": jnp.asarray(inp["pp_batch"]["tokens"], jnp.int32)}
    for name in PP_MESHES:
        mesh = meshes[name]
        sp = shard_params(pp_params, jl.param_logical_axes(cfgs["pp"]), mesh,
                          rules=js._rules_for(mesh))
        with jax.set_mesh(mesh):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jl.pipelined_loss_fn(p, batch, cfgs["pp"], mesh,
                                               n_micro=2)))(sp)
        out[name] = (float(loss), [np.asarray(g) for _, g in _leaves(grads)])
    out["pp_step"] = steps("pp", meshes["pp_data"], states["pp"],
                           inp["pp_batch"], n_micro=2)

    out["rejections"] = {}
    for name in ("stage_seq", "stage_expert"):
        with pytest.raises(NotImplementedError) as e:
            js.sharded_train_step(cfgs["pp"], opt, meshes[name])
        out["rejections"][name] = str(e.value)
    mesh = meshes["pp_data"]
    state = js.sharded_init(jax.random.PRNGKey(0), cfgs["moe"], opt, mesh)
    step = js.sharded_train_step(cfgs["moe"], opt, mesh)
    with pytest.raises(NotImplementedError) as e, jax.set_mesh(mesh):
        step(state, {"tokens": jnp.asarray(inp["moe_batch"]["tokens"])})
    out["rejections"]["moe_stage"] = str(e.value)
    return out


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
    tmp = tmp_path_factory.mktemp("gloo")
    states, pp_params, inp = _jax_inits(_inputs())
    in_path = tmp / "inputs.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inp, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, str(tmp / "store"), str(in_path),
                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = _jax_side(states, pp_params, inp)
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


def _assert_steps(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   **PARAM_TOL)


def test_expert_parallel_step_matches_jax(world):
    from torch.distributed.tensor import Replicate, Shard

    jax_out, ranks = world
    for r, res in enumerate(ranks):
        # [L, E, d, f]: data replicates, expert splits E
        assert res["moe_placements"] == (Replicate(), Shard(1))
        np.testing.assert_array_equal(res["moe_shard"],
                                      jax_out["moe_shards"][r])
        assert res["moe"][0] == ranks[0]["moe"][0]
    _assert_steps(ranks[0]["moe"], jax_out["moe"])
    assert jax_out["moe"][0][1][1] > 1.0            # the clip engaged


def test_expert_parallel_equals_replicated(world):
    _, ranks = world
    for res in ranks:
        np.testing.assert_allclose(res["moe"][0], res["moe_replicated"][0],
                                   rtol=1e-5)
        for a, b in zip(res["moe"][1], res["moe_replicated"][1]):
            np.testing.assert_allclose(a, b, **PARAM_TOL)


def test_ring_attention_matches_jax(world):
    jax_out, ranks = world
    for res in ranks:
        for name, g, w in zip(("o", "dq", "dk", "dv"), res["ring_op"],
                              jax_out["ring_op"]):
            np.testing.assert_allclose(g, w, **RING_TOL, err_msg=name)
        np.testing.assert_allclose(res["seq_gather"], jax_out["ring_op"][0],
                                   **RING_TOL)


def test_ring_layout_step_matches_jax_and_unsharded(world):
    jax_out, ranks = world
    got = ranks[0]["ring"]
    _assert_steps(got, jax_out["ring"])
    _assert_steps(got, ranks[0]["ring_unsharded"])
    for res in ranks[1:]:
        assert res["ring"][0] == got[0]


def test_pipeline_apply_matches_sequential(world):
    _, ranks = world
    for res in ranks:
        for name, (g, w) in zip(("y", "dw", "db", "dx"), res["pipe4"]):
            np.testing.assert_allclose(g, w, **RING_TOL, err_msg=name)


@pytest.mark.parametrize("layout", PP_MESHES)
def test_pipelined_loss_and_grads_match_jax(world, layout):
    jax_out, ranks = world
    want_loss, want_grads = jax_out[layout]
    for res in ranks:
        loss, grads = res[layout]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for g, w in zip(grads, want_grads):
            rel = np.abs(g - w).max() / (np.abs(w).max() + 1e-9)
            assert rel < 1e-4, rel


def test_pipelined_step_matches_jax(world):
    jax_out, ranks = world
    _assert_steps(ranks[0]["pp_step"], jax_out["pp_step"])
    for res in ranks[1:]:
        assert res["pp_step"][0] == ranks[0]["pp_step"][0]


@pytest.mark.parametrize("case", REJECTIONS)
def test_reference_rejections(world, case):
    jax_out, ranks = world
    want = jax_out["rejections"][case].replace("ray_tpu.models",
                                               "ray_tpu_torch.models")
    for res in ranks:
        assert res["rejections"][case] == want
