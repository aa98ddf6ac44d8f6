"""The port's mesh learner (`GRPOLearner(mesh=...)`) against the JAX
package's, on the CPU.

One spawned group of four gloo ranks for the module (a FileStore under
the test's temporary directory, a timeout on the group, every child
joined with a deadline and killed on failure, one thread each, no JAX in
the children, output to files), as tests/test_torch_sharded.py does.
`debug` in f32, a fixed trajectory batch from a numpy seed (8 rows,
groups of 4; behavior logprobs are the initial policy's plus noise, so
the ratios clip), lr 1e-2 and kl_coeff 0.1.  Every rank starts from the
JAX learner's state (`grpo_state_from_jax`) on fsdp 4 and on data 2 x
tensor 2, while this process runs `ray_tpu.rl.rlhf.GRPOLearner(mesh=...)`
on the same layouts over `jax.devices()[:4]`:

- with `minibatch_size=None`, three updates' losses, advantages and
  metrics within 1e-4 of the JAX mesh learner's, and the first update's
  gradients within 1e-4 of `jax.grad` of the reference's loss on its
  sharded params (ROADMAP's parity method: gradients, not params after
  several Adam steps);
- with `minibatch_size=4`, three updates within 1e-4 of the port's
  single-device learner (the torch shuffle is shared);
- `param_hash` and `get_params_numpy` equal on every rank;
- a mesh checkpoint loads into a single-device learner, which continues
  as the mesh learner does, and the reverse;
- `broadcast_weights` reaches the runtime's broadcast and the
  `rl.weight_sync` failpoint from the mesh's first rank only;
- a mesh whose device type is not the learner's raises ValueError.

No test boots the ray_tpu runtime."""
import dataclasses
import datetime
import hashlib
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
LAYOUTS = {"fsdp4": dict(data=1, fsdp=4),
           "data2_tensor2": dict(data=2, tensor=2)}
N_UPDATES = 3
TOL = 1e-4
LEARNER = dict(lr=1e-2, kl_coeff=0.1, group_size=4)
METRICS = ("loss", "policy_loss", "kl", "ratio_mean", "reward_mean",
           "reward_std", "minibatches", "version")


def _batch(logprobs: np.ndarray, tokens: np.ndarray) -> dict:
    """The trajectory batch: 8 rows (2 groups of 4), 10 prompt tokens."""
    rng = np.random.default_rng(11)
    B, T = tokens.shape
    mask = np.zeros((B, T - 1), np.float32)
    mask[:, 9:] = 1.0
    return {"tokens": tokens, "logprobs": logprobs, "mask": mask,
            "rewards": rng.normal(size=B).astype(np.float32),
            "group_size": 4, "rollout_tokens": int(mask.sum()),
            "weight_version": 0}


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(1, vocab, size=(8, 24)) \
        .astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tree_hash(tree) -> str:
    h = hashlib.blake2b(digest_size=16)
    for _, leaf in _leaves(tree):
        h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


class RecordingRuntime:
    """The seam's broadcast face and failpoint hook, recorded: a rank's
    `get_rank` is 0 (the source), `broadcast_async` hands the payload
    back."""

    def __init__(self):
        from ray_tpu_torch.serve.runtime import ServeRuntime

        self._base = ServeRuntime()
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._base, name)

    def get_rank(self, group_name="default"):
        return 0

    def failpoint(self, site):
        self.calls.append(("failpoint", site))

    def init_collective_group(self, world_size, rank, group_name="default"):
        self.calls.append(("init", group_name))

    def broadcast_async(self, payload, src_rank, group_name="default"):
        self.calls.append(("broadcast", group_name, int(payload.nbytes)))

        class Done:
            def wait(self, timeout=None):
                return payload
        return Done()


# --------------------------------------------------------- the gloo ranks
def _metrics(m: dict) -> dict:
    out = {k: m[k] for k in METRICS}
    out["advantages"] = np.asarray(m["advantages"]).copy()
    return out


def _grads(learner) -> dict:
    """The last minibatch's gradients, whole (a collective)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for path, p in _leaves(learner.params):
        g = p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad
        out[path] = g.detach().numpy().copy()
    return out


def _run_layout(name, mesh, cfg, state, batch, tmp, rank):
    """One layout's scenarios on this rank."""
    from ray_tpu_torch.rl.rlhf import GRPOLearner, RLHFConfig

    res = {}

    def mesh_learner(**kw):
        rc = RLHFConfig(model=cfg, device="cpu", **{**LEARNER, **kw})
        lr = GRPOLearner(rc, params=state["params"], mesh=mesh)
        lr.load_state(state)
        return lr

    def single_learner(**kw):
        rc = RLHFConfig(model=cfg, device="cpu", **{**LEARNER, **kw})
        lr = GRPOLearner(rc, params=state["params"])
        lr.load_state(state)
        return lr

    # Whole-batch updates, against the JAX mesh learner.
    ml = mesh_learner()
    res["placements"] = sorted({str(p.placements)
                                for _, p in _leaves(ml.params)})
    res["moment_layout_equal"] = True
    out = []
    for i in range(N_UPDATES):
        out.append(_metrics(ml.update(batch)))
        if i == 0:
            res["grads"] = _grads(ml)
            res["moment_layout_equal"] = all(
                ml.opt.state[p]["exp_avg"].placements == p.placements
                for _, p in _leaves(ml.params))
    res["whole"] = out
    res["hash"] = ml.param_hash()
    res["params_numpy_hash"] = _tree_hash(ml.get_params_numpy())
    # The checkpoint round trips: mesh -> single device, and back.
    path = os.path.join(tmp, f"ckpt_{name}")
    ml.save_async(path)
    res["ckpt_wait"] = ml.ckpt_wait()
    single = single_learner()
    res["loaded_version"] = single.load(path)
    res["loaded_hash"] = single.param_hash()
    res["mesh_next"] = _metrics(ml.update(batch))
    res["single_next"] = _metrics(single.update(batch))
    back = os.path.join(tmp, f"ckpt_back_{name}_{rank}")
    single.save_async(back)
    single.ckpt_wait()
    ml2 = mesh_learner()
    res["back_version"] = ml2.load(back)
    res["back_hash"] = ml2.param_hash()
    res["back_hash_want"] = single.param_hash()
    # Minibatches of 4, against the port's single-device learner.
    mm, sm = mesh_learner(minibatch_size=4), single_learner(minibatch_size=4)
    res["mb_mesh"] = [_metrics(mm.update(batch)) for _ in range(N_UPDATES)]
    res["mb_single"] = [_metrics(sm.update(batch)) for _ in range(N_UPDATES)]
    # The weight broadcast through a recording runtime.
    rt = RecordingRuntime()
    bl = GRPOLearner(RLHFConfig(model=cfg, device="cpu", runtime=rt,
                                **LEARNER), params=state["params"],
                     mesh=mesh)
    bl.init_collective_group(2, 0, group_name="w")
    res["broadcast_version"] = bl.broadcast_weights("w")
    res["broadcast_calls"] = rt.calls
    return res


def _rank_main(rank, store, tree_path, out_dir):
    """One gloo rank; results (or the traceback) pickled to
    out_dir/rank<r>.pkl, output to out_dir/rank<r>.log."""
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
        from ray_tpu_torch.models.convert import grpo_state_from_jax
        from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
        from ray_tpu_torch.rl import rlhf

        with open(tree_path, "rb") as f:
            tree, batch = pickle.load(f)
        cfg = dataclasses.replace(llama.llama_configs()["debug"],
                                  dtype=torch.float32)
        state = grpo_state_from_jax(tree, cfg, device="cpu")
        for name, kw in LAYOUTS.items():
            mesh = create_mesh(MeshConfig(**kw), "cpu")
            res[name] = _run_layout(name, mesh, cfg, state, batch,
                                    out_dir, rank)
        # A mesh on another device type than the learner's.
        real = rlhf.resolve_device
        rlhf.resolve_device = lambda *a: torch.device("meta")
        try:
            rlhf.GRPOLearner(rlhf.RLHFConfig(model=cfg), params=state[
                "params"], mesh=mesh)
            res["device_mismatch"] = None
        except ValueError as e:
            res["device_mismatch"] = str(e)
        finally:
            rlhf.resolve_device = real
    except BaseException:  # noqa: BLE001 - reported to the parent
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------- the JAX side
def _jax_setup():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    cfg = dataclasses.replace(jl.llama_configs()["debug"],
                              dtype=jnp.float32)
    params = jl.init_params(jax.random.PRNGKey(0), cfg)
    tokens = _tokens(cfg.vocab_size)
    lp = np.asarray(jax.jit(lambda p, t: jl.token_logprobs(p, t, cfg))(
        params, jnp.asarray(tokens)))
    noise = np.random.default_rng(5).normal(0.0, 0.2, lp.shape)
    return cfg, params, _batch((lp + noise).astype(np.float32), tokens)


def _jax_grads(learner, batch, adv):
    """jax.grad of the reference learner's loss (rl/rlhf.py `_update`) on
    its (sharded) params: the first update's gradients."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import llama as jl

    cfg, clip, klc = learner.mcfg, learner.cfg.clip, learner.cfg.kl_coeff
    tokens, mask, blogp = (jnp.asarray(batch[k])
                           for k in ("tokens", "mask", "logprobs"))

    def loss_fn(p):
        lp = jl.token_logprobs(p, tokens, cfg)
        ratio = jnp.exp(lp - blogp)
        a = jnp.asarray(adv)[:, None]
        per = jnp.minimum(ratio * a, jnp.clip(ratio, 1 - clip, 1 + clip) * a)
        denom = jnp.maximum(mask.sum(), 1.0)
        return -(per * mask).sum() / denom \
            + klc * ((blogp - lp) * mask).sum() / denom

    g = jax.jit(jax.grad(loss_fn))(learner.params)
    return {path: np.asarray(leaf) for path, leaf in _leaves(g)}


def _jax_side(cfg, params, batch):
    """The JAX mesh learner on each layout over jax.devices()[:4]: three
    updates, and the first update's gradients."""
    import jax

    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu.rl.rlhf import GRPOLearner, RLHFConfig

    out = {}
    for name, kw in LAYOUTS.items():
        mesh = create_mesh(MeshConfig(**kw), devices=jax.devices()[:WORLD])
        lr = GRPOLearner(RLHFConfig(model=cfg, **LEARNER), params=params,
                         mesh=mesh)
        ms = [lr.update(batch) for _ in range(N_UPDATES)]
        # The first update's gradients: at the initial params, which a
        # fresh learner on the same mesh holds.
        probe = GRPOLearner(RLHFConfig(model=cfg, **LEARNER),
                            params=params, mesh=mesh)
        out[name] = {
            "whole": [{k: m[k] for k in METRICS}
                      | {"advantages": np.asarray(m["advantages"])}
                      for m in ms],
            "grads": _jax_grads(probe, batch, ms[0]["advantages"])}
    return out


def _state_tree(cfg, params):
    """The fresh JAX learner's state, as its checkpoints hold it."""
    import jax

    from ray_tpu.rl.rlhf import GRPOLearner, RLHFConfig

    lr = GRPOLearner(RLHFConfig(model=cfg, **LEARNER), params=params)
    return jax.tree.map(np.array, {"params": lr.params,
                                   "opt_state": lr.opt_state,
                                   "version": np.asarray(lr.version)})


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the JAX side, each rank's results): the ranks run while this
    process runs the JAX mesh learner."""
    tmp = tmp_path_factory.mktemp("gloo")
    cfg, params, batch = _jax_setup()
    tree_path = tmp / "tree.pkl"
    with open(tree_path, "wb") as f:
        pickle.dump((_state_tree(cfg, params), batch), f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, str(tmp / "store"), str(tree_path),
                               str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        jax_out = _jax_side(cfg, params, batch)
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


def _assert_metrics_close(got: list, want: list, what: str):
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{what} update {i} {k}")
        np.testing.assert_allclose(g["advantages"], w["advantages"],
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what} update {i} advantages")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_updates_match_jax_mesh_learner(world, layout):
    """Three whole-batch updates: losses, advantages and metrics within
    1e-4 of the JAX mesh learner's on the same layout, on every rank; the
    params are sharded and Adam's moments laid out like them."""
    jax_out, ranks = world
    for r, res in enumerate(ranks):
        _assert_metrics_close(res[layout]["whole"],
                              jax_out[layout]["whole"], f"rank {r}")
        assert res[layout]["moment_layout_equal"]
    assert any("Shard" in p for p in ranks[0][layout]["placements"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_first_update_gradients_match_jax(world, layout):
    """The first update's gradients (the mesh learner's, gathered) within
    1e-4 of `jax.grad` of the reference's loss on the JAX mesh."""
    jax_out, ranks = world
    want = jax_out[layout]["grads"]
    got = ranks[0][layout]["grads"]
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=TOL, atol=TOL,
                                   err_msg=path)
    for res in ranks[1:]:
        for path, g in got.items():
            np.testing.assert_array_equal(res[layout]["grads"][path], g)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_minibatches_match_single_device_learner(world, layout):
    """minibatch_size=4: the mesh learner shuffles as the single-device
    learner does (the torch generator), and three updates agree to
    1e-4."""
    _, ranks = world
    for res in ranks:
        assert [m["minibatches"] for m in res[layout]["mb_mesh"]] == \
            [2] * N_UPDATES
        _assert_metrics_close(res[layout]["mb_mesh"],
                              res[layout]["mb_single"], "minibatches")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gathers_equal_on_every_rank(world, layout):
    """param_hash and get_params_numpy (collectives) give every rank the
    same whole tree."""
    _, ranks = world
    for key in ("hash", "params_numpy_hash"):
        assert len({res[layout][key] for res in ranks}) == 1, key


@pytest.mark.parametrize("layout", LAYOUTS)
def test_checkpoints_cross_mesh_and_single_device(world, layout):
    """A mesh checkpoint (written by the lead, waited for by every rank)
    loads into a single-device learner bit for bit, which then updates as
    the mesh learner does; a single-device checkpoint loads into a mesh
    learner bit for bit."""
    _, ranks = world
    for res in ranks:
        r = res[layout]
        assert r["ckpt_wait"][0] == N_UPDATES
        assert r["loaded_version"] == N_UPDATES
        assert r["loaded_hash"] == r["hash"]
        _assert_metrics_close([r["single_next"]], [r["mesh_next"]],
                              "after load")
        assert r["back_version"] == N_UPDATES + 1
        assert r["back_hash"] == r["back_hash_want"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_broadcast_weights_from_the_lead_only(world, layout):
    """Every rank gathers; only the mesh's first rank joins the group,
    fires rl.weight_sync and broadcasts the packed tree; every rank
    returns the version."""
    _, ranks = world
    lead = ranks[0][layout]["broadcast_calls"]
    assert [c[0] for c in lead] == ["init", "failpoint", "broadcast"]
    assert lead[1] == ("failpoint", "rl.weight_sync")
    assert lead[2][2] > 0
    for res in ranks[1:]:
        assert res[layout]["broadcast_calls"] == []
    assert {res[layout]["broadcast_version"] for res in ranks} == {0}


def test_mesh_on_another_device_raises(world):
    _, ranks = world
    for res in ranks:
        assert "create_mesh" in (res["device_mismatch"] or "")
