"""The port's RL learners (rl/learner.py and the eight algorithms' loss
builders) against the JAX package's `Learner`, on the CPU.

For each algorithm a reference `Learner(config, Algo.loss_builder)` is
built in this process (no runtime), with the params_builder and
post_update_builder its `setup` would set, and the port's from the same
config; the port's takes the reference's initial params through
`set_params`.  On one seeded batch per algorithm (IMPALA and APPO take
[B, T] fragments with episode ends and truncations):

- target nets drifted from the online ones (as after some polyak syncs);
- the first minibatch's loss and metrics agree to 1e-5, and the
  gradients of every leaf to 1e-5 of that leaf's largest (leaves the loss
  does not reach, such as DQN's value net and SAC's target critics, to
  zero);
- one `update(num_sgd_iter=1, minibatch_size=n // 2)` (two Adam steps
  over the same minibatch order, each followed by the polyak sync where
  the algorithm has one) leaves params within 1e-4 and returns the last
  minibatch's metrics within 1e-4.

No test boots the ray_tpu runtime."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

N = 16                      # rows (IMPALA / APPO: fragments of T steps)
T = 5
OBS, ACTIONS = 4, 3
TOL1 = dict(atol=1e-5, rtol=1e-5)
TOL4 = dict(atol=1e-4, rtol=1e-4)
ALGOS = ["ppo", "impala", "appo", "dqn", "bc", "marwil", "sac", "cql"]
CLASSES = {"ppo": "PPO", "impala": "IMPALA", "appo": "APPO", "dqn": "DQN",
           "bc": "BC", "marwil": "MARWIL", "sac": "SAC", "cql": "CQL"}
# What each reference setup() puts into the learner's config.
REF_BUILDERS = {"appo": ("appo", "appo_params_init", "appo_post_update"),
                "sac": ("sac", "sac_params_init", "sac_post_update"),
                "cql": ("sac", "sac_params_init", "sac_post_update")}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _batch(algo: str) -> dict:
    rng = np.random.default_rng(ALGOS.index(algo))
    f32 = np.float32

    def obs(*lead):
        return rng.normal(size=(*lead, OBS)).astype(f32)

    def actions(*lead):
        return rng.integers(0, ACTIONS, size=lead)

    if algo in ("impala", "appo"):
        b = {"obs": obs(N, T), "next_obs": obs(N, T),
             "actions": actions(N, T),
             "logp": np.log(rng.uniform(0.2, 0.6, (N, T))).astype(f32),
             "rewards": rng.normal(size=(N, T)).astype(f32),
             "dones": (rng.random((N, T)) < 0.15).astype(f32),
             "truncs": (rng.random((N, T)) < 0.1).astype(f32)}
        b["dones"][0, 2] = 1.0                  # an end inside a fragment
        b["truncs"][1, 4] = 1.0                 # a cut at the fragment end
        return b
    b = {"obs": obs(N), "actions": actions(N)}
    if algo == "ppo":
        b.update(logp=np.log(rng.uniform(0.2, 0.6, N)).astype(f32),
                 advantages=rng.normal(size=N).astype(f32),
                 value_targets=rng.normal(size=N).astype(f32))
    elif algo == "dqn":
        b["q_targets"] = rng.normal(size=N).astype(f32)
    elif algo == "marwil":
        b["returns"] = rng.normal(size=N).astype(f32) * 2
    elif algo in ("sac", "cql"):
        b.update(rewards=rng.normal(size=N).astype(f32), next_obs=obs(N),
                 dones=(rng.random(N) < 0.2).astype(f32))
    b["episode_returns"] = [1.0, 2.0]          # not an array: dropped
    return b


def _config(algo: str) -> dict:
    return {"obs_dim": OBS, "n_actions": ACTIONS, "hidden": 16,
            "lr": 3e-4, "seed": 3, "gamma": 0.9, "tau": 0.1}


def _ref_learner(algo: str):
    import importlib

    from ray_tpu.rl.learner import Learner

    mod = importlib.import_module(f"ray_tpu.rl.{algo}")
    cfg = _config(algo)
    if algo in REF_BUILDERS:
        src, params, post = REF_BUILDERS[algo]
        builders = importlib.import_module(f"ray_tpu.rl.{src}")
        cfg["params_builder"] = getattr(builders, params)
        cfg["post_update_builder"] = getattr(builders, post)
    cls = getattr(mod, CLASSES[algo])
    return Learner(cfg, cls.loss_builder), cls


def _port_learner(algo: str, params_np: dict):
    import importlib

    from ray_tpu_torch.rl.learner import Learner

    cls = getattr(importlib.import_module(f"ray_tpu_torch.rl.{algo}"),
                  CLASSES[algo])
    learner = Learner(cls.learner_config(_config(algo)), cls.loss_builder,
                      device="cpu")
    learner.set_params(params_np)
    return learner, cls


def _first_minibatch(batch: dict, seed: int) -> np.ndarray:
    idx = np.arange(len(batch["obs"]))
    np.random.default_rng(seed + 17).shuffle(idx)
    return idx[:N // 2]


@pytest.fixture(scope="module", params=ALGOS)
def pair(request):
    """(algo, batch, the reference learner's first minibatch loss,
    metrics and gradients, its params and metrics after one update, the
    port's learner before its update)."""
    algo = request.param
    batch = _batch(algo)
    ref, ref_cls = _ref_learner(algo)
    # Target nets ("pi_t", "q1_t", ...) that have drifted from the online
    # ones, as after some polyak syncs: at equality APPO's KL gradient on
    # pi_t is rounding noise around zero.
    rng = np.random.default_rng(99)
    init = {k: jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape))
                            .astype(np.float32), v) if k.endswith("_t")
            else v for k, v in ref.get_params_numpy().items()}
    ref.set_params(init)
    port, _ = _port_learner(algo, init)
    idx = _first_minibatch(batch, _config(algo)["seed"])
    mb = {k: jnp.asarray(v[idx]) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        ref_cls.loss_builder(ref.config), has_aux=True))(ref.params, mb)
    ref_metrics = ref.update(batch, num_sgd_iter=1, minibatch_size=N // 2)
    return {"algo": algo, "batch": batch, "idx": idx, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, grads),
            "after": ref.get_params_numpy(), "ref_metrics": ref_metrics,
            "port": port, "init": init}


def _port_loss(pair):
    """The port's loss, metrics and gradients on the first minibatch,
    from the initial params (the learner's own tensors stay untouched)."""
    port = pair["port"]
    params = jax.tree.map(
        lambda a: torch.tensor(a).requires_grad_(True), pair["init"])
    mb = {k: port._tensor(v[pair["idx"]]) for k, v in pair["batch"].items()
          if isinstance(v, np.ndarray)}
    loss, metrics = port._loss_fn(params, mb)
    loss.backward()
    grads = jax.tree.map(lambda t: np.zeros(t.shape, np.float32)
                         if t.grad is None else t.grad.numpy(), params)
    return float(loss.detach()), {k: float(v.detach())
                                  for k, v in metrics.items()}, grads


def test_first_minibatch_loss_and_metrics(pair):
    loss, metrics, _ = _port_loss(pair)
    np.testing.assert_allclose(loss, pair["loss"], **TOL1)
    assert set(metrics) == set(pair["metrics"])
    for k, v in pair["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, err_msg=k, **TOL1)


def test_first_minibatch_gradients(pair):
    _, _, grads = _port_loss(pair)
    want = dict(_leaves(pair["grads"]))
    got = dict(_leaves(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[path] - w).max())
        assert err <= 1e-5 * scale, (path, err, scale)
        if scale == 0.0:
            assert not got[path].any(), path


def test_update_matches_reference(pair):
    port = pair["port"]
    metrics = port.update(pair["batch"], num_sgd_iter=1,
                          minibatch_size=N // 2)
    assert set(metrics) == set(pair["ref_metrics"])
    for k, v in pair["ref_metrics"].items():
        np.testing.assert_allclose(metrics[k], v, err_msg=k, **TOL4)
    got = dict(_leaves(port.get_params_numpy()))
    for path, w in _leaves(pair["after"]):
        np.testing.assert_allclose(got[path], w, err_msg=path, **TOL4)
    moved = [p for p, w in _leaves(pair["init"])
             if not np.array_equal(got[p], w)]
    assert moved                                  # the update did move
    state = port.get_state()
    assert state["opt_state"]["count"] == 2       # two minibatches
    assert set(dict(_leaves(state["opt_state"]["mu"]))) == set(got)


# ------------------------------------------------------------- the parts
@pytest.mark.parametrize("lam,rho_bar", [(1.0, 1.0), (0.9, 0.7)])
def test_vtrace_returns_match_jax(lam, rho_bar):
    from ray_tpu.rl.impala import vtrace_returns as jvt
    from ray_tpu_torch.rl.impala import vtrace_returns as tvt

    b = _batch("impala")
    rng = np.random.default_rng(11)
    values, v_next, rhos = (rng.normal(size=(N, T)).astype(np.float32)
                            for _ in range(3))
    rhos = np.exp(rhos * 0.5)
    jb = {k: jnp.asarray(b[k]) for k in ("rewards", "dones", "truncs")}
    want = jvt(jax, jnp, jb, jnp.asarray(values), jnp.asarray(v_next),
               jnp.asarray(rhos), 0.9, rho_bar, 1.0, lam)
    got = tvt({k: torch.from_numpy(b[k]) for k in jb},
              torch.from_numpy(values), torch.from_numpy(v_next),
              torch.from_numpy(rhos), 0.9, rho_bar, 1.0, lam)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL1)


def test_mlp_apply_numpy_and_torch():
    """The env runners' numpy forward and the learner's torch forward of
    one tree agree with the reference's numpy forward."""
    from ray_tpu.rl import models as jm
    from ray_tpu_torch.rl import models as tm

    params = tm.policy_value_init(torch.Generator().manual_seed(0), OBS,
                                  ACTIONS, hidden=8)
    params_np = tm.to_numpy(params)
    x = np.random.default_rng(0).normal(size=(5, OBS)).astype(np.float32)
    want = jm.policy_logits(params_np, x)
    np.testing.assert_allclose(tm.policy_logits(params_np, x), want,
                               **TOL1)
    np.testing.assert_allclose(
        tm.policy_logits(params, torch.from_numpy(x), torch).numpy(), want,
        **TOL1)
    assert tm.value(params_np, x).shape == (5,)
    a, lp = tm.sample_action(want, np.random.default_rng(1))
    b, lq = jm.sample_action(want, np.random.default_rng(1))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lp, lq)
    w = params["pi"]["w0"]
    assert w.dtype == torch.float32 and w.shape == (OBS, 8)


def test_discounted_returns_match_reference():
    from ray_tpu.rl.marwil import discounted_returns as jd
    from ray_tpu_torch.rl.marwil import discounted_returns as td

    rng = np.random.default_rng(2)
    r = rng.normal(size=20).astype(np.float32)
    d = (rng.random(20) < 0.2).astype(np.float32)
    np.testing.assert_array_equal(td(r, d, 0.95), jd(r, d, 0.95))


def test_algorithms_raise_until_the_driver_is_ported():
    import importlib

    for algo in ALGOS:
        cls = getattr(importlib.import_module(f"ray_tpu_torch.rl.{algo}"),
                      CLASSES[algo])
        with pytest.raises(NotImplementedError,
                           match="queue 1 item 7, driver half"):
            cls({"env": "CartPole-v1"})


def test_learner_device_and_state():
    from ray_tpu_torch.rl.learner import Learner
    from ray_tpu_torch.rl.ppo import PPO

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Learner(_config("ppo"), PPO.loss_builder)
    learner = Learner(_config("ppo"), PPO.loss_builder, device="cpu")
    state = learner.get_state()
    assert state["opt_state"]["count"] == 0
    assert all(not m.any() for _, m in _leaves(state["opt_state"]["nu"]))
    with pytest.raises(ValueError, match="shape"):
        learner.set_params({**state["params"], "pi": {
            **state["params"]["pi"], "w0": np.zeros((2, 2), np.float32)}})
