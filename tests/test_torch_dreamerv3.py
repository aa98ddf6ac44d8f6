"""The port's DreamerV3 (ray_tpu_torch/rl/dreamerv3.py, with its copies of
rl/env.py, rl/replay.py and the AlgorithmConfig builder) against the JAX
package's `ray_tpu.rl.dreamerv3`, run in this process on the CPU in f32 at
the reference's defaults (deter 64, 4 x 4 latents, hidden 64, B 8, T 16,
H 10).

The noise.  The reference draws `jax.random.gumbel` and
`jax.random.categorical` inside its jitted update, which torch cannot
reproduce.  Here both are patched while the reference's update is traced:
each returns fixed seeded noise of the call's shape (categorical returns
argmax(logits + noise), as it computes), so every scan step gets the same
noise.  The port's one seam, `DreamerV3.gumbel(shape)`, gets the same
arrays.

The gradients.  To read the reference's gradients without editing it,
`optax.adam` is patched, while the reference is built, to plain SGD whose
state is the last gradient: after one update each optimizer state is that
update's gradient tree.  The port runs the same SGD and leaves each
gradient in the leaf's `.grad`.

- (a) `dreamer_params_from_jax` of the reference's init tree has the keys,
  shapes and dtypes of the port's own init;
- (b) the first update's world-model and actor-critic gradients within
  1e-4 of each leaf's largest and the metrics within 1e-4, at the default
  free bits (the KL floored) and at free bits 0 (the KL's gradient live);
- (c) one update under Adam on both sides: metrics within 1e-4 (params
  are reported, not held: ROADMAP ground rules, Adam's first step);
- (d) one whole `step()` (updates_per_step 1) from the reference's
  params: the collected fragments, the replay contents and the sampled
  sequences equal, the metrics within 1e-4;
- (e) the reference test's six-step machinery run (tests/test_rl_extra.py
  `test_dreamerv3_machinery`) in the port alone.

No test boots the ray_tpu runtime."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

TOL = 1e-4
B, T = 8, 16


def _noise(shape) -> np.ndarray:
    """Standard Gumbel noise, fixed per shape."""
    shape = tuple(int(s) for s in shape)
    u = np.random.default_rng([len(shape), *shape]).uniform(
        np.finfo(np.float32).tiny, 1.0, size=shape)
    return (-np.log(-np.log(u))).astype(np.float32)


def _patch_noise(mp) -> None:
    mp.setattr(jax.random, "gumbel",
               lambda key, shape=(), dtype=None, **_kw:
               jnp.asarray(_noise(shape)))
    mp.setattr(jax.random, "categorical",
               lambda key, logits, axis=-1, **_kw:
               jnp.argmax(logits + jnp.asarray(_noise(logits.shape)), axis))


def _recording_sgd(lr):
    """optax SGD whose state is the last gradient tree."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(lambda g: -lr * g, grads), grads

    return optax.GradientTransformation(init, update)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _cartpole_batch(seed: int = 3, n: int = 300) -> dict:
    """[B, T] windows of a seeded random-action CartPole run."""
    from ray_tpu_torch.rl.env import make_env

    env, rng = make_env("CartPole-v1", seed=seed), np.random.default_rng(seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones", "truncs")}
    obs = env.reset()
    for _ in range(n):
        a = int(rng.integers(2))
        nxt, r, term, trunc = env.step(a)
        for k, v in zip(cols, (obs, a, r, float(term),
                               float(trunc and not term))):
            cols[k].append(v)
        obs = env.reset() if term or trunc else nxt
    data = {k: np.asarray(v, np.int64 if k == "actions" else np.float32)
            for k, v in cols.items()}
    starts = rng.integers(0, n - T, size=B)
    return {k: np.stack([v[s:s + T] for s in starts])
            for k, v in data.items()}


def _ref_update(algo, batch):
    """The reference's jitted update on `batch` (the algorithm itself is
    left as it was): (params, opt states, metrics) as numpy / floats."""
    params, opts, m = algo._update(
        algo.params, (algo.opt_wm, algo.opt_actor, algo.opt_critic),
        {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(7))
    return (jax.tree.map(np.asarray, params),
            [jax.tree.map(np.asarray, o) for o in opts],
            {k: float(v) for k, v in m.items()})


def _recorded(algo, name, out: list) -> None:
    """Record copies of what `algo.<name>(...)` returns."""
    import copy

    fn = getattr(algo, name)

    def wrapper(*args):
        res = fn(*args)
        out.append(copy.deepcopy(res))
        return res

    setattr(algo, name, wrapper)


@pytest.fixture(scope="module")
def reference():
    """Every reference run, once: the SGD update at each free bits, the
    Adam update and one whole step (updates_per_step 1), with the noise
    patched while they trace."""
    from ray_tpu.rl.dreamerv3 import DreamerV3Config

    batch = _cartpole_batch()
    out = {"batch": batch, "sgd": {}}
    with pytest.MonkeyPatch.context() as mp:
        _patch_noise(mp)
        for free in (1.0, 0.0):
            with pytest.MonkeyPatch.context() as sgd:
                sgd.setattr(optax, "adam", _recording_sgd)
                algo = DreamerV3Config().training(free_bits=free).build()
            params0 = jax.tree.map(np.asarray, algo.params)
            _, opts, metrics = _ref_update(algo, batch)
            grads = {**opts[0], "actor": opts[1], "critic": opts[2]}
            out["sgd"][free] = (params0, grads, metrics)
        algo = DreamerV3Config().training(updates_per_step=1).build()
        out["params0"] = jax.tree.map(np.asarray, algo.params)
        out["adam"] = _ref_update(algo, batch)
        rec = {"fragments": [], "sequences": []}
        _recorded(algo, "_sample_with", rec["fragments"])
        _recorded(algo, "_sample_sequences", rec["sequences"])
        out["step"] = (algo.step(), rec, {
            k: v.copy() for k, v in algo.replay.storage().items()})
    return out


def _port(config: dict | None = None, params=None, sgd: bool = False):
    from ray_tpu_torch.models.convert import dreamer_params_from_jax
    from ray_tpu_torch.rl import dreamerv3
    from ray_tpu_torch.train.step import param_leaves

    algo = dreamerv3.DreamerV3(config or {}, device="cpu")
    if params is not None:
        algo.set_params(dreamer_params_from_jax(params, device="cpu"))
    if sgd:
        cfg, p = algo.cfg, algo.params
        algo.opt_wm = torch.optim.SGD(param_leaves(
            {k: p[k] for k in dreamerv3.WM_KEYS}), lr=cfg["lr"])
        algo.opt_actor = torch.optim.SGD(param_leaves(p["actor"]),
                                         lr=cfg["actor_lr"])
        algo.opt_critic = torch.optim.SGD(param_leaves(p["critic"]),
                                          lr=cfg["critic_lr"])
    algo.gumbel = lambda shape: torch.from_numpy(_noise(shape))
    return algo


def _assert_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, atol=TOL, rtol=TOL,
                                   err_msg=k)


# ------------------------------------------------------------------- (a)
def test_params_from_jax_match_the_ports_init_tree():
    from ray_tpu.rl import dreamerv3 as ref
    from ray_tpu_torch.models.convert import dreamer_params_from_jax
    from ray_tpu_torch.rl import dreamerv3

    cfg = dreamerv3.DreamerV3Config().to_dict()
    want = jax.tree.map(np.asarray, ref.dreamer_params_init(
        jax.random.PRNGKey(0), 4, 2, cfg))
    got = dreamer_params_from_jax(want, device="cpu")
    mine = dreamerv3.dreamer_params_init(torch.Generator().manual_seed(0),
                                         4, 2, cfg)
    a, b, c = (dict(_leaves(t)) for t in (got, mine, want))
    assert set(a) == set(b) == set(c)
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape) == c[k].shape, k
        assert a[k].dtype == b[k].dtype == torch.float32, k
        np.testing.assert_array_equal(a[k].numpy(), c[k])
    with pytest.raises(ValueError, match="shape"):
        dreamer_params_from_jax({**want, "gru_b": np.zeros(5, np.float32)},
                                device="cpu")


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("free_bits", [1.0, 0.0])
def test_first_update_gradients_match_jax(reference, free_bits):
    params0, grads, metrics = reference["sgd"][free_bits]
    algo = _port({"free_bits": free_bits}, params0, sgd=True)
    batch = reference["batch"]
    got = algo.update({k: algo._tensor(v) for k, v in batch.items()})
    _assert_metrics(got, metrics)
    mine = dict(_leaves(algo.params))
    worst = {}
    for k, g in _leaves(grads):
        scale = max(float(np.abs(g).max()), 1e-12)
        worst[k] = float(np.abs(mine[k].grad.numpy() - g).max()) / scale
    assert max(worst.values()) < TOL, worst
    # The KL floor: at the default free bits this batch's KL is floored
    # (the prior's gradient is zero on both sides); at 0 it is live.
    prior = np.abs(grads["prior"]["w1"]).max()
    assert (prior == 0) == (free_bits == 1.0)


# ------------------------------------------------------------------- (c)
def test_one_adam_update_metrics_match_jax(reference):
    params_ref, _, metrics = reference["adam"]
    algo = _port({"updates_per_step": 1}, reference["params0"])
    batch = reference["batch"]
    _assert_metrics(algo.update(
        {k: algo._tensor(v) for k, v in batch.items()}), metrics)
    mine = dict(_leaves(algo.get_params_numpy()))
    diff = max(float(np.abs(mine[k] - v).max())
               for k, v in _leaves(params_ref))
    # Reported, not held: an element whose gradient is rounding noise may
    # take Adam's first step (about lr) either way.
    print(f"params after one Adam update: max abs diff {diff:.3g}")
    assert diff < 10 * 3e-4


# ------------------------------------------------------------------- (d)
def test_one_step_collects_and_samples_like_jax(reference):
    result_ref, rec_ref, storage_ref = reference["step"]
    algo = _port({"updates_per_step": 1}, reference["params0"])
    rec = {"fragments": [], "sequences": []}
    _recorded(algo, "_sample_with", rec["fragments"])
    _recorded(algo, "_sample_sequences", rec["sequences"])
    result = algo.step()
    for key in ("fragments", "sequences"):
        assert len(rec[key]) == len(rec_ref[key]) == 1
    for got, want in zip(rec["fragments"][0], rec_ref["fragments"][0]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    storage = algo.replay.storage()
    assert set(storage) == set(storage_ref)
    for k, v in storage_ref.items():
        np.testing.assert_array_equal(storage[k], v, err_msg=k)
    for k, v in rec_ref["sequences"][0].items():
        np.testing.assert_array_equal(rec["sequences"][0][k], v, err_msg=k)
    assert result["num_env_steps_sampled_lifetime"] == \
        result_ref["num_env_steps_sampled_lifetime"] == 256
    assert result["env_runners"]["num_episodes"] == \
        result_ref["env_runners"]["num_episodes"]
    np.testing.assert_allclose(result["episode_return_mean"],
                               result_ref["episode_return_mean"])
    _assert_metrics({k: v for k, v in result.items()
                     if k.startswith("learner/")},
                    {k: v for k, v in result_ref.items()
                     if k.startswith("learner/")})


# ------------------------------------------------------------------- (e)
def test_six_step_machinery_in_the_port():
    """tests/test_rl_extra.py's DreamerV3 machinery test, on the port:
    the world model learns, imagination stays finite, episodes complete."""
    from ray_tpu_torch.rl.dreamerv3 import DreamerV3Config

    config = (DreamerV3Config()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=1)
              .training(train_batch_size=256, updates_per_step=3)
              .debugging(seed=0))
    algo = config.build(device="cpu")
    first, last = None, None
    for i in range(6):
        m = algo.train()
        assert m["training_iteration"] == i + 1
        wm = m.get("learner/wm_loss")
        if wm is not None and wm == wm:
            if first is None:
                first = wm
            last = wm
            for key in ("learner/actor_loss", "learner/critic_loss",
                        "learner/entropy"):
                assert m[key] == m[key], f"{key} is NaN"
    algo.stop()
    assert first is not None, "world model never trained"
    assert last < first, f"world-model loss did not drop: {first}->{last}"
    assert len(algo._episode_returns) > 0, "no episodes completed"
    assert algo._timesteps == 6 * 256


# --------------------------------------------------------- the copies
def test_env_and_replay_copies_match_the_reference():
    from ray_tpu.rl.env import make_env as ref_env
    from ray_tpu.rl.replay import ReplayBuffer as RefReplay
    from ray_tpu_torch.rl.env import make_env
    from ray_tpu_torch.rl.replay import ReplayBuffer

    mine, ref = make_env("CartPole-v1", seed=11), ref_env("CartPole-v1",
                                                         seed=11)
    np.testing.assert_array_equal(mine.reset(), ref.reset())
    rng = np.random.default_rng(0)
    for _ in range(400):
        a = int(rng.integers(2))
        got, want = mine.step(a), ref.step(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if got[2] or got[3]:
            np.testing.assert_array_equal(mine.reset(), ref.reset())
    with pytest.raises(ValueError, match="unknown env"):
        make_env("Pong-v5")
    a, b = ReplayBuffer(50, seed=4), RefReplay(50, seed=4)
    for i in range(3):
        batch = {"obs": rng.normal(size=(30, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, size=30)}
        a.add_batch(batch)
        b.add_batch(batch)
        assert len(a) == len(b)
        got = a.sample(16)
        for k, v in b.sample(16).items():
            np.testing.assert_array_equal(got[k], v)
    for k, v in b.storage().items():
        np.testing.assert_array_equal(a.storage()[k], v)


def test_config_builder_matches_the_reference():
    from ray_tpu.rl.dreamerv3 import DreamerV3Config as Ref
    from ray_tpu_torch.rl.dreamerv3 import DreamerV3, DreamerV3Config

    def build(cls):
        return (cls().environment("CartPole-v1")
                .env_runners(num_env_runners=3, rollout_fragment_length=64)
                .training(lr=1e-3, horizon=7, free_bits=0.5)
                .learners(num_learners=1).debugging(seed=5))

    def renamed(d):
        # The port's accelerator option is num_gpus_per_learner (the
        # reference's num_tpus_per_learner; ROADMAP.md queue 1, renames).
        d = dict(d)
        d["num_gpus_per_learner"] = d.pop("num_tpus_per_learner")
        return d

    mine, ref = build(DreamerV3Config), build(Ref)
    assert mine.to_dict() == renamed(ref.to_dict())
    copied = mine.copy().training(gamma=0.5)
    assert copied.gamma == 0.5 and mine.gamma == 0.997
    assert DreamerV3.get_default_config().algo_class is DreamerV3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mine.build()
    algo = mine.build(device="cpu")
    assert {k: v for k, v in algo.cfg.items() if k != "algo_class"} == {
        **renamed(Ref().to_dict()), **renamed(ref.to_dict())}


def test_gumbel_seam_and_set_params():
    from ray_tpu_torch.rl.dreamerv3 import DreamerV3

    algo = DreamerV3({"seed": 3}, device="cpu")
    g = algo.gumbel((4000, 4))
    assert g.shape == (4000, 4) and torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.05      # Euler's constant
    again = DreamerV3({"seed": 3}, device="cpu").gumbel((4000, 4))
    assert torch.equal(g, again)
    params = algo.get_params_numpy()
    with pytest.raises(ValueError, match="shape"):
        algo.set_params({**params, "gru_b": np.zeros(3, np.float32)})
