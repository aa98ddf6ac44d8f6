"""The port's MoE model family against the JAX package's, on the CPU.

`moe-debug` in float32 with one parameter tree (the JAX tree moves to the
port through models.convert), inputs from numpy seeds.  `route` agrees to
1e-5 (dispatch exactly), including tokens that capacity drops and
probabilities that tie; `moe_block`, `forward`, `loss_fn` and three
`make_train_step` steps to 1e-4 (XLA and PyTorch sum the projections in
other orders).  The remat trunk recomputes the routing in the backward and
must give the same dispatch and gradients as the plain trunk."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = dict(atol=1e-4, rtol=1e-4)
ROUTE_TOL = dict(atol=1e-5, rtol=1e-5)
N_STEPS = 3
# As in tests/test_torch_train.py: Adam's first normalised steps magnify
# summation-order noise of gradient elements near zero.
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
OPT = dict(lr=1e-3, warmup=2, total_steps=10, grad_clip=0.1)


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def models():
    from ray_tpu.models import moe as jm
    from ray_tpu_torch.models import moe as tm
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jm.moe_configs()["moe-debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.moe_configs()["moe-debug"],
                               dtype=torch.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             size=(2, 65))
    return jm, tm, jcfg, tcfg, jparams, tparams, toks


def test_configs_match_jax():
    from ray_tpu.models import moe as jm
    from ray_tpu_torch.models import moe as tm

    jcs, tcs = jm.moe_configs(), tm.moe_configs()
    assert set(jcs) == set(tcs)
    for name, jc in jcs.items():
        tc = tcs[name]
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), \
                    (name, f.name)
        assert tc.num_params() == jc.num_params()
        assert tc.active_params() == jc.active_params()
        for tokens in (64, 128, 8192, 100):
            assert tm._capacity(tokens, tc) == jm._capacity(tokens, jc)


def test_param_shapes_and_axes_match_jax(models):
    jm, tm, jcfg, tcfg, jparams, tparams, _ = models
    want = {k: tuple(v.shape) for k, v in _leaves(jparams)}
    assert {k: tuple(v) for k, v in _leaves(tm.param_shapes(tcfg))} == want
    assert {k: tuple(v.shape) for k, v in _leaves(tparams)} == want
    jaxes = dict(_leaves(jm.param_logical_axes(jcfg)))
    assert dict(_leaves(tm.param_logical_axes(tcfg))) == jaxes
    init = tm.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _leaves(init)} == want


def _route_inputs(case):
    """h [64, 128] and router w [128, 4] for one routing case."""
    rng = np.random.default_rng({"random": 1, "capacity_drop": 2,
                                 "tied": 3}[case])
    h = rng.normal(size=(64, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 4)) * 0.1).astype(np.float32)
    if case == "capacity_drop":
        # Every token prefers expert 0: 64 first choices for a capacity of
        # 40, so 24 are dropped and their second choice renormalised to 1.
        h[:, 0], w[0, 0] = 5.0, 3.0
    elif case == "tied":
        # Identical router columns but for rows 0 and 1: tokens of the
        # first half tie experts 1 and 2 for second place, tokens of the
        # second half tie experts 0 and 1 for first (and 2 and 3 below).
        w[:] = w[:, :1]
        h[:, :2] = 0.0
        h[:32, 0] = h[32:, 1] = 5.0
        w[0] = (4.0, 3.0, 3.0, 0.0)
        w[1] = (3.0, 3.0, 0.0, 0.0)
    return h, w


@pytest.mark.parametrize("case", ["random", "capacity_drop", "tied"])
def test_route_matches_jax(models, case):
    jm, tm, jcfg, tcfg, *_ = models
    h, w = _route_inputs(case)
    jd, jc, ja = jax.jit(lambda h, w: jm.route(h, w, jcfg))(h, w)
    td, tc, ta = tm.route(torch.from_numpy(h), torch.from_numpy(w), tcfg)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    np.testing.assert_allclose(tc.numpy(), _np(jc), **ROUTE_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **ROUTE_TOL)
    sums = tc.numpy().sum(axis=(1, 2))
    assert ((np.abs(sums - 1.0) < 1e-5) | (sums < 1e-6)).all()
    assert (td.numpy().sum(axis=0) <= 1.0).all()      # one token a slot
    kept = td.numpy().sum()
    if case == "capacity_drop":
        assert kept == 64 * 2 - 24
    elif case == "tied":
        assert kept == 2 * 40           # experts 0 and 1 full, 48 dropped
    else:
        assert kept == 64 * 2
    if case == "tied":
        probs = torch.softmax(torch.from_numpy(h @ w), dim=-1).numpy()
        assert (probs[:32, 1] == probs[:32, 2]).all()
        assert (probs[32:, 0] == probs[32:, 1]).all()
        # The lower index wins each tie: experts 0 and 1 for every token.
        assert td.numpy()[:, 2:].sum() == 0


def test_moe_block_matches_jax(models):
    jm, tm, jcfg, tcfg, jparams, tparams, _ = models
    x = np.random.default_rng(4).normal(size=(2, 40, 128)).astype(
        np.float32)
    jlp = jax.tree.map(lambda p: p[1], jparams["layers"])
    tlp = {k: v[1] for k, v in tparams["layers"].items()}
    jy, ja = jax.jit(lambda x, lp: jm.moe_block(x, lp, jcfg))(x, jlp)
    ty, ta = tm.moe_block(torch.from_numpy(x), tlp, tcfg)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **TOL)


def test_forward_and_loss_match_jax(models):
    jm, tm, jcfg, tcfg, jparams, tparams, toks = models
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jlogits, jaux = jax.jit(lambda p, t: jm.forward(p, t, jcfg))(jparams,
                                                                  jt)
    tlogits, taux = tm.forward(tparams, tt, tcfg)
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    assert taux.item() > 0
    mask = (np.arange(64)[None, :] < np.asarray([[64], [37]])).astype(
        np.int32)
    jloss = jax.jit(lambda p, b: jm.loss_fn(p, b, jcfg))
    for jb, tb in (({"tokens": jt}, {"tokens": tt}),
                   ({"inputs": jt[:, :-1], "targets": jt[:, 1:],
                     "mask": jnp.asarray(mask)},
                    {"inputs": tt[:, :-1], "targets": tt[:, 1:],
                     "mask": torch.from_numpy(mask)})):
        np.testing.assert_allclose(tm.loss_fn(tparams, tb, tcfg).item(),
                                   float(jloss(jparams, jb)), **TOL)


def test_train_steps_match_jax(models):
    """Three steps from the same params and batch (remat flash_resid, the
    preset's): loss and pre-clip grad norm per step to 1e-4 relative,
    params after three steps within PARAM_TOL."""
    from ray_tpu.train import step as js
    from ray_tpu_torch.train import step as ts

    jm, tm, jcfg, tcfg, jparams, tparams, toks = models
    assert js.model_module(jcfg) is jm and ts.model_module(tcfg) is tm
    jopt = js.default_optimizer(**OPT)
    jstep = jax.jit(js.make_train_step(jcfg, jopt))
    jstate = js.TrainState(params=jparams, opt_state=jopt.init(jparams),
                           step=jnp.zeros((), jnp.int32))
    opt = ts.default_optimizer(**OPT)
    state = ts.create_train_state(0, tcfg, opt, device="cpu",
                                  params=tparams)
    step = ts.make_train_step(tcfg, opt, device="cpu")
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    for i in range(N_STEPS):
        jstate, jm_ = jstep(jstate, batch)
        state, m = step(state, {"tokens": toks})
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm_["grad_norm"]), rtol=1e-4)
    assert float(jm_["grad_norm"]) > OPT["grad_clip"]    # the clip engaged
    got = dict(_leaves(state.params))
    for k, w in _leaves(jstate.params):
        np.testing.assert_allclose(got[k].detach().numpy(), _np(w),
                                   **PARAM_TOL, err_msg=k)


def test_params_from_jax_carries_an_moe_tree(models):
    from ray_tpu_torch.models.convert import params_from_jax

    jm, tm, jcfg, tcfg, jparams, tparams, _ = models
    host = jax.tree.map(np.asarray, jparams)
    for k, t in _leaves(tparams):
        np.testing.assert_array_equal(t.numpy(),
                                      _np(dict(_leaves(host))[k]))
    assert "we_gate" in tparams["layers"] and "w_gate" not in \
        tparams["layers"]
    dense = dict(host, layers={k: v for k, v in host["layers"].items()
                               if k != "router"})
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(dense, tcfg, device="cpu")


@pytest.mark.parametrize("remat_mode", ["flash_resid", "nothing"])
def test_remat_trunk_matches_plain_trunk(models, monkeypatch, remat_mode):
    """Under remat the routing runs again in the backward: each layer's
    recomputed dispatch equals its forward one to the bit, and the loss
    and gradients equal the plain trunk's."""
    jm, tm, jcfg, tcfg, jparams, tparams, toks = models
    batch = {"tokens": torch.from_numpy(toks)}

    def run(cfg):
        calls = []
        plain = tm.route
        monkeypatch.setattr(tm, "route", lambda *a: calls.append(
            plain(*a)) or calls[-1])
        params = {k: {kk: vv.detach().clone().requires_grad_()
                      for kk, vv in v.items()} if isinstance(v, dict)
                  else v.detach().clone().requires_grad_()
                  for k, v in tparams.items()}
        loss = tm.loss_fn(params, batch, cfg)
        loss.backward()
        monkeypatch.setattr(tm, "route", plain)
        return loss.item(), dict(_leaves(params)), calls

    loss0, p0, calls0 = run(dataclasses.replace(tcfg, remat=False))
    cfg = dataclasses.replace(tcfg, remat=True, remat_mode=remat_mode)
    loss1, p1, calls1 = run(cfg)
    L = tcfg.n_layers
    assert len(calls0) == L and len(calls1) == 2 * L
    # Forward layers 0..L-1, then the backward recomputes L-1..0.
    for lid in range(L):
        for a, b in zip(calls1[lid], calls1[2 * L - 1 - lid]):
            assert torch.equal(a, b)
        for a, b in zip(calls0[lid], calls1[lid]):
            assert torch.equal(a, b)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(p1[k].grad.numpy(), p0[k].grad.numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
