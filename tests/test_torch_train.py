"""The port's training path against the JAX package's, on the CPU.

The `debug` preset in float32 with one parameter tree (the JAX tree moves
to the port through models.convert), inputs from numpy seeds.  Model
functions and gradients agree to 1e-4 (absolute and relative): XLA on the
CPU and PyTorch on the CPU sum the projections in different orders.  On
CPU tensors the port's attention is the plain `xla_attention`, as the
reference's dispatcher is off-TPU; the flash Function's wiring under the
remat policies is checked at the op level on CPU tensors."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = dict(atol=1e-4, rtol=1e-4)
N_STEPS = 3
# Adam divides each moment by the root of its second moment, so its first
# normalised steps magnify tiny-gradient noise: an element whose gradient
# is near zero moves by up to ~lr (1e-3 here) on the strength of its
# summation-order noise alone.  On these inputs no element sits there (the
# largest parameter difference after three steps is about 7e-6), so the
# parameters are held to 5e-5 absolute plus 1e-4 relative.
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    from ray_tpu.models import llama as jl
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    jcfg = dataclasses.replace(jl.llama_configs()["debug"],
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.llama_configs()["debug"],
                               dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_tree_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(1, 256, size=(2, 21))
    return jl, tl, jcfg, tcfg, jparams, tparams, toks


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("mask", ["none", "random", "all_zero"])
def test_cross_entropy_matches_jax(mask):
    from ray_tpu.ops.losses import cross_entropy as jce
    from ray_tpu_torch.ops.losses import cross_entropy as tce

    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, size=(3, 7))
    m = {"none": None,
         "random": rng.integers(0, 2, size=(3, 7)).astype(np.int32),
         "all_zero": np.zeros((3, 7), np.int32)}[mask]
    want = jce(jnp.asarray(logits), jnp.asarray(targets),
               None if m is None else jnp.asarray(m))
    got = tce(torch.from_numpy(logits), torch.from_numpy(targets),
              None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5,
                               rtol=1e-5)
    if mask == "all_zero":
        assert got.item() == 0.0


def test_forward_loss_and_logprobs_match_jax(models):
    jl, tl, jcfg, tcfg, jparams, tparams, toks = models
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jforward = jax.jit(lambda p, t: jl.forward(p, t, jcfg))
    jloss = jax.jit(lambda p, b: jl.loss_fn(p, b, jcfg))
    np.testing.assert_allclose(tl.forward(tparams, tt, tcfg).numpy(),
                               _np(jforward(jparams, jt)), **TOL)
    mask = (np.arange(20)[None, :] < np.asarray([[20], [13]])).astype(
        np.int32)
    for jb, tb in (({"tokens": jt}, {"tokens": tt}),
                   ({"inputs": jt[:, :-1], "targets": jt[:, 1:],
                     "mask": jnp.asarray(mask)},
                    {"inputs": tt[:, :-1], "targets": tt[:, 1:],
                     "mask": torch.from_numpy(mask)})):
        np.testing.assert_allclose(tl.loss_fn(tparams, tb, tcfg).item(),
                                   float(jloss(jparams, jb)),
                                   **TOL)
    np.testing.assert_allclose(
        tl.token_logprobs(tparams, tt, tcfg).numpy(),
        _np(jax.jit(lambda p, t: jl.token_logprobs(p, t, jcfg))(jparams,
                                                                 jt)),
        **TOL)


@pytest.fixture(scope="module")
def jax_grads(models):
    jl, tl, jcfg, tcfg, jparams, tparams, toks = models
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    return jax.jit(jax.grad(lambda p: jl.loss_fn(p, batch, jcfg)))(jparams)


@pytest.mark.parametrize("remat_mode", [None, "flash_resid", "nothing",
                                        "dots", "flash_dots"])
def test_loss_grads_match_jax_under_every_remat_mode(models, jax_grads,
                                                     remat_mode):
    """Every leaf's gradient of loss_fn, with remat off (None) and under
    each of the four remat modes: recomputation never changes the math."""
    jl, tl, jcfg, tcfg, jparams, tparams, toks = models
    cfg = dataclasses.replace(tcfg, remat=remat_mode is not None,
                              remat_mode=remat_mode or "flash_resid")
    params = _requires_grad(tparams)
    tl.loss_fn(params, {"tokens": torch.from_numpy(toks)}, cfg).backward()
    want = dict(_leaves(jax_grads))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    for k, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), _np(want[k]), **TOL,
                                   err_msg=k)


def test_remat_policy_rejects_unknown_mode(models):
    _, tl, _, tcfg, *_ = models
    with pytest.raises(ValueError, match="remat_mode"):
        tl.remat_policy(dataclasses.replace(tcfg, remat_mode="all"))


@pytest.mark.parametrize("remat_mode,fwd_calls", [
    ("flash_resid", 1), ("nothing", 2), ("dots", 2), ("flash_dots", 1)])
def test_flash_function_forward_calls_under_remat(models, monkeypatch,
                                                  remat_mode, fwd_calls):
    """The port of tests/test_ops.py:68-100 at the op level on CPU tensors:
    a checkpointed projection + flash attention runs the flash forward once
    under flash_resid / flash_dots (its (o, lse) are saved) and twice under
    nothing / dots (the backward recomputes it), with the gradients of the
    uncheckpointed call either way."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)

    from ray_tpu_torch.ops import flash_attention as fa

    _, tl, _, tcfg, *_ = models
    calls = []
    plain = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 24, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32)
                         * 0.1).requires_grad_()

    def f(w):
        qkv = (x @ w).reshape(2, 24, 8, 32)
        o = fa.flash_attention(qkv[:, :, :4], qkv[:, :, 4:6],
                               qkv[:, :, 6:])
        return (o * torch.arange(32.0)).sum()

    f(w).backward()
    want = w.grad.clone()
    w.grad = None
    calls.clear()
    policy = tl.remat_policy(dataclasses.replace(tcfg,
                                                 remat_mode=remat_mode))
    checkpoint(f, w, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, policy)).backward()
    assert len(calls) == fwd_calls
    np.testing.assert_allclose(w.grad.numpy(), want.numpy(), atol=1e-5)


def test_schedule_matches_optax():
    import optax

    from ray_tpu_torch.train.step import default_optimizer

    for lr, warmup, total in ((1e-3, 2, 10), (3e-4, 100, 1000),
                              (1e-2, 0, 5), (5e-4, 7, 3)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, max(total, warmup + 1), end_value=lr * 0.1)
        opt = default_optimizer(lr=lr, warmup=warmup, total_steps=total)
        counts = range(0, max(total, warmup) + 5)
        # optax evaluates the schedule in f32; the port in Python floats.
        np.testing.assert_allclose([opt.schedule(c) for c in counts],
                                   [float(sched(c)) for c in counts],
                                   rtol=1e-5, atol=1e-12)


@pytest.fixture(scope="module")
def jax_run(models):
    """N_STEPS reference steps (jitted once), the state after each kept."""
    from ray_tpu.train import step as js

    jl, tl, jcfg, tcfg, jparams, tparams, toks = models
    opt = js.default_optimizer(lr=1e-3, warmup=2, total_steps=10,
                               grad_clip=0.1)
    step = jax.jit(js.make_train_step(jcfg, opt))
    state = js.TrainState(params=jparams, opt_state=opt.init(jparams),
                          step=jnp.zeros((), jnp.int32))
    batch = {"tokens": jnp.asarray(toks, jnp.int32)}
    states, metrics = [state], []
    for _ in range(N_STEPS):
        state, m = step(state, batch)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics, step, batch


def _assert_params_close(got: dict, want, what: str):
    got = dict(_leaves(got))
    for k, w in _leaves(want):
        np.testing.assert_allclose(got[k].detach().numpy(), _np(w),
                                   **PARAM_TOL, err_msg=f"{what}: {k}")


def test_train_steps_match_jax(models, jax_run):
    """Three steps from the same params and batch: loss and pre-clip
    grad_norm per step to 1e-4 relative (the clip engages: grad_clip 0.1),
    the first update at lr 0 leaves the params as they were, the params
    after three steps within PARAM_TOL."""
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    jl, tl, jcfg, tcfg, jparams, tparams, toks = models
    states, metrics, _, _ = jax_run
    opt = default_optimizer(lr=1e-3, warmup=2, total_steps=10,
                            grad_clip=0.1)
    state = create_train_state(0, tcfg, opt, device="cpu", params=tparams)
    step = make_train_step(tcfg, opt, device="cpu")
    for i in range(N_STEPS):
        state, m = step(state, {"tokens": toks})
        assert m["step"] == i + 1 == state.step
        np.testing.assert_allclose(m["loss"].item(), metrics[i]["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   metrics[i]["grad_norm"], rtol=1e-4)
        assert metrics[i]["grad_norm"] > 0.1          # the clip engaged
        if i == 0:
            for k, p in _leaves(state.params):
                np.testing.assert_array_equal(
                    p.detach().numpy(), dict(_leaves(tparams))[k].numpy())
    _assert_params_close(state.params, states[-1].params, "after 3 steps")


def test_train_state_from_jax_continues_the_run(models, jax_run):
    """Two reference steps, conversion of params + AdamW moments + count,
    then one more step on each side."""
    from ray_tpu_torch.models.convert import train_state_from_jax
    from ray_tpu_torch.train.step import default_optimizer, make_train_step

    jl, tl, jcfg, tcfg, jparams, tparams, toks = models
    states, metrics, jstep, jbatch = jax_run
    adam = states[2].opt_state[1][0]            # chain(clip, adamw)[1][0]
    tree = {"params": _tree_np(states[2].params), "mu": _tree_np(adam.mu),
            "nu": _tree_np(adam.nu), "count": np.asarray(adam.count),
            "step": np.asarray(states[2].step)}
    opt = default_optimizer(lr=1e-3, warmup=2, total_steps=10,
                            grad_clip=0.1)
    state = train_state_from_jax(tree, tcfg, opt, device="cpu")
    assert state.step == 2
    state, m = make_train_step(tcfg, opt, device="cpu")(
        state, {"tokens": toks})
    assert m["step"] == 3
    np.testing.assert_allclose(m["loss"].item(), metrics[2]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               metrics[2]["grad_norm"], rtol=1e-4)
    _assert_params_close(state.params, states[3].params, "converted run")
