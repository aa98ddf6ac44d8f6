"""The port's vision family (ViT, ResNet) against the JAX package's, on
the CPU.

`vit-debug` and `resnet-debug` in float32, one parameter tree per family
(the JAX tree moves to the port through models.convert), images and
labels from numpy seeds.  `patchify` is a relayout and agrees exactly;
forward logits agree to 1e-5, `loss_fn` and its gradients to 1e-4 (of
each leaf's largest gradient), three steps of `make_train_step` with
`default_optimizer` on a hand-built TrainState (the reference's
`create_train_state` builds Llama models only) to 1e-4 in loss and
pre-clip gradient norm, with the first step's gradients held rather than
the parameters after Adam (ROADMAP, "Parity method").  XLA "SAME"
padding (asymmetric at stride 2), the -inf max-pool edge, ResNet's
strided-slice shortcut and the leaf dtypes of bf16 trees are held on
their own.  On CPU tensors ViT's attention is the plain `xla_attention`,
as the reference's dispatcher is off the TPU."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
N_STEPS = 3
OPT = dict(lr=1e-3, warmup=1, total_steps=100)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(seed, n, size, n_classes):
    rng = np.random.default_rng(seed)
    return {"images": rng.normal(size=(n, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, n_classes, size=(n,)).astype(np.int32)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads_close(got: dict, want: dict, rel=1e-4):
    """Each leaf within `rel` of its own largest reference gradient."""
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[path]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (path, err, scale)


@dataclasses.dataclass
class Family:
    name: str
    jmod: object
    tmod: object
    jcfg: object
    tcfg: object
    jparams: dict
    tparams: dict
    batch: dict


def _trees(tmod, tcfg, convert, seed):
    """One tree for both sides: the port's init from a seeded generator,
    every leaf moved by 0.05 normal noise (so norm scales and biases are
    not the constants init gives them), as numpy; the JAX side takes it
    as arrays, the port's through the converter."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda t: (t.float().numpy() + 0.05 * rng.normal(size=t.shape))
        .astype(np.float32),
        tmod.init_params(tcfg, torch.Generator().manual_seed(seed)))
    return jax.tree.map(jnp.asarray, tree), convert(tree, tcfg, "cpu")


def _vit():
    from ray_tpu.models import vit as jv
    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.models.convert import vit_params_from_jax

    jcfg = dataclasses.replace(jv.vit_configs()["vit-debug"],
                               dtype="float32")
    tcfg = dataclasses.replace(tv.vit_configs()["vit-debug"],
                               dtype=torch.float32)
    return Family("vit", jv, tv, jcfg, tcfg,
                  *_trees(tv, tcfg, vit_params_from_jax, 0),
                  _batch(1, 4, jcfg.image_size, jcfg.n_classes))


def _resnet():
    from ray_tpu.models import resnet as jr
    from ray_tpu_torch.models import resnet as tr
    from ray_tpu_torch.models.convert import resnet_params_from_jax

    jcfg = jr.resnet_configs()["resnet-debug"]
    tcfg = tr.resnet_configs()["resnet-debug"]
    # 33 x 33: odd at every stride-2 layer, so both "SAME" paddings occur.
    return Family("resnet", jr, tr, jcfg, tcfg,
                  *_trees(tr, tcfg, resnet_params_from_jax, 1),
                  _batch(2, 4, 33, jcfg.num_classes))


@pytest.fixture(scope="module", params=["vit", "resnet"])
def fam(request):
    return {"vit": _vit, "resnet": _resnet}[request.param]()


@pytest.fixture(scope="module")
def jax_grads(fam):
    """The reference's loss and gradients at the family's params."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: fam.jmod.loss_fn(p, b, fam.jcfg)))(
            fam.jparams, _jax_batch(fam.batch))


# ---------------------------------------------------------------- forward
def test_patchify_matches_jax():
    from ray_tpu.models import vit as jv
    from ray_tpu_torch.models import vit as tv

    cfg = jv.vit_configs()["vit-debug"]
    tcfg = tv.vit_configs()["vit-debug"]
    images = _batch(3, 2, cfg.image_size, 10)["images"]
    want = np.asarray(jv.patchify(jnp.asarray(images), cfg))
    got = tv.patchify(torch.from_numpy(images), tcfg)
    assert got.shape == (2, tcfg.n_patches, 8 * 8 * 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_matches_jax(fam):
    want = np.asarray(jax.jit(
        lambda p, im: fam.jmod.forward(p, im, fam.jcfg))(
            fam.jparams, jnp.asarray(fam.batch["images"])))
    got = fam.tmod.forward(fam.tparams,
                           torch.from_numpy(fam.batch["images"]), fam.tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)


def test_loss_and_grads_match_jax(fam, jax_grads):
    want_loss, want_grads = jax_grads
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          fam.tparams)
    loss = fam.tmod.loss_fn(params, _torch_batch(fam.batch), fam.tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               **TOL)
    _assert_grads_close(jax.tree.map(lambda t: t.grad, params), want_grads)


def _jax_steps(fam):
    """The reference's make_train_step(cfg, default_optimizer(...),
    family.loss_fn) from a hand-built TrainState: each step's loss and
    pre-clip gradient norm."""
    from ray_tpu.train import step as js

    opt = js.default_optimizer(**OPT)
    state = js.TrainState(params=fam.jparams,
                          opt_state=opt.init(fam.jparams),
                          step=jnp.zeros((), jnp.int32))
    step = jax.jit(js.make_train_step(fam.jcfg, opt, fam.jmod.loss_fn))
    batch = _jax_batch(fam.batch)
    metrics = []
    for _ in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics


def test_train_steps_match_jax(fam, jax_grads):
    from ray_tpu_torch.train import step as ts

    want, want_grads = _jax_steps(fam), jax_grads[1]
    opt = ts.default_optimizer(**OPT)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          fam.tparams)
    # A vision TrainState by hand, as the reference's caller builds one:
    # create_train_state would cast every leaf to cfg.dtype.
    state = ts.TrainState(params=params, opt_state=opt.init(params), step=0)
    step = ts.make_train_step(fam.tcfg, opt, fam.tmod.loss_fn, device="cpu")
    got, first_grads = [], None
    for i in range(N_STEPS):
        state, m = step(state, _torch_batch(fam.batch))
        got.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            # .grad holds the clipped gradient: undo the clip's scale.
            scale = max(1.0, got[0][1] / 1.0)
            first_grads = jax.tree.map(
                lambda t: t.grad.detach().numpy() * scale, params)
    np.testing.assert_allclose(got, want, **TOL)
    assert want[0][1] > 1.0                       # the clip engaged
    assert state.step == N_STEPS
    _assert_grads_close(first_grads, want_grads)


def test_model_module_refuses_vision_configs():
    """create_train_state picks a family with model_module, which knows
    the decoders only: a vision config raises rather than build a
    Llama model from it (the reference's model_module would)."""
    from ray_tpu_torch.models import resnet, vit
    from ray_tpu_torch.train.step import model_module

    for cfg in (vit.vit_configs()["vit-debug"],
                resnet.resnet_configs()["resnet-debug"]):
        with pytest.raises(TypeError, match="no ported model family"):
            model_module(cfg)


# ------------------------------------------------------- ResNet's edges
@pytest.mark.parametrize("size,k,stride", [
    (33, 7, 2), (32, 7, 2), (17, 3, 2), (16, 3, 2), (9, 1, 2), (8, 1, 2),
    (11, 3, 1)])
def test_conv_same_padding_matches_xla(size, k, stride):
    """XLA's "SAME": low = total // 2, high the rest (asymmetric at
    stride 2 on even sizes for odd kernels)."""
    from ray_tpu.models import resnet as jr
    from ray_tpu_torch.models import resnet as tr

    rng = np.random.default_rng(size * 10 + k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jr._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tr._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("size", [16, 17])
def test_max_pool_pads_with_minus_inf(size):
    """The stem's 3x3/2 "SAME" max pool on all-negative inputs: a zero
    pad would win at the edge, -inf never does."""
    from jax import lax

    from ray_tpu_torch.models import resnet as tr

    x = -1.0 - np.random.default_rng(size).random(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(lax.reduce_window(
        jnp.asarray(x), -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = tr._max_pool(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() < 0).all()


def test_group_norm_matches_jax():
    from ray_tpu.models import resnet as jr
    from ray_tpu_torch.models import resnet as tr

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 6, 16)).astype(np.float32) * 3 + 1
    s, b = (rng.normal(size=(16,)).astype(np.float32) for _ in range(2))
    for groups in (4, 32):                        # 32 > C: g = min(32, C)
        want = np.asarray(jr._group_norm(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(b), groups))
        got = tr._group_norm(torch.from_numpy(x), torch.from_numpy(s),
                             torch.from_numpy(b), groups)
        np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_strided_slice_shortcut():
    """resnet-debug's stage 2 keeps width 16 at stride 2: its first block
    has no projection and takes x[:, ::2, ::2, :] as the shortcut, on an
    odd input too."""
    from ray_tpu_torch.models import resnet as tr

    cfg = tr.resnet_configs()["resnet-debug"]
    blocks = {(si, bi): (stride, cin, width)
              for si, bi, stride, cin, width in tr._blocks(cfg)}
    assert blocks[(2, 0)] == (2, 16, 16)
    shapes = tr.param_shapes(cfg)
    assert "w_proj" not in shapes["stage2_block0"]
    assert "w_proj" in shapes["stage1_block0"]       # 8 -> 16
    # The whole forward over it is held by test_forward_matches_jax; here
    # the shortcut's shape meets the strided conv's on odd sizes.
    for size in (7, 8):
        x = torch.randn(1, size, size, 16)
        h = tr._conv(x, torch.randn(3, 3, 16, 16), stride=2)
        assert h.shape == x[:, ::2, ::2, :].shape


# ----------------------------------------------------------- leaf dtypes
def test_bf16_trees_keep_f32_leaves():
    """A bf16 ResNet keeps every leaf f32 (master weights); a bf16 ViT
    keeps `head_bias` f32; the converters keep each leaf's dtype, as the
    reference's init gives it (read with eval_shape)."""
    import ml_dtypes

    from ray_tpu.models import resnet as jr
    from ray_tpu.models import vit as jv
    from ray_tpu_torch.models import resnet as tr
    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.models.convert import (resnet_params_from_jax,
                                              vit_params_from_jax)

    def reference_tree(init, cfg):
        """Zeros of the reference init's shapes and dtypes (numpy, bf16
        as ml_dtypes)."""
        spec = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
        return jax.tree.map(lambda s: np.zeros(s.shape, {
            "bfloat16": ml_dtypes.bfloat16}.get(str(s.dtype), s.dtype)),
            spec)

    rcfg = dataclasses.replace(tr.resnet_configs()["resnet-debug"],
                               dtype=torch.bfloat16)
    jrcfg = dataclasses.replace(jr.resnet_configs()["resnet-debug"],
                                dtype=jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for tree in (tr.init_params(rcfg, gen), resnet_params_from_jax(
            reference_tree(jr.init_params, jrcfg), rcfg, "cpu")):
        assert {t.dtype for _, t in _leaves(tree)} == {torch.float32}
    logits = tr.forward(tr.init_params(rcfg, gen),
                        torch.randn(1, 16, 16, 3), rcfg)
    assert logits.dtype == torch.float32

    vcfg = tv.vit_configs()["vit-debug"]
    ref = reference_tree(jv.init_params, jv.vit_configs()["vit-debug"])
    assert str(ref["head_bias"].dtype) == "float32"
    for tree in (tv.init_params(vcfg, gen),
                 vit_params_from_jax(ref, vcfg, "cpu")):
        dtypes = {p: t.dtype for p, t in _leaves(tree)}
        assert dtypes.pop("/head_bias") == torch.float32
        assert set(dtypes.values()) == {torch.bfloat16}


def test_shapes_and_sizes_match_jax():
    """param_shapes and num_params against the reference's init (shapes
    only), at the published sizes."""
    from ray_tpu.models import resnet as jr
    from ray_tpu.models import vit as jv
    from ray_tpu_torch.models import resnet as tr
    from ray_tpu_torch.models import vit as tv

    for name in ("resnet18", "resnet34", "resnet-debug"):
        jcfg, tcfg = jr.resnet_configs()[name], tr.resnet_configs()[name]
        shapes = jax.eval_shape(lambda: jr.init_params(
            jax.random.PRNGKey(0), jcfg))
        assert {p: tuple(s.shape) for p, s in _leaves(shapes)} == dict(
            _leaves(tr.param_shapes(tcfg)))
        assert tcfg.num_params() == jcfg.num_params()
    for name in ("vit-b16", "vit-l16", "vit-debug"):
        jcfg, tcfg = jv.vit_configs()[name], tv.vit_configs()[name]
        shapes = jax.eval_shape(lambda: jv.init_params(
            jax.random.PRNGKey(0), jcfg))
        assert {p: tuple(s.shape) for p, s in _leaves(shapes)} == dict(
            _leaves(tv.param_shapes(tcfg)))
        assert (tcfg.head_dim, tcfg.n_patches) == (jcfg.head_dim,
                                                   jcfg.n_patches)
        assert tcfg.num_params() == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
