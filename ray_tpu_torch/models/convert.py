"""Move a JAX-package parameter tree, a LoRA adapter, or a whole training
state, into the port.

The caller turns each leaf into a numpy array (`np.asarray(leaf)`), so
this module needs no JAX.  Keys, shapes and the stacked layer axis stay
as they are; decoder leaves are cast to the config's dtype on `device`,
vision leaves keep their own dtype (ViT's f32 `head_bias`, ResNet's f32
tree).
"""
from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import resnet, vit
from ray_tpu_torch.models.llama import LlamaConfig, lora_target_dims
from ray_tpu_torch.train.step import (ClippedAdamW, TrainState,
                                      create_train_state, model_module,
                                      param_leaves)


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr)                     # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bf16: reinterpret
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is, anything else (numpy, ml_dtypes bf16 included)
    as a CPU tensor copy."""
    return x if isinstance(x, torch.Tensor) else _tensor(x)


def _convert(src, shapes, device, dtype, path=""):
    """`src`'s leaves as tensors on `device`, checked against the shape
    tree `shapes` key by key; cast to `dtype`, or kept in their own dtype
    when it is None."""
    if isinstance(shapes, dict):
        if not isinstance(src, dict) or set(src) != set(shapes):
            got = sorted(src) if isinstance(src, dict) else type(src)
            raise ValueError(f"{path or 'params'}: keys {got} != "
                             f"{sorted(shapes)}")
        return {k: _convert(src[k], shapes[k], device, dtype, f"{path}/{k}")
                for k in shapes}
    t = _tensor(src)
    if tuple(t.shape) != tuple(shapes):
        raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                         f"{tuple(shapes)}")
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: dict, cfg: LlamaConfig, device="cuda") -> dict:
    """The port's parameter tree from the reference's (numpy leaves), for
    the config's model family (llama or moe)."""
    return _convert(tree, model_module(cfg).param_shapes(cfg), device,
                    cfg.dtype)


def vit_params_from_jax(tree: dict, cfg: vit.ViTConfig,
                        device="cuda") -> dict:
    """The port's ViT tree from the reference's (numpy leaves), each leaf
    in its own dtype (the tree's, and f32 for `head_bias`)."""
    return _convert(tree, vit.param_shapes(cfg), device, None)


def resnet_params_from_jax(tree: dict, cfg: resnet.ResNetConfig,
                           device="cuda") -> dict:
    """The port's ResNet tree from the reference's (numpy leaves), each
    leaf in its own dtype (f32 in the reference's tree, whatever
    cfg.dtype is)."""
    return _convert(tree, resnet.param_shapes(cfg), device, None)


def dreamer_params_from_jax(tree: dict, device=None) -> dict:
    """The port's DreamerV3 tree from the reference's
    `dreamer_params_init` tree (numpy leaves): the same keys and shapes
    (the widths read off the tree), f32 on `device` (cuda by default)."""
    from ray_tpu_torch.rl.dreamerv3 import param_shapes

    device = resolve_device(device, "dreamer_params_from_jax")
    try:
        dims = dict(obs_dim=np.shape(tree["enc"]["w0"])[0],
                    n_actions=np.shape(tree["actor"]["w1"])[1],
                    deter=np.shape(tree["gru_b"])[0] // 3,
                    stoch=np.shape(tree["prior"]["w1"])[1],
                    hidden=np.shape(tree["enc"]["w0"])[1])
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(f"not a DreamerV3 tree: {e!r}") from None
    return _convert(tree, param_shapes(**dims), device, torch.float32)


def lora_adapter_from_jax(adapter: dict, cfg: LlamaConfig,
                          device="cuda") -> dict:
    """The port's adapter from the reference's {"rank", "targets": {t:
    {"a": [L, din, r], "b": [L, r, dout]}}} (numpy leaves), in the
    config's dtype on `device`."""
    dims = lora_target_dims(cfg)
    out = {}
    for t, ab in adapter["targets"].items():
        if t not in dims:
            raise ValueError(f"unknown lora target {t!r}; valid: "
                             f"{sorted(dims)}")
        a, b = _tensor(ab["a"]), _tensor(ab["b"])
        din, dout = dims[t]
        if (a.dim() != 3 or b.dim() != 3
                or tuple(a.shape[:2]) != (cfg.n_layers, din)
                or b.shape[0] != cfg.n_layers or b.shape[2] != dout
                or a.shape[2] != b.shape[1]):
            raise ValueError(f"lora target {t!r}: shapes {tuple(a.shape)} / "
                             f"{tuple(b.shape)} do not fit the config")
        out[t] = {"a": a.to(device=device, dtype=cfg.dtype),
                  "b": b.to(device=device, dtype=cfg.dtype)}
    return {"rank": int(adapter.get("rank") or 0), "targets": out}


def train_state_from_jax(tree: dict, cfg: LlamaConfig,
                         optimizer: ClippedAdamW, device=None) -> TrainState:
    """A port TrainState that continues the reference's run.

    `tree` holds numpy leaves: "params", the AdamW moments "mu" and "nu"
    (trees shaped like params, taken from optax's ScaleByAdamState), the
    optimizer's update "count" and the TrainState "step".  The next update
    reads the schedule at `count` and bias-corrects with count + 1, as
    optax does."""
    device = resolve_device(device, "train_state_from_jax")
    state = create_train_state(0, cfg, optimizer, device=device,
                               params=params_from_jax(tree["params"], cfg,
                                                      device))
    count = torch.tensor(float(np.asarray(tree["count"])))
    moments = [param_leaves(params_from_jax(tree[k], cfg, device))
               for k in ("mu", "nu")]
    for p, mu, nu in zip(param_leaves(state.params), *moments):
        state.opt_state.state[p] = {"step": count.clone(), "exp_avg": mu,
                                    "exp_avg_sq": nu}
    state.step = int(np.asarray(tree["step"]))
    return state


def _adam_state(opt_state):
    """The ScaleByAdamState (mu, nu, count) inside optax.adam's chain
    state."""
    for sub in opt_state if isinstance(opt_state, (list, tuple)) else ():
        if all(hasattr(sub, k) for k in ("mu", "nu", "count")):
            return sub
    raise ValueError("no Adam state (mu, nu, count) in the optimizer state")


def grpo_state_from_jax(tree: dict, cfg: LlamaConfig, device=None) -> dict:
    """A GRPOLearner state (`GRPOLearner.load_state`) that continues the
    reference learner's run.

    `tree` is the reference learner's state as its checkpoints hold it,
    with numpy leaves: "params", "opt_state" (optax.adam's chain state, a
    tuple around a ScaleByAdamState) and "version".  Returns {"params",
    "opt_state": {"mu", "nu", "count"}, "version"} as tensors on `device`
    (cuda by default) in the config's dtype."""
    device = resolve_device(device, "grpo_state_from_jax")
    adam = _adam_state(tree["opt_state"])
    return {"params": params_from_jax(tree["params"], cfg, device),
            "opt_state": {"mu": params_from_jax(adam.mu, cfg, device),
                          "nu": params_from_jax(adam.nu, cfg, device),
                          "count": torch.tensor(
                              float(np.asarray(adam.count)))},
            "version": int(np.asarray(tree["version"]))}
