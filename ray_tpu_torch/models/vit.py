"""Vision Transformer, the attention-based vision family (port of
ray_tpu/models/vit.py).

Parameters keep the reference's tree: the same keys, shapes and stacked
[n_layers, ...] layer axis, and each leaf's own dtype (the tree is in
`cfg.dtype` except `head_bias`, which is f32), so models/convert.py moves
a JAX tree over unchanged.  Layers run as a Python loop over that axis.

- Patchify is a reshape and a transpose, then one matmul with
  `patch_embed`: [b, H, W, C] -> [b, nP, P*P*C] with the features in (p,
  p, c) order.  `F.unfold` orders them (c, p, p) and is not used.
- Attention is non-causal through ops.attention: the flash kernels on
  CUDA (ViT-B/16 and ViT-L/16 have head_dim 64; `vit-debug`'s 16 has no
  kernel and raises there), the plain version on the CPU.
- `cfg.remat` checkpoints each layer whole (torch.utils.checkpoint, the
  reference's jax.checkpoint with no policy): the backward re-runs each
  layer's forward, flash forward kernel included.
- On DTensor parameters laid out by `param_logical_axes` the encoder
  constrains its activations where the reference does
  (parallel/sharding.py; plain tensors pass through).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.losses import cross_entropy
from ray_tpu_torch.ops.norms import layernorm
from ray_tpu_torch.parallel.sharding import with_sharding_constraint

LAYER_KEYS = ("ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "ln2_scale",
              "ln2_bias", "w_up", "b_up", "w_down", "b_down")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    n_classes: int = 1000
    norm_eps: float = 1e-6
    remat: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def num_params(self) -> int:
        return _count(param_shapes(self))

    def forward_flops(self) -> float:
        """FLOPs of one image's forward pass: 2 m n k per product (patch
        embedding, q/k/v/o, the MLP, the head) and 4 s^2 d per attention
        layer (scores and values); norms and elementwise ops left out."""
        s, d, m = self.n_patches + 1, self.dim, self.mlp_dim
        patch_dim = self.patch_size ** 2 * self.channels
        per_layer = 2 * s * (4 * d * d + 2 * d * m) + 4 * s * s * d
        return (2 * self.n_patches * patch_dim * d
                + self.n_layers * per_layer + 2 * d * self.n_classes)


def _count(shapes) -> int:
    """Elements in a tree of shapes."""
    if isinstance(shapes, dict):
        return sum(_count(v) for v in shapes.values())
    return math.prod(shapes)


def vit_configs() -> dict:
    """Named sizes (ViT-B/16 et al.; debug size for tests)."""
    return {
        "vit-debug": ViTConfig(image_size=32, patch_size=8, dim=64,
                               n_layers=2, n_heads=4, mlp_dim=128,
                               n_classes=10),
        "vit-b16": ViTConfig(),
        "vit-l16": ViTConfig(dim=1024, n_layers=24, n_heads=16,
                             mlp_dim=4096),
    }


def param_shapes(cfg: ViTConfig) -> dict:
    """Shape of every leaf, in the reference's tree layout."""
    d, L, m = cfg.dim, cfg.n_layers, cfg.mlp_dim
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels
    return {
        "patch_embed": (patch_dim, d),
        "pos_embed": (cfg.n_patches + 1, d),
        "cls_token": (d,),
        "layers": {
            "ln1_scale": (L, d), "ln1_bias": (L, d),
            "wq": (L, d, d), "wk": (L, d, d), "wv": (L, d, d),
            "wo": (L, d, d),
            "ln2_scale": (L, d), "ln2_bias": (L, d),
            "w_up": (L, d, m), "b_up": (L, m),
            "w_down": (L, m, d), "b_down": (L, d),
        },
        "final_ln_scale": (d,),
        "final_ln_bias": (d,),
        "head": (d, cfg.n_classes),
        "head_bias": (cfg.n_classes,),
    }


def param_logical_axes(cfg: ViTConfig) -> dict:
    return {
        "patch_embed": (None, "embed"),
        "pos_embed": (None, "embed"),
        "cls_token": (None,),
        "layers": {
            "ln1_scale": ("layers", None),
            "ln1_bias": ("layers", None),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "heads"),
            "wv": ("layers", "embed", "heads"),
            "wo": ("layers", "heads", "embed"),
            "ln2_scale": ("layers", None),
            "ln2_bias": ("layers", None),
            "w_up": ("layers", "embed", "mlp"),
            "b_up": ("layers", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
            "b_down": ("layers", None),
        },
        "final_ln_scale": (None,),
        "final_ln_bias": (None,),
        "head": ("embed", None),
        "head_bias": (None,),
    }


def init_params(cfg: ViTConfig, generator: torch.Generator) -> dict:
    """Random weights on the generator's device: normal / sqrt(fan_in)
    drawn in f32 and cast, norm scales at one, biases and the class token
    at zero; `head_bias` f32, every other leaf in cfg.dtype."""
    device = generator.device
    d, m = cfg.dim, cfg.mlp_dim
    shapes = param_shapes(cfg)

    def normal(name, fan_in, tree=shapes):
        return (torch.randn(tree[name], generator=generator, device=device)
                * fan_in ** -0.5).to(cfg.dtype)

    def const(value, shape, dtype=cfg.dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    ls = shapes["layers"]
    patch_dim = shapes["patch_embed"][0]
    return {
        "patch_embed": normal("patch_embed", patch_dim),
        "pos_embed": normal("pos_embed", d),
        "cls_token": const(0.0, shapes["cls_token"]),
        "layers": {
            "ln1_scale": const(1.0, ls["ln1_scale"]),
            "ln1_bias": const(0.0, ls["ln1_bias"]),
            "wq": normal("wq", d, ls), "wk": normal("wk", d, ls),
            "wv": normal("wv", d, ls), "wo": normal("wo", d, ls),
            "ln2_scale": const(1.0, ls["ln2_scale"]),
            "ln2_bias": const(0.0, ls["ln2_bias"]),
            "w_up": normal("w_up", d, ls),
            "b_up": const(0.0, ls["b_up"]),
            "w_down": normal("w_down", m, ls),
            "b_down": const(0.0, ls["b_down"]),
        },
        "final_ln_scale": const(1.0, shapes["final_ln_scale"]),
        "final_ln_bias": const(0.0, shapes["final_ln_bias"]),
        "head": normal("head", d),
        "head_bias": const(0.0, shapes["head_bias"], torch.float32),
    }


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[b, H, W, C] -> [b, n_patches, P*P*C]: patches in row-major grid
    order, each patch's features in (row, column, channel) order."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)              # [b, gh, gw, p, p, c]
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _encoder_block(x, lp, cfg: ViTConfig):
    b, s, d = x.shape
    h = layernorm(x, lp["ln1_scale"], lp["ln1_bias"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    # On a mesh attention runs on each rank's shards: q, k and v laid out
    # alike, batch and heads split (a no-op on plain tensors).
    q, k, v = (with_sharding_constraint(t, ("batch", "seq", "heads", None))
               for t in (q, k, v))
    o = attention(q, k, v, causal=False)
    x = x + (o.reshape(b, s, d) @ lp["wo"])
    h = layernorm(x, lp["ln2_scale"], lp["ln2_bias"], cfg.norm_eps)
    h = F.gelu((h @ lp["w_up"] + lp["b_up"]).float(),
               approximate="tanh").to(x.dtype)      # jax.nn.gelu's default
    h = with_sharding_constraint(h, ("batch", "seq", "mlp"))
    return x + ((h @ lp["w_down"]) + lp["b_down"])


def forward(params: dict, images: torch.Tensor, cfg: ViTConfig
            ) -> torch.Tensor:
    """images [b, H, W, C] float -> logits [b, n_classes] float32."""
    b = images.shape[0]
    x = patchify(images.to(cfg.dtype), cfg) @ params["patch_embed"]
    cls = params["cls_token"].expand(b, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    x = with_sharding_constraint(x, ("batch", "seq", None))

    def layer(x, *leaves):
        out = _encoder_block(x, dict(zip(LAYER_KEYS, leaves)), cfg)
        return with_sharding_constraint(out, ("batch", "seq", None))

    stacked = [params["layers"][k].unbind(0) for k in LAYER_KEYS]
    for lid in range(cfg.n_layers):
        leaves = [t[lid] for t in stacked]
        if cfg.remat:
            x = checkpoint(layer, x, *leaves, use_reentrant=False)
        else:
            x = layer(x, *leaves)
    x = layernorm(x, params["final_ln_scale"], params["final_ln_bias"],
                  cfg.norm_eps)
    cls_out = x[:, 0, :]
    return (cls_out @ params["head"]).float() + params["head_bias"]


def loss_fn(params: dict, batch: dict, cfg: ViTConfig) -> torch.Tensor:
    """Softmax cross entropy; batch = {"images": [b, H, W, C], "labels":
    [b] int}."""
    logits = forward(params, batch["images"], cfg)
    return cross_entropy(logits, batch["labels"])
