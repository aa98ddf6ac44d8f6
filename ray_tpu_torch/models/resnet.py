"""ResNet image classifier, the convolutional vision family (port of
ray_tpu/models/resnet.py).

The API takes NHWC images, and the parameter tree is the reference's:
the same keys, HWIO conv weights, and every leaf in f32 whatever
`cfg.dtype` is (the reference's initialisers default to f32).  Weights are
cast to the activation dtype where they are used, so a bf16 ResNet trains
f32 master weights.

Layout on the device: activations stay NHWC tensors.  A convolution views
its input as NCHW (a permute, no copy: the NHWC tensor is NCHW in the
channels-last memory format) and runs `F.conv2d`, the matching level for
the reference's `lax.conv_general_dilated` (an XLA op, not a Pallas
kernel; cuDNN on CUDA).

Padding follows XLA's "SAME": the output has ceil(in / stride) rows, the
total padding is what that needs, and the low side takes total // 2, the
high side the rest.  At stride 2 that is asymmetric (the 7x7/2 stem on 224
pads (2, 3), a 3x3/2 conv on 56 pads (0, 1)), which `F.conv2d`'s
symmetric padding cannot give, so such inputs are padded with `F.pad`
first.  The stem's 3x3/2 max pool pads the same way with -inf.

GroupNorm (in place of BatchNorm, as in the reference) runs in f32 over
contiguous channel groups with the population variance, then casts to
the activation dtype.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops.losses import cross_entropy


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    # Stage widths and block counts; resnet18 = (2,2,2,2) basic blocks.
    widths: tuple = (64, 128, 256, 512)
    depths: tuple = (2, 2, 2, 2)
    groups: int = 32               # GroupNorm groups
    dtype: torch.dtype = torch.bfloat16

    def num_params(self) -> int:
        return _count(param_shapes(self))

    def forward_flops(self, image_size: int) -> float:
        """FLOPs of one image's forward pass at image_size x image_size:
        2 m n k per convolution (output pixels x cout x kh kw cin) and for
        the head; norms, pooling and elementwise ops left out."""
        def out(n, stride):
            return -(-n // stride)

        total = 0
        h = out(image_size, 2)                         # the 7x7/2 stem
        total += 2 * h * h * self.widths[0] * 7 * 7 * 3
        h = out(h, 2)                                  # the 3x3/2 max pool
        for _, _, stride, cin, width in _blocks(self):
            h = out(h, stride)
            total += 2 * h * h * width * 9 * (cin + width)
            if cin != width:
                total += 2 * h * h * width * cin
        return total + 2 * self.widths[-1] * self.num_classes


def _count(shapes) -> int:
    """Elements in a tree of shapes."""
    if isinstance(shapes, dict):
        return sum(_count(v) for v in shapes.values())
    return math.prod(shapes)


def resnet_configs() -> dict[str, ResNetConfig]:
    return {
        "resnet18": ResNetConfig(depths=(2, 2, 2, 2)),
        "resnet34": ResNetConfig(depths=(3, 4, 6, 3)),
        "resnet-debug": ResNetConfig(num_classes=10, widths=(8, 16, 16, 32),
                                     depths=(1, 1, 1, 1), groups=4,
                                     dtype=torch.float32),
    }


def _blocks(cfg: ResNetConfig):
    """(stage, block, stride, cin, width) of every residual block."""
    cin = cfg.widths[0]
    for si, (width, depth) in enumerate(zip(cfg.widths, cfg.depths)):
        for bi in range(depth):
            yield si, bi, 2 if (bi == 0 and si > 0) else 1, cin, width
            cin = width


def param_shapes(cfg: ResNetConfig) -> dict:
    """Shape of every leaf, in the reference's tree layout (blocks keyed
    'stage{i}_block{j}', conv weights HWIO)."""
    w0 = cfg.widths[0]
    p: dict = {"stem": {"w": (7, 7, 3, w0), "scale": (w0,), "bias": (w0,)}}
    for si, bi, _, cin, width in _blocks(cfg):
        blk = {"w1": (3, 3, cin, width), "s1": (width,), "b1": (width,),
               "w2": (3, 3, width, width), "s2": (width,), "b2": (width,)}
        if cin != width:
            blk["w_proj"] = (1, 1, cin, width)
        p[f"stage{si}_block{bi}"] = blk
    p["head"] = {"w": (cfg.widths[-1], cfg.num_classes),
                 "b": (cfg.num_classes,)}
    return p


def init_params(cfg: ResNetConfig, generator: torch.Generator) -> dict:
    """Param tree on the generator's device, every leaf f32: He-normal
    convs (normal x sqrt(2 / fan_in)), the head normal / sqrt(fan_in),
    norm scales at one, biases at zero."""
    device = generator.device

    def leaf(name, shape):
        if len(shape) == 1:
            return torch.full(shape, 1.0 if name.startswith("s") else 0.0,
                              device=device)
        fan_in = math.prod(shape[:-1])
        std = (2.0 / fan_in) ** 0.5 if len(shape) == 4 else fan_in ** -0.5
        return torch.randn(shape, generator=generator, device=device) * std

    return {g: {k: leaf(k, s) for k, s in sub.items()}
            for g, sub in param_shapes(cfg).items()}


def param_logical_axes(cfg: ResNetConfig) -> dict:
    """Logical axes for parallel.sharding: convs shard output channels
    over 'mlp' (the tensor axis), the head over 'vocab'."""
    def axes(blk: dict) -> dict:
        return {k: (None, None, None, "mlp") if k.startswith("w")
                else (None,) for k in blk}

    return {g: ({"w": ("embed", "vocab"), "b": (None,)} if g == "head"
                else axes(blk))
            for g, blk in param_shapes(cfg).items()}


def _same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """NCHW `x` padded for a k x k window at `stride`; returns (x, the
    symmetric padding left to the conv or pool)."""
    ph = _same_padding(x.shape[2], k, stride)
    pw = _same_padding(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def _group_norm(x, scale, bias, groups: int, eps: float = 1e-5):
    """GroupNorm of NHWC `x` in f32 over min(groups, C) contiguous channel
    groups, cast back to x's dtype."""
    c = x.shape[-1]
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), min(groups, c),
                     scale.float(), bias.float(), eps)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _conv(x, w, stride: int = 1):
    """NHWC `x` convolved with HWIO `w` (cast to x's dtype), "SAME"."""
    xc, pad = _pad_same(x.permute(0, 3, 1, 2), w.shape[0], stride)
    y = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1)


def _max_pool(x, k: int = 3, stride: int = 2):
    """NHWC max pool, "SAME" with -inf padding."""
    xc, pad = _pad_same(x.permute(0, 3, 1, 2), k, stride, float("-inf"))
    return F.max_pool2d(xc, k, stride, padding=pad).permute(0, 2, 3, 1)


def forward(params: dict, images: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """images [N, H, W, 3] float; returns logits [N, num_classes] f32."""
    x = images.to(cfg.dtype)
    stem = params["stem"]
    x = _conv(x, stem["w"], stride=2)
    x = _group_norm(x, stem["scale"], stem["bias"], cfg.groups)
    x = _max_pool(F.relu(x))
    for si, bi, stride, _, _ in _blocks(cfg):
        blk = params[f"stage{si}_block{bi}"]
        h = _conv(x, blk["w1"], stride=stride)
        h = F.relu(_group_norm(h, blk["s1"], blk["b1"], cfg.groups))
        h = _conv(h, blk["w2"])
        h = _group_norm(h, blk["s2"], blk["b2"], cfg.groups)
        shortcut = x
        if "w_proj" in blk:
            shortcut = _conv(x, blk["w_proj"], stride=stride)
        elif stride != 1:
            shortcut = x[:, ::stride, ::stride, :]
        x = F.relu(h + shortcut)
    # Global average pool: the mean in f32, rounded to the compute dtype
    # (the reference's mean of a cfg.dtype array), then f32.
    x = x.float().mean(dim=(1, 2)).to(cfg.dtype).float()
    head = params["head"]
    return x @ head["w"] + head["b"]


def loss_fn(params: dict, batch: dict, cfg: ResNetConfig) -> torch.Tensor:
    """Cross entropy on {'images': [N, H, W, 3], 'labels': [N]}."""
    logits = forward(params, batch["images"], cfg)
    return cross_entropy(logits, batch["labels"])
