"""Mixtral-style sparse Mixture-of-Experts decoder (port of
ray_tpu/models/moe.py).

The llama trunk with the dense MLP swapped for a routed one: top-k routing
with a fixed per-expert capacity, and dense one-hot dispatch and combine
tensors (GShard / Switch), so every shape is static.  Expert weights carry
a leading [E, ...] dim that the "expert" mesh axis shards; on DTensors the
dispatch and combine einsums meet expert-sharded operands and DTensor's
propagation inserts the collectives that GSPMD's all-to-all is in the
reference.  A Switch load-balance loss keeps routing uniform.

The dispatch and combine einsums and the expert products are the
reference's own XLA einsums (no Pallas kernel), so they stay torch einsums
(bmm / mm).  What the reference computes in f32 stays f32: the router
logits and softmax, the combine tensor and the product that brings expert
outputs home (`combine . out` in f32; with TF32 off on CUDA, as the port
keeps it, that product runs on the FMA path).

A layer runs in `record_function` ranges (`TRACE_RANGES`) so a profiler
trace can split its device time.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.losses import cross_entropy
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.parallel.sharding import (replicate_like,
                                             with_sharding_constraint)


# The profiler ranges of an MoE layer, in its order: the attention block,
# then moe_block's four.  Under remat the layer's recompute runs inside
# the backward of whichever node first needs it; code outside a range
# would be read as part of that node's range.
TRACE_RANGES = ("moe.attention", "moe.route", "moe.dispatch",
                "moe.experts", "moe.combine")


@dataclasses.dataclass(frozen=True)
class MoEConfig(llama.LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    # capacity per expert = capacity_factor * tokens * k / E, rounded up
    # to a multiple of 8 (_capacity)
    capacity_factor: float = 1.25
    router_aux_coeff: float = 0.01

    def num_params(self) -> int:
        d, f = self.dim, self.ffn_dim
        dense = super().num_params()
        # the dense 3*d*f MLP becomes E experts + the router
        per_layer_delta = (self.n_experts - 1) * 3 * d * f \
            + d * self.n_experts
        return dense + self.n_layers * per_layer_delta

    def active_params(self) -> int:
        """Params touched per token (k experts of E)."""
        d, f = self.dim, self.ffn_dim
        dense = super().num_params()
        per_layer_delta = (self.experts_per_token - 1) * 3 * d * f \
            + d * self.n_experts
        return dense + self.n_layers * per_layer_delta


def moe_configs() -> dict[str, MoEConfig]:
    return {
        # Mixtral-8x7B shape
        "mixtral-8x7b": MoEConfig(
            vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, ffn_dim=14336, max_seq=32768,
            rope_theta=1e6, n_experts=8, experts_per_token=2),
        "moe-debug": MoEConfig(
            vocab_size=2048, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=256, max_seq=256, n_experts=4, experts_per_token=2),
    }


# ---------------------------------------------------------------- params
def param_shapes(cfg: MoEConfig) -> dict:
    """Shape of every leaf, in the reference's tree layout."""
    shapes = llama.param_shapes(cfg)
    d, f, E, L = cfg.dim, cfg.ffn_dim, cfg.n_experts, cfg.n_layers
    layers = {k: v for k, v in shapes["layers"].items()
              if k not in ("w_gate", "w_up", "w_down")}
    layers.update({"router": (L, d, E), "we_gate": (L, E, d, f),
                   "we_up": (L, E, d, f), "we_down": (L, E, f, d)})
    return {**shapes, "layers": layers}


def param_logical_axes(cfg: MoEConfig) -> dict:
    axes = llama.param_logical_axes(cfg)
    layer_axes = dict(axes["layers"])
    for name in ("w_gate", "w_up", "w_down"):
        del layer_axes[name]
    layer_axes.update({
        "router": ("layers", "embed", "expert"),
        "we_gate": ("layers", "expert", "embed", "mlp"),
        "we_up": ("layers", "expert", "embed", "mlp"),
        "we_down": ("layers", "expert", "mlp", "embed"),
    })
    axes["layers"] = layer_axes
    return axes


def init_params(cfg: MoEConfig, generator: torch.Generator) -> dict:
    """llama.init_params with the dense MLP replaced by the router and the
    experts (normal / sqrt(fan_in)), on the generator's device."""
    params = llama.init_params(cfg, generator)
    lp = params["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        del lp[name]
    shapes = param_shapes(cfg)["layers"]
    for name, fan_in in (("router", cfg.dim), ("we_gate", cfg.dim),
                         ("we_up", cfg.dim), ("we_down", cfg.ffn_dim)):
        lp[name] = llama.normal_init(shapes[name], fan_in, cfg, generator)
    return params


# --------------------------------------------------------------- routing
def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(cfg.capacity_factor * tokens * cfg.experts_per_token
              / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(h: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """Top-k routing with capacity (GShard dispatch / combine tensors).

    h [T, d] -> dispatch [T, E, C] (0/1 in h's dtype), combine [T, E, C]
    (gates in h's dtype), aux_loss (f32 scalar).  T tokens, all shapes
    static."""
    T = h.shape[0]
    C = _capacity(T, cfg)
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = h.float() @ router_w.float()                    # [T, E]
    probs = torch.softmax(logits, dim=-1)

    # Switch aux loss: E * sum_e (fraction_tokens_e * mean_prob_e).
    # argmax takes the first of equal maxima, as jnp.argmax does.
    top1 = probs.argmax(dim=-1)
    frac = _one_hot(top1, E, torch.float32).mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()

    # Top-k experts per token.  lax.top_k breaks ties toward the lower
    # index.  torch.topk documents no order among equal values: on the CPU
    # it gave the lower index at these shapes (the tied case of
    # tests/test_torch_moe.py passes with it), and chip_smoke.py phase
    # moe_small_f32 reports what its CUDA path gives.  So the top k come
    # from a stable descending sort, which keeps equal probabilities in
    # index order on both devices.
    sorted_p, sorted_e = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    topk_p, topk_e = sorted_p[:, :K], sorted_e[:, :K]        # [T, K]
    # Position of each (token, k) in its expert's queue: a cumulative
    # count over the token-major, k-minor flattening (the reference's
    # order: capacity drops the same tokens).
    onehot = _one_hot(topk_e, E, torch.int32)                # [T, K, E]
    flat = onehot.reshape(T * K, E)
    pos_in_expert = flat.cumsum(dim=0) - flat                # [T*K, E]
    pos = (pos_in_expert * flat).sum(dim=-1).reshape(T, K)   # [T, K]
    keep = pos < C                                           # capacity drop
    gate = topk_p * keep                                     # [T, K]
    denom = gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    gate = gate / denom                                      # renormalize

    slot = _one_hot(torch.where(keep, pos, C), C,
                    torch.float32)                           # [T, K, C]
    # combine[t,e,c] = sum_k gate[t,k] * [expert k == e] * slot[t,k,c]
    combine = torch.einsum("tk,tke,tkc->tec", gate.float(), onehot.float(),
                           slot)
    dispatch = (combine > 0).to(h.dtype)
    return dispatch, combine.to(h.dtype), aux


def _route_whole(ht: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """route() over every token of the step.  On DTensors the tokens and
    the router are gathered whole (capacity positions count over the
    global token order) and the outputs come back replicated on the mesh;
    autograd carries the gradients back to the shards."""
    if not isinstance(ht, DTensor):
        return route(ht, router_w, cfg)
    out = route(ht.full_tensor(), router_w.full_tensor(), cfg)
    return tuple(replicate_like(t, ht) for t in out)


def moe_block(x: torch.Tensor, lp: dict, cfg: MoEConfig):
    """Routed-FFN residual block (replaces llama._mlp_block).

    x [b, s, d] -> (y [b, s, d], aux scalar)."""
    b, s, d = x.shape
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    ht = h.reshape(b * s, d)
    with record_function("moe.route"):
        dispatch, combine, aux = _route_whole(ht, lp["router"], cfg)
    with record_function("moe.dispatch"):
        # Tokens to experts: [E, C, d]; E sharded over the expert axis.
        xe = torch.einsum("tec,td->ecd", dispatch, ht)
        xe = with_sharding_constraint(xe, ("expert", None, None))
    with record_function("moe.experts"):
        gate = torch.einsum("ecd,edf->ecf", xe, lp["we_gate"])
        up = torch.einsum("ecd,edf->ecf", xe, lp["we_up"])
        act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
        out = torch.einsum("ecf,efd->ecd", act, lp["we_down"])  # [E, C, d]
        out = with_sharding_constraint(out, ("expert", None, None))
    with record_function("moe.combine"):
        # Results home, weighted by the gates, in f32.
        y = torch.einsum("tec,ecd->td", combine.float(), out.float())
    y = y.to(x.dtype).reshape(b, s, d)
    return x + y, aux


# --------------------------------------------------------------- forward
def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [b, s] -> (logits [b, s, vocab] f32, aux_loss scalar), the
    aux loss averaged over the layers."""
    def layer_fn(x, lp, cos, sin, aux):
        with record_function("moe.attention"):
            y = llama._attention_block(x, lp, cfg, cos, sin)
        y, a = moe_block(y, lp, cfg)
        return y, aux + a

    logits, aux = llama.run_trunk(params, tokens, cfg, layer_fn)
    return logits, aux / cfg.n_layers


def loss_fn(params: dict, batch: dict, cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross entropy (mask-aware) + router load-balance aux."""
    inputs, targets = llama.split_batch(batch)
    logits, aux = forward(params, inputs, cfg)
    return cross_entropy(logits, targets, batch.get("mask")) \
        + cfg.router_aux_coeff * aux
