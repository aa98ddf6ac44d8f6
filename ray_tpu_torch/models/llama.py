"""Llama-3-family decoder, serving surface (port of ray_tpu/models/llama.py).

Parameters keep the reference's tree: the same keys and the stacked
[n_layers, ...] layer axis, so one converter (models/convert.py) moves a
JAX tree over unchanged.  Layers run as a Python loop over that axis.
The large projections stay `torch.matmul`, as the reference leaves them
to XLA; attention goes through ops.attention (flash kernel on CUDA) in
prefill and ops.paged_attention (paged kernel on CUDA) in decode.

The training surface (`forward`, `loss_fn`, `token_logprobs`, `run_trunk`)
checkpoints each layer when `cfg.remat`, with a selective-checkpoint
policy per `cfg.remat_mode` (`remat_policy`).  Its parameters may be
DTensors laid out by `param_logical_axes` (parallel/sharding.py, the
sharded train step): the trunk then constrains its activations where the
reference does, and the mesh it reads is the parameters' own.

Dense decode (`decode_step_unrolled` over `init_kv_cache_leaves`, and
`decode_step` over the stacked `init_kv_cache`) is plain einsum attention
over a [b, max_len, kvh, hd] cache per layer, as in the reference; the
serving engine's `paged=False` mode runs it.

Batched multi-LoRA (`lora` arguments of the serving functions): adapters
live in per-target banks, stacked [L, n_slots, din, r] / [L, n_slots, r,
dout] tensors, and a per-row slot index gathers each row's adapter
(BGMV, `_lora_proj`).  Slot 0 is all zeros, the base model.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.flash_attention import FLASH_FWD_OP
from ray_tpu_torch.ops.losses import cross_entropy
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.paged_attention import (gather_pages,
                                               paged_decode_attention)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.parallel.sharding import (logical_axis_size, mesh_of,
                                             replicate_like,
                                             with_sharding_constraint)

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # "flash_resid": recompute everything except the flash forward's
    # (o, lse); "nothing": full recompute; "dots": save the projection
    # matmuls; "flash_dots": both (see remat_policy).
    remat_mode: str = "flash_resid"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd ~ 6N + attention)."""
        attn = 12 * self.n_layers * self.dim * self.max_seq  # rough
        return 6.0 * self.num_params() + attn

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        per_layer = (d * self.n_heads * self.head_dim
                     + 2 * d * self.n_kv_heads * self.head_dim
                     + self.n_heads * self.head_dim * d
                     + 3 * d * f
                     + 2 * d)
        return v * d * 2 + self.n_layers * per_layer + d


def llama_configs() -> dict[str, LlamaConfig]:
    """Preset family: the reference's Llama-3 shapes and its scaled-down
    bench/debug configs."""
    return {
        "llama3-8b": LlamaConfig(),
        "llama3-70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64,
                                  n_kv_heads=8, ffn_dim=28672),
        "llama3-1b": LlamaConfig(dim=2048, n_layers=16, n_heads=32,
                                 n_kv_heads=8, ffn_dim=8192,
                                 vocab_size=128256),
        "bench-350m": LlamaConfig(dim=1024, n_layers=24, n_heads=8,
                                  n_kv_heads=4, ffn_dim=4096,
                                  vocab_size=32768, max_seq=2048),
        "debug": LlamaConfig(dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn_dim=256, vocab_size=256, max_seq=128,
                             remat=False),
    }


# ---------------------------------------------------------------- params
def param_shapes(cfg: LlamaConfig) -> dict:
    """Shape of every leaf, in the reference's tree layout."""
    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers
    return {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "attn_norm": (L, d),
            "wq": (L, d, cfg.n_heads * hd),
            "wk": (L, d, cfg.n_kv_heads * hd),
            "wv": (L, d, cfg.n_kv_heads * hd),
            "wo": (L, cfg.n_heads * hd, d),
            "mlp_norm": (L, d),
            "w_gate": (L, d, cfg.ffn_dim),
            "w_up": (L, d, cfg.ffn_dim),
            "w_down": (L, cfg.ffn_dim, d),
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def param_logical_axes(cfg: LlamaConfig) -> dict:
    """Logical-axes tree matching init_params' structure (consumed by
    parallel.sharding.param_shardings)."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "heads"),
            "wv": ("layers", "embed", "heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", None),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def init_params(cfg: LlamaConfig, generator: torch.Generator) -> dict:
    """Random weights on the generator's device: normal / sqrt(fan_in),
    norms at one.  Filled one layer slice at a time, so the f32 staging
    stays one slice big at any model size."""
    device = generator.device
    shapes = param_shapes(cfg)

    def normal(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for sl in (out if len(shape) == 3 else (out,)):
            sl.copy_(torch.randn(sl.shape, generator=generator,
                                 device=device) * fan_in ** -0.5)
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    ls = shapes["layers"]
    nhd = cfg.n_heads * cfg.head_dim
    return {
        "embed": normal(shapes["embed"], cfg.dim),
        "layers": {
            "attn_norm": ones(ls["attn_norm"]),
            "wq": normal(ls["wq"], cfg.dim),
            "wk": normal(ls["wk"], cfg.dim),
            "wv": normal(ls["wv"], cfg.dim),
            "wo": normal(ls["wo"], nhd),
            "mlp_norm": ones(ls["mlp_norm"]),
            "w_gate": normal(ls["w_gate"], cfg.dim),
            "w_up": normal(ls["w_up"], cfg.dim),
            "w_down": normal(ls["w_down"], cfg.ffn_dim),
        },
        "final_norm": ones(shapes["final_norm"]),
        "lm_head": normal(shapes["lm_head"], cfg.dim),
    }


def _layer(params: dict, lid: int) -> dict:
    return {k: params["layers"][k][lid] for k in LAYER_KEYS}


# ------------------------------------------------------------------ lora
# Batched multi-LoRA: per-target banks [L, n_slots, din, r] / [L, n_slots,
# r, dout] and an int slot index per row, gathered inside the step.  Bank
# writes change data in place, never the tensors a captured decode graph
# reads.  Slot 0 is all zeros = the base model (y + 0.0 == y), so base and
# adapter rows mix freely in one batch.
LORA_TARGETS = ("wq", "wk", "wv", "wo")


def lora_target_dims(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    """(din, dout) per LoRA-targetable projection."""
    hd = cfg.head_dim
    return {
        "wq": (cfg.dim, cfg.n_heads * hd),
        "wk": (cfg.dim, cfg.n_kv_heads * hd),
        "wv": (cfg.dim, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, cfg.dim),
    }


def init_lora_adapter(generator: torch.Generator, cfg: LlamaConfig,
                      rank: int, *, targets: tuple | None = None,
                      scale: float = 1.0) -> dict:
    """Random adapter {"rank", "targets": {t: {"a": [L, din, r], "b":
    [L, r, dout]}}} on the generator's device.  The LoRA scale is folded
    into b; b is random (a zero b would make every synthetic adapter a
    no-op)."""
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")
    dims = lora_target_dims(cfg)
    targets = tuple(targets) if targets is not None else LORA_TARGETS
    bad = set(targets) - set(dims)
    if bad:
        raise ValueError(f"unknown lora targets {sorted(bad)}; valid: "
                         f"{sorted(dims)}")
    L, device = cfg.n_layers, generator.device
    out = {}
    for t in targets:
        din, dout = dims[t]
        a = torch.randn((L, din, rank), generator=generator, device=device)
        b = torch.randn((L, rank, dout), generator=generator, device=device)
        out[t] = {"a": (a * din ** -0.5).to(cfg.dtype),
                  "b": (b * (rank ** -0.5 * scale)).to(cfg.dtype)}
    return {"rank": int(rank), "targets": out}


def merge_lora(params: dict, adapter: dict, cfg: LlamaConfig) -> dict:
    """A new param tree with the adapter merged dense (W + A @ B,
    accumulated in f32); leaves it does not target are shared."""
    layers = dict(params["layers"])
    for t, ab in adapter["targets"].items():
        w = layers[t]
        delta = torch.einsum("ldr,lro->ldo", ab["a"].float(), ab["b"].float())
        layers[t] = (w.float() + delta.to(w.device)).to(w.dtype)
    return {**params, "layers": layers}


def _lora_proj(h, w, bank, idx):
    """h @ w plus each row's low-rank delta (h @ A[idx]) @ B[idx].

    bank: {"a": [n_slots, din, r], "b": [n_slots, r, dout]}, one layer's
    slice of the engine bank, or None (plain projection); idx: [b] slot
    per row.  The delta accumulates in f32 and casts once; slot 0's zero
    rows add an exact 0.0."""
    y = h @ w
    if bank is None:
        return y
    a = bank["a"][idx]                                  # [b, din, r]
    bb = bank["b"][idx]                                 # [b, r, dout]
    t = torch.einsum("b...d,bdr->b...r", h.float(), a.float())
    d = torch.einsum("b...r,bro->b...o", t, bb.float())
    return y + d.to(y.dtype)


def _lora_layer_slice(lora, lid):
    """One layer's bank views ({} when there are none) and the slot
    index."""
    if not lora:
        return {}, None
    return ({t: {"a": ab["a"][lid], "b": ab["b"][lid]}
             for t, ab in lora["banks"].items()}, lora["idx"])


# --------------------------------------------------------------- forward
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """Token-embedding lookup.  A gather (`embedding`, whose backward
    DTensor lays out for a sharded table as well), except on a table
    whose vocab axis is sharded (a DTensor on a mesh with "tensor" > 1):
    there, as in the reference, a one-hot matrix is contracted against
    the table, so each rank touches only its vocab shard and the partial
    sums reduce over the tensor axis.  The one-hot product picks single
    rows, so both branches give the same values."""
    if logical_axis_size("vocab", mesh_of(table)) > 1:
        vocab = replicate_like(
            torch.arange(table.shape[0], device=tokens.device), table)
        one_hot = (tokens.long()[..., None] == vocab).to(table.dtype)
        return torch.einsum("bsv,vd->bsd", one_hot, table).to(dtype)
    return torch.nn.functional.embedding(tokens.long(), table).to(dtype)


def _mlp_block(x, lp, cfg: LlamaConfig):
    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = h @ lp["w_gate"]
    up = h @ lp["w_up"]
    h = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    h = with_sharding_constraint(h, ("batch", "seq", "mlp"))
    return x + (h @ lp["w_down"])


def _qkv(x, lp, cfg: LlamaConfig, lb=None, idx=None):
    """q, k, v of one layer; `lb` ({target: bank slice}) and `idx` add
    the rows' LoRA deltas."""
    b, s, _ = x.shape
    lb = lb or {}
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = _lora_proj(h, lp["wq"], lb.get("wq"), idx)
    k = _lora_proj(h, lp["wk"], lb.get("wk"), idx)
    v = _lora_proj(h, lp["wv"], lb.get("wv"), idx)
    return (q.reshape(b, s, cfg.n_heads, cfg.head_dim),
            k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim))


def prefill(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            lora: dict | None = None):
    """Prompt pass for serving: final hidden states plus per-layer K/V.

    tokens [b, P] (right-padded).  Returns (hidden [b, P, dim] post final
    norm, k [L, b, P, n_kv, hd], v likewise), RoPE applied.  Padding rows
    produce garbage K/V that decode never attends to (causal masking keeps
    them out of the real rows).

    lora: None (base model) or {"idx": [b] slots, "banks": {target: {"a":
    [L, n_slots, din, r], "b": [L, n_slots, r, dout]}}}."""
    b, P = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    cos, sin = rope_frequencies(cfg.head_dim, P, cfg.rope_theta,
                                device=x.device)
    ks, vs = [], []
    for lid in range(cfg.n_layers):
        lp = _layer(params, lid)
        lb, idx = _lora_layer_slice(lora, lid)
        q, k, v = _qkv(x, lp, cfg, lb, idx)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attention(q, k, v, causal=True)
        x = x + _lora_proj(o.reshape(b, P, -1), lp["wo"], lb.get("wo"), idx)
        x = _mlp_block(x, lp, cfg)
        ks.append(k.to(cfg.dtype))
        vs.append(v.to(cfg.dtype))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(ks), torch.stack(vs)


# ------------------------------------------------------------ dense decode
def _decode_layer(x, lp, ck, cv, pos, cos, sin, mask, cfg: LlamaConfig):
    """One decoder layer of a single dense decode step, shared by
    decode_step and decode_step_unrolled.  ck/cv: [b, max_len, kvh, hd];
    the current token's K/V row is written IN PLACE at each sequence's pos
    (clamped to the last row, as the reference's dynamic_update_slice
    clamps).  GQA folds the queries into [kv group, rep] and reads each
    group's cache without repeating it; scores in f32, masked to -1e30
    outside `mask`.  Returns x."""
    b = x.shape[0]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(x, lp, cfg)
    p = pos.long().clamp(max=ck.shape[1] - 1)
    q = apply_rope(q, cos, sin, positions=p[:, None])
    k = apply_rope(k, cos, sin, positions=p[:, None])
    rows = torch.arange(b, device=x.device)
    ck[rows, p] = k[:, 0].to(cfg.dtype)
    cv[rows, p] = v[:, 0].to(cfg.dtype)
    qg = q.reshape(b, 1, cfg.n_kv_heads, n_rep, cfg.head_dim)
    a = _gqa_scores(qg, ck) * cfg.head_dim ** -0.5
    a = a.masked_fill(~mask[:, None, None, None, :], -1e30)
    probs = torch.softmax(a, dim=-1).to(cfg.dtype)
    o = _gqa_values(probs, cv)
    x = x + (o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ lp["wo"])
    return _mlp_block(x, lp, cfg)


def _strided_groups(cache: torch.Tensor) -> bool:
    """Whether the dense decode reads a 16-bit CUDA cache in place, one
    strided bmm per KV group: the whole [b, max_len, kvh, hd] leaf is then
    never copied (a permuted einsum operand or an f32 upcast would copy
    it at every layer and step)."""
    return cache.is_cuda and cache.dtype != torch.float32


def _gqa_scores(qg: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    """f32 scores [b, g, r, 1, max_len] of the folded queries qg [b, 1, g,
    r, hd] against the cache ck [b, max_len, g, hd]: the reference's
    preferred_element_type=f32 (products of the operand type summed and
    returned in f32).  Off the strided route the operands go to f32 first,
    which gives the same products."""
    if not _strided_groups(ck):
        return torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck.float())
    return torch.stack([torch.bmm(qg[:, 0, g], ck[:, :, g].transpose(1, 2),
                                  out_dtype=torch.float32)
                        for g in range(ck.shape[2])], 1)[:, :, :, None]


def _gqa_values(probs: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """o [b, 1, g, r, hd] = probs [b, g, r, 1, max_len] (the cache dtype)
    against the cache cv [b, max_len, g, hd], in the cache dtype."""
    if not _strided_groups(cv):
        return torch.einsum("bgrqk,bkgd->bqgrd", probs, cv)
    return torch.stack([torch.bmm(probs[:, g, :, 0], cv[:, :, g])
                        for g in range(cv.shape[2])], 1)[:, None]


def init_kv_cache_leaves(cfg: LlamaConfig, batch: int, max_len: int,
                         device=None) -> dict:
    """Per-layer dense cache leaves for decode_step_unrolled: separate [b,
    max_len, kvh, hd] tensors per layer, written in place, and pos [b]."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": [torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step_unrolled(params: dict, cache: dict, tokens: torch.Tensor,
                         cfg: LlamaConfig, rope=None
                         ) -> tuple[torch.Tensor, dict]:
    """One dense decode step over per-layer cache leaves
    (init_kv_cache_leaves).  tokens [b]: each sequence's current token.
    Writes each layer's new K/V row and advances cache["pos"] by one, IN
    PLACE (returns `cache` itself; the reference returns a new cache).
    `rope` optionally passes (cos, sin) tables over max_len positions.
    Returns (logits [b, vocab] f32, cache)."""
    max_len = cache["k"][0].shape[1]
    pos = cache["pos"]
    x = embed_lookup(params["embed"], tokens[:, None], cfg.dtype)
    if rope is None:
        rope = rope_frequencies(cfg.head_dim, max_len, cfg.rope_theta,
                                device=x.device)
    cos, sin = rope
    mask = (torch.arange(max_len, device=x.device)[None, :]
            <= pos[:, None])
    for lid in range(cfg.n_layers):
        x = _decode_layer(x, _layer(params, lid), cache["k"][lid],
                          cache["v"][lid], pos, cos, sin, mask, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    pos.add_(1)
    return (x[:, 0] @ params["lm_head"]).float(), cache


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device=None) -> dict:
    """Stacked dense cache: k/v [L, b, max_len, kvh, hd] and pos [b]."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: LlamaConfig) -> tuple[torch.Tensor, dict]:
    """One dense decode step over the stacked cache (init_kv_cache): the
    layers of decode_step_unrolled on views of the [L, ...] tensors, so
    the rows land in the stacked cache IN PLACE.  Returns (logits [b,
    vocab] f32, cache)."""
    leaves = {"k": list(cache["k"].unbind(0)),
              "v": list(cache["v"].unbind(0)), "pos": cache["pos"]}
    logits, _ = decode_step_unrolled(params, leaves, tokens, cfg)
    return logits, cache


def init_paged_kv_cache(cfg: LlamaConfig, batch: int, n_pages: int,
                        page: int, device) -> dict:
    """Shared page-pool KV cache: per-layer [n_pages, kvh, page, hd]
    leaves, kv-head major.  Page 0 is the trash page that idle slots'
    table rows point at."""
    shape = (n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    return {"k": [torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(cfg.n_layers)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def scatter_prefill_pages(cache: dict, ks, vs, page_ids, rows, slots,
                          true_lens, aligned: bool = True) -> dict:
    """Write a prefill wave's K/V into the page pool, IN PLACE (returns
    `cache`).

    ks/vs: [L, W, P, kvh, hd]; page_ids/rows: [W, P] (page id + in-page
    row per token position; positions past a slot's allocation point at
    the trash page).  Duplicate wave-padding rows write identical data.
    Page-aligned waves write whole page blocks; aligned=False forces the
    per-token coordinate form (suffix waves start mid-page)."""
    nk = len(cache["k"])
    W, P = page_ids.shape
    page = cache["k"][0].shape[2]
    page_ids = page_ids.long()
    rows = rows.long()
    for leaf, src in ((cache["k"], ks), (cache["v"], vs)):
        for li in range(nk):
            if not aligned or (P > page and P % page):
                leaf[li][page_ids, :, rows] = src[li]
            elif P <= page:
                leaf[li][page_ids[:, 0], :, :P, :] = src[li].transpose(1, 2)
            else:
                m = P // page
                kvh, hd = src.shape[3], src.shape[4]
                blocks = src[li].reshape(W, m, page, kvh, hd) \
                    .permute(0, 1, 3, 2, 4).reshape(W * m, kvh, page, hd)
                leaf[li][page_ids[:, ::page].reshape(W * m)] = blocks
    cache["pos"][slots.long()] = true_lens.to(cache["pos"].dtype)
    return cache


def prefill_with_prefix(params: dict, tokens: torch.Tensor,
                        pos0: torch.Tensor, cfg: LlamaConfig,
                        k_pages: list, v_pages: list,
                        prefix_table: torch.Tensor,
                        lora: dict | None = None):
    """Suffix prompt pass over a cached paged prefix.

    tokens [b, S]: suffix tokens, right-padded; suffix token j sits at
    absolute position pos0[b] + j (pos0 a page multiple).  Each layer
    gathers its prefix rows dense and runs GQA attention where suffix
    query i admits prefix keys < pos0[b] plus suffix keys j <= i -- plain
    einsum, as in the reference.  Returns (hidden, ks, vs) with
    prefill()'s contract; `lora` as in prefill()."""
    b, S = tokens.shape
    page = k_pages[0].shape[2]
    Pp = prefix_table.shape[1] * page
    n_rep = cfg.n_heads // cfg.n_kv_heads
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    dev = x.device
    cos, sin = rope_frequencies(cfg.head_dim, Pp + S, cfg.rope_theta,
                                device=dev)
    positions = pos0.long()[:, None] + torch.arange(S, device=dev)[None, :]
    prefix_admit = (torch.arange(Pp, device=dev)[None, None, :]
                    < pos0.long()[:, None, None])              # [b, 1, Pp]
    causal = (torch.arange(S, device=dev)[None, :, None]
              >= torch.arange(S, device=dev)[None, None, :])   # [1, S, S]
    admit = torch.cat([prefix_admit.expand(b, S, Pp),
                       causal.expand(b, S, S)], dim=2)         # [b, S, Pp+S]
    ks_out, vs_out = [], []
    for lid in range(cfg.n_layers):
        lp = _layer(params, lid)
        lb, idx = _lora_layer_slice(lora, lid)
        q, k, v = _qkv(x, lp, cfg, lb, idx)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        k = k.to(cfg.dtype)
        v = v.to(cfg.dtype)
        ks_out.append(k)
        vs_out.append(v)
        ck = torch.cat([gather_pages(k_pages[lid], prefix_table), k], dim=1)
        cv = torch.cat([gather_pages(v_pages[lid], prefix_table), v], dim=1)
        qg = q.reshape(b, S, cfg.n_kv_heads, n_rep, cfg.head_dim)
        a = torch.einsum("bsgrd,bkgd->bgrsk", qg.float(), ck.float())
        a = a * cfg.head_dim ** -0.5
        a = a.masked_fill(~admit[:, None, None], -1e30)
        probs = torch.softmax(a, dim=-1).to(cfg.dtype)
        o = torch.einsum("bgrsk,bkgd->bsgrd", probs, cv)
        x = x + _lora_proj(o.reshape(b, S, cfg.n_heads * cfg.head_dim),
                           lp["wo"], lb.get("wo"), idx)
        x = _mlp_block(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.stack(ks_out), torch.stack(vs_out)


def decode_step_paged(params: dict, pages: dict, tails: dict,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      tail_start: torch.Tensor, j: int,
                      page_table: torch.Tensor, cfg: LlamaConfig,
                      lora: dict | None = None, rope=None):
    """One decode step over the paged cache + in-window tail.

    pages {"k"/"v": [L x [n_pages, kvh, page, hd]]} are read-only here.
    The new K/V rows are written IN PLACE into tails {"k"/"v": [L x [B,
    kvh, kt, hd]]} at the shared in-window column `j` (a Python int:
    every slot's pos advances in lockstep).  `rope` optionally passes the
    (cos, sin) tables covering maxp * page positions; `lora` as in
    prefill().  Returns (logits [B, vocab] f32, tails)."""
    b = tokens.shape[0]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    x = embed_lookup(params["embed"], tokens[:, None], cfg.dtype)
    if rope is None:
        rope = rope_frequencies(
            cfg.head_dim, page_table.shape[1] * pages["k"][0].shape[2],
            cfg.rope_theta, device=x.device)
    cos, sin = rope
    # An idle lane's pos keeps advancing window after window; clamp its
    # table lookup to the last row, as JAX clamps the reference's gather
    # (an index past the table raises on the CPU and asserts on CUDA).
    positions = torch.clamp(pos, max=cos.shape[0] - 1)[:, None]
    for lid in range(cfg.n_layers):
        lp = _layer(params, lid)
        lb, idx = _lora_layer_slice(lora, lid)
        q, k, v = _qkv(x, lp, cfg, lb, idx)
        q = apply_rope(q, cos, sin, positions=positions)
        k = apply_rope(k, cos, sin, positions=positions)
        tails["k"][lid][:, :, j] = k[:, 0].to(cfg.dtype)
        tails["v"][lid][:, :, j] = v[:, 0].to(cfg.dtype)
        o = paged_decode_attention(
            q.reshape(b, cfg.n_kv_heads, n_rep, cfg.head_dim).to(cfg.dtype),
            pages["k"][lid], pages["v"][lid], tails["k"][lid],
            tails["v"][lid], page_table, pos, tail_start)
        x = x + _lora_proj(o.reshape(b, 1, cfg.n_heads * cfg.head_dim),
                           lp["wo"], lb.get("wo"), idx)
        x = _mlp_block(x, lp, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x[:, 0] @ params["lm_head"]).float(), tails


# --------------------------------------------------------------- training
REMAT_MODES = ("flash_resid", "nothing", "dots", "flash_dots")


def remat_policy(cfg: LlamaConfig | None = None):
    """Selective-checkpoint policy per cfg.remat_mode, for
    torch.utils.checkpoint (the reference's jax.checkpoint policies).

    "flash_resid" (default): recompute everything except the flash
    forward's (o, lse) (`FLASH_FWD_OP`), so the backward does not re-run
    the forward kernel.  Costs (o + lse) per layer in device memory.  Off
    the flash path (CPU tensors take the plain attention) nothing is
    saved, exactly like "nothing".

    "nothing": full recompute, the least memory.

    "dots": save the outputs of the projection matmuls (`aten.mm`, the
    reference's dots without batch dims); the backward recomputes the
    elementwise ops and attention.

    "flash_dots": "dots" plus the flash residuals."""
    mode = cfg.remat_mode if cfg is not None else "flash_resid"
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat_mode {mode!r}; valid: "
                         + ", ".join(repr(m) for m in REMAT_MODES))
    saved = set()
    if mode in ("dots", "flash_dots"):
        saved.add(torch.ops.aten.mm.default)
    if mode in ("flash_resid", "flash_dots"):
        saved.add(FLASH_FWD_OP)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _attention_block(x, lp, cfg: LlamaConfig, cos, sin):
    b, s, _ = x.shape
    q, k, v = _qkv(x, lp, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # On a mesh, attention runs on each rank's shards: lay q, k and v out
    # alike, batch and heads split, so every shard is a whole problem.
    q, k, v = (with_sharding_constraint(t, ("batch", "seq", "heads", None))
               for t in (q, k, v))
    o = attention(q, k, v, causal=True)
    return x + (o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ lp["wo"])


def dense_layer(x, lp, cfg: LlamaConfig, cos, sin):
    """One dense decoder layer (attention + MLP): the single layer body of
    the training trunk."""
    return _mlp_block(_attention_block(x, lp, cfg, cos, sin), lp, cfg)


def head_loss(params: dict, x: torch.Tensor, targets: torch.Tensor, mask,
              cfg: LlamaConfig) -> torch.Tensor:
    """Shared trunk tail: final norm -> lm_head (f32) -> cross entropy."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return cross_entropy(logits, targets, mask)


def run_trunk(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
              layer_fn) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared decoder trunk: embed -> layers -> final norm -> lm_head.

    A Python loop over the stacked [L, ...] axis takes the place of the
    reference's lax.scan; each layer runs under torch.utils.checkpoint with
    remat_policy(cfg) when cfg.remat.  The layer leaves are unbound once,
    so the backward stacks each leaf's gradient in one pass.
    `layer_fn(x, lp, cos, sin, aux) -> (x, aux)` is the layer body.
    On DTensor parameters the activations are constrained to the
    reference's layouts (batch over data x fsdp, logits' vocab over
    tensor) and the constant tables are replicated on the params' mesh.
    Returns (logits f32, aux)."""
    _, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    x = with_sharding_constraint(x, ("batch", "seq", None))
    cos, sin = (replicate_like(t, x) for t in rope_frequencies(
        cfg.head_dim, s, cfg.rope_theta, device=x.device))
    aux = replicate_like(torch.zeros((), dtype=torch.float32,
                                     device=x.device), x)
    stacked = [params["layers"][k].unbind(0) for k in LAYER_KEYS]

    def body(x, aux, *leaves):
        x, aux = layer_fn(x, dict(zip(LAYER_KEYS, leaves)), cos, sin, aux)
        return with_sharding_constraint(x, ("batch", "seq", None)), aux

    policy = remat_policy(cfg) if cfg.remat else None
    for lid in range(cfg.n_layers):
        leaves = [t[lid] for t in stacked]
        if policy is None:
            x, aux = body(x, aux, *leaves)
        else:
            x, aux = checkpoint(
                body, x, aux, *leaves, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, policy))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return with_sharding_constraint(logits, ("batch", "seq", "vocab")), aux


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig
            ) -> torch.Tensor:
    """tokens [b, s] int -> logits [b, s, vocab] float32."""
    def layer_fn(x, lp, cos, sin, aux):
        return dense_layer(x, lp, cfg, cos, sin), aux

    return run_trunk(params, tokens, cfg, layer_fn)[0]


def split_batch(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """{"tokens": [b, s+1]} or {"inputs", "targets"} -> (inputs, targets)."""
    if "inputs" in batch:
        return batch["inputs"], batch["targets"]
    return batch["tokens"][:, :-1], batch["tokens"][:, 1:]


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy; batch = {"tokens": [b, s+1]} or
    {"inputs", "targets"}, with an optional "mask"."""
    inputs, targets = split_batch(batch)
    logits = forward(params, inputs, cfg)
    return cross_entropy(logits, targets, batch.get("mask"))


def token_logprobs(params: dict, tokens: torch.Tensor, cfg: LlamaConfig
                   ) -> torch.Tensor:
    """out[b, t] = log p(tokens[b, t+1] | tokens[b, :t+1]) for t in
    [0, s-2]: one teacher-forced forward, f32 log-softmax, [b, s-1].
    Positions past a sequence's true length score garbage; callers mask."""
    logits = forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
