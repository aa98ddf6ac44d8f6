"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits 1:

  1. device   -- the card's name and power limit (nvidia-smi), and the
                 kernels built from csrc/ (one nvcc per source, together).
  2. kernels  -- every kernel of the serving, training and RLHF paths
                 against its plain PyTorch version on the card, at the
                 main paths' shapes in bf16 plus ragged and edge cases
                 (head_dim 32, 64 and 128): the error against the plain
                 version computed in f32 from the same inputs, kernel /
                 plain / library times and the bound.  The flash forward
                 is timed at the 8B wave, the `bench-350m` layer and the
                 rlhf_350m scoring call, the flash backward (dQ, dK/dV) at
                 the `bench-350m` layer and the rlhf_350m learner's; the
                 f32 routes (FMA kernels) at the `debug` training shapes;
                 the paged kernel at the 8B decode state, at a long
                 context, at batch 32 and at the rlhf_350m decode state.
                 Each backward case must launch dQ and dK/dV once each on
                 its dtype's route, and every backward and paged case
                 gives the same bits when run again.
  3. engine_small_f32 -- the whole engine at small depth (`debug`, f32) on
                 CUDA (kernels, captured decode windows) and on the CPU
                 (plain versions, eager windows) from the same parameters:
                 warmup, a shared page-aligned prefix, a whole-prompt hit, a
                 wave mixing base and LoRA rows, a sync-window change to 2,
                 a prefill-only export imported into a second engine, a
                 prefix demoted from one engine and grafted into the other,
                 a live weight swap, and a pool small enough to preempt; the
                 greedy tokens must be identical on both devices, the swap
                 must give a fresh engine's tokens, the migration an
                 uninterrupted run's, the graft a prefix hit.  On CUDA every
                 window after the first of its size K must be a graph
                 replay, and one replayed window runs under CUDA sync
                 debug mode "error".
  3b. engine_small_dense_f32 -- the dense engine (paged=False) at `debug`
                 in f32: its greedy tokens on CUDA (captured windows, the
                 forward kernel in prefill) equal the same engine's on the
                 CPU and the paged engine's on CUDA; every window after the
                 first of its size is a replay and no paged kernel runs;
                 an LLMServer(paged=False) serves concurrent calls and a
                 stream with the same tokens, and a server reconfigured
                 from paged to dense and back gives them in all three.
  4. serve_8b -- `llama3-8b` at full width and depth in bf16 with random
                 seeded weights and the engine's defaults: eight requests
                 of 300-1000 prompt tokens submitted together, 64 new
                 tokens each, then a ninth that shares the first 512
                 tokens of a finished prompt (a prefix-cache hit: the
                 suffix path).  The launch counters are zeroed just before
                 this phase and read just after: both kernels must have
                 run, the forward on its bf16 route only, every decode
                 window must be a replay of the graph the warm-up
                 captured, and the paged kernel's launches must equal
                 replays x layers x K.  Then a wave of fresh prompts runs
                 under torch.profiler (profile_serve.trace_wave): its
                 busy share, and its paged kernels as the trace counts them
                 against the counter.
  4b. serve_8b_engine -- the same model and weights on four engines:
                 a mixed wave of four base and four adapter requests on an
                 engine with LoRA banks (2 slots, rank 16) whose base rows
                 must equal the same requests on a bank-free engine, one
                 request prefilled on a prefill-only engine and decoded on
                 a decode engine (the same tokens as the request run
                 alone; the prefill, decode and bank-free engines share
                 one tree with share_params), and a same-shape
                 update_weights of the banked engine's own copy (version
                 bump, radix tree flushed, graphs still replaying, the
                 same tokens; a sharing engine refuses one).  Counters
                 zeroed before, read after, as in 4.
  4c. serve_8b_server -- `LLMServer`, the serve deployment body, on the
                 same model and weights at the engine's defaults (max_batch
                 8, page 512, K 8), with no runtime (a process outside any
                 cluster).  (a) Unified: eight concurrent `__call__`s
                 (asyncio.gather) must give the greedy tokens of a bare
                 engine on the same params and seed, and a `stream` the
                 tokens of its `__call__`; each wave is queued while the
                 engine loop is stopped and admitted when it restarts, so
                 both engines prefill it as one wave (bf16 tokens depend
                 on the prefill's shapes).  A second pair of waves on fresh
                 prompts, sent as they come, gives tokens/s and TTFT
                 through the server against the bare engine.  (c) A
                 `reconfigure` to K 4 rebuilds the engine and serves a
                 bare K-4 engine's tokens; after `shutdown`, `kv_check`
                 passes.  (b) PD, built after (a) is freed: a prefill-role
                 server and a decode-role server linked by an in-process
                 handle (`serve/runtime.LocalHandle`) serve (a)'s eight
                 requests with (a)'s tokens and eight migrations; a
                 handle whose `kv_decode` raises gives a "full_reprefill"
                 fallback.  Counters zeroed before, read after (a) and
                 (b): both kernels launched, the forward on its bf16
                 route only, every counted window a replay.
  4d. serve_8b_dense -- the dense engine on the same model and weights
                 (share_params) at the engine's defaults but paged=False
                 (max_len 8192, max_batch 8, K 8): the eight requests as
                 one held wave, against a paged engine's held wave.  Each
                 first token must be the paged engine's (the same prefill);
                 the share of equal decoded tokens is reported.  Counters
                 zeroed before, read after: the forward on its bf16 route,
                 no paged launch, every counted window a replay.  Then a
                 wave of fresh prompts under torch.profiler: busy share
                 and device time by kernel group.
  5. train_small_f32 -- three `make_train_step` steps of `debug` in f32
                 (TF32 off) at seq 100, batch 2, from the same params and
                 batch on CUDA (kernels) and on the CPU (plain versions),
                 with remat flash_resid, nothing and off: losses, pre-clip
                 grad norms and final params agree; the forward kernel runs
                 n_layers times a step under flash_resid and twice that
                 under nothing, the forward, dQ and dK/dV on their f32
                 (FMA) routes only.
  6. train_350m -- `bench-350m` at full width and depth in bf16, weights
                 from seed 0, `default_optimizer(total_steps=1000)`, batch
                 8 x seq 2048 of seeded random tokens, remat flash_resid:
                 one warm-up step (lr 0: params unchanged), five timed
                 steps (loss, grad norm, step ms, tokens/s, MFU, peak
                 memory; the counters are zeroed just before and read just
                 after: 24 launches a step of each flash kernel, all on
                 their bf16 (wgmma) routes), then one step under
                 torch.profiler for the device time by kernel group, in
                 which no FMA flash kernel may run.
  6b. train_350m_sharded -- the same model, state, batch and optimizer
                 through `sharded_train_step` on a one-rank NCCL group and
                 a `create_mesh(MeshConfig(data=1))` DeviceMesh, the state
                 laid out by `reshard_state`: a warm-up step and four timed
                 steps, each beside the single-device step from the same
                 state (loss and grad norm equal to the bit; step ms,
                 tokens/s and MFU of both), and 24 launches a step of each
                 flash kernel on its bf16 route in both; then one sharded
                 step under torch.profiler (busy share, kernel groups).

  7. rlhf_small_f32 -- the in-process online GRPO loop (`RLHFTrainer`,
                 rollouts through the paged engine, the GRPO learner, live
                 weight sync) at `debug` in f32 (TF32 off) on CUDA and on
                 the CPU from the same params: engine max_batch 8, max_len
                 128, page 16, K 3; 4 prompts of 10 tokens, groups of 4, 2
                 prompts a step, 5 new tokens at temperature 1.0, lr 1e-2;
                 three steps.  The trajectories' tokens and masks equal on
                 both devices, each update's advantages and losses within
                 1e-4, the first update's gradients within 1e-4 of the
                 CPU's relative to each leaf's largest (the params after
                 three steps are reported: Adam's eps lets f32 rounding
                 pick the sign of some steps); every kernel on its
                 f32 (FMA) route only, dQ and dK/dV once per layer per
                 update; every window after the first a graph replay,
                 across each weight swap; the engine's weight_version the
                 learner's after every step.  A save_async taken before an
                 update, loaded into a fresh learner, gives the saved
                 state to the bit.
  7b. rlhf_350m -- the same loop at `bench-350m`, full width and depth, in
                 bf16 with weights from seed 0: 8 prompts of 384 tokens,
                 groups of 8, 2 prompts a step (16 completions), 64 new
                 tokens at temperature 1.0, lr 1e-6, engine max_batch 16,
                 max_len 512, page 64, K 4.  One warm-up step, four timed
                 steps (rollout seconds and completion tokens/s, scoring
                 and update seconds, learner tokens/s, weight sync ms,
                 reward, prefix-hit against prefilled tokens, peak
                 memory), then one step under torch.profiler (busy share,
                 kernel groups).  Counters zeroed before the timed steps
                 and read after: the paged kernel replays x layers x K, the
                 forward on bf16 only, dQ and dK/dV 24 per update on bf16
                 only; every timed window a replay; versions equal after
                 every step.  A second trainer from the same seed must
                 sample the same version-0 tokens; the equality of the
                 param hashes after as many steps is reported.

  8. moe_small_f32 -- the MoE family (`moe-debug`, f32, TF32 off) on CUDA
                 and on the CPU from the same params and tokens (batch 2 x
                 seq 64): `route` on the same hidden states gives the same
                 dispatch, and combine and aux within 1e-6; on tied
                 probabilities the same dispatch, ties to the lower index
                 (as lax.top_k; whether torch.topk's CUDA path does too is
                 reported); logits and loss
                 within 1e-4, and the first step's gradients within 1e-4 of
                 each leaf's largest; the grad pass launches the forward,
                 dQ and dK/dV once a layer each, on the f32 (FMA) routes
                 only.
  9. train_mixtral_4l -- `mixtral-8x7b` at its published widths (dim 4096,
                 32 / 8 heads of 128, ffn 14336, 8 experts, top 2, capacity
                 factor 1.25, vocab 32000) cut to 4 of its 32 layers for
                 memory (bf16 weights, gradients and AdamW moments: 8
                 bytes a parameter, 48.6 GB for 6.07 G parameters), bf16,
                 weights from seed 0, batch 2 x seq 4096 of seeded random
                 tokens (capacity 2560 an expert), `default_optimizer`,
                 remat flash_resid: one warm-up step, three timed steps
                 (step ms, tokens/s, MFU over active parameters, peak
                 memory, loss; the counters are zeroed just before and read
                 just after: 4 launches a step of each flash kernel, all
                 bf16), a no-grad forward for the aux loss and the share of
                 routed slots that capacity dropped, then one step under
                 torch.profiler split by range of the MoE layer (its
                 attention block; routing, dispatch, the expert GEMMs, the
                 f32 combine; each with its recompute and backward), the
                 flash kernels and the rest.

  10. vit_small_f32 -- a ViT with head_dim 32 (dim 128, 4 heads, 2 layers,
                 32-pixel images in 8-pixel patches; `vit-debug`'s head_dim
                 16 takes no kernel) in f32 (TF32 off) on CUDA and on the
                 CPU from the same params and images: logits and loss
                 within 1e-4, the first gradients within 1e-4 of each
                 leaf's largest; the grad pass (remat: each layer's
                 forward again in the backward) launches the forward twice
                 a layer and dQ and dK/dV once, non-causal, on the f32
                 (FMA) routes only.
  11. resnet_small_f32 -- `resnet-debug` on 33-pixel images (odd at every
                 stride 2) the same way, with cuDNN's TF32 off (printed:
                 f32 convolutions on TF32 would fail 1e-4); no flash
                 kernel runs.
  12. train_vit_b16 -- ViT-B/16 (Dosovitskiy et al. 2021: 224 px, patch 16,
                 dim 768, 12 x 12 heads, mlp 3072, 1000 classes) in bf16
                 with weights from seed 0, batch 256 of seeded random images,
                 `default_optimizer` over a TrainState built by hand from
                 the family's params (head_bias f32): one warm-up step,
                 three timed steps (images/s, MFU = images/s x 3 x forward
                 FLOPs / 989 TFLOP/s, peak memory), the counters zeroed just
                 before and read just after: 24 forward (12 and their remat
                 recompute), 12 dQ and 12 dK/dV launches a step, all on the
                 wgmma route; then one step under torch.profiler split into
                 flash, GEMM and conv, optimizer, norm and elementwise.
  13. train_resnet18 -- ResNet-18 (He et al. 2016, the reference's
                 GroupNorm 32 in place of BatchNorm) the same way at 224 px
                 in bf16 with its f32 parameter tree; no flash kernel.
  14. rl_learners_f32 -- each of the eight algorithms' learners (PPO,
                 IMPALA, APPO, DQN, BC, MARWIL, SAC, CQL) on CUDA and on the
                 CPU from the same params and a seeded batch: the first
                 minibatch's gradients within 1e-4 of each leaf's largest,
                 the first update's metrics within 1e-4 (its params are
                 reported: Adam's first step may flip an element whose
                 gradient is noise near zero).

Phase `kernels` also holds the flash forward and backward at the Mixtral
layer's shape ([2, 4096, 32, 8, 128], bf16, timed) and at the ViT-B/16
layer's ([256, 197, 12, 12, 64], bf16, non-causal, timed).

The line before the last is {"kernels": [...]}, one entry per kernel
(the forward, dQ and dK/dV: one per dtype route) with each main path's
launches and each timed layer's times; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound's rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Relative error |g - ref| / |ref| of the flash backward against its plain
# version in f32.  bf16: inputs and outputs are rounded to bf16 (2^-9
# relative each), the dQ kernel rounds dS to bf16 before dS K, as the TPU
# kernel does, and the dK/dV kernel rounds P and dS to bf16 for the tensor
# cores, where the f32 plain version does neither: about 3-5e-3 expected,
# 2e-2 allowed.  f32: summation order alone.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timing
class Timer:
    """CUDA-event timing of single launches with L2 flushed before each:
    in the model the same layer's call finds its inputs cold, since the
    whole weight set streams through L2 between two of them."""

    def __init__(self):
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def kernel_name(mangled: str) -> str:
    """`flash_fwd_wgmma_kernel<128>` from an Itanium-mangled kernel name."""
    rest, parts = mangled[mangled.index("_ZN") + 3:], []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        parts.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    args = re.match(r"I(\w+?)EE", rest)
    if not args:
        return parts[-1]
    a = args.group(1).replace("13__nv_bfloat16", "bf16,")
    a = re.sub(r"^f", "f32,", a).replace("Li", "")
    return f"{parts[-1]}<{a}>"


def ptxas_report(log: str) -> dict:
    """From one source's `ptxas -v` log: registers per kernel, the spill
    line of each kernel that spills, and the performance warnings (such as
    wgmma serialised for want of registers)."""
    regs, spills, warnings, name = {}, {}, [], None
    for ln in (x.strip() for x in log.splitlines()):
        m = re.search(r"(?:entry function '|properties for )(_ZN[^' ]+)", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in ln and name and " 0 bytes spill stores" not in ln:
            spills[name] = ln
        elif "Used" in ln and "registers" in ln and name:
            regs[name] = int(re.search(r"Used (\d+) registers", ln).group(1))
        elif "Performance Loss" in ln or "ignored" in ln:
            warnings.append(ln[:240])
    return {"registers": regs, "spilling": spills, "warnings": warnings}


def bound_ms(nbytes: float, flops: float, flops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# ------------------------------------------------------- phase 2: kernels
def flash_case(timer, name, b, s, hq, hkv, d, dtype, causal=True,
               timed=False):
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_attention_reference(q.float(), k.float(),
                                               v.float(), causal=causal)
    err = max(max_err(o, ref_o), max_err(lse, ref_lse))
    row = {"case": name, "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
           "causal": causal, "max_abs_err": err, "tol": TOL[dtype]}
    if err > TOL[dtype] or not torch.isfinite(o.float()).all():
        raise AssertionError(f"flash_attention_fwd {name}: {row}")
    if timed:
        row["ms"] = timer.ms(lambda: flash_attention_fwd(q, k, v, causal))
        row["plain_ms"] = timer.ms(
            lambda: flash_attention_reference(q, k, v, causal), iters=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rep = hq // hkv
        kr = kt.repeat_interleave(rep, dim=1)
        vr = vt.repeat_interleave(rep, dim=1)
        row["library_ms"] = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kr, vr, is_causal=causal))
        pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size() \
            + lse.numel() * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 4 * d * pairs,
            BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    return row


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def flash_bwd_case(timer, name, b, s, hq, hkv, d, dtype, causal=True,
                   timed=False):
    from ray_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_reference, flash_attention_fwd)

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_fwd(q, k, v, causal)
    delta = attention_delta(o, do)
    n0 = flash_counts()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    # Each wrapper launched once, on its dtype's route only.
    ran = {n: c - n0[n] for n, c in flash_counts().items() if c != n0[n]}
    route = "/wgmma" if dtype == torch.bfloat16 else "/fma"
    if ran != {w + r: 1 for w in ("flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")
               for r in ("", route)}:
        raise AssertionError(f"flash backward {name}: launches {ran}")
    # The same bits on a second run: no atomics, one order of sums.
    again = (flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash backward {name}: a second run gave "
                             "other bits")
    ref = flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), causal)
    got = dict(zip(("dq", "dk", "dv"), (dq, dk, dv)))
    want = dict(zip(("dq", "dk", "dv"), ref))
    row = {"case": name, "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
           "causal": causal, "launches": ran, "same_bits_on_rerun": True,
           "rel_err": {n: rel_err(got[n], want[n]) for n in got},
           "max_abs_err": {n: max_err(got[n], want[n]) for n in got},
           "tol_rel": BWD_TOL[dtype]}
    if max(row["rel_err"].values()) > BWD_TOL[dtype] or not all(
            torch.isfinite(t.float()).all() for t in got.values()):
        raise AssertionError(f"flash backward {name}: {row}")
    if timed:
        row["dq_ms"] = timer.ms(lambda: flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal))
        row["dkv_ms"] = timer.ms(lambda: flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal))
        # One plain function computes dq, dk and dv together.
        row["plain_ms"] = timer.ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal), iters=3)
        rep = hq // hkv
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kr = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous() \
            .requires_grad_()
        vr = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous() \
            .requires_grad_()
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kr, vr, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        # The backward alone of SDPA: one call for dq, dk and dv together.
        row["library_ms"] = timer.ms(lambda: torch.autograd.grad(
            out, (qt, kr, vr), dot, retain_graph=True))
        del out
        pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
        esz = q.element_size()
        qb, kb, f32b = q.numel() * esz, k.numel() * esz, lse.numel() * 4
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        # Each input read once, each output written once: q, k, v, dO, lse,
        # delta in; dq (3 products, 6 d flops a pair) or dk, dv (4
        # products, 8 d); the pair fused: 5 products, 10 d.
        row["dq_bound_ms"], row["dq_bound_by"] = bound_ms(
            3 * qb + 2 * kb + 2 * f32b, 6 * d * pairs, rate)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bound_ms(
            2 * qb + 4 * kb + 2 * f32b, 8 * d * pairs, rate)
        row["fused_bound_ms"], row["fused_bound_by"] = bound_ms(
            3 * qb + 4 * kb + 2 * f32b, 10 * d * pairs, rate)
    return row


def paged_inputs(B, kvh, rep, hd, page, maxp, kt, n_pages, dtype, ts, pos,
                 table=None):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    if table is None:      # distinct pages per slot; unused columns -> 0
        table = torch.zeros(B, maxp, dtype=torch.int32)
        nxt = 1
        for b in range(B):
            for i in range(-(-(int(pos[b]) + 1) // page)):
                table[b, i] = nxt
                nxt += 1
        assert nxt <= n_pages
    return [rnd(B, kvh, rep, hd), rnd(n_pages, kvh, page, hd),
            rnd(n_pages, kvh, page, hd), rnd(B, kvh, kt, hd),
            rnd(B, kvh, kt, hd), table.to("cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"),
            torch.tensor(ts, dtype=torch.int32, device="cuda")]


def paged_case(timer, name, args, timed=False):
    from ray_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                   paged_decode_reference)

    dtype = args[0].dtype
    n0 = paged_decode_attention.launches
    o = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = paged_decode_reference(*[a.float() if a.is_floating_point()
                                   else a for a in args])
    err = max_err(o, ref)
    B, kvh, rep, hd = args[0].shape
    row = {"case": name, "shape": [B, kvh, rep, hd, args[1].shape[2],
                                   args[5].shape[1], args[3].shape[2]],
           "tail_start": args[7].tolist(), "pos": args[6].tolist(),
           "dtype": str(dtype), "max_abs_err": err, "tol": TOL[dtype],
           "same_bits_on_rerun": bool(torch.equal(o, again))}
    if err > TOL[dtype] or not torch.isfinite(o.float()).all() \
            or paged_decode_attention.launches - n0 != 2:
        raise AssertionError(f"paged_decode_attention {name}: {row}")
    if not row["same_bits_on_rerun"]:
        raise AssertionError(f"paged_decode_attention {name}: a second run "
                             "gave other bits")
    if timed:
        row["ms"] = timer.ms(lambda: paged_decode_attention(*args))
        row["plain_ms"] = timer.ms(lambda: paged_decode_reference(*args),
                                   iters=3)
        row["library_ms"] = None
        pos = args[6].cpu().numpy().astype(np.int64)
        ts = args[7].cpu().numpy().astype(np.int64)
        rows = np.minimum(ts, args[5].shape[1] * args[1].shape[2]) \
            + np.maximum(0, np.minimum(pos - ts + 1, args[3].shape[2]))
        esz = args[0].element_size()
        nbytes = (2 * rows.sum() * kvh * hd + 2 * args[0].numel()) * esz \
            + 4 * (args[5].numel() + 2 * B)
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 4 * rep * hd * kvh * rows.sum(),
            BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    return row


MAIN_PROMPTS = [312, 1000, 457, 803, 640, 999, 388, 725]   # phase 4 lengths


def phase_kernels(timer):
    """Rows by case name: {"fwd": {...}, "paged": {...}, "bwd": {...}}."""
    bf, f32 = torch.bfloat16, torch.float32
    flash = [
        # The 8-request wave's prefill: bucket 1024, Llama-3-8B heads.
        flash_case(timer, "8b_wave_bucket1024", 8, 1024, 32, 8, 128, bf,
                   timed=True),
        # One bench-350m layer call: b 8 x s 2048, 8 q / 4 kv heads.
        flash_case(timer, "350m_train_layer", 8, 2048, 8, 4, 128, bf,
                   timed=True),
        # The rlhf_350m loop: scoring and the learner's forward at b 16 x
        # s 512 (the pow2 scoring width), the leaders' prefill at the
        # width bucket 8 x bucket 512.
        flash_case(timer, "350m_rlhf_score", 16, 512, 8, 4, 128, bf,
                   timed=True),
        flash_case(timer, "350m_rlhf_prefill", 8, 512, 8, 4, 128, bf),
        # One Mixtral layer call in train_mixtral_4l: b 2 x s 4096, 32 q /
        # 8 kv heads.
        flash_case(timer, "mixtral_train_layer", 2, 4096, 32, 8, 128, bf,
                   timed=True),
        # One ViT-B/16 layer call in train_vit_b16: b 256 x 197 tokens, 12
        # heads of 64, no GQA, non-causal.
        flash_case(timer, "vit_b16_layer", 256, 197, 12, 12, 64, bf,
                   causal=False, timed=True),
        flash_case(timer, "8b_single_bucket512", 1, 512, 32, 8, 128, bf),
        flash_case(timer, "ragged_1000", 1, 1000, 32, 8, 128, bf),
        flash_case(timer, "bf16_hd64_ragged", 2, 333, 8, 2, 64, bf),
        flash_case(timer, "bf16_hd32_ragged", 1, 517, 4, 1, 32, bf),
        flash_case(timer, "bf16_noncausal", 1, 300, 4, 2, 128, bf,
                   causal=False),
        # The f32 route (FMA) at the `debug` training shapes.
        flash_case(timer, "f32_debug_train", 2, 100, 4, 2, 32, f32,
                   timed=True),
        flash_case(timer, "f32_hd64_ragged", 2, 77, 8, 2, 64, f32),
        flash_case(timer, "f32_hd32_noncausal", 1, 45, 4, 2, 32, f32,
                   causal=False),
    ]
    # Decode at the main path's state: slots mid-window (pos = ts + 3).
    ts = [n + 32 for n in MAIN_PROMPTS]
    pos = [t + 3 for t in ts]
    paged = [
        paged_case(timer, "8b_decode_window",
                   paged_inputs(8, 8, 4, 128, 512, 16, 8, 65, bf, ts, pos),
                   timed=True),
        # The rlhf_350m decode state: bench-350m heads (kvh 4, rep 2, hd
        # 128), pages of 64, table width 8, K 4; two groups of 8 slots
        # whose 384-token prompt is six shared pages (1-6 and 7-12), each
        # slot's completion on a page of its own, slots spread over the
        # 64 new tokens (pos 384-447) and over the window's four steps.
        paged_case(timer, "350m_rlhf_decode", paged_inputs(
            16, 4, 2, 128, 64, 8, 4, 29, bf,
            [384 + 4 * b for b in range(16)],
            [384 + 4 * b + b % 4 for b in range(16)],
            table=torch.tensor([[1 + 6 * (b // 8) + i for i in range(6)]
                                + [13 + b, 0] for b in range(16)],
                               dtype=torch.int32)),
            timed=True),
        # Page boundaries; an idle slot whose pos ran far past its table
        # row (all zeros: the trash page); a slot with nothing admitted.
        paged_case(timer, "f32_page8_boundaries", paged_inputs(
            4, 2, 2, 32, 8, 4, 4, 20, f32, [0, 7, 8, 27], [2, 9, 10, 29])),
        paged_case(timer, "bf16_runaway_and_empty", paged_inputs(
            3, 2, 4, 64, 16, 2, 4, 8, bf, [3, 10_000, 5], [4, 10_001, 4],
            table=torch.tensor([[1, 2], [0, 0], [3, 0]], dtype=torch.int32))),
        paged_case(timer, "f32_hd128_rep8", paged_inputs(
            2, 1, 8, 128, 16, 3, 8, 9, f32, [17, 40], [20, 40])),
        # A long context at the 8B heads: keys in every split of each
        # cluster, each split's share looping.
        paged_case(timer, "8b_long_context",
                   paged_inputs(2, 8, 4, 128, 512, 16, 8, 26, bf,
                                [7990, 4100], [7993, 4103]),
                   timed=True),
        # Batch 32 at 1000 tokens each: against the 8B state's time, how
        # much of a call is fixed cost and how much moves bytes.
        paged_case(timer, "8b_batch32_decode",
                   paged_inputs(32, 8, 4, 128, 512, 16, 8, 65, bf,
                                [1000] * 32, [1003] * 32),
                   timed=True),
        # Fewer admitted keys than splits (4 and 3): most splits empty.
        paged_case(timer, "bf16_fewer_keys_than_splits", paged_inputs(
            3, 2, 4, 128, 16, 4, 4, 8, bf, [3, 0, 40], [3, 2, 41])),
        # 128 keys in 8 splits of 16 on pages of 16: every split ends on a
        # page boundary (slot 1: the last split is the tail).
        paged_case(timer, "f32_splits_on_page_boundaries", paged_inputs(
            2, 2, 2, 64, 16, 8, 8, 17, f32, [128, 120], [127, 127])),
    ]
    flash_bwd = [
        # One bench-350m layer call: b 8 x s 2048, 8 q / 4 kv heads.
        flash_bwd_case(timer, "350m_train_layer", 8, 2048, 8, 4, 128, bf,
                       timed=True),
        # The rlhf_350m learner's layer call: b 16 x s 512.
        flash_bwd_case(timer, "350m_rlhf_learner", 16, 512, 8, 4, 128, bf,
                       timed=True),
        # The Mixtral layer call of train_mixtral_4l.
        flash_bwd_case(timer, "mixtral_train_layer", 2, 4096, 32, 8, 128,
                       bf, timed=True),
        # The ViT-B/16 layer call of train_vit_b16 (non-causal, head_dim
        # 64).
        flash_bwd_case(timer, "vit_b16_layer", 256, 197, 12, 12, 64, bf,
                       causal=False, timed=True),
        flash_bwd_case(timer, "8b_heads", 1, 1024, 32, 8, 128, bf),
        flash_bwd_case(timer, "ragged_1000", 1, 1000, 8, 4, 128, bf),
        flash_bwd_case(timer, "bf16_hd64_ragged", 2, 333, 8, 2, 64, bf),
        flash_bwd_case(timer, "bf16_hd32_ragged", 1, 517, 4, 1, 32, bf),
        flash_bwd_case(timer, "bf16_noncausal", 1, 300, 4, 2, 128, bf,
                       causal=False),
        # The f32 routes (FMA) at the `debug` training shapes.
        flash_bwd_case(timer, "f32_debug_train", 2, 100, 4, 2, 32, f32,
                       timed=True),
        flash_bwd_case(timer, "f32_hd64_ragged", 2, 77, 8, 2, 64, f32),
        flash_bwd_case(timer, "f32_hd32_noncausal", 1, 45, 4, 2, 32, f32,
                       causal=False),
        flash_bwd_case(timer, "f32_mqa", 2, 130, 4, 1, 64, f32),
    ]
    emit({"phase": "kernels", "flash_attention_fwd": flash,
          "paged_decode_attention": paged, "flash_attention_bwd": flash_bwd})
    return {"fwd": {r["case"]: r for r in flash},
            "paged": {r["case"]: r for r in paged},
            "bwd": {r["case"]: r for r in flash_bwd}}


# ----------------------------------------------- phase 3: small f32 engine
SHARED = [(i * 7 + 3) % 250 + 1 for i in range(32)]      # 2 pages of 16
GRAFT = [(i * 11 + 5) % 250 + 1 for i in range(40)]      # 2 pages + 8
MIGRATE = SHARED[:16] + [(i * 13 + 1) % 250 + 1 for i in range(21)]


def run_small(engine_cls, cfg, params, device, adapter, new_params):
    """Greedy tokens of the small workloads on one device, and each
    engine's counters.  `eng` (LoRA banks) serves the prefix, COW, LoRA,
    sync-window and prefill-only requests, demotes a prefix and takes a
    weight swap; `dec` resumes the exported request and takes the
    demoted prefix as a graft.  Each engine decodes with its own copy of
    `params`."""
    out = {}
    kw = dict(device=device, max_batch=4, max_len=128, page_size=16, seed=0)
    eng = engine_cls(cfg, params, lora_slots=2, lora_rank=4, **kw)
    dec = engine_cls(cfg, params, **kw)
    eng.start()
    dec.start()
    try:
        eng.warmup()
        out["prefix"] = [eng.generate(SHARED + t, max_new_tokens=12)["tokens"]
                         for t in ([40, 41, 42], [50, 51], [60])]
        out["cow"] = [eng.generate(SHARED, max_new_tokens=8)["tokens"]
                      for _ in range(2)]
        st = eng.stats()
        out["hits"], out["cow_copies"] = st["prefix_hit_tokens"], \
            st["cow_copies"]
        # One wave mixing base and adapter rows.
        eng.load_adapter("t/a", adapter)
        futs = [eng.submit(SHARED[:20] + [70 + i], max_new_tokens=12,
                           model_id="t/a" if i % 2 else None)
                for i in range(4)]
        out["lora"] = [f.result(timeout=600)["tokens"] for f in futs]
        # A smaller live window, then back to the configured one.
        eng.set_sync_window(2)
        out["window2"] = eng.generate(SHARED[:9], max_new_tokens=11)["tokens"]
        eng.set_sync_window(None)
        # Prefill on eng, decode on dec.
        out["migrate_ref"] = dec.generate(MIGRATE, max_new_tokens=12,
                                          _cache_ok=False)["tokens"]
        exp = eng.submit(MIGRATE, max_new_tokens=1, prefill_only=True) \
            .result(timeout=600)["kv_export"]
        out["migrated"] = dec.kv_import(
            MIGRATE, exp["tokens"], exp["kv"], kv_len=exp["len"],
            max_new_tokens=12, sample_seed=exp["sample_seed"]
        ).result(timeout=600)["tokens"]
        # Demote GRAFT's two blocks from eng, graft them into dec.
        out["graft_src"] = eng.generate(GRAFT, max_new_tokens=8)["tokens"]
        store = {}
        eng.set_prefix_store(
            lambda e: store.setdefault(tuple(e["tokens"]), e) is e,
            min_idle=0, period_s=0.01, watermark_frac=0.0, limit=8,
            max_inflight=8)
        key, deadline = tuple(GRAFT[:32]), time.time() + 60
        while key not in store and time.time() < deadline:
            eng._wake.set()
            time.sleep(0.01)
        eng.set_prefix_store(None)
        h0 = dec.stats()["prefix_hit_tokens"]
        out["grafted"] = dec.kv_graft(list(key), store[key]["kv"], kv_len=32,
                                      weight_version=0).result(timeout=600)
        out["graft"] = dec.generate(GRAFT, max_new_tokens=8)["tokens"]
        out["graft_hit_tokens"] = dec.stats()["prefix_hit_tokens"] - h0
        # A live weight swap.
        out["before_swap"] = eng.generate(SHARED[:5], 10)["tokens"]
        eng.update_weights(new_params)
        out["swapped"] = eng.generate(SHARED[:5], 10)["tokens"]
        counters = {"eng": eng.stats(), "dec": dec.stats(),
                    "eng_graphs": eng.graph_stats()}
    finally:
        eng.stop()
        dec.stop()
    fresh = engine_cls(cfg, tree_to(new_params, device), **kw)
    try:
        out["fresh"] = fresh.generate(SHARED[:5], 10)["tokens"]
    finally:
        fresh.stop()
    starved = engine_cls(cfg, params, device=device, max_batch=4,
                         max_len=128, page_size=16, kv_pages=7,
                         prefix_cache=False, kv_preempt=True, seed=0)
    futs = [starved.submit([i + 1, i + 2, i + 3, i + 4, i + 5],
                           max_new_tokens=38) for i in range(0, 40, 10)]
    starved.start()
    try:
        out["preempt"] = [f.result(timeout=600)["tokens"] for f in futs]
    finally:
        starved.stop()
    out["preemptions"] = starved.preemptions
    return out, counters


def window_sync_check(cfg, params) -> dict:
    """One decode window dispatched under CUDA sync debug mode "error":
    the K steps, the sampling and the tail merge never wait on the device
    (the engine's one sync per window is its copy of the returned token
    block).  Drives the loop's own steps on this thread; the first window
    captures the graph, the checked one replays it."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", max_batch=4, max_len=128,
                    page_size=16, seed=0)
    for i in range(4):
        eng.submit([i + 1, 2, 3, 4, 5], max_new_tokens=20,
                   temperature=0.8 * (i % 2))
    eng._admit()
    active = eng._ensure_decode_blocks()
    eng._decode_window(active)            # first use: eager, then capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_window(active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if eng.graph_replays != 1:
        raise AssertionError("the checked window was not a graph replay")
    return {"slots": len(active), "replayed": eng.graph_replays}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device) if isinstance(tree, torch.Tensor) \
        else tree


def graph_accounting(stats: dict) -> dict:
    """Every window after the first of its kind replays its graph."""
    return {k: stats[k] for k in ("decode_windows", "graph_replays",
                                  "graph_captures", "graph_capture_s")}


def phase_engine_small():
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    new_params = llama.init_params(cfg,
                                   torch.Generator().manual_seed(SEED + 5))
    adapter = llama.init_lora_adapter(torch.Generator().manual_seed(SEED + 1),
                                      cfg, 4)

    n0 = (flash_counts(), paged_decode_attention.launches)
    t0 = time.perf_counter()
    gpu, counters = run_small(LLMEngine, cfg, tree_to(cpu_params, "cuda"),
                              "cuda", tree_to(adapter, "cuda"), new_params)
    t_gpu = time.perf_counter() - t0
    sync = window_sync_check(cfg, tree_to(cpu_params, "cuda"))
    cpu, _ = run_small(LLMEngine, cfg, cpu_params, "cpu", adapter,
                       new_params)
    fwd = {n: c - n0[0][n] for n, c in flash_counts().items()
           if n.startswith("flash_attention_fwd")}
    launched = {**fwd, "paged_decode_attention":
                paged_decode_attention.launches - n0[1]}
    same = {k: gpu[k] == cpu[k] for k in gpu}
    graphs = {e: graph_accounting(counters[e]) for e in ("eng", "dec")}
    row = {"phase": "engine_small_f32", "same_tokens": same,
           "prefix_hit_tokens": gpu["hits"], "cow_copies": gpu["cow_copies"],
           "preemptions": gpu["preemptions"],
           "graft": gpu["grafted"], "graft_hit_tokens": gpu["graft_hit_tokens"],
           "swap_changed_tokens": gpu["swapped"] != gpu["before_swap"],
           "swapped_equals_fresh_engine": gpu["swapped"] == gpu["fresh"],
           "migrated_equals_uninterrupted":
               gpu["migrated"] == gpu["migrate_ref"],
           "graphs": graphs, "eng_graphs": counters["eng_graphs"],
           "window_without_host_sync": sync,
           "kernel_launches": launched,
           "cuda_seconds": t_gpu}
    emit(row)
    if not all(same.values()) or gpu != cpu:
        raise AssertionError(f"CUDA and CPU engines disagree: {gpu} {cpu}")
    if gpu["preemptions"] == 0 or gpu["cow_copies"] == 0 \
            or gpu["hits"] == 0 or launched["paged_decode_attention"] == 0 \
            or launched["flash_attention_fwd/fma"] == 0 \
            or launched["flash_attention_fwd/wgmma"]:
        raise AssertionError(f"small engine missed a path: {row}")
    if not (row["swap_changed_tokens"] and row["swapped_equals_fresh_engine"]
            and row["migrated_equals_uninterrupted"]
            and gpu["grafted"]["grafted"] == 2
            and gpu["graft_hit_tokens"] >= 32
            and gpu["graft"] == gpu["graft_src"]
            and counters["eng"]["weight_version"] == 1
            and counters["dec"]["kv_imports"] == 1
            and counters["eng"]["kv_exports"] == 1):
        raise AssertionError(f"small engine: a slice path failed: {row}")
    for name, g in graphs.items():
        if g["graph_replays"] == 0 or g["decode_windows"] \
                != g["graph_replays"] + g["graph_captures"]:
            raise AssertionError(f"{name}: a window after the first of its "
                                 f"kind was not a replay: {g}")
    if set(counters["eng_graphs"]) != {"K=8", "K=2"}:
        raise AssertionError(f"captured windows {counters['eng_graphs']} "
                             "are not one per size, K=8 and K=2")
    return launched


# ----------------------------------------- phase 3b: small f32 dense engine
DENSE_PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
                 for k, n in ((7, 21), (5, 13), (11, 30), (3, 9), (13, 40),
                              (17, 5))]
DENSE_NEW = [9, 6, 12, 7, 5, 10]
SMALL = dict(max_batch=4, max_len=128, steps_per_sync=4, seed=0)


def small_wave(eng):
    """DENSE_PROMPTS submitted together on a started engine; tokens."""
    futs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(DENSE_PROMPTS, DENSE_NEW)]
    return [f.result(timeout=600)["tokens"] for f in futs]


def phase_engine_small_dense():
    """The dense engine (paged=False) at `debug` in f32: its greedy tokens
    on CUDA (captured windows, the flash forward in prefill) against the
    same engine on the CPU and the paged engine on CUDA, an LLMServer
    (paged=False) serving calls and a stream, and a server reconfigured
    from paged to dense and back."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    params = tree_to(cpu_params, "cuda")
    runs, stats = {}, {}
    zero_serve_counts()
    for name, device, kw in (("dense_cuda", "cuda", {"paged": False}),
                             ("dense_cpu", "cpu", {"paged": False}),
                             ("paged_cuda", "cuda", {"page_size": 16})):
        eng = LLMEngine(cfg, params if device == "cuda" else cpu_params,
                        device=device, **SMALL, **kw)
        eng.start()
        try:
            small_wave(eng)                     # the first windows capture
            runs[name] = small_wave(eng)
        finally:
            eng.stop()
        stats[name] = graph_accounting(eng.stats())
        if name == "dense_cuda":
            torch.cuda.synchronize()
            dense_launches = launch_counts()
            stats[name]["kv_check"] = eng.kv_check()
    # The server, on CUDA: concurrent calls and a stream.
    reqs = [{"prompt": p, "max_new_tokens": n}
            for p, n in zip(DENSE_PROMPTS, DENSE_NEW)]

    async def gather(srv):
        return await asyncio.gather(*(srv(r) for r in reqs))

    srv = LLMServer(cfg, params=params, device="cuda", paged=False, **SMALL)
    try:
        served = [r["tokens"]
                  for r in asyncio.run(asyncio.wait_for(gather(srv), 600))]
        streamed = list(srv.stream(reqs[2]))
        srv_check = srv.kv_check()
    finally:
        srv.shutdown()
    # Reconfigure a paged server to dense and back.
    srv = LLMServer(cfg, params=params, device="cuda", page_size=16, **SMALL)
    recon = {}
    try:
        for label, change in (("paged", None), ("dense", {"paged": False}),
                              ("paged_again", {"paged": True})):
            if change:
                srv.reconfigure(change)
            recon[label] = {
                "paged": srv.engine.paged,
                "tokens": [r["tokens"] for r in asyncio.run(
                    asyncio.wait_for(gather(srv), 600))]}
    finally:
        srv.shutdown()
    dense = runs["dense_cuda"]
    row = {"phase": "engine_small_dense_f32", "requests": len(reqs),
           "max_batch": SMALL["max_batch"],
           "dense_cuda_equals_dense_cpu": dense == runs["dense_cpu"],
           "dense_cuda_equals_paged_cuda": dense == runs["paged_cuda"],
           "server_equals_engine": served == dense,
           "stream_equals_call": streamed == dense[2],
           "server_kv_check": srv_check,
           "reconfigure": {k: {"paged": v["paged"],
                               "same_tokens": v["tokens"] == dense}
                           for k, v in recon.items()},
           "graphs": stats, "launches_dense_cuda": dense_launches}
    emit(row)
    if not (row["dense_cuda_equals_dense_cpu"]
            and row["dense_cuda_equals_paged_cuda"]
            and row["server_equals_engine"] and row["stream_equals_call"]
            and all(v["same_tokens"] for v in row["reconfigure"].values())
            and [v["paged"] for v in row["reconfigure"].values()]
            == [True, False, True]):
        raise AssertionError(f"engine_small_dense_f32: tokens: {row}")
    g = stats["dense_cuda"]
    if g["graph_replays"] == 0 or g["decode_windows"] \
            != g["graph_replays"] + g["graph_captures"] \
            or stats["dense_cuda"]["kv_check"] != {"ok": True,
                                                  "paged": False}:
        raise AssertionError(f"engine_small_dense_f32: windows: {g}")
    if dense_launches["paged_decode_attention"] \
            or dense_launches["flash_attention_fwd/fma"] == 0 \
            or dense_launches["flash_attention_fwd/wgmma"]:
        raise AssertionError(f"engine_small_dense_f32: the dense engine's "
                             f"launches {dense_launches}")
    return dense_launches


# ----------------------------------------------- phase 4: full-width 8B
def paged_per_replay(cfg, k: int) -> int:
    """Paged-kernel launches in one replay of a K-step window."""
    return cfg.n_layers * k


def phase_serve_8b(card, cfg, params, t_init):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.tools.profile_serve import trace_wave, wave_decode_rate

    # The hidden states of a real prompt come out finite and shaped.
    probe = torch.arange(1, 65, device="cuda")[None]
    hidden, ks, _ = llama.prefill(params, probe, cfg)
    if hidden.shape != (1, 64, cfg.dim) or ks.shape != (
            cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim) \
            or not torch.isfinite(hidden.float()).all():
        raise AssertionError("llama3-8b prefill gave bad hidden states")
    del hidden, ks

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in MAIN_PROMPTS]
    eng = LLMEngine(cfg, params, seed=SEED)      # engine defaults
    K = eng.steps_per_sync
    eng.start()
    try:
        # Warm-up: a 300-token prompt (prefill bucket 512) whose one decode
        # window captures the greedy K-step graph; the wave below pads to
        # bucket 1024 and every one of its windows replays that graph.
        eng.generate(rng.integers(1, cfg.vocab_size, size=300).tolist(),
                     max_new_tokens=8)
        torch.cuda.synchronize()
        zero_flash_counts()
        paged_decode_attention.launches = 0
        s0 = eng.stats()
        t_wave = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=64) for p in prompts]
        res = [f.result(timeout=600) for f in futs]
        wave_s = time.perf_counter() - t_wave
        ninth = prompts[1][:512] + rng.integers(
            1, cfg.vocab_size, size=200).tolist()
        r9 = eng.submit(ninth, max_new_tokens=64).result(timeout=600)
        torch.cuda.synchronize()
        launches = {n: c for n, c in flash_counts().items()
                    if n.startswith("flash_attention_fwd")}
        launches["paged_decode_attention"] = paged_decode_attention.launches
        s1 = eng.stats()
        # The same wave shape again under torch.profiler (fresh prompts, no
        # prefix hits): the busy share, and the replayed windows' paged
        # kernels counted in the trace against the credited counter.
        traced_prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                          for n in MAIN_PROMPTS]
        p0 = paged_decode_attention.launches
        traced = trace_wave(eng, traced_prompts)
        traced_counter = paged_decode_attention.launches - p0
        graphs = eng.graph_stats()
    finally:
        eng.stop()
    for r in res + [r9]:
        toks = r["tokens"]
        if len(toks) != 64 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            raise AssertionError(f"bad completion: {toks}")
    hit = s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"]
    if hit < 512:
        raise AssertionError(f"ninth request missed the prefix cache: {s1}")
    if launches["paged_decode_attention"] == 0 \
            or launches["flash_attention_fwd/wgmma"] == 0 \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"]:
        raise AssertionError(f"a kernel of the path never launched, or the "
                             f"bf16 forward left its route: {launches}")
    replays = s1["graph_replays"] - s0["graph_replays"]
    windows = s1["decode_windows"] - s0["decode_windows"]
    traced_paged = traced["groups"].get("paged_decode", {}).get("launches")
    if replays == 0 or replays != windows \
            or launches["paged_decode_attention"] \
            != replays * paged_per_replay(cfg, K):
        raise AssertionError(
            f"windows {windows}, replays {replays}, paged launches "
            f"{launches['paged_decode_attention']} != replays x "
            f"{paged_per_replay(cfg, K)}")
    if traced["graph_replays"] != traced["decode_windows"] \
            or traced_paged != traced_counter \
            or traced_counter != traced["graph_replays"] \
            * paged_per_replay(cfg, K):
        raise AssertionError(f"traced wave: profiler counted {traced_paged} "
                             f"paged kernels, the counter {traced_counter}, "
                             f"replays {traced['graph_replays']}")
    ttft = [r["ttft_s"] for r in res]
    emit({"phase": "serve_8b", "card": card, "model": "llama3-8b",
          "dtype": "bfloat16", "requests": len(res) + 1,
          "new_tokens_each": 64, "prompt_tokens": MAIN_PROMPTS,
          "init_params_s": t_init, "wave_s": wave_s,
          "ttft_s": {"min": min(ttft), "max": max(ttft)},
          "prefill_tokens_per_s": sum(MAIN_PROMPTS) / max(ttft),
          "decode_tokens_per_s": wave_decode_rate(res),
          "ninth_ttft_s": r9["ttft_s"], "ninth_prefix_hit_tokens": hit,
          "preemptions": s1["preemptions"], "launches": launches,
          "decode_windows": windows, "graph_replays": replays,
          "graph_capture_s": s1["graph_capture_s"], "graphs": graphs,
          "traced_wave": traced,
          "traced_paged_kernels_profiler": traced_paged,
          "traced_paged_kernels_counter": traced_counter,
          "traced_device_busy_share": traced["device_busy_share"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


LORA_PROMPTS = [300, 420, 510, 350, 470, 280, 505, 390]   # bucket 512


def phase_serve_8b_engine(card, cfg, params):
    """The rest of the engine at `llama3-8b` width and depth in bf16: a
    mixed base / adapter batch on a banked engine (lora_slots 2, rank 16)
    against the same requests on a bank-free engine, one request migrated
    from a prefill engine to a decode engine against the same request run
    alone, and a same-shape weight update on the banked engine, which
    holds its own copy of the weights.  The other three share the
    caller's tree (share_params, read-only); each engine captures its
    greedy window at warm-up, so every counted window is a replay."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.tools.profile_serve import wave_decode_rate

    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(1, V, size=n).tolist() for n in LORA_PROMPTS]
    mig_prompt = rng.integers(1, V, size=700).tolist()
    swap_prompt = rng.integers(1, V, size=400).tolist()
    adapter = llama.init_lora_adapter(
        torch.Generator(device="cuda").manual_seed(SEED + 1), cfg, 16)
    pool = dict(seed=SEED, kv_pages=1 + 8 * 2)
    banked = LLMEngine(cfg, params, lora_slots=2, lora_rank=16,
                       name="banked", **pool)
    shared = dict(pool, share_params=True)
    plain = LLMEngine(cfg, params, name="plain", **shared)
    pre = LLMEngine(cfg, params, name="prefill", **shared)
    dec = LLMEngine(cfg, params, name="decode", **shared)
    engines = (banked, plain, pre, dec)
    K = banked.steps_per_sync
    for e in engines:
        e.start()
    try:
        banked.load_adapter("t/a", adapter)
        warm = rng.integers(1, V, size=100).tolist()
        for e in (banked, plain, dec):
            e.generate(warm, max_new_tokens=K + 1)
        torch.cuda.synchronize()
        zero_flash_counts()
        paged_decode_attention.launches = 0
        s0 = {e.name: e.stats() for e in engines}
        futs = [banked.submit(p, max_new_tokens=32,
                              model_id="t/a" if i % 2 else None)
                for i, p in enumerate(prompts)]
        mixed_res = [f.result(timeout=600) for f in futs]
        futs = [plain.submit(p, max_new_tokens=32) for p in prompts]
        base_res = [f.result(timeout=600) for f in futs]
        mixed = [r["tokens"] for r in mixed_res]
        base = [r["tokens"] for r in base_res]
        alone = plain.generate(mig_prompt, max_new_tokens=32)["tokens"]
        exp = pre.submit(mig_prompt, max_new_tokens=1, prefill_only=True) \
            .result(timeout=600)["kv_export"]
        migrated = dec.kv_import(
            mig_prompt, exp["tokens"], exp["kv"], kv_len=exp["len"],
            max_new_tokens=32, sample_seed=exp["sample_seed"]
        ).result(timeout=600)["tokens"]
        torch.cuda.synchronize()
        launches = {n: c for n, c in flash_counts().items()
                    if n.startswith("flash_attention_fwd")}
        launches["paged_decode_attention"] = paged_decode_attention.launches
        s1 = {e.name: e.stats() for e in engines}
        # A same-shape update of the banked engine's own copy: the values
        # of the shared tree, copied in.  An engine on the shared tree
        # refuses one.
        before = banked.generate(swap_prompt, max_new_tokens=16)["tokens"]
        cached_before = banked._mgr.cached_count()
        replays_before = banked.graph_replays
        version = banked.update_weights(params)
        after = banked.generate(swap_prompt, max_new_tokens=16)["tokens"]
        torch.cuda.synchronize()
        try:
            dec.update_weights(params)
            shared_refused = False
        except ValueError:
            shared_refused = True
        swap = {"version": banked.stats()["weight_version"],
                "staged_version": version,
                "weight_updates": banked.weight_updates,
                "last_weight_sync_ms": banked.last_weight_sync_ms,
                "cached_blocks_before": cached_before,
                "cached_blocks_after": banked._mgr.cached_count(),
                "replays_after_swap": banked.graph_replays - replays_before,
                "captures": len(banked.graph_stats()),
                "same_tokens": after == before,
                "shared_engine_refused": shared_refused}
        graphs = {e.name: e.graph_stats() for e in engines}
    finally:
        for e in engines:
            e.stop()
    gc.collect()
    torch.cuda.empty_cache()
    base_rows = [i for i in range(8) if i % 2 == 0]
    lora_rows = [i for i in range(8) if i % 2]
    replays = sum(s1[n]["graph_replays"] - s0[n]["graph_replays"]
                  for n in s0)
    windows = sum(s1[n]["decode_windows"] - s0[n]["decode_windows"]
                  for n in s0)
    row = {"phase": "serve_8b_engine", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "lora_slots": 2, "lora_rank": 16,
           "prompt_tokens": LORA_PROMPTS, "new_tokens_each": 32,
           "base_rows_equal_bank_free":
               all(mixed[i] == base[i] for i in base_rows),
           "adapter_rows_differ":
               all(mixed[i] != base[i] for i in lora_rows),
           "migrated_equals_alone": migrated == alone,
           "decode_tokens_per_s": {
               "banked_mixed": wave_decode_rate(mixed_res),
               "bank_free": wave_decode_rate(base_res)},
           "kv_export_shape": list(exp["kv"].shape),
           "kv_exports": s1["prefill"]["kv_exports"],
           "kv_imports": s1["decode"]["kv_imports"],
           "weight_swap": swap, "launches": launches,
           "decode_windows": windows, "graph_replays": replays,
           "replays_by_engine": {n: s1[n]["graph_replays"]
                                 - s0[n]["graph_replays"] for n in s0},
           "graph_capture_s": {n: s1[n]["graph_capture_s"] for n in s1},
           "graphs": graphs}
    emit(row)
    if not (row["base_rows_equal_bank_free"] and row["adapter_rows_differ"]
            and row["migrated_equals_alone"] and row["kv_exports"] == 1
            and row["kv_imports"] == 1):
        raise AssertionError(f"serve_8b_engine: tokens disagree: {row}")
    if not (swap["version"] == 1 and swap["weight_updates"] == 1
            and swap["cached_blocks_before"] > 0
            and swap["cached_blocks_after"] == 0
            and swap["replays_after_swap"] > 0 and swap["captures"] == 1
            and swap["same_tokens"] and swap["shared_engine_refused"]):
        raise AssertionError(f"serve_8b_engine: weight swap: {swap}")
    if replays == 0 or replays != windows \
            or launches["paged_decode_attention"] \
            != replays * paged_per_replay(cfg, K) \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"]:
        raise AssertionError(f"serve_8b_engine: windows {windows}, replays "
                             f"{replays}, launches {launches}")
    return launches


def server_wave(srv, reqs, hold=False):
    """`srv(r)` for every request at once (asyncio.gather); (results,
    seconds).  With `hold`, the requests are queued while the server's
    engine loop is stopped and admitted as one wave when it restarts."""
    async def go():
        eng = srv.engine
        if hold:
            eng.stop()
        tasks = [asyncio.ensure_future(srv(r)) for r in reqs]
        if hold:
            deadline = time.monotonic() + 120
            while eng._waiting.qsize() < len(reqs):
                if time.monotonic() > deadline:
                    raise AssertionError("the held wave never queued")
                await asyncio.sleep(0.001)
            eng.start()
        return await asyncio.gather(*tasks)

    t0 = time.perf_counter()
    res = asyncio.run(asyncio.wait_for(go(), 600))
    return res, time.perf_counter() - t0


def engine_wave(eng, prompts, new, hold=False):
    """The bare engine's counterpart of server_wave."""
    if hold:
        eng.stop()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    if hold:
        eng.start()
    res = [f.result(timeout=600) for f in futs]
    return res, time.perf_counter() - t0


class KvDecodeDown:
    """Decode-pool handle whose `kv_decode` raises (a decode replica lost
    mid-migration); its other methods go to `local`."""

    def __init__(self, local, method_name="__call__"):
        self._local, self._method = local, method_name

    def options(self, *, method_name="__call__"):
        return KvDecodeDown(self._local, method_name)

    def remote(self, *args, **kwargs):
        if self._method == "kv_decode":
            raise RuntimeError("decode replica lost")
        return self._local.options(method_name=self._method).remote(
            *args, **kwargs)


def launch_counts() -> dict:
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    out = {n: c for n, c in flash_counts().items()
           if n.startswith("flash_attention_fwd")}
    out["paged_decode_attention"] = paged_decode_attention.launches
    return out


def zero_serve_counts() -> None:
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    zero_flash_counts()
    paged_decode_attention.launches = 0


def wave_row(res, wave_s) -> dict:
    from ray_tpu_torch.tools.profile_serve import wave_decode_rate

    ttft = [r["ttft_s"] for r in res]
    return {"wave_s": wave_s,
            "tokens_per_s": sum(len(r["tokens"]) for r in res) / wave_s,
            "decode_tokens_per_s": wave_decode_rate(res),
            "ttft_s": {"min": min(ttft), "max": max(ttft)}}


def phase_serve_8b_server(card, cfg, params, device="cuda"):
    """LLMServer on `cfg` in bf16 with `params` (see 4c in the module
    docstring)."""
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer
    from ray_tpu_torch.serve.runtime import LocalHandle

    V, new = cfg.vocab_size, 64
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    fresh = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    warm = rng.integers(1, V, size=300).tolist()
    reqs = [{"prompt": p, "max_new_tokens": new} for p in prompts]
    knobs = dict(seed=SEED, max_batch=8, page_size=512)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()

    def call(srv, req):
        return asyncio.run(asyncio.wait_for(srv(req), 600))

    # (a) unified, against a bare engine on the caller's tree.
    srv = LLMServer(cfg, params=params, device=device, **knobs)
    bare = LLMEngine(cfg, params, share_params=True, device=device,
                     name="bare", **knobs)
    K = srv.engine.steps_per_sync
    bare.start()
    try:
        call(srv, {"prompt": warm, "max_new_tokens": K + 1})
        bare.generate(warm, max_new_tokens=K + 1)
        torch.cuda.synchronize()
        zero_serve_counts()
        s0 = srv.stats()
        held, _ = server_wave(srv, reqs, hold=True)
        # Alone after the wave: the stream and its call both hit the
        # wave's cached prefix of prompts[0].
        one = {"prompt": prompts[0], "max_new_tokens": new}
        streamed = list(srv.stream(one))
        called = call(srv, one)["tokens"]
        torch.cuda.synchronize()
        launches_a = launch_counts()
        s1 = srv.stats()
        bare_held, _ = engine_wave(bare, prompts, new, hold=True)
        srv_t, srv_s = server_wave(
            srv, [{"prompt": p, "max_new_tokens": new} for p in fresh])
        bare_t, bare_s = engine_wave(bare, fresh, new)
        bare.stop()
        del bare
        # (c) reconfigure: K 4 rebuilds the engine.
        old = srv.engine
        srv.reconfigure({"steps_per_sync": 4})
        rebuilt = (srv.engine is not old and srv.engine.steps_per_sync == 4
                   and not old._thread.is_alive())
        del old
        gc.collect()
        torch.cuda.empty_cache()
        k4 = LLMEngine(cfg, params, share_params=True, device=device,
                       name="k4", steps_per_sync=4, **knobs)
        k4.start()
        try:
            after = call(srv, {"prompt": prompts[1],
                               "max_new_tokens": new})["tokens"]
            want_k4 = k4.generate(prompts[1], max_new_tokens=new)["tokens"]
        finally:
            k4.stop()
        st_c = srv.stats()
    finally:
        srv.shutdown()
    check_c = srv.kv_check()
    del srv, k4
    gc.collect()
    torch.cuda.empty_cache()

    # (b) PD: a prefill-role and a decode-role server, each with its own
    # copy of the weights, linked by an in-process handle.
    dec = LLMServer(cfg, params=params, device=device, role="decode",
                    **knobs)
    local = LocalHandle(dec)
    pre = LLMServer(cfg, params=params, device=device, role="prefill",
                    decode_deployment=local, **knobs)
    try:
        call(pre, {"prompt": warm, "max_new_tokens": K + 1})
        torch.cuda.synchronize()
        zero_serve_counts()
        p0, d0 = pre.stats(), dec.stats()
        pd_res, pd_s = server_wave(pre, reqs, hold=True)
        torch.cuda.synchronize()
        launches_b = launch_counts()
        p1, d1 = pre.stats(), dec.stats()
        pre.reconfigure({"decode_deployment": KvDecodeDown(local)})
        fb = call(pre, {"prompt": prompts[2], "max_new_tokens": 8})
        fb_stats = pre.stats()["pd"]
        checks_b = (pre.kv_check(), dec.kv_check())
    finally:
        pre.shutdown()
        dec.shutdown()
        local.close()
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()

    a_tokens = [r["tokens"] for r in held]
    migrations = p1["pd"]["migrations"] - p0["pd"]["migrations"]
    pd_bytes = p1["pd"]["kv_migrate_bytes"] - p0["pd"]["kv_migrate_bytes"]
    replays_a = s1["graph_replays"] - s0["graph_replays"]
    windows_a = s1["decode_windows"] - s0["decode_windows"]
    replays_b = d1["graph_replays"] - d0["graph_replays"]
    windows_b = d1["decode_windows"] - d0["decode_windows"]
    row = {"phase": "serve_8b_server", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "max_batch": 8, "page_size": 512,
           "steps_per_sync": K, "prompt_tokens": MAIN_PROMPTS,
           "new_tokens_each": new,
           "unified": {
               "same_tokens_as_bare_engine":
                   a_tokens == [r["tokens"] for r in bare_held],
               "stream_equals_call": streamed == called,
               "stream_tokens": len(streamed),
               "server": wave_row(srv_t, srv_s),
               "bare_engine": wave_row(bare_t, bare_s),
               "held_wave_server_ttft_s": [r["ttft_s"] for r in held],
               "decode_windows": windows_a, "graph_replays": replays_a,
               "launches": launches_a},
           "reconfigure": {
               "rebuilt": rebuilt, "sync_window": st_c["sync_window"],
               "same_tokens_as_bare_k4": after == want_k4,
               "same_tokens_as_k8_wave": after == a_tokens[1],
               "kv_check_after_shutdown": check_c},
           "pd": {
               "same_tokens_as_unified": [r["tokens"] for r in pd_res]
                   == a_tokens,
               "migrations": migrations, "requests": len(reqs),
               "wave": wave_row(pd_res, pd_s),
               "kv_migrate_bytes": pd_bytes,
               "kv_migrate_bytes_per_request": pd_bytes / max(1, migrations),
               "kv_migrate_put_ms": p1["pd"]["kv_migrate_put_ms"]
                   - p0["pd"]["kv_migrate_put_ms"],
               "kv_pull_ms": d1["pd"]["kv_pull_ms"] - d0["pd"]["kv_pull_ms"],
               "kv_pull_bytes": d1["pd"]["kv_pull_bytes"]
                   - d0["pd"]["kv_pull_bytes"],
               "total_s": [r["total_s"] for r in pd_res],
               "fallback": fb.get("pd_fallback"),
               "fallback_tokens": len(fb["tokens"]),
               "fallbacks": fb_stats["fallbacks"],
               "decode_windows": windows_b, "graph_replays": replays_b,
               "kv_check": list(checks_b),
               "launches": launches_b},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    u, c, pd = row["unified"], row["reconfigure"], row["pd"]
    if not (u["same_tokens_as_bare_engine"] and u["stream_equals_call"]
            and u["stream_tokens"] == new
            and all(len(t) == new for t in a_tokens)):
        raise AssertionError(f"serve_8b_server: unified tokens: {u}")
    if not (c["rebuilt"] and c["sync_window"] == 4
            and c["same_tokens_as_bare_k4"]):
        raise AssertionError(f"serve_8b_server: reconfigure: {c}")
    if not (pd["same_tokens_as_unified"] and migrations == len(reqs)
            and pd["kv_pull_bytes"] == pd_bytes > 0
            and pd["fallback"] == "full_reprefill"
            and pd["fallback_tokens"] == 8 and pd["fallbacks"] == 1):
        raise AssertionError(f"serve_8b_server: PD: {pd}")
    for name, launches, replays, windows in (
            ("unified", launches_a, replays_a, windows_a),
            ("pd", launches_b, replays_b, windows_b)):
        if launches["paged_decode_attention"] == 0 \
                or launches["flash_attention_fwd/wgmma"] == 0 \
                or launches["flash_attention_fwd/wgmma"] \
                != launches["flash_attention_fwd"] \
                or replays == 0 or replays != windows \
                or launches["paged_decode_attention"] != replays * L * K:
            raise AssertionError(
                f"serve_8b_server {name}: windows {windows}, replays "
                f"{replays}, launches {launches}")
    return {"unified": launches_a, "pd": launches_b}


def phase_serve_8b_dense(card, cfg, params):
    """The dense engine (paged=False) on `llama3-8b` in bf16 at the
    engine's defaults (max_len cfg.max_seq, max_batch 8, K 8), on the
    caller's weights (share_params), against a paged engine on the same
    weights: the eight MAIN_PROMPTS requests as one held wave on each.
    Both prefill the same wave through the flash forward, so each
    request's first token must be the paged engine's; later tokens come
    from einsum attention over the dense cache against the paged kernel
    and may round differently in bf16 (their share of equal tokens is
    reported, not asserted)."""
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.tools.profile_serve import trace_wave, wave_decode_rate

    V, new = cfg.vocab_size, 64
    rng = np.random.default_rng(SEED + 24)
    prompts = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    warm = rng.integers(1, V, size=300).tolist()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paged = LLMEngine(cfg, params, share_params=True, seed=SEED,
                      name="paged")
    paged.start()
    try:
        paged.generate(warm, max_new_tokens=paged.steps_per_sync + 1)
        want, _ = engine_wave(paged, prompts, new, hold=True)
    finally:
        paged.stop()
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    eng = LLMEngine(cfg, params, share_params=True, seed=SEED, paged=False,
                    name="dense")
    K = eng.steps_per_sync
    cache_bytes = sum(t.nbytes for kk in ("k", "v") for t in eng.cache[kk])
    eng.start()
    try:
        # Warm-up captures the K-step window; every counted one replays.
        eng.generate(warm, max_new_tokens=K + 1)
        torch.cuda.synchronize()
        zero_serve_counts()
        s0 = eng.stats()
        res, wave_s = engine_wave(eng, prompts, new, hold=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        s1 = eng.stats()
        check = eng.kv_check()
        # The same wave shape on fresh prompts under torch.profiler.
        traced = trace_wave(eng, [rng.integers(1, V, size=n).tolist()
                                  for n in MAIN_PROMPTS])
        graphs = eng.graph_stats()
    finally:
        eng.stop()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    got = [r["tokens"] for r in res]
    ref = [r["tokens"] for r in want]
    decoded = [(a[1:], b[1:]) for a, b in zip(got, ref)]
    equal = sum(x == y for a, b in decoded for x, y in zip(a, b))
    total = sum(len(a) for a, _ in decoded)
    replays = s1["graph_replays"] - s0["graph_replays"]
    windows = s1["decode_windows"] - s0["decode_windows"]
    row = {"phase": "serve_8b_dense", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "paged": False, "max_len": cfg.max_seq,
           "max_batch": 8, "steps_per_sync": K,
           "prompt_tokens": MAIN_PROMPTS, "new_tokens_each": new,
           "first_tokens_equal_paged": [a[0] == b[0]
                                        for a, b in zip(got, ref)],
           "decoded_equal_share": equal / total,
           "decoded_equal": equal, "decoded": total,
           "dense": wave_row(res, wave_s),
           "paged_engine_decode_tokens_per_s": wave_decode_rate(want),
           "dense_cache_bytes": cache_bytes,
           "decode_windows": windows, "graph_replays": replays,
           "graph_capture_s": s1["graph_capture_s"], "graphs": graphs,
           "kv_check": check, "launches": launches,
           "traced_wave": traced,
           "traced_device_busy_share": traced["device_busy_share"],
           "peak_mem_gb": peak}
    emit(row)
    if not all(row["first_tokens_equal_paged"]) \
            or any(len(t) != new for t in got) \
            or not all(0 <= t < V for toks in got for t in toks):
        raise AssertionError(f"serve_8b_dense: tokens: {row}")
    if replays == 0 or replays != windows \
            or launches["paged_decode_attention"] \
            or launches["flash_attention_fwd/wgmma"] == 0 \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"] \
            or check != {"ok": True, "paged": False}:
        raise AssertionError(f"serve_8b_dense: windows {windows}, replays "
                             f"{replays}, launches {launches}, {check}")
    return launches


# --------------------------------------------- phase 5: small f32 training
def flash_counts() -> dict:
    """Launches of each flash wrapper and, as "<wrapper>/<route>", of each
    dtype route of the forward and dK/dV."""
    from ray_tpu_torch.ops import flash_attention as fa

    out = {}
    for n in FLASH_KERNELS:
        fn = getattr(fa, n)
        out[n] = fn.launches
        for route, c in getattr(fn, "launches_by_route", {}).items():
            out[f"{n}/{route}"] = c
    return out


def zero_flash_counts() -> None:
    from ray_tpu_torch.ops import flash_attention as fa

    for n in FLASH_KERNELS:
        fn = getattr(fa, n)
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# CUDA against CPU in f32: the loss and the pre-clip grad norm to 1e-4
# relative, the params after three steps to 5e-5 + 1e-4 relative.  Both
# sides sum in other orders (the kernels' FMA loops, cuBLAS against the
# CPU's BLAS), and Adam's first normalised steps magnify the noise of
# gradient elements near zero.
TRAIN_TOL = dict(atol=5e-5, rtol=1e-4)


def phase_train_small():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step,
                                          param_leaves)

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(llama.llama_configs()["debug"],
                               dtype=torch.float32)
    opt = default_optimizer(lr=1e-3, warmup=2, total_steps=10,
                            grad_clip=0.1)
    params = llama.init_params(base, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(1, base.vocab_size, size=(2, 101))}
    runs, row = {}, {"phase": "train_small_f32", "seq": 100, "batch": 2,
                     "n_layers": base.n_layers, "steps": 3}
    zero_flash_counts()
    for label, remat in (("flash_resid", True), ("nothing", True),
                         ("remat_off", False)):
        cfg = dataclasses.replace(base, remat=remat,
                                  remat_mode="nothing" if label == "nothing"
                                  else "flash_resid")
        for device in ("cuda", "cpu"):
            state = create_train_state(SEED, cfg, opt, device=device,
                                       params=params)
            step = make_train_step(cfg, opt, device=device)
            out = {"loss": [], "grad_norm": [], "launches_per_step": []}
            for _ in range(3):
                n0 = flash_counts()
                state, m = step(state, batch)
                out["loss"].append(m["loss"].item())
                out["grad_norm"].append(m["grad_norm"].item())
                out["launches_per_step"].append(
                    {n: c - n0[n] for n, c in flash_counts().items()})
            out["params"] = tree_to(state.params, "cpu")
            runs[label, device] = out
        gpu, cpu = runs[label, "cuda"], runs[label, "cpu"]
        diff = max(float((a - b).abs().max()) for a, b in zip(
            param_leaves(gpu["params"]), param_leaves(cpu["params"])))
        row[label] = {"loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
                      "grad_norm_cuda": gpu["grad_norm"],
                      "grad_norm_cpu": cpu["grad_norm"],
                      "param_max_abs_diff": diff,
                      "launches_per_step": gpu["launches_per_step"][-1]}
        np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=1e-4)
        np.testing.assert_allclose(gpu["grad_norm"], cpu["grad_norm"],
                                   rtol=1e-4)
        for a, b in zip(param_leaves(gpu["params"]),
                        param_leaves(cpu["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TRAIN_TOL)
        fwd = 2 * base.n_layers if label == "nothing" else base.n_layers
        want = {"flash_attention_fwd": fwd, "flash_attention_fwd/fma": fwd,
                "flash_attention_fwd/wgmma": 0,
                "flash_attention_bwd_dq": base.n_layers,
                "flash_attention_bwd_dq/fma": base.n_layers,
                "flash_attention_bwd_dq/wgmma": 0,
                "flash_attention_bwd_dkv": base.n_layers,
                "flash_attention_bwd_dkv/fma": base.n_layers,
                "flash_attention_bwd_dkv/wgmma": 0}
        if any(per != want for per in gpu["launches_per_step"]) or any(
                c for per in cpu["launches_per_step"] for c in per.values()):
            raise AssertionError(f"train_small {label}: launches "
                                 f"{gpu['launches_per_step']} != {want}")
    row["tol"] = {"loss_rel": 1e-4, "grad_norm_rel": 1e-4,
                  "params": TRAIN_TOL}
    row["launches"] = launches = flash_counts()
    emit(row)
    return launches


def named_leaves(tree, prefix=""):
    """(path, tensor) in param_leaves' order (sorted key paths)."""
    if isinstance(tree, dict):
        return [nt for k in sorted(tree)
                for nt in named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


# ----------------------------------------------- phase 6: bench-350m steps
def phase_train_350m(card):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools.profile_serve import kernel_group, kernel_groups
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    cfg = llama.llama_configs()["bench-350m"]
    batch_size, seq, n_timed = 8, 2048, 5
    opt = default_optimizer(total_steps=1000)
    t0 = time.perf_counter()
    state = create_train_state(SEED, cfg, opt)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch_size, seq))).to("cuda")
    batch = {"inputs": tokens, "targets": tokens}      # bench.py's batch
    step = make_train_step(cfg, opt)
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in named_leaves(state.params)}
    torch.cuda.reset_peak_memory_stats()

    def moved_share() -> dict:
        """Per leaf, the share of elements that differ from `before`."""
        return {n: float((p.detach().cpu() != before[n]).float().mean())
                for n, p in named_leaves(state.params)}

    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, lr 0
    loss0 = m["loss"].item()
    warmup_s = time.perf_counter() - t0
    if any(moved_share().values()):
        raise AssertionError("the first update (lr 0) moved the params")
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    zero_flash_counts()
    for i in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:                                     # after update 2
            moved2 = moved_share()
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = moved_share()
    del before

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels, groups = kernel_groups(prof)
    device_ms = sum(ms for ms, _ in groups.values())
    top_other = sorted(((n, ms, c) for n, (ms, c) in kernels.items()
                        if kernel_group(n) == "other"),
                       key=lambda t: -t[1])[:10]
    fma_traced = {n[:100]: c for n, (_, c) in kernels.items()
                  if any(k in n for k in ("flash_fwd_kernel",
                                          "flash_bwd_dq_kernel",
                                          "flash_bwd_dkv_kernel"))}

    mean_ms = sum(step_ms) / len(step_ms)
    tokens_per_s = batch_size * seq / (mean_ms / 1e3)
    flops_per_token = cfg.flops_per_token()
    row = {"phase": "train_350m", "card": card, "model": "bench-350m",
           "dtype": "bfloat16", "params": cfg.num_params(),
           "batch": batch_size, "seq": seq, "remat_mode": cfg.remat_mode,
           "init_params_s": t_init, "warmup_step_s": warmup_s,
           "first_loss": loss0, "ln_vocab": math.log(cfg.vocab_size),
           "loss": losses, "grad_norm": norms, "step_ms": step_ms,
           "mean_step_ms": mean_ms, "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token,
           "mfu": tokens_per_s * flops_per_token / BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "moved_share_after_update_2": moved2,
           "moved_share_after_update_6": moved,
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())},
           "traced_fma_flash_launches": fma_traced,
           "traced_top_other": [{"name": n[:100], "ms": ms, "launches": c}
                                for n, ms, c in top_other]}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms + [loss0]):
        raise AssertionError(f"non-finite loss or grad norm: {row}")
    if abs(loss0 - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {loss0} is far from ln(vocab)")
    if any(c != (0 if n.endswith("/fma") else n_timed * cfg.n_layers)
           for n, c in launches.items()):
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.n_layers} per step, all bf16 routes")
    if fma_traced:
        raise AssertionError(f"FMA flash kernels ran in the bf16 step: "
                             f"{fma_traced}")
    traced = {g: groups.get(g, [0.0, 0])[1]
              for g in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if any(n != cfg.n_layers for n in traced.values()):
        raise AssertionError(f"traced step's flash groups {traced} != "
                             f"{cfg.n_layers} launches each")
    # Every matrix moves from the second update on.  The norm weights sit
    # at 1.0, where a bf16 step is 2^-7: warm-up updates of about lr *
    # count / warmup (1.5e-5 by the sixth) round away there, as they do in
    # the reference's bf16 params.
    still = [n for n, share in moved2.items()
             if share == 0 and not n.endswith("norm")]
    if still:
        raise AssertionError(f"params did not move: {still}")
    return launches


# ------------------------------------- phase 6b: bench-350m, sharded step
# The sharded step against the single-device step from the same state, in
# bf16: on a one-rank mesh every placement is Replicate and the DTensor ops
# run the same local kernels on the same data in the same order, so the
# loss and the pre-clip grad norm must be equal to the bit (PERF.md keeps
# the readings: every step of every run so far was).  Any difference means
# the sharded path computes something else.


def phase_train_350m_sharded(card):
    """`bench-350m` through `sharded_train_step` on a one-rank NCCL group
    (a file:// store in a temporary directory) and `create_mesh(
    MeshConfig(data=1))` on CUDA: the state, batch and optimizer of
    train_350m laid out with `reshard_state`, then a warm-up step and
    four timed steps, each beside the single-device step from the same
    state.  The group is destroyed whatever happens; if NCCL or the mesh
    cannot be set up, the phase fails."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step,
                                          reshard_state, sharded_train_step)

    cfg = llama.llama_configs()["bench-350m"]
    batch_size, seq, n_timed = 8, 2048, 4
    opt = default_optimizer(total_steps=1000)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch_size, seq))).to("cuda")
    batch = {"inputs": tokens, "targets": tokens}      # train_350m's batch
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{store}/store", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=300))
        mesh = create_mesh(MeshConfig(data=1))
        single = create_train_state(SEED, cfg, opt)
        t0 = time.perf_counter()
        sharded = reshard_state(single, cfg, opt, mesh)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        steps = {"single": make_train_step(cfg, opt),
                 "sharded": sharded_train_step(cfg, opt, mesh)}
        states = {"single": single, "sharded": sharded}
        out = {k: {"loss": [], "grad_norm": [], "step_ms": [],
                   "launches": []} for k in steps}
        for i in range(1 + n_timed):          # step 0: warm-up, lr 0
            for name in ("single", "sharded"):
                torch.cuda.synchronize()
                zero_flash_counts()
                t0 = time.perf_counter()
                states[name], m = steps[name](states[name], batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rec = out[name]
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                rec["launches"].append(flash_counts())
                if i:
                    rec["step_ms"].append(ms)
        placements = {str(p.placements) for p in
                      (states["sharded"].params["embed"],
                       states["sharded"].params["layers"]["wq"])}
        mesh_desc = str(mesh)
        # One more sharded step under torch.profiler: its device time
        # against its wall time.
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            steps["sharded"](states["sharded"], batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        _, groups = kernel_groups(prof)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del states, steps, single, sharded
    gc.collect()
    torch.cuda.empty_cache()

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    flops = cfg.flops_per_token()
    row = {"phase": "train_350m_sharded", "card": card,
           "model": "bench-350m", "dtype": "bfloat16", "mesh": mesh_desc,
           "placements": sorted(placements), "batch": batch_size,
           "seq": seq, "remat_mode": cfg.remat_mode,
           "reshard_state_s": reshard_s, "tol": "bitwise",
           "traced_sharded_step_ms": traced_ms,
           "traced_device_ms": sum(ms for ms, _ in groups.values()),
           "traced_device_busy_share":
               sum(ms for ms, _ in groups.values()) / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())}}
    for name, rec in out.items():
        mean_ms = sum(rec["step_ms"]) / len(rec["step_ms"])
        tps = batch_size * seq / (mean_ms / 1e3)
        row[name] = {"loss": rec["loss"], "grad_norm": rec["grad_norm"],
                     "step_ms": rec["step_ms"], "mean_step_ms": mean_ms,
                     "tokens_per_s": tps, "mfu": tps * flops / BF16_FLOPS,
                     "launches_per_step": rec["launches"][-1]}
    row["max_loss_rel_diff"] = rel(out["sharded"]["loss"],
                                   out["single"]["loss"])
    row["max_grad_norm_rel_diff"] = rel(out["sharded"]["grad_norm"],
                                        out["single"]["grad_norm"])
    row["max_loss_abs_diff"] = max(abs(x - y) for x, y in zip(
        out["sharded"]["loss"], out["single"]["loss"]))
    emit(row)
    if not all(math.isfinite(x) for rec in out.values()
               for x in rec["loss"] + rec["grad_norm"]):
        raise AssertionError(f"train_350m_sharded: non-finite: {row}")
    if out["sharded"]["loss"] != out["single"]["loss"] \
            or out["sharded"]["grad_norm"] != out["single"]["grad_norm"]:
        raise AssertionError(f"train_350m_sharded: the sharded step left "
                             f"the single-device step: {row}")
    want = {n: (0 if n.endswith("/fma") else cfg.n_layers)
            for n in out["single"]["launches"][-1]}
    for name, rec in out.items():
        if any(per != want for per in rec["launches"]):
            raise AssertionError(f"train_350m_sharded {name}: launches "
                                 f"{rec['launches']} != {want}")
    return {n: sum(per[n] for per in out["sharded"]["launches"])
            for n in want}


# ------------------------------------------------------ phase 7: online RLHF
def rlhf_counts() -> dict:
    """The flash counts and the paged kernel's launches."""
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    return {**flash_counts(),
            "paged_decode_attention": paged_decode_attention.launches}


def recording_worker():
    """LLMRolloutWorker that keeps each trajectory it returns (the
    trainer's worker_cls extension point)."""
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class Recording(LLMRolloutWorker):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.trajs = []

        def rollout(self, *a, **kw):
            traj = super().rollout(*a, **kw)
            self.trajs.append(traj)
            return traj

    return Recording


def engine_graphs(tr) -> dict:
    return graph_accounting(tr.workers[0].engine.stats())


def phase_rlhf_small():
    """The in-process GRPO loop at `debug` in f32 on CUDA and on the CPU
    from the same params: three steps each (see 7 in the module
    docstring)."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import GRPOLearner, RLHFConfig, RLHFTrainer
    from ray_tpu_torch.train.step import param_leaves

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    base = dict(model=cfg, seed=SEED, n_prompts=4, prompt_len=10,
                group_size=4, prompts_per_step=2, max_new_tokens=5,
                temperature=1.0, lr=1e-2, worker_cls=recording_worker(),
                engine=dict(max_batch=8, max_len=128, page_size=16,
                            steps_per_sync=3))
    runs, n_steps = {}, 3
    for device in ("cuda", "cpu"):
        tr = RLHFTrainer(RLHFConfig(**base, params=tree_to(params, device),
                                    device=device))
        try:
            rec = {"metrics": [], "graphs": [], "versions": []}
            if device == "cuda":
                torch.cuda.synchronize()
                zero_serve_counts()
            for i in range(n_steps):
                m = tr.step()
                if i == 0:
                    # The first update's gradients: both learners start
                    # from the same params and trajectories.
                    rec["grads"] = [p.grad.detach().to("cpu", copy=True)
                                    for p in param_leaves(tr.learner.params)]
                rec["metrics"].append(m)
                rec["graphs"].append(engine_graphs(tr))
                rec["versions"].append(
                    (tr.stats()["workers"][0]["weight_version"],
                     tr.learner.version))
            rec["trajs"] = tr.workers[0].trajs
            rec["params"] = tr.learner.get_params_numpy()
            if device == "cuda":
                torch.cuda.synchronize()
                rec["launches"] = rlhf_counts()
                rec["ckpt"] = checkpoint_roundtrip(tr, GRPOLearner,
                                                   tempfile, shutil)
        finally:
            tr.shutdown()
        runs[device] = rec
    gpu, cpu = runs["cuda"], runs["cpu"]
    same_tokens = [bool(np.array_equal(a["tokens"], b["tokens"])
                        and np.array_equal(a["mask"], b["mask"]))
                   for a, b in zip(gpu["trajs"], cpu["trajs"])]
    # The backward kernels are held where their output is: the first
    # update's gradients, leaf by leaf, against the CPU's (max error over
    # the leaf's max).  The params after three Adam steps at lr 1e-2 are
    # reported but not bounded: Adam moves an element by lr * m / (sqrt(v)
    # + eps), so where a gradient sums to near eps, f32 rounding on either
    # device picks the sign of a step of up to lr.
    grad_rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(gpu["grads"], cpu["grads"])]
    flat = {k: torch.cat([t.detach().reshape(-1).cpu()
                          for t in param_leaves(tree)])
            for k, tree in (("cuda", gpu["params"]), ("cpu", cpu["params"]))}
    diffs = {"advantages": max(float(np.abs(a["advantages"]
                                            - b["advantages"]).max())
                               for a, b in zip(gpu["metrics"],
                                               cpu["metrics"])),
             "first_update_grads_rel": max(grad_rel),
             "params_after_3_updates": float((flat["cuda"]
                                              - flat["cpu"]).abs().max())}
    for k in ("loss", "policy_loss", "kl", "ratio_mean"):
        diffs[k] = max(abs(a[k] - b[k]) for a, b in
                       zip(gpu["metrics"], cpu["metrics"]))
    launches = gpu["launches"]
    g = gpu["graphs"]
    row = {"phase": "rlhf_small_f32", "model": "debug", "dtype": "float32",
           "steps": n_steps, "same_tokens_and_masks": same_tokens,
           "max_abs_diff": diffs, "tol": 1e-4,
           "loss_cuda": [m["loss"] for m in gpu["metrics"]],
           "loss_cpu": [m["loss"] for m in cpu["metrics"]],
           "reward_mean": [m["reward_mean"] for m in gpu["metrics"]],
           "versions_engine_learner": gpu["versions"], "graphs": g,
           "launches": launches, "checkpoint": gpu["ckpt"]}
    emit(row)
    if not all(same_tokens):
        raise AssertionError("rlhf_small: trajectories differ between "
                             "CUDA and the CPU")
    for a, b in zip(gpu["metrics"], cpu["metrics"]):
        np.testing.assert_allclose(a["advantages"], b["advantages"],
                                   atol=1e-4, rtol=0)
        for k in ("loss", "policy_loss", "kl", "ratio_mean"):
            if abs(a[k] - b[k]) > 1e-4 * max(1.0, abs(b[k])):
                raise AssertionError(f"rlhf_small: {k} {a[k]} != {b[k]}")
    if not all(g <= 1e-4 for g in grad_rel):
        raise AssertionError(f"rlhf_small: first-update gradients differ "
                             f"from the CPU's: {grad_rel}")
    if any(e != lv for e, lv in gpu["versions"] + cpu["versions"]):
        raise AssertionError(f"rlhf_small: engine and learner versions "
                             f"{gpu['versions']} {cpu['versions']}")
    per_update = cfg.n_layers * n_steps
    if (launches["paged_decode_attention"] == 0
            or launches["flash_attention_fwd/fma"] < 3 * cfg.n_layers
            * n_steps
            or launches["flash_attention_fwd/wgmma"]
            or launches["flash_attention_bwd_dq/fma"] != per_update
            or launches["flash_attention_bwd_dkv/fma"] != per_update
            or launches["flash_attention_bwd_dq/wgmma"]
            or launches["flash_attention_bwd_dkv/wgmma"]):
        raise AssertionError(f"rlhf_small: launches {launches}")
    for prev, cur in zip(g, g[1:]):
        new = cur["decode_windows"] - prev["decode_windows"]
        if new == 0 or cur["graph_replays"] - prev["graph_replays"] != new:
            raise AssertionError(f"rlhf_small: a window after a weight "
                                 f"swap was not a replay: {g}")
    if g[-1]["decode_windows"] != g[-1]["graph_replays"] \
            + g[-1]["graph_captures"] or g[-1]["graph_captures"] != 1:
        raise AssertionError(f"rlhf_small: windows {g[-1]}")
    if not gpu["ckpt"]["bitwise"]:
        raise AssertionError(f"rlhf_small: checkpoint {gpu['ckpt']}")
    return launches


def checkpoint_roundtrip(tr, learner_cls, tempfile, shutil) -> dict:
    """save_async, then an update (in place) before the write is waited
    for; a fresh learner loaded from the file must hold the saved state
    to the bit."""
    from ray_tpu_torch.train.step import param_leaves

    learner = tr.learner

    def leaves(st):
        o = st["opt_state"]
        return (param_leaves(st["params"]) + param_leaves(o["mu"])
                + param_leaves(o["nu"]) + [o["count"]])

    saved = [t.detach().clone() for t in leaves(learner.state_tree())]
    version = learner.version
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        learner.save_async(os.path.join(d, "v"))
        learner.update(tr.workers[0].trajs[-1])
        learner.ckpt_wait()
        fresh = learner_cls(tr.cfg)
        fresh.load(os.path.join(d, "v"))
        got = leaves(fresh.state_tree())
        moved = any(not torch.equal(a, b) for a, b in
                    zip(saved, leaves(learner.state_tree())))
        bitwise = fresh.version == version and all(
            a.dtype == b.dtype and torch.equal(a.to(b.device), b)
            for a, b in zip(got, saved))
        del fresh
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"bitwise": bitwise, "update_moved_state": moved,
            "version": version}


RLHF_350M = dict(n_prompts=8, prompt_len=384, group_size=8,
                 prompts_per_step=2, max_new_tokens=64, temperature=1.0,
                 lr=1e-6, engine=dict(max_batch=16, max_len=512,
                                      page_size=64, steps_per_sync=4))


def rlhf_350m_trainer(cfg):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer

    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    return RLHFTrainer(RLHFConfig(model=cfg, params=params, seed=SEED,
                                  worker_cls=recording_worker(),
                                  **RLHF_350M))


def step_row(m: dict, traj: dict, step_s: float) -> dict:
    r = m["rollout"]
    B, T = traj["tokens"].shape
    # The learner's positions that hold a real next token: each row's
    # total_len - 1, not the pow2 width's padding.
    positions = int(traj["total_len"].sum()) - B
    return {"step_s": step_s, "rollout_s": r["gen_s"],
            "decode_tokens_per_s": r["rollout_tokens"] / r["gen_s"],
            "completion_tokens": r["rollout_tokens"],
            "scoring_s": r["score_s"], "update_s": m["update_s"],
            "learner_positions": positions,
            "learner_tokens_per_s": positions / m["update_s"],
            "weight_sync_ms": m["step_weight_sync_ms"],
            "reward_mean": m["reward_mean"], "loss": m["loss"],
            "kl": m["kl"], "ratio_mean": m["ratio_mean"],
            "prefix_hit_tokens": r["prefix_hit_tokens"],
            "prefill_tokens": r["prefill_tokens"],
            "batch": [B, T]}


def phase_rlhf_350m(card):
    """The GRPO loop at `bench-350m`, full width and depth, bf16 (see 7b
    in the module docstring)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools.profile_serve import kernel_groups

    cfg = llama.llama_configs()["bench-350m"]
    n_timed = 4
    t0 = time.perf_counter()
    tr = rlhf_350m_trainer(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps, versions = [], []
    try:
        t0 = time.perf_counter()
        m = tr.step()                                  # warm-up
        torch.cuda.synchronize()
        warm = step_row(m, tr.workers[0].trajs[-1],
                        time.perf_counter() - t0)
        versions.append((tr.stats()["workers"][0]["weight_version"],
                         tr.learner.version))
        v0_tokens = tr.workers[0].trajs[0]["tokens"].copy()
        torch.cuda.reset_peak_memory_stats()
        g0 = engine_graphs(tr)
        zero_serve_counts()
        for _ in range(n_timed):
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            steps.append(step_row(m, tr.workers[0].trajs[-1],
                                  time.perf_counter() - t0))
            versions.append((tr.stats()["workers"][0]["weight_version"],
                             tr.learner.version))
        torch.cuda.synchronize()
        launches = rlhf_counts()
        g1 = engine_graphs(tr)
        graph_st = tr.workers[0].engine.graph_stats()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        traced = step_row(m, tr.workers[0].trajs[-1], traced_s)
        versions.append((tr.stats()["workers"][0]["weight_version"],
                         tr.learner.version))
        kernels, groups = kernel_groups(prof)
        del prof
        hash1 = tr.learner.param_hash()
        n_steps = tr.learner.version
    finally:
        tr.shutdown()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    # A second trainer from the same seed: version-0 tokens and, after as
    # many steps, the param hash.
    tr = rlhf_350m_trainer(cfg)
    try:
        for _ in range(n_steps):
            tr.step()
        v0_again = tr.workers[0].trajs[0]["tokens"]
        hash2 = tr.learner.param_hash()
    finally:
        tr.shutdown()
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    windows = g1["decode_windows"] - g0["decode_windows"]
    replays = g1["graph_replays"] - g0["graph_replays"]
    device_ms = sum(ms for ms, _ in groups.values())
    top = sorted(((n, ms, c) for n, (ms, c) in kernels.items()),
                 key=lambda t: -t[1])[:12]

    def mean(key):
        return sum(s[key] for s in steps) / len(steps)

    row = {"phase": "rlhf_350m", "card": card, "model": "bench-350m",
           "dtype": "bfloat16", "params": cfg.num_params(),
           "config": {k: v for k, v in RLHF_350M.items()},
           "build_s": build_s, "warmup_step": warm, "steps": steps,
           "mean": {k: mean(k) for k in (
               "step_s", "rollout_s", "decode_tokens_per_s", "scoring_s",
               "update_s", "learner_tokens_per_s", "weight_sync_ms",
               "reward_mean")},
           "prefix_hit_share": sum(s["prefix_hit_tokens"] for s in steps)
           / sum(s["prefix_hit_tokens"] + s["prefill_tokens"]
                 for s in steps),
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {k: v / n_timed for k, v in
                                 launches.items()},
           "timed_windows": windows, "timed_replays": replays,
           "graphs": g1, "graph_stats": graph_st,
           "versions_engine_learner": versions,
           "traced_step": traced, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / (traced_s * 1e3),
           # The profiler slows the host: the traced step's device time
           # over the mean untraced step.
           "traced_device_ms_over_mean_step": device_ms
           / (mean("step_s") * 1e3),
           "traced_groups": {k: {"ms": ms, "launches": n}
                             for k, (ms, n) in sorted(groups.items())},
           "traced_top": [{"name": n[:100], "ms": ms, "launches": c}
                          for n, ms, c in top],
           "v0_tokens_equal_second_run": bool(np.array_equal(v0_tokens,
                                                             v0_again)),
           "param_hash_equal_second_run": hash1 == hash2,
           "param_hashes": [hash1, hash2], "steps_hashed": n_steps}
    emit(row)
    if not all(math.isfinite(s[k]) for s in steps + [warm, traced]
               for k in ("loss", "kl", "ratio_mean", "reward_mean")):
        raise AssertionError(f"rlhf_350m: non-finite metrics: {steps}")
    if any(e != lv for e, lv in versions):
        raise AssertionError(f"rlhf_350m: versions {versions}")
    if windows == 0 or replays != windows:
        raise AssertionError(f"rlhf_350m: {windows} windows, {replays} "
                             "replays: a window after a swap was not a "
                             "replay")
    want_bwd = cfg.n_layers * n_timed
    if (launches["paged_decode_attention"] == 0
            or launches["paged_decode_attention"] != replays
            * paged_per_replay(cfg, RLHF_350M["engine"]["steps_per_sync"])
            or launches["flash_attention_fwd/wgmma"] == 0
            or launches["flash_attention_fwd/fma"]
            or any(launches[f"flash_attention_bwd_{k}/wgmma"] != want_bwd
                   or launches[f"flash_attention_bwd_{k}/fma"]
                   for k in ("dq", "dkv"))):
        raise AssertionError(f"rlhf_350m: launches {launches}")
    if not row["v0_tokens_equal_second_run"]:
        raise AssertionError("rlhf_350m: a second trainer from the same "
                             "seed sampled other version-0 tokens")
    return launches


# ------------------------------------------- phase 8: MoE, small f32
# CUDA against the CPU in f32 (TF32 off): routing is exact comparisons and
# counts over f32 probabilities, so the dispatch must be equal and the
# gates within 1e-6; logits, loss and the first step's gradients (relative
# to each leaf's largest, the rlhf_small_f32 rule) within 1e-4.
MOE_ROUTE_TOL = 1e-6
MOE_TOL = 1e-4


def phase_moe_small():
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, param_leaves)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(moe.moe_configs()["moe-debug"],
                              dtype=torch.float32)
    params = moe.init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 65)))
    # route() on the same hidden states and router on both devices.
    h = torch.from_numpy(rng.normal(size=(128, cfg.dim)).astype(np.float32))
    w = params["layers"]["router"][0]
    cpu_r = moe.route(h, w, cfg)
    gpu_r = [t.cpu() for t in moe.route(h.cuda(), w.cuda(), cfg)]
    # Tied probabilities (tests/test_torch_moe.py's case): identical
    # router columns but for two rows; experts 1 and 2 tie for second
    # place in the first 32 tokens, 0 and 1 for first in the others.
    ht = torch.from_numpy(rng.normal(size=(64, cfg.dim)).astype(np.float32))
    ht[:, :2] = 0.0
    ht[:32, 0] = ht[32:, 1] = 5.0
    wt = (torch.from_numpy(rng.normal(size=(cfg.dim, 1)).astype(np.float32))
          * 0.1).repeat(1, cfg.n_experts)
    wt[0] = torch.tensor([4.0, 3.0, 3.0, 0.0])
    wt[1] = torch.tensor([3.0, 3.0, 0.0, 0.0])
    tied_cpu = moe.route(ht, wt, cfg)[0]
    tied_gpu = moe.route(ht.cuda(), wt.cuda(), cfg)[0].cpu()
    probs = torch.softmax(ht.cuda() @ wt.cuda(), dim=-1)
    topk_e = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
    row = {"phase": "moe_small_f32", "model": "moe-debug",
           "tied_dispatch_equal": bool(torch.equal(tied_gpu, tied_cpu)),
           "tied_lower_index": bool(tied_gpu[:, 2:].sum() == 0),
           "cuda_topk_picks_lower_index": bool(
               (topk_e.sort(dim=-1).values.cpu()
                == torch.tensor([0, 1])).all()),
           "dtype": "float32", "batch": 2, "seq": 64,
           "route_tokens": 128, "capacity": moe._capacity(128, cfg),
           "dispatch_equal": bool(torch.equal(gpu_r[0], cpu_r[0])),
           "route_kept": float(cpu_r[0].sum()),
           "combine_max_abs_diff": max_err(gpu_r[1], cpu_r[1]),
           "aux_abs_diff": abs(float(gpu_r[2]) - float(cpu_r[2])),
           "tol": {"route": MOE_ROUTE_TOL, "model": MOE_TOL}}
    out = {}
    opt = default_optimizer(lr=1e-3, warmup=2, total_steps=10)
    zero_flash_counts()
    for device in ("cuda", "cpu"):
        state = create_train_state(SEED, cfg, opt, device=device,
                                   params=params)
        toks = tokens.to(device)
        with torch.no_grad():
            logits, aux = moe.forward(state.params, toks[:, :-1], cfg)
        n0 = flash_counts()
        loss = moe.loss_fn(state.params, {"tokens": toks}, cfg)
        loss.backward()
        out[device] = {"logits": logits.cpu(), "aux": aux.item(),
                       "loss": loss.item(),
                       "grads": [p.grad.cpu()
                                 for p in param_leaves(state.params)],
                       "launches": {n: c - n0[n] for n, c in
                                    flash_counts().items()}}
    gpu, cpu = out["cuda"], out["cpu"]
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(gpu["grads"], cpu["grads"]))
    row.update({"logits_max_abs_diff": max_err(gpu["logits"],
                                               cpu["logits"]),
                "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
                "aux_cuda": gpu["aux"], "aux_cpu": cpu["aux"],
                "first_step_grads_rel": grad_rel,
                "launches_grad_pass": gpu["launches"]})
    emit(row)
    if not (row["dispatch_equal"] and row["tied_dispatch_equal"]
            and row["tied_lower_index"]):
        raise AssertionError(f"moe_small: route's dispatch differs on CUDA "
                             f"or breaks a tie upward: {row}")
    if max(row["combine_max_abs_diff"], row["aux_abs_diff"]) \
            > MOE_ROUTE_TOL:
        raise AssertionError(f"moe_small: route differs: {row}")
    np.testing.assert_allclose(gpu["logits"].numpy(), cpu["logits"].numpy(),
                               atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=MOE_TOL)
    if grad_rel > MOE_TOL:
        raise AssertionError(f"moe_small: gradients differ: {grad_rel}")
    L = cfg.n_layers
    want = {"flash_attention_fwd": L, "flash_attention_fwd/fma": L,
            "flash_attention_fwd/wgmma": 0,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dq/fma": L,
            "flash_attention_bwd_dq/wgmma": 0,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv/fma": L,
            "flash_attention_bwd_dkv/wgmma": 0}
    if gpu["launches"] != want or any(cpu["launches"].values()):
        raise AssertionError(f"moe_small: launches {gpu['launches']} != "
                             f"{want}")
    return flash_counts()


# ------------------------------------ phase 9: Mixtral, 4 of 32 layers
def range_split(prof, ranges, groups) -> dict:
    """Device ms of a trace by where each kernel came from: a kernel
    launched inside a record_function range (forward, or its remat
    recompute) counts to that range; a backward kernel to the range of
    the forward op whose autograd node launched it (sequence number and
    thread, the profiler's own forward-backward link).  The flash
    kernels, and the "gemm" and "other" kernels outside the ranges, come
    from `groups` (kernel_groups of the same trace: each device kernel
    once); on the card's torch a CPU event's `kernels` can repeat
    kernels of other events, so only the ranges' are read from there,
    and only names seen among the trace's device kernels."""
    from ray_tpu_torch.tools.profile_serve import kernel_group

    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    device_names = {e.name for e in events if e.device_type == cuda
                    and not getattr(e, "is_user_annotation", False)}
    fwd = {}
    for e in events:
        if e.name in ranges:
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.sequence_nr >= 0:
                    fwd[(c.sequence_nr, c.thread)] = e.name
                stack.extend(c.cpu_children)

    def label(e):
        while e is not None:
            if e.name in ranges:
                return e.name
            if e.scope == 1:                       # a backward function
                return fwd.get((e.sequence_nr, e.fwd_thread))
            e = e.cpu_parent
        return None

    out, inside = {}, {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        lab = label(e)
        for k in e.kernels:
            g = kernel_group(k.name)
            if lab is None or k.name not in device_names \
                    or g.startswith("flash"):
                continue
            for d, key in ((out, lab), (inside, g)):
                ms, n = d.get(key, (0.0, 0))
                d[key] = (ms + k.duration / 1e3, n + 1)
    for g, (ms, n) in groups.items():
        ms_in, n_in = inside.get(g, (0.0, 0))
        out[g] = (ms - ms_in, n - n_in)     # outside the ranges
    return out


def phase_train_mixtral_4l(card):
    """`mixtral-8x7b` at its published widths, 4 of its 32 layers (bf16
    weights, gradients and AdamW moments take 8 bytes a parameter: 4
    layers are 6.07 G parameters, 48.6 GB; 32 would be 373 GB)."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    cfg = dataclasses.replace(moe.moe_configs()["mixtral-8x7b"], n_layers=4)
    batch_size, seq, n_timed = 2, 4096, 3
    opt = default_optimizer(total_steps=1000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(SEED, cfg, opt)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch_size, seq))).to("cuda")
    batch = {"inputs": tokens, "targets": tokens}      # bench.py's batch
    step = make_train_step(cfg, opt)
    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, lr 0
    loss0 = m["loss"].item()
    warmup_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    zero_flash_counts()
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Routing of one no-grad forward: slots kept per layer, and the aux.
    kept, plain = [], moe.route
    C = moe._capacity(batch_size * seq, cfg)

    def recording(h, w, cfg_):
        out = plain(h, w, cfg_)
        kept.append(float(out[0].sum(dtype=torch.float32)))
        return out

    moe.route = recording
    try:
        with torch.no_grad():
            _, aux = moe.forward(state.params, tokens, cfg)
    finally:
        moe.route = plain
    routed = batch_size * seq * cfg.experts_per_token

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    _, groups = kernel_groups(prof)
    device_ms = sum(ms for ms, _ in groups.values())
    split = range_split(prof, moe.TRACE_RANGES, groups)

    mean_ms = sum(step_ms) / len(step_ms)
    tokens_per_s = batch_size * seq / (mean_ms / 1e3)
    flops_per_token = 6 * cfg.active_params() \
        + 12 * cfg.n_layers * cfg.dim * seq
    row = {"phase": "train_mixtral_4l", "card": card,
           "model": "mixtral-8x7b", "n_layers": cfg.n_layers,
           "dtype": "bfloat16", "params": cfg.num_params(),
           "active_params": cfg.active_params(), "batch": batch_size,
           "seq": seq, "capacity": C, "remat_mode": cfg.remat_mode,
           "init_params_s": t_init, "warmup_step_s": warmup_s,
           "first_loss": loss0, "ln_vocab": math.log(cfg.vocab_size),
           "loss": losses, "grad_norm": norms, "aux": aux.item(),
           "kept_slots_per_layer": kept, "routed_slots": routed,
           "dropped_share_per_layer": [1 - k / routed for k in kept],
           "step_ms": step_ms, "mean_step_ms": mean_ms,
           "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token,
           "mfu_active": tokens_per_s * flops_per_token / BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())},
           "traced_split": {g: {"ms": ms, "launches": n}
                            for g, (ms, n) in sorted(split.items())},
           "traced_split_ranges_ms": sum(ms for g, (ms, _) in split.items()
                                         if g in moe.TRACE_RANGES)}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms + [loss0,
                                                           aux.item()]):
        raise AssertionError(f"non-finite loss, grad norm or aux: {row}")
    if abs(loss0 - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {loss0} is far from ln(vocab)")
    if len(kept) != cfg.n_layers or not all(0 < k <= routed for k in kept):
        raise AssertionError(f"routing counts {kept} of {routed}")
    if any(c != (0 if n.endswith("/fma") else n_timed * cfg.n_layers)
           for n, c in launches.items()):
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.n_layers} per step, all bf16 routes")
    del state, m, prof
    return launches


# ------------------------------------------- phases 10-11: vision, f32
VISION_TOL = 1e-4


def grads_rel(gpu: list, cpu: list) -> float:
    """Largest |g - ref| over each leaf's largest |ref|, over the leaves."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(gpu, cpu))


def vision_small(mod, cfg, params, batch) -> tuple[dict, dict]:
    """A vision model's no-grad logits, loss and first gradients on CUDA
    and on the CPU from the same params and batch; the CUDA grad pass's
    flash launches."""
    from ray_tpu_torch.train.step import param_leaves

    out = {}
    for device in ("cuda", "cpu"):
        params_d = tree_to(params, device)
        for p in param_leaves(params_d):
            p.requires_grad_(True)
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            logits = mod.forward(params_d, b["images"], cfg)
        n0 = flash_counts()
        loss = mod.loss_fn(params_d, b, cfg)
        loss.backward()
        out[device] = {"logits": logits.cpu(), "loss": loss.item(),
                       "grads": [p.grad.cpu()
                                 for p in param_leaves(params_d)],
                       "launches": {n: c - n0[n] for n, c in
                                    flash_counts().items()}}
    gpu, cpu = out["cuda"], out["cpu"]
    row = {"logits_max_abs_diff": max_err(gpu["logits"], cpu["logits"]),
           "logits_max_abs": float(cpu["logits"].abs().max()),
           "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
           "first_step_grads_rel": grads_rel(gpu["grads"], cpu["grads"]),
           "launches_grad_pass": gpu["launches"], "tol": VISION_TOL}
    np.testing.assert_allclose(gpu["logits"].numpy(), cpu["logits"].numpy(),
                               atol=VISION_TOL, rtol=VISION_TOL)
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=VISION_TOL)
    if row["first_step_grads_rel"] > VISION_TOL:
        raise AssertionError(f"gradients differ: {row}")
    if any(cpu["launches"].values()):
        raise AssertionError(f"a CPU pass launched a kernel: {cpu}")
    return row, gpu["launches"]


def vision_batch(n, size, n_classes, device="cpu", seed=SEED) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(rng.normal(
                size=(n, size, size, 3)).astype(np.float32)).to(device),
            "labels": torch.from_numpy(rng.integers(
                0, n_classes, size=n)).to(device)}


def phase_vit_small():
    """A ViT with head_dim 32 (`vit-debug`'s 16 takes no kernel), f32,
    TF32 off: CUDA (the FMA flash kernels) against the CPU."""
    from ray_tpu_torch.models import vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = vit.ViTConfig(image_size=32, patch_size=8, dim=128, n_layers=2,
                        n_heads=4, mlp_dim=256, n_classes=10,
                        dtype=torch.float32)
    params = vit.init_params(cfg, torch.Generator().manual_seed(SEED))
    row, launches = vision_small(vit, cfg, params,
                                 vision_batch(4, 32, cfg.n_classes))
    L = cfg.n_layers
    # remat: each layer's forward runs again in the backward.
    want = {"flash_attention_fwd": 2 * L, "flash_attention_fwd/fma": 2 * L,
            "flash_attention_fwd/wgmma": 0,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dq/fma": L,
            "flash_attention_bwd_dq/wgmma": 0,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv/fma": L,
            "flash_attention_bwd_dkv/wgmma": 0}
    row = {"phase": "vit_small_f32", "dim": cfg.dim, "n_heads": cfg.n_heads,
           "head_dim": cfg.head_dim, "n_layers": L, "tokens":
           cfg.n_patches + 1, "batch": 4, "remat": cfg.remat, **row}
    emit(row)
    if launches != want:
        raise AssertionError(f"vit_small: launches {launches} != {want}")
    return launches


def phase_resnet_small():
    """`resnet-debug` (f32) on 33-pixel images, cuDNN's TF32 off: CUDA
    against the CPU."""
    from ray_tpu_torch.models import resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.resnet_configs()["resnet-debug"]
    params = resnet.init_params(cfg, torch.Generator().manual_seed(SEED))
    row, launches = vision_small(resnet, cfg, params,
                                 vision_batch(4, 33, cfg.num_classes))
    row = {"phase": "resnet_small_f32", "model": "resnet-debug",
           "image_size": 33, "batch": 4,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, **row}
    emit(row)
    if any(launches.values()):
        raise AssertionError(f"resnet launched flash kernels: {launches}")


# ------------------------------------- phases 12-13: vision at full width
def vision_groups(kernels: dict) -> dict:
    """Device ms and launches of a traced vision step by group: the
    flash kernels, GEMMs and convolutions, the optimizer's multi-tensor
    kernels, and the rest (norms and elementwise)."""
    from ray_tpu_torch.tools.profile_serve import kernel_group

    out = {}
    for name, (ms, n) in kernels.items():
        g, low = kernel_group(name), name.lower()
        if g == "gemm" or any(k in low for k in (
                "conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")):
            g = "gemm_conv"
        elif "multi_tensor_apply" in low:
            g = "optimizer"
        elif g == "other":
            g = "norm_elementwise"
        acc = out.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    return out


def train_vision(card, mod, cfg, name, image_size, n_classes,
                 fwd_flops) -> tuple[dict, dict]:
    """Three timed `make_train_step` steps of a vision model in bf16 at
    batch 256 of seeded random images, after one warm-up step (lr 0),
    then one step under torch.profiler.  The TrainState is built by hand
    from the family's own params (create_train_state casts every leaf to
    cfg.dtype)."""
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import (TrainState, default_optimizer,
                                          make_train_step, param_leaves)

    batch_size, n_timed = 256, 3
    opt = default_optimizer(total_steps=1000)
    torch.cuda.reset_peak_memory_stats()
    params = mod.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED))
    for p in param_leaves(params):
        p.requires_grad_(True)
    dtypes = sorted({str(p.dtype) for p in param_leaves(params)})
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    batch = vision_batch(batch_size, image_size, n_classes, "cuda")
    step = make_train_step(cfg, opt, mod.loss_fn, device="cuda")
    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, lr 0
    loss0 = m["loss"].item()
    warmup_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    zero_flash_counts()
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = kernel_groups(prof)
    groups = vision_groups(kernels)
    device_ms = sum(ms for ms, _ in groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    mean_ms = sum(step_ms) / len(step_ms)
    images_per_s = batch_size / (mean_ms / 1e3)
    row = {"phase": f"train_{name}", "card": card, "model": name,
           "dtype": str(cfg.dtype), "param_dtypes": dtypes,
           "params": cfg.num_params(), "batch": batch_size,
           "image_size": image_size, "n_classes": n_classes,
           "warmup_step_s": warmup_s, "first_loss": loss0,
           "ln_classes": math.log(n_classes), "loss": losses,
           "grad_norm": norms, "step_ms": step_ms, "mean_step_ms": mean_ms,
           "images_per_s": images_per_s, "forward_flops_per_image":
           fwd_flops, "mfu": images_per_s * 3 * fwd_flops / BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n,
                                 "share": ms / device_ms}
                             for g, (ms, n) in sorted(groups.items())},
           "traced_top_kernels": [{"name": n[:100], "ms": ms, "launches": c}
                                  for n, (ms, c) in top]}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms + [loss0]):
        raise AssertionError(f"non-finite loss or grad norm: {row}")
    # One fixed batch: the warm-up (lr 0) and three small warm-up-schedule
    # updates must lower its loss.  (At init ResNet's logits are far from
    # uniform: its first loss sits well above ln(classes).)
    if not losses[-1] < loss0:
        raise AssertionError(f"the loss did not fall: {loss0} -> {losses}")
    del state, m, prof
    return row, launches


def phase_train_vit_b16(card):
    """ViT-B/16 (Dosovitskiy et al. 2021: 224 px, patch 16, dim 768, 12 x
    12 heads, mlp 3072, 1000 classes) in bf16, remat on: 24 forward (12
    and their recompute), 12 dQ and 12 dK/dV launches a step, all on the
    wgmma route (head_dim 64, non-causal, 197 tokens)."""
    from ray_tpu_torch.models import vit

    cfg = vit.vit_configs()["vit-b16"]
    row, launches = train_vision(card, vit, cfg, "vit_b16", cfg.image_size,
                                 cfg.n_classes, cfg.forward_flops())
    L, n_timed = cfg.n_layers, 3
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    got = {n: c / n_timed for n, c in launches.items()}
    if any(got[n] != c or got[f"{n}/wgmma"] != c or got[f"{n}/fma"]
           for n, c in want.items()):
        raise AssertionError(f"train_vit_b16: launches per step {got} != "
                             f"{want}, all bf16 (wgmma)")
    fl = row["traced_groups"]
    if any(fl.get(g, {}).get("launches") != c for g, c in (
            ("flash_fwd", 2 * L), ("flash_bwd_dq", L),
            ("flash_bwd_dkv", L))):
        raise AssertionError(f"train_vit_b16: traced flash groups {fl}")
    return launches


def phase_train_resnet18(card):
    """ResNet-18 (He et al. 2016, the reference's GroupNorm 32 in place of
    BatchNorm) in bf16 on 224 px images, 1000 classes; the parameter tree
    stays f32 (master weights).  No flash kernel on this path."""
    from ray_tpu_torch.models import resnet

    cfg = resnet.resnet_configs()["resnet18"]
    row, launches = train_vision(card, resnet, cfg, "resnet18", 224,
                                 cfg.num_classes, cfg.forward_flops(224))
    if any(launches.values()) or row["param_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"train_resnet18: flash launches {launches} or "
                             f"param dtypes {row['param_dtypes']}")
    return launches


# ------------------------------------------------ phase 14: RL learners
RL_ALGOS = ("ppo", "impala", "appo", "dqn", "bc", "marwil", "sac", "cql")


def rl_batch(algo: str, n: int = 64, t: int = 8, obs: int = 8,
             actions: int = 4) -> dict:
    """One seeded batch of what `algo`'s loss reads ([n, t] fragments with
    episode ends and truncations for IMPALA and APPO)."""
    rng = np.random.default_rng(RL_ALGOS.index(algo))
    f32 = np.float32
    lead = (n, t) if algo in ("impala", "appo") else (n,)
    b = {"obs": rng.normal(size=(*lead, obs)).astype(f32),
         "actions": rng.integers(0, actions, size=lead),
         "next_obs": rng.normal(size=(*lead, obs)).astype(f32),
         "rewards": rng.normal(size=lead).astype(f32),
         "dones": (rng.random(lead) < 0.15).astype(f32),
         "truncs": (rng.random(lead) < 0.1).astype(f32),
         "logp": np.log(rng.uniform(0.1, 0.5, lead)).astype(f32),
         "advantages": rng.normal(size=lead).astype(f32),
         "value_targets": rng.normal(size=lead).astype(f32),
         "q_targets": rng.normal(size=lead).astype(f32),
         "returns": rng.normal(size=lead).astype(f32)}
    return b


def phase_rl_learners():
    """Each algorithm's first update on CUDA against the CPU, f32 (TF32
    off): the same initial params (the CPU learner's with its target
    nets moved off the online ones, through set_params), the same batch
    and minibatch order; the first
    minibatch's gradients within 1e-4 of each leaf's largest and the
    update's metrics within 1e-4.  The params after the update (two Adam
    steps) are reported: Adam's first step moves an element by about lr
    whatever its gradient, so an element whose gradient is rounding noise
    near zero may step either way on the two devices (PERF.md, PR 9)."""
    import importlib

    from ray_tpu_torch.parallel.sharding import tree_map
    from ray_tpu_torch.rl.learner import Learner

    torch.backends.cuda.matmul.allow_tf32 = False
    names = {"ppo": "PPO", "impala": "IMPALA", "appo": "APPO", "dqn": "DQN",
             "bc": "BC", "marwil": "MARWIL", "sac": "SAC", "cql": "CQL"}
    rows = {}
    for algo in RL_ALGOS:
        cls = getattr(importlib.import_module(f"ray_tpu_torch.rl.{algo}"),
                      names[algo])
        config = cls.learner_config({"obs_dim": 8, "n_actions": 4,
                                     "hidden": 64, "seed": SEED})
        batch = rl_batch(algo)
        n = len(batch["obs"])
        cpu = Learner(config, cls.loss_builder, device="cpu")
        gpu = Learner(config, cls.loss_builder, device="cuda")
        # Target nets ("pi_t", "q1_t", ...) drifted from the online ones,
        # as after some polyak syncs: while pi_t == pi, APPO's KL gradient
        # on pi_t is rounding noise around zero.
        rng = np.random.default_rng(SEED + 99)
        start = {k: tree_map(lambda a: (a + 0.05 * rng.normal(
                     size=a.shape)).astype(np.float32), v)
                 if k.endswith("_t") else v
                 for k, v in cpu.get_params_numpy().items()}
        cpu.set_params(start)
        gpu.set_params(start)
        idx = np.arange(n)
        np.random.default_rng(SEED + 17).shuffle(idx)
        grads = {}
        for label, ln in (("cuda", gpu), ("cpu", cpu)):
            params = tree_to(ln.params, ln.device)
            leaves = [p.requires_grad_(True) for _, p in
                      named_leaves(params)]
            mb = {k: ln._tensor(v[idx[:n // 2]]) for k, v in batch.items()}
            loss, _ = ln._loss_fn(params, mb)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads[label] = [torch.zeros_like(p).cpu() if g is None
                            else g.cpu() for p, g in zip(leaves, got)]
        m_gpu = gpu.update(batch, num_sgd_iter=1, minibatch_size=n // 2)
        m_cpu = cpu.update(batch, num_sgd_iter=1, minibatch_size=n // 2)
        p_gpu = dict(named_leaves(gpu.get_params_numpy()))
        p_cpu = dict(named_leaves(cpu.get_params_numpy()))
        rows[algo] = {
            "grads_rel": grads_rel(grads["cuda"], grads["cpu"]),
            "metrics_max_rel": max(abs(m_gpu[k] - v) / max(abs(v), 1e-6)
                                   for k, v in m_cpu.items()),
            "params_max_abs_diff": max(float(np.abs(p_gpu[k] - v).max())
                                       for k, v in p_cpu.items()),
            "loss_cuda": m_gpu["loss"], "loss_cpu": m_cpu["loss"]}
        np.testing.assert_allclose(
            [m_gpu[k] for k in sorted(m_cpu)],
            [m_cpu[k] for k in sorted(m_cpu)], atol=1e-4, rtol=1e-4,
            err_msg=f"rl_learners {algo}: metrics")
    emit({"phase": "rl_learners_f32", "batch": 64, "fragment_steps": 8,
          "obs_dim": 8, "n_actions": 4, "hidden": 64, "tol": 1e-4,
          "algorithms": rows})
    bad = {a: r for a, r in rows.items() if r["grads_rel"] > 1e-4}
    if bad:
        raise AssertionError(f"rl_learners: gradients differ: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch import _kernels

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    built = _kernels.build_all()
    ptxas = {n: ptxas_report(_kernels.nvcc_log(n)) for n in _kernels.SOURCES}
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": built,
          "build_wall_s": time.perf_counter() - t0,
          "spilling": {n: r["spilling"] for n, r in ptxas.items()},
          "registers": {n: r["registers"] for n, r in ptxas.items()},
          "ptxas_warnings": {n: r["warnings"] for n, r in ptxas.items()}})

    timer = Timer()
    rows = phase_kernels(timer)
    del timer
    small = phase_engine_small()
    small_dense = phase_engine_small_dense()
    from ray_tpu_torch.models import llama

    cfg8 = llama.llama_configs()["llama3-8b"]
    t0 = time.perf_counter()
    params8 = llama.init_params(
        cfg8, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    serve = phase_serve_8b(card, cfg8, params8, time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_8b_engine(card, cfg8, params8)
    gc.collect()
    torch.cuda.empty_cache()
    server = phase_serve_8b_server(card, cfg8, params8)
    dense8 = phase_serve_8b_dense(card, cfg8, params8)
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    train_small = phase_train_small()
    train = phase_train_350m(card)
    sharded = phase_train_350m_sharded(card)
    gc.collect()
    torch.cuda.empty_cache()
    rlhf_small = phase_rlhf_small()
    rlhf = phase_rlhf_350m(card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_small = phase_moe_small()
    mixtral = phase_train_mixtral_4l(card)
    gc.collect()
    torch.cuda.empty_cache()
    vit_small = phase_vit_small()
    phase_resnet_small()
    vit_b16 = phase_train_vit_b16(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_resnet18(card)
    phase_rl_learners()

    def entry(name, kernel, src, replaces, launches, row, part=None,
              errs=()):
        e = {"name": name, "kernel": kernel, "route": "cuda",
             "source": "ray_tpu_torch/csrc/" + src, "replaces": replaces,
             "dtype": row["dtype"], "launches": launches,
             "case": row["case"], "card": card}
        if part is None:
            e.update({k: row[k] for k in (
                "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")})
        else:
            e.update({
                "max_abs_err": max(row["max_abs_err"][x] for x in errs),
                "rel_err": max(row["rel_err"][x] for x in errs),
                "tol_rel": row["tol_rel"], "ms": row[f"{part}_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{part}_bound_ms"],
                "bound_by": row[f"{part}_bound_by"],
                "library_ms": row["library_ms"],
                "plain_and_library_cover": "dq, dk and dv together",
                "fused_bound_ms": row["fused_bound_ms"]})
        return e

    fwd, bwd, paged = rows["fwd"], rows["bwd"], rows["paged"]
    fa_py = "ray_tpu/ops/flash_attention.py"
    kernels = [
        entry("paged_decode_attention", "paged_decode_split_kernel",
              "paged_decode.cu", "ray_tpu/ops/paged_attention.py:53",
              serve["paged_decode_attention"], paged["8b_decode_window"]),
        entry("flash_attention_fwd", "flash_fwd_wgmma_kernel",
              "flash_fwd.cu", f"{fa_py}:38",
              serve["flash_attention_fwd/wgmma"], fwd["8b_wave_bucket1024"]),
        entry("flash_attention_fwd", "flash_fwd_kernel", "flash_fwd.cu",
              f"{fa_py}:38", small["flash_attention_fwd/fma"],
              fwd["f32_debug_train"]),
        entry("flash_attention_bwd_dq", "flash_bwd_dq_wgmma_kernel",
              "flash_bwd.cu", f"{fa_py}:142",
              train["flash_attention_bwd_dq/wgmma"],
              bwd["350m_train_layer"], "dq", ("dq",)),
        entry("flash_attention_bwd_dq", "flash_bwd_dq_kernel",
              "flash_bwd.cu", f"{fa_py}:142",
              train_small["flash_attention_bwd_dq/fma"],
              bwd["f32_debug_train"], "dq", ("dq",)),
        entry("flash_attention_bwd_dkv", "flash_bwd_dkv_wgmma_kernel",
              "flash_bwd.cu", f"{fa_py}:192",
              train["flash_attention_bwd_dkv/wgmma"],
              bwd["350m_train_layer"], "dkv", ("dk", "dv")),
        entry("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel",
              "flash_bwd.cu", f"{fa_py}:192",
              train_small["flash_attention_bwd_dkv/fma"],
              bwd["f32_debug_train"], "dkv", ("dk", "dv")),
    ]
    # Launches on the other main path of each kernel, the paged kernel's
    # time at a long context, and the forward's at the training layer.
    long = paged["8b_long_context"]
    for i in (0, 1):
        name = kernels[i]["name"] + ("/wgmma" if i else "")
        kernels[i]["launches_serve_8b_server"] = {
            k: v[name] for k, v in server.items()}
    kernels[0].update({"ms_long_context": long["ms"],
                       "bound_ms_long_context": long["bound_ms"],
                       "plain_ms_long_context": long["plain_ms"]})
    kernels[1]["launches_train_350m"] = train["flash_attention_fwd/wgmma"]
    kernels[1]["ms_350m_train_layer"] = fwd["350m_train_layer"]["ms"]
    kernels[1]["bound_ms_350m_train_layer"] = \
        fwd["350m_train_layer"]["bound_ms"]
    kernels[1]["library_ms_350m_train_layer"] = \
        fwd["350m_train_layer"]["library_ms"]
    kernels[2]["launches_train_small_f32"] = \
        train_small["flash_attention_fwd/fma"]
    # The dense engine's prefill (small f32 and 8B bf16), and the sharded
    # step's forward and backward on a one-rank mesh.
    kernels[0]["launches_serve_8b_dense"] = dense8["paged_decode_attention"]
    kernels[1]["launches_serve_8b_dense"] = dense8["flash_attention_fwd/wgmma"]
    kernels[2]["launches_engine_small_dense_f32"] = \
        small_dense["flash_attention_fwd/fma"]
    for i, name in ((1, "flash_attention_fwd"), (3, "flash_attention_bwd_dq"),
                    (5, "flash_attention_bwd_dkv")):
        kernels[i]["launches_train_350m_sharded"] = sharded[f"{name}/wgmma"]
    # The online RLHF loop: the f32 routes at `debug`, bf16 at bench-350m.
    for i, name in enumerate(("paged_decode_attention",
                              "flash_attention_fwd/wgmma",
                              "flash_attention_fwd/fma",
                              "flash_attention_bwd_dq/wgmma",
                              "flash_attention_bwd_dq/fma",
                              "flash_attention_bwd_dkv/wgmma",
                              "flash_attention_bwd_dkv/fma")):
        if i == 0 or name.endswith("/fma"):
            kernels[i]["launches_rlhf_small_f32"] = rlhf_small[name]
        if i == 0 or name.endswith("/wgmma"):
            kernels[i]["launches_rlhf_350m"] = rlhf[name]
    # The MoE slice: the f32 routes at moe-debug, bf16 at Mixtral's widths.
    for i, name in ((1, "flash_attention_fwd/wgmma"),
                    (2, "flash_attention_fwd/fma"),
                    (3, "flash_attention_bwd_dq/wgmma"),
                    (4, "flash_attention_bwd_dq/fma"),
                    (5, "flash_attention_bwd_dkv/wgmma"),
                    (6, "flash_attention_bwd_dkv/fma")):
        if name.endswith("/fma"):
            kernels[i]["launches_moe_small_f32"] = moe_small[name]
            kernels[i]["launches_vit_small_f32"] = vit_small[name]
        else:
            kernels[i]["launches_train_mixtral_4l"] = mixtral[name]
            kernels[i]["launches_train_vit_b16"] = vit_b16[name]
    # Each bf16 kernel's times at the rlhf_350m and Mixtral layer shapes.
    for i, row, part in ((0, paged["350m_rlhf_decode"], None),
                         (1, fwd["350m_rlhf_score"], None),
                         (3, bwd["350m_rlhf_learner"], "dq"),
                         (5, bwd["350m_rlhf_learner"], "dkv"),
                         (1, fwd["mixtral_train_layer"], None),
                         (3, bwd["mixtral_train_layer"], "dq"),
                         (5, bwd["mixtral_train_layer"], "dkv"),
                         (1, fwd["vit_b16_layer"], None),
                         (3, bwd["vit_b16_layer"], "dq"),
                         (5, bwd["vit_b16_layer"], "dkv")):
        pre = "" if part is None else f"{part}_"
        key = (row["case"] if row["case"] in ("mixtral_train_layer",
                                              "vit_b16_layer")
               else "rlhf_350m_shape")
        kernels[i][key] = {
            "case": row["case"], "max_abs_err": row["max_abs_err"],
            "ms": row[f"{pre}ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row[f"{pre}bound_ms"],
            "bound_by": row[f"{pre}bound_by"],
            "library_ms": row["library_ms"]}
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:  # noqa: BLE001 - report, then fail the run
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    os._exit(rc)
