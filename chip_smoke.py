"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits 1:

  1. device   -- the card's name and power limit (nvidia-smi), and the
                 kernels built from csrc/ (one nvcc per source, together).
  2. kernels  -- every kernel of the serving and training paths against
                 its plain PyTorch version on the card, at the main paths'
                 shapes in bf16 plus ragged and edge cases (head_dim 32,
                 64 and 128): the error against the plain version computed
                 in f32 from the same inputs, kernel / plain / library
                 times and the bound.  The flash forward is timed at the
                 8B wave and the `bench-350m` layer, the flash backward
                 (dQ, dK/dV) at the `bench-350m` layer; the f32 routes
                 (FMA kernels) at the `debug` training shapes; the paged
                 kernel at the 8B decode state, at a long context and at
                 batch 32.
                 Each backward case must launch dQ and dK/dV once each on
                 its dtype's route, and every backward and paged case
                 gives the same bits when run again.
  3. engine_small_f32 -- the whole engine at small depth (`debug`, f32) on
                 CUDA (kernels) and on the CPU (plain versions) from the
                 same parameters: a shared page-aligned prefix, a
                 whole-prompt hit and a pool small enough to preempt; the
                 greedy tokens must be identical; and one decode window
                 dispatched under CUDA sync debug mode "error".
  4. serve_8b -- `llama3-8b` at full width and depth in bf16 with random
                 seeded weights and the engine's defaults: eight requests
                 of 300-1000 prompt tokens submitted together, 64 new
                 tokens each, then a ninth that shares the first 512
                 tokens of a finished prompt (a prefix-cache hit: the
                 suffix path).  The launch counters are zeroed just before
                 this phase and read just after: both kernels must have
                 run, the forward on its bf16 route only.
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

The line before the last is {"kernels": [...]}, one entry per kernel
(the forward, dQ and dK/dV: one per dtype route); the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

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


def run_small(engine_cls, cfg, params, device):
    """Greedy tokens of the small workloads on one device."""
    out = {}
    eng = engine_cls(cfg, params, device=device, max_batch=4, max_len=128,
                     page_size=16, seed=0)
    eng.start()
    try:
        out["prefix"] = [eng.generate(SHARED + t, max_new_tokens=12)["tokens"]
                         for t in ([40, 41, 42], [50, 51], [60])]
        out["cow"] = [eng.generate(SHARED, max_new_tokens=8)["tokens"]
                      for _ in range(2)]
        st = eng.stats()
        out["hits"], out["cow_copies"] = st["prefix_hit_tokens"], \
            st["cow_copies"]
    finally:
        eng.stop()
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
    return out


def window_sync_check(cfg, params) -> int:
    """One decode window dispatched under CUDA sync debug mode "error":
    the K steps, the sampling and the tail merge never wait on the device
    (the engine's one sync per window is its copy of the returned token
    block).  Drives the loop's own steps on this thread."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", max_batch=4, max_len=128,
                    page_size=16, seed=0)
    for i in range(4):
        eng.submit([i + 1, 2, 3, 4, 5], max_new_tokens=20,
                   temperature=0.8 * (i % 2))
    eng._admit()
    active = eng._ensure_decode_blocks()
    eng._decode_window(active)            # first use: pinned staging
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_window(active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return len(active)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def phase_engine_small():
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))

    n0 = (flash_counts(), paged_decode_attention.launches)
    t0 = time.perf_counter()
    gpu = run_small(LLMEngine, cfg, tree_to(cpu_params, "cuda"), "cuda")
    t_gpu = time.perf_counter() - t0
    synced_slots = window_sync_check(cfg, tree_to(cpu_params, "cuda"))
    cpu = run_small(LLMEngine, cfg, cpu_params, "cpu")
    fwd = {n: c - n0[0][n] for n, c in flash_counts().items()
           if n.startswith("flash_attention_fwd")}
    launched = {**fwd, "paged_decode_attention":
                paged_decode_attention.launches - n0[1]}
    same = {k: gpu[k] == cpu[k] for k in ("prefix", "cow", "preempt")}
    row = {"phase": "engine_small_f32", "same_tokens": same,
           "prefix_hit_tokens": gpu["hits"], "cow_copies": gpu["cow_copies"],
           "preemptions": gpu["preemptions"],
           "window_without_host_sync_slots": synced_slots,
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
    return launched


# ----------------------------------------------- phase 4: full-width 8B
def phase_serve_8b(card):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.llama_configs()["llama3-8b"]
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
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
    eng.start()
    try:
        # Warm-up: a 300-token prompt (prefill bucket 512); the wave below
        # pads to bucket 1024.
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
    ttft = [r["ttft_s"] for r in res]
    decode_s = max(r["total_s"] for r in res) - max(ttft)
    emit({"phase": "serve_8b", "card": card, "model": "llama3-8b",
          "dtype": "bfloat16", "requests": len(res) + 1,
          "new_tokens_each": 64, "prompt_tokens": MAIN_PROMPTS,
          "init_params_s": t_init, "wave_s": wave_s,
          "ttft_s": {"min": min(ttft), "max": max(ttft)},
          "prefill_tokens_per_s": sum(MAIN_PROMPTS) / max(ttft),
          "decode_tokens_per_s": 8 * 63 / decode_s,
          "ninth_ttft_s": r9["ttft_s"], "ninth_prefix_hit_tokens": hit,
          "preemptions": s1["preemptions"], "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
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
    serve = phase_serve_8b(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_small = phase_train_small()
    train = phase_train_350m(card)

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
