"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits 1:

  1. device   -- the card's name and power limit (nvidia-smi), and the
                 kernels built from csrc/ (one nvcc per source, together).
  2. kernels  -- every kernel of the serving path against its plain
                 PyTorch version on the card, at the Llama-3-8B main-path
                 shapes in bf16 plus ragged and edge cases: max abs error
                 against the plain version computed in f32 from the same
                 inputs, kernel / plain / library times and the bound.
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
                 this phase and read just after: both kernels must have run.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
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
    o = paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = paged_decode_reference(*[a.float() if a.is_floating_point()
                                   else a for a in args])
    err = max_err(o, ref)
    B, kvh, rep, hd = args[0].shape
    row = {"case": name, "shape": [B, kvh, rep, hd, args[1].shape[2],
                                   args[5].shape[1], args[3].shape[2]],
           "dtype": str(dtype), "max_abs_err": err, "tol": TOL[dtype]}
    if err > TOL[dtype] or not torch.isfinite(o.float()).all():
        raise AssertionError(f"paged_decode_attention {name}: {row}")
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
    bf, f32 = torch.bfloat16, torch.float32
    flash = [
        # The 8-request wave's prefill: bucket 1024, Llama-3-8B heads.
        flash_case(timer, "8b_wave_bucket1024", 8, 1024, 32, 8, 128, bf,
                   timed=True),
        flash_case(timer, "8b_single_bucket512", 1, 512, 32, 8, 128, bf),
        flash_case(timer, "ragged_1000", 1, 1000, 32, 8, 128, bf),
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
    ]
    emit({"phase": "kernels", "flash_attention_fwd": flash,
          "paged_decode_attention": paged})
    return flash[0], paged[0]


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


def phase_engine_small():
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        return tree.to(device)

    n0 = (flash_attention_fwd.launches, paged_decode_attention.launches)
    t0 = time.perf_counter()
    gpu = run_small(LLMEngine, cfg, to(cpu_params, "cuda"), "cuda")
    t_gpu = time.perf_counter() - t0
    synced_slots = window_sync_check(cfg, to(cpu_params, "cuda"))
    cpu = run_small(LLMEngine, cfg, cpu_params, "cpu")
    launched = (flash_attention_fwd.launches - n0[0],
                paged_decode_attention.launches - n0[1])
    same = {k: gpu[k] == cpu[k] for k in ("prefix", "cow", "preempt")}
    row = {"phase": "engine_small_f32", "same_tokens": same,
           "prefix_hit_tokens": gpu["hits"], "cow_copies": gpu["cow_copies"],
           "preemptions": gpu["preemptions"],
           "window_without_host_sync_slots": synced_slots,
           "kernel_launches": {"flash_attention_fwd": launched[0],
                               "paged_decode_attention": launched[1]},
           "cuda_seconds": t_gpu}
    emit(row)
    if not all(same.values()) or gpu != cpu:
        raise AssertionError(f"CUDA and CPU engines disagree: {gpu} {cpu}")
    if gpu["preemptions"] == 0 or gpu["cow_copies"] == 0 \
            or gpu["hits"] == 0 or min(launched) == 0:
        raise AssertionError(f"small engine missed a path: {row}")


# ----------------------------------------------- phase 4: full-width 8B
def phase_serve_8b(card):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
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
        flash_attention_fwd.launches = 0
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
        launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                    "paged_decode_attention": paged_decode_attention.launches}
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
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
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
    regs = {n: [ln.strip() for ln in _kernels.nvcc_log(n).splitlines()
                if "spill" in ln and " 0 bytes spill stores" not in ln]
            for n in _kernels.SOURCES}
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": built,
          "build_wall_s": time.perf_counter() - t0, "spilling": regs})

    timer = Timer()
    flash_row, paged_row = phase_kernels(timer)
    del timer
    phase_engine_small()
    launches = phase_serve_8b(card)

    kernels = []
    for name, src, replaces, row in (
            ("paged_decode_attention", "ray_tpu_torch/csrc/paged_decode.cu",
             "ray_tpu/ops/paged_attention.py:53", paged_row),
            ("flash_attention_fwd", "ray_tpu_torch/csrc/flash_fwd.cu",
             "ray_tpu/ops/flash_attention.py:38", flash_row)):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "tol": row["tol"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "case": row["case"],
            "card": card})
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
