"""Where the serving time goes on the card: one traced run of the engine.

    python3 -m ray_tpu_torch.tools.profile_serve

Serves `llama3-8b` (bf16, random seeded weights, engine defaults) the
same eight-request wave as chip_smoke.py's serve phase (prompts of
300-1000 tokens, 64 new tokens each) under torch.profiler, after one
untraced warm-up request, and prints one JSON line: the wall time of the
traced window, the device time summed over every kernel, the device busy
share (device time / wall time; one stream, so kernels do not overlap),
and the device time and launch count per kernel group and for the top
kernels.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

PROMPTS = [312, 1000, 457, 803, 640, 999, 388, 725]
# Kernel name substrings by group, the first match winning: each flash
# group holds both dtype routes (the bf16 wgmma and the f32 FMA kernel),
# ahead of "gemm" so a wgmma kernel never counts as a library GEMM.
GROUPS = (("paged_decode", "paged_decode"),
          ("flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")),
          ("flash_bwd_dq", ("flash_bwd_dq_wgmma_kernel",
                            "flash_bwd_dq_kernel")),
          ("flash_bwd_dkv", ("flash_bwd_dkv_wgmma_kernel",
                             "flash_bwd_dkv_kernel")),
          ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "gemv")))


def kernel_group(name: str) -> str:
    for label, keys in GROUPS:
        keys = (keys,) if isinstance(keys, str) else keys
        if any(k in name.lower() for k in keys):
            return label
    return "other"


def kernel_groups(prof) -> tuple[dict, dict]:
    """Device time of a torch.profiler trace: ({kernel name: [ms, n]},
    {group: [ms, n]}) over every CUDA event but the ranges that
    annotations (such as Optimizer.step) mirror onto the device timeline,
    which would count their kernels twice."""
    kernels = {}
    for evt in prof.events():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        k = kernels.setdefault(evt.name, [0.0, 0])
        k[0] += evt.time_range.elapsed_us() / 1e3
        k[1] += 1
    groups = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(kernel_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    return kernels, groups


def main() -> None:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = llama.llama_configs()["llama3-8b"]
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in PROMPTS]
    eng = LLMEngine(cfg, params, seed=0)
    eng.start()
    try:
        eng.generate(rng.integers(1, cfg.vocab_size, size=300).tolist(),
                     max_new_tokens=8)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            futs = [eng.submit(p, max_new_tokens=64) for p in prompts]
            res = [f.result(timeout=600) for f in futs]
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng.stop()
    kernels, groups = kernel_groups(prof)
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({
        "card": card, "model": "llama3-8b", "dtype": "bfloat16",
        "requests": len(res), "new_tokens_each": 64,
        "prompt_tokens": PROMPTS, "traced_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "groups": {g: {"ms": ms, "launches": n}
                   for g, (ms, n) in sorted(groups.items())},
        "top_kernels": [{"name": n[:120], "ms": ms, "launches": c}
                        for n, (ms, c) in top]}))


if __name__ == "__main__":
    main()
