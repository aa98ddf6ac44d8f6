"""Continuous-batched LLM engine over the paged KV pool or a dense cache
(port of ray_tpu/serve/llm.py's LLMEngine).

The path: submit / generate -> wave admission (radix prefix match, block
reservation with copy-on-write) -> paged prefill (flash kernel on CUDA)
-> K-step paged decode windows (paged kernel on CUDA) -> finish.

  - Slots: a fixed [max_batch] slot array; requests join and leave
    between decode windows.  Prompt lengths are bucketed to powers of
    two and wave widths to (1, 8, chunk), as in the reference.
  - KV lives in a shared page pool (models/llama.init_paged_kv_cache),
    managed on the host by serve/kv_blocks.BlockManager: the longest
    cached prefix is matched and only the suffix is prefilled; blocks
    are allocated one decode window ahead; when the pool runs dry the
    newest request is preempted and recomputed later.
  - A decode window runs K steps with the current tokens kept on the
    device and makes exactly ONE device -> host copy (the [K, B] token
    block).  Its state lives in persistent device tensors (current
    tokens, pos, page table, temperatures, seeds, starts, adapter slot
    per lane, the tails, the weights, the LoRA banks), written in place
    between windows.  On CUDA each window size K is captured once as a
    CUDA graph and replayed after that, the counterpart of the
    reference's one compiled program per window size: the first window
    of a size runs eagerly on a side stream (it warms cuBLAS up for the
    capture) and every later one is a replay.  As in the reference, the
    window always computes the sampled and the greedy token and selects
    per lane, so the graph does not depend on the lanes' temperatures.  The kernel wrappers'
    launch counters are credited per replay with what the capture
    recorded.  On the CPU the window runs eagerly.
  - Sampling: token g of request s is drawn by Gumbel-max from a
    counter-based hash keyed by (engine seed, s, g), on the device.  A
    preempted-and-recomputed or migrated request therefore draws the
    same tokens it would have drawn uninterrupted, whatever the window
    size.  Greedy (temperature 0) uses no randomness.  JAX's threefry
    cannot be reproduced in torch, so the reference and the port agree
    token for token only when greedy.
  - Multi-LoRA: static per-target banks [L, slots+1, din, r] / [L,
    slots+1, r, dout] (slot 0 all zeros = base model), rows written in
    place by load_adapter; radix keys are salted per (adapter, version).
  - PD disaggregation: submit(prefill_only=True) exports the request's
    KV pages ([2, L, n, kvh, page, hd]) after its first token; kv_import
    resumes it on another engine.  Device -> host copies of exports and
    demotions finish on an export thread, behind a CUDA event.
  - Tier-2 prefix store: cold radix leaves demote through a publish
    callback (set_prefix_store); kv_graft re-warms the radix tree.
  - Live weight updates (update_weights) copy a new tree into the
    resident tensors (the engine's own copy of the weights) between
    windows, so the captured graphs decode with the new weights; the
    swap flushes the radix tree.
  - Dense mode (paged=False): per-layer [max_batch, max_len, kvh, hd]
    cache leaves (models/llama.init_kv_cache_leaves) instead of the pool.
    A wave's prefill writes each layer's rows with one indexed write and
    sets pos to the true lengths; the K-step window runs
    llama.decode_step_unrolled (einsum attention, no kernel) through the
    same persistent tensors and capture-and-replay as the paged window.
    As in the reference there is no prefix cache, preemption, LoRA bank,
    KV export / import or graft in this mode.

Kill switches shared with the reference: RAY_TPU_PREFIX_CACHE=0 disables
prefix matching, RAY_TPU_KV_PREEMPT=0 restores full-span up-front
allocation, RAY_TPU_RL_WEIGHT_SYNC=0 drops weight updates (read per
call), RAY_TPU_PREFIX_STORE=0 stops demotion (read per scan).  Prefill is not
captured as a graph.

Observability goes through the engine's `runtime` (serve/runtime.py; the
null runtime by default, which records nothing), at the reference's
sites and under its names:
  - metrics (`_engine_metrics`): the serve_llm_* counters, flushed as
    deltas at most once a second from the loop and at every stats(); the
    gauges at the same flush; the serve_request_ttft_ms / _tpot_ms /
    _stage_ms histograms observed at each request's end (a migrated
    request skips TTFT, queue and prefill).  All tagged `engine`.
  - spans, only while `runtime.tracing_enabled()`: a request captures
    the trace context at submit; admission emits llm.queue, llm.prefill,
    llm.first_token (and serve.adapter_apply, or llm.kv_import for a
    migrated request); each decode window emits llm.decode_window per
    traced request, timed around the window's one device -> host copy;
    an export emits llm.kv_export, an adapter eviction
    serve.adapter_swap.  With tracing off nothing is timed or captured.
  - the memory ledger: start() registers a provider with an "hbm_kv" row
    (used blocks x bytes per page of the page pool) and, with LoRA
    banks, a "lora_banks" row; stop() unregisters it.
  - failpoints `serve.kv_import` (kv_import's entry), `serve.adapter_swap`
    (before an eviction changes anything), `serve.prefix_graft` (a graft
    on the loop), `serve.prefix_demote` (before a demotion's publish) and
    `serve.kv_export` (inside an export's pinned window); each armed error
    takes the path an error there takes: the one call, graft, demotion
    or export fails and the loop serves on.

LLMServer, the serve deployment body, wraps one engine: the request path
(__call__, stream), the PD pool roles, adapter page-in, the tier-2 prefix
store client, the overload ladder and reconfigure.  Its runtime calls go
through a ServeRuntime (serve/runtime.py); the ObjectRef forms of
update_weights resolve there.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import as_tensor
from ray_tpu_torch.ops import counters
from ray_tpu_torch.ops.paged_attention import merge_tail_pages
from ray_tpu_torch.ops.rope import rope_frequencies
from ray_tpu_torch.serve import lora as lora_mod
from ray_tpu_torch.serve import slo
from ray_tpu_torch.serve.kv_blocks import BlockManager
from ray_tpu_torch.serve.kv_router import (env_on, lora_on, pd_disagg_on,
                                           prefix_store_on)
from ray_tpu_torch.serve.lora import AdapterLoadError
from ray_tpu_torch.serve.prefix_store import PrefixStoreClient
from ray_tpu_torch.serve.runtime import ServeRuntime, resolve_tree
from ray_tpu_torch.serve.schema import ENGINE_CONFIG_KEYS, ENGINE_ROLES

_M32 = 0xFFFFFFFF

# Latency-histogram bucket upper bounds in ms (the reference's).
_MS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
               1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def _engine_metrics(runtime) -> dict:
    """The serve-LLM metrics on `runtime` (the reference's
    `_engine_metrics`: the same names, descriptions, tag keys and
    buckets), tagged per engine so engines sharing a registry keep their
    own series."""
    tk = ("engine",)

    def m(kind, name, desc, tags=tk, **kw):
        return runtime.metric(kind, name, desc, tags, **kw)

    return {
        "prefill_tokens": m("counter", "serve_llm_prefill_tokens",
                            "Prompt tokens actually prefilled on device"),
        "prefix_hit_tokens": m(
            "counter", "serve_llm_prefix_hit_tokens",
            "Prompt tokens served from the KV prefix cache"),
        "decode_tokens": m("counter", "serve_llm_decode_tokens",
                           "Tokens decoded"),
        "preemptions": m("counter", "serve_llm_preemptions",
                         "Requests preempted for KV blocks"),
        "evictions": m("counter", "serve_llm_kv_evictions",
                       "Cached KV blocks LRU-evicted"),
        "completed": m("counter", "serve_llm_requests_completed",
                       "Requests completed"),
        "occupancy": m("gauge", "serve_llm_batch_occupancy",
                       "Active slots / max_batch"),
        "queue_depth": m("gauge", "serve_llm_queue_depth",
                         "Requests waiting for a batch slot (the telemetry "
                         "timeline's engine-queue series)"),
        "free_blocks": m("gauge", "serve_llm_kv_free_blocks",
                         "Free KV blocks in the pool"),
        "hit_rate": m("gauge", "serve_llm_prefix_hit_rate",
                      "Prefix-cache hit tokens / prompt tokens"),
        "weight_version": m("gauge", "serve_llm_weight_version",
                            "Policy weight version currently decoding "
                            "(online RLHF live weight sync)"),
        "weight_updates": m("counter", "serve_llm_weight_updates",
                            "Live weight swaps applied between decode "
                            "syncs"),
        "ttft": m("histogram", "serve_request_ttft_ms",
                  "Time to first token per request (ms)",
                  boundaries=_MS_BUCKETS),
        "tpot": m("histogram", "serve_request_tpot_ms",
                  "Time per output token after the first (ms)",
                  boundaries=_MS_BUCKETS),
        "stage": m("histogram", "serve_request_stage_ms",
                   "Per-request stage latency breakdown "
                   "(queue/prefill/decode, ms)", ("engine", "stage"),
                   boundaries=_MS_BUCKETS),
    }


def _buckets_for(max_len: int, smallest: int = 32) -> list[int]:
    out, b = [], smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def _check_pool_role(role: str, decode_deployment) -> None:
    """The pool-role combination rules, shared by LLMServer.__init__ and
    reconfigure (ENGINE_ROLES is their source of truth)."""
    if role not in ENGINE_ROLES:
        raise ValueError(
            f"engine role must be one of {list(ENGINE_ROLES)}, "
            f"got {role!r}")
    if role == "prefill" and decode_deployment is None:
        raise ValueError(
            "role='prefill' requires decode_deployment (the decode "
            "pool this replica ships KV to) — a prefill pool with no "
            "decode pool cannot serve")
    if role != "prefill" and decode_deployment is not None:
        raise ValueError(
            f"decode_deployment only applies to role='prefill' (got "
            f"role={role!r}) — a dangling decode target would "
            "silently serve unified")


def _pow2(n: int) -> int:
    """Smallest power of two >= n: the width padding of the COW-free
    import / export / graft / demotion page lists."""
    m = 1
    while m < n:
        m *= 2
    return m


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash on int64 tensors holding values in [0, 2^32).
    Multipliers stay below 2^31, so no product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


# torch.cuda.graph synchronizes the device and empties the caching
# allocator as it enters, which invalidates a capture in progress on
# another thread (two engines of one process capturing their first
# windows at once: rollout workers as in-process actors), so captures
# take turns.
_CAPTURE_LOCK = threading.Lock()


def _leaves(tree, path: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves(tree[k],
                                                           f"{path}/{k}")]
    return [(path, tree)]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass
class _Request:
    prompt: list[int]
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    future: concurrent.futures.Future
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: float | None = None
    admitted_at: float = 0.0          # perf_counter at slot assignment
    tokens: list[int] = field(default_factory=list)
    slot: int = -1
    # Optional thread-safe sink for token streaming (None = end).
    token_queue: Any = None
    # KV blocks owned by this request, in table order (block i covers
    # positions [i*page, (i+1)*page)); released at finish/preempt.
    pages: list[int] = field(default_factory=list)
    # Sampling identity: token g is drawn from hash(engine, sample_seed, g).
    sample_seed: int = 0
    # First prompt position this admission prefills (below it: cached).
    prefill_from: int = 0
    # False for warmup traffic: never match or populate the prefix cache.
    cache_ok: bool = True
    preempted: int = 0
    # Finish after the first token and export the KV pages (kv_export).
    prefill_only: bool = False
    # Migrated KV (kv_import): [2, L, n, kvh, page, hd] scattered into
    # fresh blocks at admission instead of a prefill; dropped right after.
    import_kv: Any = None
    import_len: int = 0
    # Prefix-cache generation at admission: a request admitted before a
    # weight swap must not commit its (old-policy) blocks.
    cache_gen: int = 0
    # Multi-LoRA identity: the adapter (None = base), its bank slot
    # (0 = the all-zeros base row) and the KV salt, resolved at admission.
    model_id: str | None = None
    lora_slot: int = 0
    salt: int = 0
    # Tracing: the (trace id, span id) context captured at submit (None
    # when tracing was off), and the wall-clock submit and admission times.
    trace: Any = None
    t0_wall: float = field(default_factory=time.time)
    admitted_wall: float = 0.0

    def emit(self, tok: int | None) -> None:
        if self.token_queue is not None:
            self.token_queue.put(tok)


@dataclass
class _WindowGraph:
    """One captured K-step decode window and what its replays count."""
    graph: Any
    seq: torch.Tensor                  # [K, B] token block (output)
    launches: dict                     # kernel launches of one window
    capture_s: float
    replays: int = 0


class LLMEngine:
    """Continuous-batching decode engine over llama-family params, on the
    paged KV pool or (paged=False) a dense per-slot cache.

    Runs on `device` ("cuda" unless the caller passes "cpu"); on a machine
    without CUDA the default raises RuntimeError rather than running on
    the CPU.  The engine decodes with its own copy of `params` (numpy
    arrays or tensors), which update_weights rewrites in place, since the
    captured windows read fixed addresses.  With `share_params=True` it
    decodes with the caller's tensors themselves (on its device): engines
    built so share one tree's memory, and their weights are read-only
    (update_weights raises).  `runtime` (serve/runtime.py) receives the
    metrics, spans, memory-ledger rows and failpoint hits; the null
    runtime records nothing."""

    def __init__(self, cfg, params=None, *, max_batch: int = 8,
                 max_len: int | None = None, seed: int = 0,
                 steps_per_sync: int = 8, paged: bool = True,
                 page_size: int = 512, kv_pages: int | None = None,
                 prefix_cache: bool | None = None,
                 kv_preempt: bool | None = None,
                 lora_slots: int = 0, lora_rank: int = 0,
                 lora_targets: tuple | None = None,
                 share_params: bool = False,
                 name: str = "llm", device=None,
                 runtime: ServeRuntime | None = None):
        self.device = resolve_device(device, "LLMEngine")
        self.cfg = cfg
        self.name = name
        self._runtime = runtime or ServeRuntime()
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq
        self.steps_per_sync = max(1, steps_per_sync)
        self._shared_params = params is not None and share_params
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(cfg, gen)
        elif share_params:
            off = [p for p, t in _leaves(params)
                   if not isinstance(t, torch.Tensor)
                   or t.device.type != self.device.type]
            if off:
                raise ValueError(
                    f"share_params needs tensors on {self.device}; "
                    f"{off[:3]} are not")
        else:
            params = _tree_map(
                lambda t: as_tensor(t).to(self.device, copy=True), params)
        self.params = params
        self.paged = paged
        self._prefix_cache = paged and (
            prefix_cache if prefix_cache is not None
            else env_on("RAY_TPU_PREFIX_CACHE"))
        self._preempt_on = paged and (
            kv_preempt if kv_preempt is not None
            else env_on("RAY_TPU_KV_PREEMPT"))
        if paged:
            # Shared page pool: device memory holds the page budget, not
            # max_len x slots.  Page 0 is the trash page idle slots point
            # at.
            self.page = page_size
            self._maxp = -(-self.max_len // page_size)
            if kv_pages is None:
                kv_pages = 1 + max_batch * (
                    -(-min(self.max_len, 4096) // page_size))
            self.n_pages = kv_pages
            self.cache = llama.init_paged_kv_cache(cfg, max_batch, kv_pages,
                                                   page_size, self.device)
            self._mgr = BlockManager(kv_pages - 1, page_size,
                                     prefix_cache=self._prefix_cache)
            self._table = np.zeros((max_batch, self._maxp), np.int32)
            rope_len = self._maxp * page_size
            # Decode tails [B, kvh, K, hd] per layer, allocated once and
            # reused: rows a window has not written yet are masked, and
            # stay finite.  A smaller live window uses the first K columns.
            tshape = (max_batch, cfg.n_kv_heads, self.steps_per_sync,
                      cfg.head_dim)
            self._tails = {kk: [torch.zeros(tshape, dtype=cfg.dtype,
                                            device=self.device)
                                for _ in range(cfg.n_layers)]
                           for kk in ("k", "v")}
        else:
            # Dense per-layer cache leaves, written in place by the wave
            # prefill and every decode step.
            self.cache = llama.init_kv_cache_leaves(cfg, max_batch,
                                                    self.max_len, self.device)
            self._mgr = None
            rope_len = self.max_len
        self._buckets = _buckets_for(self.max_len)
        self._chunk = min(16, max_batch)
        self._width_buckets = sorted({w for w in (1, 8, self._chunk)
                                      if w <= max_batch})
        # RoPE tables over every cache position, built once.
        self._rope = rope_frequencies(cfg.head_dim, rope_len,
                                      cfg.rope_theta, device=self.device)
        self._seed_key = int(_mix32(torch.tensor(seed + 1)).item())
        self._vocab_ids = torch.arange(cfg.vocab_size, device=self.device)

        # Multi-LoRA banks: static [L, slots+1, din, r] / [L, slots+1, r,
        # dout] per target, written in place (load_adapter) so a captured
        # window reads the new rows.  Slot 0 stays all zeros.
        self.lora_slots = max(0, int(lora_slots))
        self.lora_rank = int(lora_rank) if self.lora_slots else 0
        if self.lora_slots:
            if not paged:
                raise ValueError(
                    "lora_slots > 0 requires a paged engine (adapter "
                    "KV identity is radix/page-granular)")
            if self.lora_rank < 1:
                raise ValueError(
                    "lora_slots > 0 requires lora_rank >= 1 (bank "
                    "shapes are static)")
            dims = llama.lora_target_dims(cfg)
            tgts = tuple(lora_targets or llama.LORA_TARGETS)
            bad = [t for t in tgts if t not in dims]
            if bad:
                raise ValueError(
                    f"unknown lora targets {bad}; valid: {sorted(dims)}")
            ns = self.lora_slots + 1

            def zeros(*shape):
                return torch.zeros(shape, dtype=cfg.dtype,
                                   device=self.device)

            self._lora_banks = {
                t: {"a": zeros(cfg.n_layers, ns, dims[t][0], self.lora_rank),
                    "b": zeros(cfg.n_layers, ns, self.lora_rank, dims[t][1])}
                for t in tgts}
            self._lora_free = list(range(1, ns))
        else:
            self._lora_banks = None
            self._lora_free = []
        # model_id -> bank slot + metadata, the per-lane slot the window
        # gathers with, and the ONE lock over eviction choice, map updates
        # and admission-time resolution.
        self._lora_lock = threading.Lock()
        self._lora_map: dict[str, int] = {}
        self._lora_meta: dict[str, dict] = {}
        self._adapters = np.zeros((max_batch,), np.int32)
        self.adapter_loads = 0
        self.adapter_evictions = 0

        # Slot state.  The window's inputs and outputs are persistent
        # device tensors, written in place between windows.
        self._slots: list[_Request | None] = [None] * max_batch
        self._temps = np.zeros((max_batch,), np.float32)
        self._seeds = np.zeros((max_batch,), np.int32)

        def dev_zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._cur = dev_zeros((max_batch,), torch.int32)
        self._table_dev = dev_zeros((max_batch, self._maxp), torch.int32) \
            if paged else None
        self._temps_dev = dev_zeros((max_batch,), torch.float32)
        self._seeds_dev = dev_zeros((max_batch,), torch.int32)
        self._starts_dev = dev_zeros((max_batch,), torch.int32)
        self._lanes_dev = dev_zeros((max_batch,), torch.int32)
        self._table_dirty = paged
        # Captured windows by size K, the side stream they are warmed up
        # and captured on, and the lock that orders window dispatch against
        # bank writes from caller threads.
        self._graphs: dict[int, _WindowGraph] = {}
        self._side_stream = None
        self._dispatch_lock = threading.Lock()
        self.decode_windows = 0
        # Compiled-window counterpart of the reference: the live window
        # size (set_sync_window) and how often it was shrunk.
        self._k_live = self.steps_per_sync
        self.sync_window_shrinks = 0

        # Admission order: preempted requests re-enter at the FRONT.
        self._pending: collections.deque[_Request] = collections.deque()
        self._waiting: queue.Queue[_Request] = queue.Queue()
        self._error: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        # Burst coalescing (see _admit): submissions in flight and the
        # entry stamp of the newest one.
        self._inflight_lock = threading.Lock()
        self._inflight_submits = 0
        self._last_submit_t = 0.0
        self._next_seed = 0
        self.completed = 0
        # Recent request latencies by stage (stats()["slo"]).
        self._slo_window = slo.LatencyWindow()
        self.preemptions = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.kv_exports = 0
        self.kv_imports = 0
        # Export side thread (started at the first export or demotion):
        # device -> host copies finish there, never on the loop.
        self._export_q: queue.Queue | None = None
        self._export_thread: threading.Thread | None = None
        # Live weight sync: update_weights stages a tree; the loop copies
        # it into the resident tensors between windows.
        self._weights_lock = threading.Lock()
        self._staged_weights: tuple | None = None   # (version, tree, t)
        self._staged_version = 0
        self.weight_version = 0
        self.weight_updates = 0
        self.weight_syncs_skipped = 0
        self.last_weight_sync_ms = 0.0
        # Prefix-cache generation, bumped (and the radix tree flushed) at
        # every weight swap.
        self._cache_gen = 0
        # Tier-2 prefix store: demotion callback, knobs and bookkeeping
        # (no-ops until set_prefix_store installs a callback), and queued
        # grafts.
        self._demote_cb = None
        self._demote_knobs: dict = {}
        self._demote_lock = threading.Lock()
        self._demote_inflight = 0
        self._demote_t = 0.0
        self._demote_skip: set[int] = set()
        self._graft_q: queue.Queue = queue.Queue()
        self.kv_grafts = 0
        self.graft_tokens = 0
        self.demote_published = 0
        self.demote_failures = 0
        # Metrics (made at the first flush) and the counters' values at
        # the last flush: stats() flushes from callers' threads while the
        # loop flushes on its own cadence, so the deltas take a lock.
        self._metrics: dict | None = None
        self._metrics_last: dict[str, float] = {}
        self._metrics_t = 0.0
        self._metrics_lock = threading.Lock()
        self._memledger_provider: str | None = None

    # ------------------------------------------------------------- public
    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: int | None = None,
               token_queue: "queue.Queue | None" = None,
               _cache_ok: bool = True, prefill_only: bool = False,
               model_id: str | None = None,
               ) -> concurrent.futures.Future:
        """Thread-safe; resolves to {tokens, ttft_s, total_s}.  With
        `token_queue`, every decoded token is also pushed as produced
        (None = end).  With `prefill_only`, the result also carries
        `kv_export` = {kv, len, page, sample_seed, tokens}: the request's
        KV pages as one CPU tensor [2, L, n, kvh, page, hd] covering its
        first `len` positions, which kv_import() on another engine
        resumes from.  With `model_id`, the request decodes under that
        LoRA adapter (resident by admission time, or the future fails
        with AdapterLoadError) and its KV keys on the adapter's salt."""
        if prefill_only and not self.paged:
            raise ValueError(
                "prefill_only requires a paged engine (KV export is "
                "page-granular)")
        if model_id is not None and self._lora_banks is None:
            raise AdapterLoadError(
                "engine has no adapter slots (set lora_slots)",
                model_id=model_id, deployment=self.name,
                reason="lora_slots=0")
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}; "
                "decode past the cache end would corrupt output")
        if self.paged:
            need = -(-(len(prompt) + max_new_tokens) // self.page)
            if need > self.n_pages - 1:
                raise ValueError(
                    f"request needs {need} KV pages but the pool holds "
                    f"{self.n_pages - 1}; raise kv_pages (admission would "
                    "otherwise block forever)")
        if self._error is not None:
            raise RuntimeError(
                "LLM engine is dead after an earlier failure") \
                from self._error
        with self._inflight_lock:
            self._inflight_submits += 1
            self._last_submit_t = time.perf_counter()
            seed = self._next_seed
            self._next_seed += 1
        try:
            req = _Request(list(prompt), max_new_tokens, temperature,
                           eos_id, concurrent.futures.Future(),
                           token_queue=token_queue, sample_seed=seed,
                           cache_ok=_cache_ok, prefill_only=prefill_only,
                           model_id=model_id)
            if self._runtime.tracing_enabled():
                req.trace = self._runtime.trace_capture()
            self._waiting.put(req)
            self._wake.set()
        finally:
            with self._inflight_lock:
                self._inflight_submits -= 1
        return req.future

    def generate(self, prompt: list[int], max_new_tokens: int = 32,
                 temperature: float = 0.0, eos_id: int | None = None,
                 _cache_ok: bool = True) -> dict:
        """Blocking convenience wrapper."""
        self.start()
        return self.submit(prompt, max_new_tokens, temperature, eos_id,
                           _cache_ok=_cache_ok).result()

    def kv_import(self, prompt: list[int], tokens: list[int], kv,
                  *, kv_len: int, max_new_tokens: int = 32,
                  temperature: float = 0.0, eos_id: int | None = None,
                  sample_seed: int = 0,
                  token_queue: "queue.Queue | None" = None,
                  ) -> concurrent.futures.Future:
        """Resume a request whose prefill ran on ANOTHER engine (this
        port's or the reference's): `kv` is its `kv_export` array ([2, L,
        n, kvh, page, hd], numpy or tensor) covering the first `kv_len`
        positions of prompt+tokens.  The pages are scattered into fresh
        pool blocks at admission; decode continues from tokens[-1] as if
        prefill had run here.  With matching engine seeds and the
        exporter's `sample_seed` the continued sample stream is the one
        an uninterrupted run draws.  The result's `tokens` include the
        ones passed in.  The `serve.kv_import` failpoint fires first."""
        self._runtime.failpoint("serve.kv_import")
        if not self.paged:
            raise ValueError("kv_import requires a paged engine")
        if not tokens:
            raise ValueError("kv_import needs at least the first "
                             "generated token")
        if len(tokens) > max_new_tokens:
            raise ValueError(
                f"already have {len(tokens)} generated tokens but "
                f"max_new_tokens is {max_new_tokens}")
        if kv_len != len(prompt) + len(tokens) - 1:
            raise ValueError(
                f"kv_len {kv_len} != prompt+tokens-1 "
                f"({len(prompt) + len(tokens) - 1}): exported KV must "
                "cover every position but the newest token's")
        kv = as_tensor(kv)
        n_imp = -(-kv_len // self.page)
        want = (2, self.cfg.n_layers, n_imp, self.cfg.n_kv_heads,
                self.page, self.cfg.head_dim)
        if tuple(kv.shape) != want:
            raise ValueError(
                f"kv shape {tuple(kv.shape)} does not match this engine "
                f"(expected {want}: page_size/config mismatch between "
                "prefill and decode pools?)")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}")
        need = -(-(len(prompt) + max_new_tokens) // self.page)
        if need > self.n_pages - 1:
            raise ValueError(
                f"request needs {need} KV pages but the pool holds "
                f"{self.n_pages - 1}; raise kv_pages")
        if self._error is not None:
            raise RuntimeError(
                "LLM engine is dead after an earlier failure") \
                from self._error
        req = _Request(list(prompt), max_new_tokens, temperature,
                       eos_id, concurrent.futures.Future(),
                       token_queue=token_queue, sample_seed=sample_seed,
                       tokens=list(tokens), import_kv=kv,
                       import_len=kv_len)
        if self._runtime.tracing_enabled():
            req.trace = self._runtime.trace_capture()
        self._waiting.put(req)
        self._wake.set()
        return req.future

    def set_prefix_store(self, publish_cb, *, min_idle: int = 256,
                         period_s: float = 0.25,
                         watermark_frac: float = 0.125,
                         limit: int = 2, max_inflight: int = 2) -> None:
        """Install (or, with None, remove) the tier-2 prefix-store
        demotion hook.  `publish_cb(entry)` runs on the export thread with
        the demoted subtree's host KV ({tokens, kv, hashes, depth, page,
        weight_version, salt}; kv a CPU tensor [2, L, depth, kvh, page,
        hd]) and returns True once tier 2 holds it; only then is the
        tier-1 leaf evicted.  A leaf demotes after `min_idle` LRU-clock
        ticks of disuse, or at once when the free pool falls under
        `watermark_frac`; at most `limit` leaves per `period_s` scan and
        `max_inflight` unfinished demotions."""
        self._demote_cb = publish_cb
        self._demote_knobs = dict(
            min_idle=max(0, int(min_idle)),
            period_s=max(0.01, float(period_s)),
            watermark=int(max(0.0, float(watermark_frac))
                          * (self.n_pages - 1)) if self.paged else 0,
            limit=max(1, int(limit)),
            max_inflight=max(1, int(max_inflight)))
        with self._demote_lock:
            self._demote_skip.clear()

    def kv_graft(self, tokens: list[int], kv, *, kv_len: int,
                 weight_version: int | None = None, salt: int = 0,
                 ) -> concurrent.futures.Future:
        """Graft a stored prefix's KV into this engine's pool: scatter `kv`
        ([2, L, n, kvh, page, hd], numpy or tensor) into fresh blocks and
        commit them into the radix tree under `tokens`, so the next
        matching request hits tier 1.  Full blocks only (kv_len a page
        multiple covering all of `tokens`).  Applied on the loop between
        windows; resolves to {"grafted": n_blocks, "tokens"} or
        {"grafted": 0, "reason"}.  A `weight_version` other than the
        engine's at application time never grafts.  `salt` keys the
        radix entry per (adapter, version); 0 = base model."""
        if not self.paged:
            raise ValueError("kv_graft requires a paged engine")
        if kv_len <= 0 or kv_len % self.page != 0:
            raise ValueError(
                f"kv_len {kv_len} must be a positive multiple of the "
                f"page size {self.page} (the radix tree is "
                "block-granular)")
        if len(tokens) != kv_len:
            raise ValueError(
                f"tokens ({len(tokens)}) must cover exactly kv_len "
                f"({kv_len}) positions")
        kv = as_tensor(kv)
        n = kv_len // self.page
        want = (2, self.cfg.n_layers, n, self.cfg.n_kv_heads,
                self.page, self.cfg.head_dim)
        if tuple(kv.shape) != want:
            raise ValueError(
                f"kv shape {tuple(kv.shape)} does not match this engine "
                f"(expected {want}: page_size/config mismatch?)")
        if n > self.n_pages - 1:
            raise ValueError(
                f"graft needs {n} KV pages but the pool holds "
                f"{self.n_pages - 1}")
        if self._error is not None:
            raise RuntimeError(
                "LLM engine is dead after an earlier failure") \
                from self._error
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._graft_q.put((list(tokens), kv, n, weight_version, int(salt),
                           fut))
        self._wake.set()
        return fut

    # ---------------------------------------------------------- multi-LoRA
    def load_adapter(self, model_id: str, adapter: dict, *,
                     version: int = 1) -> int:
        """Make an adapter device-resident: validate it against this
        engine's config, pick a bank slot (free list, else the least
        recently used slot no in-flight lane decodes with) and write its
        [L, din, r] / [L, r, dout] stacks into the slot's bank rows, zero
        padded to the bank rank.  Runs on the caller's thread; the writes
        are ordered against window dispatch by the dispatch lock and land
        in a slot no lane reads.  Re-loading a resident (model_id,
        version) is a no-op; a new version overwrites in place under a
        new KV salt.  Raises AdapterLoadError when the weights do not fit
        or no slot can be freed.  The `serve.adapter_swap` failpoint fires
        before an eviction changes anything."""
        if self._lora_banks is None:
            raise AdapterLoadError(
                "engine has no adapter slots (set lora_slots)",
                model_id=model_id, deployment=self.name,
                reason="lora_slots=0")
        targets = (adapter or {}).get("targets") or {}
        dims = llama.lora_target_dims(self.cfg)
        rank = 0
        for t, ab in targets.items():
            if t not in self._lora_banks:
                raise AdapterLoadError(
                    f"adapter targets {t!r} but this engine banks "
                    f"{sorted(self._lora_banks)}", model_id=model_id,
                    deployment=self.name, reason="bad_target")
            a, b = ab["a"], ab["b"]
            din, dout = dims[t]
            if (a.ndim != 3 or b.ndim != 3
                    or a.shape[0] != self.cfg.n_layers
                    or a.shape[1] != din or b.shape[2] != dout
                    or a.shape[2] != b.shape[1]):
                raise AdapterLoadError(
                    f"adapter target {t!r} shapes {tuple(a.shape)}/"
                    f"{tuple(b.shape)} do not fit this engine (want "
                    f"[L={self.cfg.n_layers}, {din}, r] / [L, r, {dout}])",
                    model_id=model_id, deployment=self.name,
                    reason="bad_shape")
            rank = max(rank, a.shape[2])
        if rank < 1:
            raise AdapterLoadError(
                "adapter has no targets", model_id=model_id,
                deployment=self.name, reason="empty")
        if rank > self.lora_rank:
            raise AdapterLoadError(
                f"adapter rank {rank} exceeds the engine's static bank "
                f"rank {self.lora_rank} (lora_rank)",
                model_id=model_id, deployment=self.name,
                reason="rank_overflow")
        with self._lora_lock:
            cur = self._lora_map.get(model_id)
            if cur is not None \
                    and self._lora_meta[model_id]["version"] == version:
                self._lora_meta[model_id]["last_used"] = time.monotonic()
                return cur
            if cur is not None:
                slot = cur                      # re-upload in place
            elif self._lora_free:
                slot = self._lora_free.pop(0)
            else:
                in_use = {int(s) for s in self._adapters if s}
                cands = [(self._lora_meta[mid]["last_used"], mid)
                         for mid, s in self._lora_map.items()
                         if s not in in_use]
                if not cands:
                    raise AdapterLoadError(
                        "every adapter slot has an in-flight request",
                        model_id=model_id, deployment=self.name,
                        reason="no_free_slot")
                # Before the eviction: an injected fault leaves the
                # resident set as it was.
                self._runtime.failpoint("serve.adapter_swap")
                _, victim = min(cands)
                slot = self._lora_map.pop(victim)
                del self._lora_meta[victim]
                self.adapter_evictions += 1
                if self._runtime.tracing_enabled():
                    self._runtime.emit(
                        "serve.adapter_swap", time.time(),
                        attrs={"deployment": self.name, "slot": slot,
                               "loaded": model_id, "evicted": victim})
            with self._dispatch_lock, torch.no_grad():
                for t, bank in self._lora_banks.items():
                    bank["a"][:, slot].zero_()
                    bank["b"][:, slot].zero_()
                    ab = targets.get(t)
                    if ab is not None:      # absent target: no delta
                        a, b = as_tensor(ab["a"]), as_tensor(ab["b"])
                        r = a.shape[2]
                        bank["a"][:, slot, :, :r].copy_(a)
                        bank["b"][:, slot, :r].copy_(b)
            self._lora_map[model_id] = slot
            self._lora_meta[model_id] = {
                "version": int(version),
                "salt": lora_mod.adapter_salt(model_id, version),
                "rank": rank, "last_used": time.monotonic()}
            self.adapter_loads += 1
            return slot

    def adapter_resident(self, model_id: str,
                         version: int | None = None) -> bool:
        """True when the adapter (at `version`, if given) holds a bank
        slot."""
        with self._lora_lock:
            meta = self._lora_meta.get(model_id)
            return (meta is not None
                    and (version is None or meta["version"] == version))

    def adapter_touch(self, model_id: str) -> None:
        """Stamp an adapter's LRU clock (eviction ranks by traffic, not by
        load time)."""
        with self._lora_lock:
            meta = self._lora_meta.get(model_id)
            if meta is not None:
                meta["last_used"] = time.monotonic()

    def adapter_salt_of(self, model_id: str | None) -> int:
        """KV salt of a resident adapter (0 = base / not resident)."""
        if model_id is None or self._lora_banks is None:
            return 0
        with self._lora_lock:
            meta = self._lora_meta.get(model_id)
            return meta["salt"] if meta else 0

    def _resolve_adapter(self, req: _Request, lane: int) -> bool:
        """Admission-time model_id -> bank slot (loop thread).  Marks the
        lane under the lora lock before any block work, so a concurrent
        load_adapter cannot evict the slot this admission decodes with.
        A missing adapter fails the one request with AdapterLoadError."""
        with self._lora_lock:
            slot = self._lora_map.get(req.model_id)
            if slot is not None:
                meta = self._lora_meta[req.model_id]
                req.lora_slot = slot
                req.salt = meta["salt"]
                meta["last_used"] = time.monotonic()
                self._adapters[lane] = slot
                return True
        req.emit(None)
        if not req.future.done():
            req.future.set_exception(AdapterLoadError(
                "adapter not resident at admission",
                model_id=req.model_id, deployment=self.name,
                reason="not_resident"))
        return False

    def _lora_args(self, idx: torch.Tensor) -> dict | None:
        """The model functions' `lora` argument: None without banks."""
        if self._lora_banks is None:
            return None
        return {"idx": idx, "banks": self._lora_banks}

    # ------------------------------------------------------ weight sync
    def update_weights(self, refs, version: int | None = None) -> int:
        """Stage a new param tree for live weight sync (online RLHF): the
        loop copies it into the resident tensors between decode windows,
        never mid-window and without draining a request, so the captured
        windows decode with it from the next window on.  `refs` is the
        param tree itself (numpy arrays or tensors, any dtype: leaves are
        cast to the resident dtype); its structure and leaf shapes are
        validated here, on the caller's thread.  The ObjectRef forms of
        the reference wait for the port's object plane.

        The swap flushes the radix prefix cache and gates pending commits
        behind a new generation: cached KV belongs to the old policy.
        Thread-safe; the latest staged version wins.  Returns the staged
        version.  RAY_TPU_RL_WEIGHT_SYNC=0 (read per call) drops the
        update and returns the current version.  An engine built with
        share_params=True raises ValueError: other engines decode with
        the same tensors."""
        if self._shared_params:
            raise ValueError(
                "update_weights: this engine was built with "
                "share_params=True; its weights are read-only")
        if not env_on("RAY_TPU_RL_WEIGHT_SYNC"):
            with self._weights_lock:
                self.weight_syncs_skipped += 1
                return self.weight_version
        new, cur = _leaves(refs), _leaves(self.params)
        if [p for p, _ in new] != [p for p, _ in cur]:
            raise ValueError(
                "update_weights: param tree structure does not match the "
                f"engine's ({[p for p, _ in new]} vs {[p for p, _ in cur]})")
        for (path, a), (_, b) in zip(new, cur):
            if tuple(getattr(a, "shape", ())) != tuple(b.shape):
                raise ValueError(
                    f"update_weights: leaf {path} shape "
                    f"{tuple(getattr(a, 'shape', ()))} != resident "
                    f"{tuple(b.shape)} (wrong model config?)")
        with self._weights_lock:
            if version is None:
                version = max(self.weight_version,
                              self._staged_version) + 1
            self._staged_weights = (version, refs, time.perf_counter())
            self._staged_version = version
        self._wake.set()
        return version

    def _maybe_swap_weights(self) -> None:
        """Loop half of update_weights: copy the newest staged tree into
        the resident tensors (the ones every captured window reads)."""
        with self._weights_lock:
            staged, self._staged_weights = self._staged_weights, None
        if staged is None:
            return
        version, tree, staged_t = staged
        with self._weights_lock, torch.no_grad():
            for (_, new), (_, old) in zip(_leaves(tree),
                                          _leaves(self.params)):
                old.copy_(as_tensor(new))
            self.weight_version = version
        self.weight_updates += 1
        if self._mgr is not None:
            self._cache_gen += 1
            self._mgr.flush()
            with self._demote_lock:
                self._demote_skip.clear()
        self.last_weight_sync_ms = (time.perf_counter() - staged_t) * 1e3

    def params_snapshot(self):
        """Consistent (params, weight_version) pair for trajectory
        scoring: a copy of the resident tree, taken under the weights lock
        that the swap holds, so a later swap never changes it and it is
        never labelled with another tree's version.  Costs one copy of
        the weights in device memory."""
        with self._weights_lock:
            return _tree_map(torch.clone, self.params), self.weight_version

    # ------------------------------------------------------------ controls
    def warmup(self, buckets: list[int] | None = None) -> None:
        """Run one prefill per prompt bucket, then one request long enough
        for a decode window of the configured size, so the first real
        request meets no first-use cost (on CUDA: the kernels' load and
        the default window's graph).  Warmup traffic bypasses the prefix
        cache (_cache_ok=False)."""
        cap = self.max_len - 1
        if self.paged:
            cap = min(cap, (self.n_pages - 1) * self.page - 1)
        for b in buckets or self._buckets:
            n = min(b, cap)
            if n >= 1:
                self.generate(list(range(1, n + 1)), max_new_tokens=1,
                              _cache_ok=False)
        new = min(self.steps_per_sync + 1, cap - 1)
        if new >= 2:
            self.generate([1], max_new_tokens=new, _cache_ok=False)

    def set_sync_window(self, k: int | None) -> int:
        """Set the live decode window size (overload degradation: smaller
        windows admit and check eos more often).  None restores
        steps_per_sync; sizes clamp to [1, steps_per_sync].  Takes effect
        at the next window; each size is captured once on CUDA.  Token
        streams do not change with it: sampling keys on the request's
        generation index."""
        k = self.steps_per_sync if not k \
            else max(1, min(int(k), self.steps_per_sync))
        if k != self._k_live:
            if k < self.steps_per_sync:
                self.sync_window_shrinks += 1
            self._k_live = k
            self._wake.set()
        return k

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="llm-engine", daemon=True)
            self._thread.start()
            self._register_memledger_provider()

    def _register_memledger_provider(self) -> None:
        """Attach the page pool (and the LoRA banks) to the runtime's
        memory harvest: used bytes = used pool blocks x bytes per page,
        from the block manager's accounting; the pool's bytes are its
        cache tensors'."""
        if self._mgr is None:
            return
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in self.cache["k"] + self.cache["v"]
                         + [self.cache["pos"]])
        per_page = pool_bytes // max(1, self.n_pages)
        lora_bytes = 0
        if self._lora_banks is not None:
            lora_bytes = sum(t.numel() * t.element_size()
                             for bank in self._lora_banks.values()
                             for t in bank.values())
        key = f"llm:{self.name}:{id(self):x}"

        def rows():
            st = self._mgr.stats()
            used = st["n_blocks"] - st["free"]
            out = [{"object_id": f"kvpool:{self.name}",
                    "size": used * per_page, "tag": "hbm_kv",
                    "tier": "hbm",
                    "callsite": f"serve/llm.py engine {self.name}",
                    "pool_bytes": pool_bytes, "blocks_used": used,
                    "blocks_total": st["n_blocks"],
                    "blocks_cached": st["cached"]}]
            if lora_bytes:
                out.append({"object_id": f"lorabanks:{self.name}",
                            "size": lora_bytes, "tag": "lora_banks",
                            "tier": "hbm",
                            "callsite": f"serve/llm.py engine {self.name}",
                            "slots": self.lora_slots,
                            "rank": self.lora_rank})
            return out

        self._runtime.register_provider(key, rows)
        self._memledger_provider = key

    def stop(self) -> None:
        if self._memledger_provider is not None:
            self._runtime.unregister_provider(self._memledger_provider)
            self._memledger_provider = None
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
        if self._export_thread is not None:
            # Sentinel after the loop stopped: pending exports drain in
            # order, then the thread exits.
            self._export_q.put(None)
            self._export_thread.join(timeout=60.0)
            self._export_thread = None
            self._export_q = None

    def abort_pending(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request and queued graft (call
        after stop(): the loop must not race the slot table)."""
        self._drain_requests(exc)

    # ----------------------------------------------------------- sampling
    def _sample_rows(self, logits, temps, seeds, gidx):
        """Per-row sampling: row b draws from hash(engine, seeds[b],
        gidx[b]) -- the stream belongs to the request, not the batch.
        Greedy rows (temperature 0) take the argmax."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        h = _mix32((seeds.long() + self._seed_key) & _M32)
        h = _mix32((h + gidx.long()) & _M32)
        h = _mix32((h[:, None] + self._vocab_ids[None, :]) & _M32)
        u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
        gumbel = -torch.log(-torch.log(u))
        sampled = (logits / temps.clamp_min(1e-6)[:, None] + gumbel) \
            .argmax(dim=-1).to(torch.int32)
        return torch.where(temps > 0, sampled, greedy)

    def _first_token(self, last_h, temps, seeds, starts):
        logits = (last_h @ self.params["lm_head"]).float()
        return self._sample_rows(logits, self._dev(temps), self._dev(seeds),
                                 self._dev(starts))

    def _staged(self, arr) -> torch.Tensor:
        """Host array or tensor as the source of a copy that does not
        sync: pinned when a host array goes to CUDA, so the copy queues
        behind the device work."""
        t = torch.from_numpy(arr) if isinstance(arr, np.ndarray) else arr
        if self.device.type == "cuda" and not t.is_cuda:
            return t.pin_memory()
        return t

    def _dev(self, arr) -> torch.Tensor:
        """Host array or CPU tensor -> a device tensor, without a sync."""
        return self._staged(arr).to(self.device, non_blocking=True)

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into a persistent device tensor of the same
        dtype, in place and without a sync."""
        dst.copy_(self._staged(arr), non_blocking=True)

    # -------------------------------------------------------------- decode
    def _decode_window(self, active: list[int], k_win: int | None = None):
        """K decode steps for the active slots (K = the live window size
        unless given); pages stay read-only during the window, new rows
        ride the tails and merge into the pages once at the end.  Returns
        the [K, B] token block on the device without waiting for it:
        nothing here reads a device value on the host.  On CUDA the
        window is a replay of its captured graph after its first use.
        Dense engines run the same way over their cache leaves."""
        K = k_win or self._k_live
        starts = np.zeros((self.max_batch,), np.int32)
        for i in active:
            starts[i] = len(self._slots[i].tokens)
        with self._dispatch_lock:
            if self._table_dirty:
                self._upload(self._table_dev, self._table)
                self._table_dirty = False
            self._upload(self._temps_dev, self._temps)
            self._upload(self._seeds_dev, self._seeds)
            self._upload(self._starts_dev, starts)
            if self._lora_banks is not None:
                self._upload(self._lanes_dev, self._adapters)
            self.decode_windows += 1
            if self.device.type != "cuda":
                seq = torch.empty((K, self.max_batch), dtype=torch.int32)
                self._window_body(K, seq)
                return seq
            g = self._graphs.get(K)
            if g is None:
                g = self._graphs[K] = self._capture(K)
            else:
                g.graph.replay()
                g.replays += 1
                counters.credit(g.launches)
            return g.seq

    def _window_body(self, K: int, seq: torch.Tensor):
        """The window itself, on persistent tensors only: reads the
        uploaded inputs, writes the token block into `seq` and the new
        pos and current tokens in place.  Everything it allocates is
        dead when it returns (a captured graph's private pool)."""
        if not self.paged:
            self._window_body_dense(K, seq)
            return
        cfg = self.cfg
        ts = self.cache["pos"]
        pages = {"k": self.cache["k"], "v": self.cache["v"]}
        lora = self._lora_args(self._lanes_dev)
        pos, toks = ts, self._cur
        for j in range(K):
            logits, _ = llama.decode_step_paged(
                self.params, pages, self._tails, toks, pos, ts, j,
                self._table_dev, cfg, lora=lora, rope=self._rope)
            toks = self._sample_rows(logits, self._temps_dev,
                                     self._seeds_dev, self._starts_dev + j)
            seq[j] = toks
            pos = pos + 1
        for li in range(cfg.n_layers):
            for kk in ("k", "v"):
                merge_tail_pages(pages[kk][li], self._tails[kk][li],
                                 self._table_dev, ts, K)
        ts.copy_(pos)
        self._cur.copy_(toks)

    def _window_body_dense(self, K: int, seq: torch.Tensor):
        """Dense window (the reference's _decode_k_dense): K steps of
        decode_step_unrolled, each writing its K/V rows into the cache
        leaves and advancing cache["pos"] in place."""
        toks = self._cur
        for j in range(K):
            logits, _ = llama.decode_step_unrolled(
                self.params, self.cache, toks, self.cfg, rope=self._rope)
            toks = self._sample_rows(logits, self._temps_dev,
                                     self._seeds_dev, self._starts_dev + j)
            seq[j] = toks
        self._cur.copy_(toks)

    def _capture(self, K: int) -> _WindowGraph:
        """First window of its size on CUDA: run it eagerly on the side
        stream (its result is this window's; it also creates the cuBLAS
        workspaces the capture needs), then capture the same body once.
        The capture runs nothing, so the launches it records are held
        back (this thread's only) and credited on every replay instead.
        One engine of the process captures at a time (_CAPTURE_LOCK)."""
        with _CAPTURE_LOCK:
            return self._capture_locked(K)

    def _capture_locked(self, K: int) -> _WindowGraph:
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        seq = torch.empty((K, self.max_batch), dtype=torch.int32,
                          device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._window_body(K, seq)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with counters.deferred() as launches, torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            self._window_body(K, seq)
        torch.cuda.current_stream(self.device).wait_stream(side)
        return _WindowGraph(graph, seq, launches, time.perf_counter() - t0)

    # ----------------------------------------------------------- admission
    def _reserve_blocks(self, req: _Request,
                        copies: list[tuple[int, int]]) -> bool:
        """Match the longest cached prefix (none for imports and warmup),
        then allocate enough fresh blocks to cover the prompt plus one
        decode window (the full span when preemption is off).  Returns
        False with no net state change when the pool can't cover it."""
        mgr = self._mgr
        seq = req.prompt + req.tokens       # resume includes generated
        total = len(seq)
        remaining = req.max_new_tokens - len(req.tokens)
        matched = mgr.match(seq, salt=req.salt) \
            if (req.cache_ok and req.import_kv is None) else []
        matched_tokens = len(matched) * self.page
        cover = total + (min(remaining, self._k_live)
                         if self._preempt_on else remaining)
        need = max(0, -(-cover // self.page) - len(matched))
        fresh = mgr.allocate(need)
        if fresh is None:
            mgr.release(matched)
            return False
        pages = matched + fresh
        if matched_tokens >= total:
            # Whole prompt cached: recompute only the LAST token, whose
            # write lands in the final matched (shared, sealed) block --
            # fork it first (COW).
            li = (total - 1) // self.page
            nb, copied = mgr.cow(pages[li])
            if nb < 0:
                mgr.release(pages)
                return False
            if copied:
                copies.append((pages[li], nb))
                pages[li] = nb
            req.prefill_from = total - 1
        else:
            req.prefill_from = matched_tokens
        req.pages = pages
        return True

    def _admit(self) -> None:
        """Prefill a whole wave of waiting requests; one fetch per chunk
        brings their first tokens to the host.  Imported requests scatter
        their pages instead of prefilling."""
        while True:        # drain arrivals behind any preempted requests
            try:
                self._pending.append(self._waiting.get_nowait())
            except queue.Empty:
                break
        wave: list[tuple[int, _Request]] = []
        copies: list[tuple[int, int]] = []
        grace_deadline = None
        while True:
            free = next((i for i, s in enumerate(self._slots)
                         if s is None), None)
            if free is None:
                break
            if not self._pending:
                # Burst coalescing: once a request is in hand, linger a
                # few ms so a burst rides one wave; a lone request (nobody
                # mid-submit, nothing newer) launches at once.
                try:
                    self._pending.append(self._waiting.get_nowait())
                    continue
                except queue.Empty:
                    pass
                if not wave:
                    break
                if grace_deadline is None:
                    with self._inflight_lock:
                        busy = self._inflight_submits > 0
                        last_t = self._last_submit_t
                    if not busy and last_t <= max(
                            r.submitted_at for _, r in wave):
                        break
                    grace_deadline = time.perf_counter() + 0.005
                rem = grace_deadline - time.perf_counter()
                if rem <= 0:
                    break
                try:
                    self._pending.append(self._waiting.get(timeout=rem))
                except queue.Empty:
                    break
                continue
            req = self._pending[0]
            if req.model_id is not None \
                    and not self._resolve_adapter(req, free):
                # Unknown or evicted adapter: fail this request and keep
                # admitting -- never a head-of-line barrier.
                self._pending.popleft()
                continue
            if self.paged:
                # The block pool is the admission control: the FRONT
                # request blocks FIFO when free + evictable can't cover it.
                if not self._reserve_blocks(req, copies):
                    if req.lora_slot:
                        with self._lora_lock:      # not decoding after all
                            self._adapters[free] = 0
                    break
                self._table[free, :] = 0
                self._table[free, :len(req.pages)] = req.pages
                self._table_dirty = True
            self._pending.popleft()
            req.slot = free
            req.admitted_at = time.perf_counter()
            if req.trace is not None:
                req.admitted_wall = time.time()
            req.cache_gen = self._cache_gen
            self._slots[free] = req
            self._temps[free] = req.temperature
            self._seeds[free] = req.sample_seed
            wave.append((free, req))
        if not wave:
            return
        imports = [(s, r) for s, r in wave if r.import_kv is not None]
        wave = [(s, r) for s, r in wave if r.import_kv is None]
        rt = self._runtime
        traced = rt.tracing_enabled()
        for slot, req in imports:
            t_imp0 = time.time() if traced else 0.0
            kv_len = req.import_len
            self._apply_import(slot, req)
            if req.first_token_at is None:
                req.first_token_at = time.perf_counter()
            if traced and req.trace is not None:
                rt.emit("llm.queue", req.t0_wall, req.admitted_wall,
                        ctx=req.trace)
                rt.emit("llm.kv_import", t_imp0, ctx=req.trace,
                        attrs={"kv_len": kv_len, "pages": len(req.pages)})
            if self._done(req):
                self._finish(slot)
        if not wave:
            return
        if copies:
            # Materialize COW copies before any prefill touches the pages.
            src = self._dev(np.asarray([s for s, _ in copies], np.int64))
            dst = self._dev(np.asarray([d for _, d in copies], np.int64))
            for leaf in self.cache["k"] + self.cache["v"]:
                leaf[dst] = leaf[src]
        # Dispatch every chunk's prefill, then fetch the first tokens.
        pending_waves = []
        for c0 in range(0, len(wave), self._chunk):
            chunk = wave[c0:c0 + self._chunk]
            t_disp = time.time() if traced else 0.0
            if any(r.prefill_from > 0 for _, r in chunk):
                nxt = self._prefill_chunk_suffix(chunk)
            else:
                nxt = self._prefill_chunk_full(chunk)
            pending_waves.append((chunk, nxt, t_disp))
        for chunk, nxt, t_disp in pending_waves:
            firsts = nxt.cpu().numpy()[:len(chunk)]
            now = time.perf_counter()
            for (slot, req), first in zip(chunk, firsts):
                if req.first_token_at is None:
                    req.first_token_at = now
                req.tokens.append(int(first))
                req.emit(int(first))
                if self._done(req):
                    self._finish(slot)
            if traced:
                self._emit_admission(chunk, t_disp, time.time())

    def _emit_admission(self, chunk, t_disp: float, now_wall: float) -> None:
        """A traced request's engine-side TTFT anatomy: queue (submit to
        slot), the adapter apply leg, prefill (chunk dispatch to first
        tokens on the host: chunk-mates share it) and the first-token
        marker."""
        rt = self._runtime
        for _, req in chunk:
            if req.trace is None:
                continue
            rt.emit("llm.queue", req.t0_wall, req.admitted_wall,
                    ctx=req.trace)
            if req.model_id is not None:
                rt.emit("serve.adapter_apply", req.admitted_wall,
                        req.admitted_wall, ctx=req.trace,
                        attrs={"model_id": req.model_id,
                               "slot": req.lora_slot})
            rt.emit("llm.prefill", t_disp, now_wall, ctx=req.trace,
                    attrs={"prompt_tokens": len(req.prompt),
                           "prefill_from": req.prefill_from,
                           "cached_tokens": req.prefill_from})
            rt.emit("llm.first_token", now_wall, now_wall, ctx=req.trace,
                    attrs={"ttft_ms": round(
                        (req.first_token_at - req.submitted_at) * 1000, 1)})

    def _wave_arrays(self, chunk, lens):
        """Per-row host arrays of a width-bucketed wave (rows past the
        chunk duplicate its last request: same slot, same data); also
        counts the tokens the chunk prefills."""
        W = len(chunk)
        padded_w = next(w for w in self._width_buckets if w >= W)
        bucket = next(b for b in self._buckets if b >= max(lens))
        a = {"tokens": np.zeros((padded_w, bucket), np.int32),
             "pos0": np.zeros((padded_w,), np.int32),
             "last": np.zeros((padded_w,), np.int32),
             "lens": np.ones((padded_w,), np.int32),
             "slots": np.zeros((padded_w,), np.int32),
             "temps": np.zeros((padded_w,), np.float32),
             "seeds": np.zeros((padded_w,), np.int32),
             "starts": np.zeros((padded_w,), np.int32),
             "lidx": np.zeros((padded_w,), np.int32)}
        for j in range(padded_w):
            slot, req = chunk[min(j, W - 1)]
            seq = req.prompt + req.tokens
            part = seq[req.prefill_from:]
            a["tokens"][j, :len(part)] = part
            a["pos0"][j] = req.prefill_from
            a["last"][j] = len(part) - 1
            a["lens"][j] = len(seq)
            a["slots"][j] = slot
            a["temps"][j] = req.temperature
            a["seeds"][j] = req.sample_seed
            a["starts"][j] = len(req.tokens)
            a["lidx"][j] = req.lora_slot
        for _, req in chunk:
            self.prefill_tokens += (len(req.prompt) + len(req.tokens)
                                    - req.prefill_from)
        return a, padded_w, bucket

    def _prefill_chunk_full(self, chunk):
        """Full-prompt prefill (no cached prefix in the chunk).  Dense
        engines write each layer's rows into the chunk's slots with one
        indexed write and set pos to the true lengths."""
        a, W, bucket = self._wave_arrays(
            chunk, [len(r.prompt) + len(r.tokens) for _, r in chunk])
        hidden, ks, vs = llama.prefill(self.params, self._dev(a["tokens"]),
                                       self.cfg,
                                       self._lora_args(self._dev(a["lidx"])))
        rows_idx = self._dev(a["last"].astype(np.int64))
        last_h = hidden[torch.arange(W, device=self.device), rows_idx]
        nxt = self._first_token(last_h, a["temps"], a["seeds"], a["starts"])
        slots = self._dev(a["slots"].astype(np.int64))
        if not self.paged:
            for leaf, src in ((self.cache["k"], ks), (self.cache["v"], vs)):
                for li in range(self.cfg.n_layers):
                    leaf[li][slots, :bucket] = src[li]
            self.cache["pos"][slots] = self._dev(a["lens"])
            self._cur[slots] = nxt
            return nxt
        cols = np.arange(bucket) // self.page
        page_ids = self._table[a["slots"]][:, cols]
        rows = np.tile(np.arange(bucket, dtype=np.int32) % self.page, (W, 1))
        llama.scatter_prefill_pages(self.cache, ks, vs, self._dev(page_ids),
                                    self._dev(rows), slots,
                                    self._dev(a["lens"]))
        self._cur[slots] = nxt
        return nxt

    def _prefill_chunk_suffix(self, chunk):
        """Prefix-cache prefill: forward only each request's uncached
        suffix, attending the cached prefix through the page pool; the
        suffix KV scatters at its absolute positions."""
        a, W, bucket = self._wave_arrays(
            chunk, [len(r.prompt) + len(r.tokens) - r.prefill_from
                    for _, r in chunk])
        table_rows = self._table[a["slots"]]
        hidden, ks, vs = llama.prefill_with_prefix(
            self.params, self._dev(a["tokens"]), self._dev(a["pos0"]),
            self.cfg, self.cache["k"], self.cache["v"],
            self._dev(table_rows), self._lora_args(self._dev(a["lidx"])))
        rows_idx = self._dev(a["last"].astype(np.int64))
        last_h = hidden[torch.arange(W, device=self.device), rows_idx]
        nxt = self._first_token(last_h, a["temps"], a["seeds"], a["starts"])
        apos = np.minimum(a["pos0"][:, None] + np.arange(bucket)[None, :],
                          self._maxp * self.page - 1)
        page_ids = np.take_along_axis(table_rows, apos // self.page, axis=1)
        rows = (apos % self.page).astype(np.int32)
        slots = self._dev(a["slots"].astype(np.int64))
        llama.scatter_prefill_pages(self.cache, ks, vs, self._dev(page_ids),
                                    self._dev(rows), slots,
                                    self._dev(a["lens"]), aligned=False)
        self._cur[slots] = nxt
        return nxt

    # ------------------------------------------------------ page transfer
    def _padded_ids(self, ids: list[int]) -> torch.Tensor:
        """Block ids padded to a power of two with the trash page 0."""
        return self._dev(np.asarray(
            list(ids) + [0] * (_pow2(len(ids)) - len(ids)), np.int64))

    def _gather_kv(self, ids: list[int]) -> torch.Tensor:
        """[2, L, m, kvh, page, hd] device copy of the listed blocks (m
        the padded width)."""
        idx = self._padded_ids(ids)
        return torch.stack([torch.stack([leaf[idx] for leaf in self.cache[kk]])
                            for kk in ("k", "v")])

    def _scatter_kv(self, kv: torch.Tensor, ids: list[int]) -> None:
        """Write a [2, L, n, kvh, page, hd] host KV array into blocks
        `ids` (n of them) of the pool."""
        n = len(ids)
        m = _pow2(n)
        if m > n:           # pad rows land on the trash page
            kv = torch.cat([kv, kv.new_zeros(kv.shape[:2] + (m - n,)
                                             + kv.shape[3:])], dim=2)
        src = self._dev(kv.contiguous()).to(self.cfg.dtype)
        idx = self._padded_ids(ids)
        for ki, kk in enumerate(("k", "v")):
            for li, leaf in enumerate(self.cache[kk]):
                leaf[idx] = src[ki, li]

    def _to_host(self, arr: torch.Tensor, n: int):
        """Start the device -> host copy of arr[:, :, :n]; returns (host
        tensor, CUDA event or None) for the export thread to wait on."""
        part = arr[:, :, :n]
        if not arr.is_cuda:
            return part.clone(), None
        host = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
        host.copy_(part, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _host_result(host: torch.Tensor, ev) -> torch.Tensor:
        """Export thread: wait for the copy, hand back pageable memory."""
        if ev is None:
            return host
        ev.synchronize()
        return host.clone()

    def _apply_import(self, slot: int, req: _Request) -> None:
        """Scatter a migrated request's KV pages into its freshly
        reserved blocks and seed the slot's pos and current token; the
        payload is dropped right after."""
        n_imp = -(-req.import_len // self.page)
        self._scatter_kv(req.import_kv, req.pages[:n_imp])
        self.cache["pos"][slot] = req.import_len
        self._cur[slot] = req.tokens[-1]
        req.import_kv = None
        self.kv_imports += 1

    def _finish_export(self, slot: int, req: _Request) -> None:
        """Finish a prefill_only request: pin the covered blocks, dispatch
        the gather and the device -> host copy, release the slot, and
        hand the wait to the export thread.  Every error path drops the
        export pins and the request's own blocks."""
        ids = None
        try:
            kv_len = len(req.prompt) + len(req.tokens) - 1
            ids = self._mgr.export_blocks(req.pages, kv_len)
            # A fault inside the pinned window: the pins must drop.
            self._runtime.failpoint("serve.kv_export")
            host, ev = self._to_host(self._gather_kv(ids), len(ids))
        except Exception as e:  # noqa: BLE001 - fail this request only
            if ids is not None:
                self._mgr.release(ids)
            self._release_slot(slot, req)
            req.emit(None)
            if not req.future.done():
                req.future.set_exception(e)
            return
        self._release_slot(slot, req)
        self._observe_done(req, time.perf_counter())
        self._ensure_export_thread().put(
            ("export", req, host, ev, ids, kv_len))

    def _ensure_export_thread(self) -> queue.Queue:
        if self._export_q is None:
            self._export_q = queue.Queue()
            self._export_thread = threading.Thread(
                target=self._export_loop, name="llm-kv-export",
                daemon=True)
            self._export_thread.start()
        return self._export_q

    def _export_loop(self) -> None:
        """Waits on device -> host copies off the loop: KV exports and
        prefix-store demotions."""
        while True:
            item = self._export_q.get()
            if item is None:
                return
            if item[0] == "demote":
                self._demote_one(*item[1:])
            else:
                self._export_one(*item[1:])

    def _export_one(self, req, host, ev, ids, kv_len: int) -> None:
        """One kv_export: the [2, L, n, kvh, page, hd] host array covers
        every position whose KV is written (the newest token's is not:
        the importer computes it in its first decode step); resolves the
        future and drops the export pins."""
        traced = req.trace is not None and self._runtime.tracing_enabled()
        t_exp0 = time.time() if traced else 0.0
        try:
            kv = self._host_result(host, ev)
        except Exception as e:  # noqa: BLE001 - fail this request only
            self._mgr.release(ids)
            req.emit(None)
            if not req.future.done():
                req.future.set_exception(e)
            return
        self._mgr.release(ids)
        self.kv_exports += 1
        if traced:
            # The device -> host fetch of one migration.
            self._runtime.emit("llm.kv_export", t_exp0, ctx=req.trace,
                               attrs={"bytes": kv.nbytes, "kv_len": kv_len,
                                      "pages": kv.shape[2]})
        now = time.perf_counter()
        req.emit(None)
        if not req.future.done():
            req.future.set_result({
                "tokens": req.tokens,
                "ttft_s": (req.first_token_at or now) - req.submitted_at,
                "total_s": now - req.submitted_at,
                "kv_export": {"kv": kv, "len": kv_len, "page": self.page,
                              "sample_seed": req.sample_seed,
                              "tokens": list(req.tokens)}})

    # -------------------------------------------------------- prefix store
    def _apply_grafts(self) -> None:
        """Loop half of kv_graft: allocate, scatter, commit, release.  A
        failed graft (the `serve.prefix_graft` failpoint, a scatter
        error) fails its own future only."""
        while True:
            try:
                tokens, kv, n, wv, salt, fut = self._graft_q.get_nowait()
            except queue.Empty:
                return
            try:
                self._runtime.failpoint("serve.prefix_graft")
                if not self._prefix_cache:
                    out = {"grafted": 0, "reason": "no_prefix_cache"}
                elif wv is not None and wv != self.weight_version:
                    # KV from another policy version: never grafted.
                    out = {"grafted": 0, "reason": "stale_version"}
                else:
                    blocks = self._mgr.allocate(n)
                    if blocks is None:
                        out = {"grafted": 0, "reason": "no_blocks"}
                    else:
                        try:
                            self._scatter_kv(kv, blocks)
                        except Exception:
                            self._mgr.release(blocks)
                            raise
                        # Commit before release: the blocks become cached
                        # and evictable instead of free.
                        self._mgr.commit(tokens, blocks, salt=salt)
                        self._mgr.release(blocks)
                        self.kv_grafts += 1
                        self.graft_tokens += n * self.page
                        out = {"grafted": n, "tokens": n * self.page}
            except Exception as e:  # noqa: BLE001 - fail this graft only
                if not fut.done():
                    fut.set_exception(e)
                continue
            if not fut.done():
                fut.set_result(out)

    def _maybe_demote(self) -> None:
        """Loop-side demotion scan: pick cold refcount-0 radix leaves,
        dispatch one gather per candidate covering its whole path, and
        hand the host copy and the publish to the export thread.
        Throttled by period and in-flight cap; RAY_TPU_PREFIX_STORE is
        read per scan."""
        cb = self._demote_cb
        if cb is None or not self._prefix_cache:
            return
        knobs = self._demote_knobs
        now = time.monotonic()
        if now - self._demote_t < knobs["period_s"]:
            return
        self._demote_t = now
        with self._demote_lock:
            if self._demote_inflight >= knobs["max_inflight"]:
                return
            budget = knobs["max_inflight"] - self._demote_inflight
            exclude = set(self._demote_skip)
        if not prefix_store_on():
            return
        cands = self._mgr.demote_scan(
            limit=min(knobs["limit"], budget), min_idle=knobs["min_idle"],
            watermark=knobs["watermark"], exclude=exclude)
        if not cands:
            return
        q = self._ensure_export_thread()
        gen, wv = self._cache_gen, self.weight_version
        for c in cands:
            try:
                host, ev = self._to_host(self._gather_kv(c["blocks"]),
                                         c["depth"])
            except Exception:  # noqa: BLE001 - keep the leaf in tier 1
                self.demote_failures += 1
                self._mgr.demote_finish(c["leaf"], c["blocks"], drop=False)
                continue
            with self._demote_lock:
                self._demote_inflight += 1
            q.put(("demote", c, host, ev, gen, wv))

    def _demote_one(self, c: dict, host, ev, gen: int, wv: int) -> None:
        """Export-thread half of one demotion: wait for the host KV,
        publish it, then finish the manager's accounting (pins released
        either way; the tier-1 leaf drops only when tier 2 holds the
        entry and no weight swap invalidated it meanwhile)."""
        published = False
        try:
            kv = self._host_result(host, ev)
        except Exception:  # noqa: BLE001 - device fault: keep tier 1
            self.demote_failures += 1
            kv = None
        if kv is not None and gen == self._cache_gen:
            try:
                # Between the KV gather and the store registration: the
                # pins must still drop, and tier 1 keeps the leaf.
                self._runtime.failpoint("serve.prefix_demote")
                published = bool(self._demote_cb(dict(
                    tokens=c["tokens"], kv=kv, hashes=c["hashes"],
                    depth=c["depth"], page=self.page, weight_version=wv,
                    salt=c.get("salt", 0))))
            except Exception:  # noqa: BLE001 - a failing store
                self.demote_failures += 1
            if not published:
                with self._demote_lock:
                    self._demote_skip.add(c["hash"])
                    if len(self._demote_skip) > 4096:
                        self._demote_skip.clear()
        self._mgr.demote_finish(c["leaf"], c["blocks"],
                                drop=published and gen == self._cache_gen)
        if published:
            self.demote_published += 1
        with self._demote_lock:
            self._demote_inflight -= 1
        self._wake.set()

    # -------------------------------------------------------------- finish
    def _done(self, req: _Request) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None
                    and req.tokens[-1] == req.eos_id))

    def _release_slot(self, slot: int, req: _Request) -> None:
        """Commit the request's computed full blocks into the prefix
        cache (unless it is warmup traffic or predates a weight swap),
        then drop its references.  KV is valid only below
        prompt+tokens-1 (the newest token's K/V is not written yet)."""
        if not req.pages:
            return
        kv_valid = len(req.prompt) + len(req.tokens) - 1
        if req.cache_ok and req.cache_gen == self._cache_gen:
            self._mgr.commit(req.prompt + req.tokens,
                             req.pages[:kv_valid // self.page],
                             salt=req.salt)
        self._mgr.release(req.pages)
        req.pages = []
        # The freed slot's garbage decode writes go to the trash page once
        # the zeroed table row reaches the device.
        self._table[slot, :] = 0
        self._table_dirty = True

    def _finish(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self._adapters[slot] = 0      # the lane's adapter is evictable
        self.completed += 1
        if req.prefill_only and req.pages and not (
                req.eos_id is not None and req.tokens[-1] == req.eos_id):
            # Export path; an eos-terminated request has nothing to
            # migrate and finishes plainly.
            self._finish_export(slot, req)
            return
        self._release_slot(slot, req)
        now = time.perf_counter()
        self._observe_done(req, now)
        req.emit(None)
        if not req.future.done():
            req.future.set_result({
                "tokens": req.tokens,
                "ttft_s": (req.first_token_at or now) - req.submitted_at,
                "total_s": now - req.submitted_at,
            })

    def _metrics_table(self) -> dict:
        if self._metrics is None:
            self._metrics = _engine_metrics(self._runtime)
        return self._metrics

    def _observe_done(self, req: _Request, now: float) -> None:
        """Record a finished request's latencies in the TTFT / TPOT /
        stage histograms and the SLO window.  A migrated request skips
        TTFT, queue and prefill (its first token came from the exporting
        engine, which observed it); a prefill-only export skips decode."""
        ft = req.first_token_at
        if ft is None:
            return
        m = self._metrics_table()
        tags = {"engine": self.name}
        imported = req.import_len > 0
        if not imported:
            m["ttft"].observe((ft - req.submitted_at) * 1000.0, tags)
            self._slo_window.observe(
                "ttft_ms", (ft - req.submitted_at) * 1000.0)
        n = len(req.tokens)
        if n > 1 and now > ft:
            m["tpot"].observe((now - ft) * 1000.0 / (n - 1), tags)
        if req.admitted_at:
            st = m["stage"]
            if not imported:
                queue_ms = (req.admitted_at - req.submitted_at) * 1000.0
                prefill_ms = (ft - req.admitted_at) * 1000.0
                st.observe(queue_ms, {**tags, "stage": "queue"})
                st.observe(prefill_ms, {**tags, "stage": "prefill"})
                self._slo_window.observe("queue_ms", queue_ms)
                self._slo_window.observe("prefill_ms", prefill_ms)
            if not req.prefill_only:
                st.observe((now - ft) * 1000.0, {**tags, "stage": "decode"})
                self._slo_window.observe("decode_ms", (now - ft) * 1000.0)

    def _flush_metrics(self, force: bool = False) -> None:
        """Export the engine's counters as metrics: deltas against the
        last flush, at most once a second unless forced (stats()), and
        the gauges."""
        now = time.monotonic()
        if not force and now - self._metrics_t < 1.0:
            return
        m = self._metrics_table()
        tags = {"engine": self.name}
        cur = {"prefill_tokens": self.prefill_tokens,
               "decode_tokens": self.decode_tokens,
               "preemptions": self.preemptions,
               "completed": self.completed,
               "weight_updates": self.weight_updates}
        if self._mgr is not None:
            cur["prefix_hit_tokens"] = self._mgr.hit_tokens
            cur["evictions"] = self._mgr.evictions
        with self._metrics_lock:
            self._metrics_t = now
            for key, val in cur.items():
                delta = val - self._metrics_last.get(key, 0)
                if delta > 0:
                    m[key].inc(delta, tags)
                self._metrics_last[key] = val
        m["occupancy"].set(
            sum(s is not None for s in self._slots) / self.max_batch, tags)
        m["queue_depth"].set(self._waiting.qsize() + len(self._pending),
                             tags)
        m["weight_version"].set(float(self.weight_version), tags)
        if self._mgr is not None:
            m["free_blocks"].set(self._mgr.free_count(), tags)
            seen = self._mgr.hit_tokens + self.prefill_tokens
            m["hit_rate"].set(self._mgr.hit_tokens / seen if seen else 0.0,
                              tags)

    def _preempt_slot(self, slot: int) -> None:
        """Evict a running request: its blocks go to the prefix cache and
        it re-enters the pending queue at the FRONT."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._seeds[slot] = 0
        self._adapters[slot] = 0
        self._release_slot(slot, req)
        req.slot = -1
        req.preempted += 1
        self.preemptions += 1
        self._pending.appendleft(req)

    def _ensure_decode_blocks(self, k_win: int | None = None) -> list[int]:
        """Fund every active slot's next window of merge positions, oldest
        request first; when the pool runs dry the NEWEST active request
        is preempted.  `k_win` is the loop's snapshot of the window size
        (funding and the window must agree).  Returns the surviving
        active slots."""
        if k_win is None:
            k_win = self._k_live
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not self.paged:
            return active
        for slot in sorted(active,
                           key=lambda i: self._slots[i].sample_seed):
            req = self._slots[slot]
            if req is None:                  # preempted this round
                continue
            total = len(req.prompt) + len(req.tokens)
            cover = min(total - 1 + k_win,
                        len(req.prompt) + req.max_new_tokens)
            need = -(-cover // self.page) - len(req.pages)
            if need <= 0:
                continue
            got = self._mgr.allocate(need)
            while got is None and self._preempt_on:
                victims = [i for i, s in enumerate(self._slots)
                           if s is not None]
                victim = max(victims,
                             key=lambda i: self._slots[i].sample_seed)
                self._preempt_slot(victim)
                if victim == slot:
                    break
                got = self._mgr.allocate(need)
            if got is None or self._slots[slot] is None:
                continue
            req.pages.extend(got)
            self._table[slot, :len(req.pages)] = req.pages
            self._table_dirty = True
        return [i for i, s in enumerate(self._slots) if s is not None]

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        try:
            with torch.no_grad():      # params may come from a trainer
                self._loop_inner()
        except BaseException as e:  # noqa: BLE001
            # Fail every in-flight and waiting request instead of letting
            # their futures hang, then re-raise.
            self._error = e
            self._drain_requests(e)
            self._stop.set()
            raise

    def _drain_requests(self, exc: BaseException) -> None:
        while True:
            try:
                *_rest, fut = self._graft_q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(exc)
        doomed = list(self._pending) + [r for r in self._slots if r]
        self._pending.clear()
        self._slots = [None] * self.max_batch
        while True:
            try:
                doomed.append(self._waiting.get_nowait())
            except queue.Empty:
                break
        for req in doomed:
            req.emit(None)
            if not req.future.done():
                req.future.set_exception(exc)

    def _loop_inner(self) -> None:
        while not self._stop.is_set():
            # The reference's order: swap weights, apply grafts (the
            # version check sees the tree a commit lands in), admit, fund
            # blocks, demote, decode.
            self._maybe_swap_weights()
            self._apply_grafts()
            self._admit()
            k_win = self._k_live
            active = self._ensure_decode_blocks(k_win)
            self._maybe_demote()
            self._flush_metrics()
            if not active:
                self._wake.wait(timeout=0.002 if self._pending else 0.05)
                self._wake.clear()
                continue
            traced = [self._slots[i] for i in active
                      if self._slots[i].trace is not None] \
                if self._runtime.tracing_enabled() else ()
            t_win0 = time.time() if traced else 0.0
            seq = self._decode_window(active, k_win).cpu().numpy()  # 1 sync
            if traced:
                # One span per window per traced co-resident request,
                # from dispatch to the tokens on the host.
                t_win1 = time.time()
                for r in traced:
                    self._runtime.emit(
                        "llm.decode_window", t_win0, t_win1, ctx=r.trace,
                        attrs={"steps": k_win,
                               "weight_version": self.weight_version})
            for i in active:
                req = self._slots[i]
                if req is None:
                    continue
                for tok in seq[:, i]:
                    req.tokens.append(int(tok))
                    self.decode_tokens += 1
                    req.emit(int(tok))
                    if self._done(req):
                        self._finish(i)       # trims K-step overshoot
                        break

    # ------------------------------------------------------------- probes
    def kv_check(self) -> dict:
        """Assert the block-state partition: raises if any KV block is
        leaked or double-booked.  A dense engine has no blocks."""
        if self._mgr is None:
            return {"ok": True, "paged": False}
        self._mgr.check()
        return {"ok": True, "free": self._mgr.free_count(),
                "available": self._mgr.available()}

    @property
    def graph_replays(self) -> int:
        return sum(g.replays for g in list(self._graphs.values()))

    def graph_stats(self) -> dict:
        """Per captured window size "K=<k>": replays, capture seconds and
        the kernel launches one replay counts."""
        return {f"K={k}": {
                    "replays": g.replays, "capture_s": g.capture_s,
                    "launches_per_replay": {
                        fn.__name__ + (f"/{r}" if r else ""): n
                        for (fn, r), n in g.launches.items()}}
                for k, g in list(self._graphs.items())}

    def stats(self) -> dict:
        out = {"completed": self.completed,
               "active": sum(s is not None for s in self._slots),
               "waiting": self._waiting.qsize() + len(self._pending),
               "max_batch": self.max_batch,
               "max_len": self.max_len,
               "preemptions": self.preemptions,
               "prefill_tokens": self.prefill_tokens,
               "decode_tokens": self.decode_tokens,
               "prefix_cache": self._prefix_cache,
               "kv_preempt": self._preempt_on,
               "kv_exports": self.kv_exports,
               "kv_imports": self.kv_imports,
               "kv_grafts": self.kv_grafts,
               "graft_tokens": self.graft_tokens,
               "demote_published": self.demote_published,
               "demote_failures": self.demote_failures,
               "weight_version": self.weight_version,
               "weight_updates": self.weight_updates,
               "weight_syncs_skipped": self.weight_syncs_skipped,
               "last_weight_sync_ms": round(self.last_weight_sync_ms, 3),
               "slo": self._slo_window.snapshot(),
               "adapter_loads": self.adapter_loads,
               "adapter_evictions": self.adapter_evictions,
               "sync_window": self._k_live,
               "sync_window_shrinks": self.sync_window_shrinks,
               "decode_windows": self.decode_windows,
               "graph_replays": self.graph_replays,
               "graph_captures": len(self._graphs),
               "graph_capture_s": sum(g.capture_s
                                      for g in list(self._graphs.values()))}
        if self._lora_banks is not None:
            with self._lora_lock:
                now = time.monotonic()
                out["lora"] = {
                    "slots": self.lora_slots, "rank": self.lora_rank,
                    "free": len(self._lora_free),
                    "loads": self.adapter_loads,
                    "evictions": self.adapter_evictions,
                    "resident": {
                        mid: {"salt": m["salt"], "version": m["version"],
                              "age": round(now - m["last_used"], 3)}
                        for mid, m in self._lora_meta.items()}}
        if self._mgr is not None:
            kv = self._mgr.stats()
            out.update(kv=kv, prefix_hits=kv["hits"],
                       prefix_misses=kv["misses"],
                       prefix_hit_tokens=kv["hit_tokens"],
                       evictions=kv["evictions"],
                       cow_copies=kv["cow_copies"])
        self._flush_metrics(force=True)
        return out


class LLMServer:
    """Serve deployment body: one engine per replica, paged or (paged=False)
    dense (port of ray_tpu/serve/llm.py's LLMServer).

    Requests are dicts with a token-id "prompt" and the optional
    "max_new_tokens", "temperature", "eos_id", "model_id", "disagg" and
    "prefix_store" keys.  Engine memory knobs are operator-tunable through
    `reconfigure` (serve/schema.py's ENGINE_CONFIG_KEYS), which rebuilds
    the engine in place.  The engine runs on `device`: None means CUDA and
    raises where there is none; tests pass "cpu".

    **Pool roles.**  `role="prefill"` replicas run only the prompt pass
    and hand the request's KV pages (put through the runtime) to the
    `decode_deployment` pool's `kv_decode`, which imports them and runs
    the decode phase.  `decode_deployment` is a handle (`.remote`,
    `.options(method_name=...)`) or a deployment name the runtime
    resolves.  Failures degrade, never fail the request: an export error
    serves unified locally ("export_failed"); a decode-pool error re-runs
    the whole request on the decode pool ("full_reprefill"), then locally
    ("local").  Both pools should share the engine `seed`.  Kill switch
    RAY_TPU_PD_DISAGG=0, or {"disagg": false} per request.

    **Mixed pools run one way only.**  A JAX engine's f32 numpy export
    imports into this `kv_decode`; the port's bf16 export cannot be read
    by the reference's `kv_decode` (numpy has no bf16).

    **Runtime seam.**  `runtime` (serve/runtime.py) carries every runtime
    call: the KV put and pull, deployment-name resolution, the replica
    context and the controller behind the adapter and prefix-store
    clients.  None is ServeRuntime(), a process outside any cluster: no
    replica context, a KV export passes to the decode handle as the tensor
    itself, a decode deployment named by a string cannot be resolved (the
    PD path falls back), and the adapter and prefix-store clients reach
    only an in-process directory (`lora_directory`, `prefix_store`'s
    "directory") or return their defaults.

    **Observability.**  The runtime also receives the engine's metrics,
    spans and memory rows (the engine is built with it), and the server's
    own: the spans serve.adapter_load (under the caller's trace context),
    serve.shed / serve.restore, serve.kv_put (with the memory tag
    "kv_export") and serve.kv_pull, and the `serve.adapter_load`
    failpoint at the page-in's entry, whose error rejects the request
    with AdapterLoadError(reason="load_failed")."""

    # Adapter requests re-page and resubmit this many times in all when a
    # concurrent tenant's load evicts their adapter between the page-in
    # and admission; admission precedes the first token, so a resubmit is
    # invisible to the client.
    _LORA_ADMIT_RETRIES = 3

    def __init__(self, model="debug", *, max_batch: int = 8,
                 max_len: int | None = None, params=None, seed: int = 0,
                 warmup: bool = False, paged: bool = True,
                 page_size: int = 512, kv_pages: int | None = None,
                 prefix_cache: bool | None = None,
                 kv_preempt: bool | None = None,
                 steps_per_sync: int = 8,
                 role: str = "unified",
                 decode_deployment=None,
                 prefix_store: dict | None = None,
                 lora_slots: int = 0, lora_rank: int = 0,
                 lora_directory=None,
                 runtime: ServeRuntime | None = None,
                 device=None):
        _check_pool_role(role, decode_deployment)
        if role == "prefill" and not paged:
            raise ValueError(
                "role='prefill' requires a paged engine (KV migration "
                "is page-granular)")
        self._device = resolve_device(device, "LLMServer")
        self._runtime = runtime or ServeRuntime()
        cfg = llama.llama_configs()[model] if isinstance(model, str) \
            else model
        name = "llm"
        self._app_name = None
        ctx = self._runtime.replica_context()
        if ctx is not None and ctx.deployment:
            name = ctx.deployment
            self._app_name = ctx.app_name
        self._engine_kwargs = dict(
            max_batch=max_batch, max_len=max_len, seed=seed, paged=paged,
            page_size=page_size, kv_pages=kv_pages,
            prefix_cache=prefix_cache, kv_preempt=kv_preempt,
            steps_per_sync=steps_per_sync, lora_slots=lora_slots,
            lora_rank=lora_rank, name=name)
        self._cfg = cfg
        self._params = params
        self._warmup = warmup
        self._role = role
        self._decode_dep = decode_deployment
        self._decode_handle = None
        self._decode_kv_handle = None
        # Migration counters (stats()["pd"]).  kv_decode runs on the
        # caller's threads, so the pull side takes the lock; the put side
        # runs on the event loop.
        self._pd_lock = threading.Lock()
        self._migrations = 0
        self._pd_fallbacks = 0
        self._kv_migrate_bytes = 0
        self._kv_migrate_put_ms = 0.0
        self._kv_pull_bytes = 0
        self._kv_pull_ms = 0.0
        # Overload ladder over the engine's queue depth: level 1 sheds
        # disaggregation to unified serving, level 2 also shrinks the
        # decode sync window.  Kill switch RAY_TPU_SERVE_DEGRADE=0.
        self._overload = slo.OverloadTracker(hi=max(4, 2 * max_batch))
        self._degraded_window = max(1, min(2, steps_per_sync))
        self._sheds = 0
        self._restores = 0
        # Tier-2 prefix store: knobs ride the `prefix_store` dict
        # ({"enabled", "directory", "min_idle", "period_s",
        # "watermark_frac", "min_tokens", "migrate_ms", ...}).
        self._prefix_store_cfg = dict(prefix_store or {})
        self._prefix_client = None
        # Multi-LoRA page-in: one in-flight load per model_id (racing
        # requests wait on its future) and a short TTL cache of the
        # directory's version answer, so a resident adapter costs no
        # directory round trip.
        self._lora_client = None
        self._lora_directory = lora_directory
        self._lora_inflight: dict = {}
        self._lora_inflight_lock = threading.Lock()
        self._lora_seen: dict[str, tuple[float, int]] = {}
        self._lora_ttl = float(
            os.environ.get("RAY_TPU_LORA_TTL_S", "2.0") or 0.0)
        self.adapter_load_errors = 0
        self.adapter_admit_retries = 0
        self._closed = False
        self.engine = self._new_engine(self._engine_kwargs)
        self._install_prefix_store()
        self.engine.start()
        if warmup:
            self.engine.warmup()

    def _new_engine(self, kwargs: dict) -> LLMEngine:
        return LLMEngine(self._cfg, self._params, device=self._device,
                         runtime=self._runtime, **kwargs)

    def _install_prefix_store(self) -> None:
        """(Re)attach the prefix-store client and demotion hook to the
        current engine (constructor and every reconfigure rebuild).
        Disabled for dense engines, prefix_cache=0 engines and by
        prefix_store={"enabled": False}."""
        if self._prefix_client is not None:
            self._prefix_client.close()
            self._prefix_client = None
        eng = self.engine
        cfg = self._prefix_store_cfg
        if not eng._prefix_cache or cfg.get("enabled", True) is False:
            eng.set_prefix_store(None)
            return
        ctx = self._runtime.replica_context()
        rid = (ctx.replica_tag or None) if ctx is not None else None
        self._prefix_client = PrefixStoreClient(
            app=self._app_name or "default", deployment=eng.name,
            # Unique in-process fallback: several servers may share one
            # interpreter, and a bare pid would make one server's close()
            # withdraw its siblings' entries.
            replica_id=rid or f"pid:{os.getpid()}-{os.urandom(3).hex()}",
            seed=self._engine_kwargs.get("seed", 0), page=eng.page,
            config=cfg, directory=cfg.get("directory"),
            runtime=self._runtime)
        eng.set_prefix_store(
            self._prefix_client.publish,
            min_idle=cfg.get("min_idle", 256),
            period_s=cfg.get("period_s", 0.25),
            watermark_frac=cfg.get("watermark_frac", 0.125),
            limit=cfg.get("limit", 2),
            max_inflight=cfg.get("max_inflight", 2))

    # -------------------------------------------------------- multi-LoRA
    def _request_model_id(self, request) -> str | None:
        """The request's adapter, gated per request by the RAY_TPU_LORA
        kill switch (off: every request serves the base model)."""
        if not isinstance(request, dict):
            return None
        mid = request.get("model_id")
        if mid is None or not lora_on():
            return None
        return mid

    def _ensure_adapter_sync(self, model_id: str, trace_ctx=None) -> None:
        """Make `model_id` device-resident before submit (blocking;
        callers keep it off the event loop).  Fast path: resident at the
        version the directory reported within RAY_TPU_LORA_TTL_S seconds.
        Slow path: one in-flight load per model_id (racing requests wait
        on its future): directory lookup, pull through the runtime,
        engine.load_adapter, the serve.adapter_load span under
        `trace_ctx`.  Every failure surfaces as AdapterLoadError before
        the request holds a batch slot; the `serve.adapter_load`
        failpoint fires at entry."""
        eng = self.engine
        try:
            self._runtime.failpoint("serve.adapter_load")
        except Exception as e:  # noqa: BLE001 - typed reject
            self.adapter_load_errors += 1
            raise AdapterLoadError(
                f"adapter load faulted: {type(e).__name__}: {e}",
                model_id=model_id, deployment=eng.name,
                reason="load_failed") from e
        if eng._lora_banks is None:
            raise AdapterLoadError(
                "deployment has no adapter slots (set engine_config "
                "lora_slots)", model_id=model_id, deployment=eng.name,
                reason="lora_slots=0")
        now = time.monotonic()
        seen = self._lora_seen.get(model_id)
        if seen and seen[0] > now \
                and eng.adapter_resident(model_id, seen[1]):
            eng.adapter_touch(model_id)
            return
        with self._lora_inflight_lock:
            fut = self._lora_inflight.get(model_id)
            owner = fut is None
            if owner:
                fut = concurrent.futures.Future()
                self._lora_inflight[model_id] = fut
        if not owner:
            fut.result(timeout=120.0)   # re-raises the owner's error
            return
        try:
            t0 = time.time()
            try:
                if self._lora_client is None:
                    self._lora_client = lora_mod.LoraClient(
                        directory=self._lora_directory,
                        runtime=self._runtime)
                entry = self._lora_client.lookup(model_id)
                if entry is None:
                    raise AdapterLoadError(
                        "no such adapter published",
                        model_id=model_id, deployment=eng.name,
                        reason="not_published")
                if not eng.adapter_resident(model_id, entry["version"]):
                    adapter = lora_mod.resolve_entry(entry, self._runtime)
                    eng.load_adapter(model_id, adapter,
                                     version=entry["version"])
                    if self._runtime.tracing_enabled():
                        self._runtime.emit(
                            "serve.adapter_load", t0, time.time(),
                            ctx=trace_ctx,
                            attrs={"model_id": model_id,
                                   "deployment": eng.name,
                                   "version": entry["version"],
                                   "bytes": entry.get("nbytes", 0)})
                eng.adapter_touch(model_id)
                self._lora_seen[model_id] = (
                    time.monotonic() + self._lora_ttl, entry["version"])
                fut.set_result(None)
            except Exception as e:  # noqa: BLE001 - typed reject
                self.adapter_load_errors += 1
                err = e if isinstance(e, AdapterLoadError) \
                    else AdapterLoadError(
                        f"adapter load faulted: {type(e).__name__}: {e}",
                        model_id=model_id, deployment=eng.name,
                        reason="load_failed")
                fut.set_exception(err)
                raise err from (None if e is err else e)
        finally:
            with self._lora_inflight_lock:
                self._lora_inflight.pop(model_id, None)

    def _graft_eligible(self, request) -> bool:
        """The one miss-path gate of the unary and streaming entry points:
        a dict request with a token prompt of at least one page, not opted
        out, with the env switch on."""
        eng = self.engine
        if (self._prefix_client is None or not isinstance(request, dict)
                or not request.get("prefix_store", True)
                or not eng._prefix_cache):
            return False
        prompt = request.get("prompt")
        if not isinstance(prompt, (list, tuple)) \
                or len(prompt) < eng.page:
            return False
        return prefix_store_on()

    def _maybe_graft_sync(self, request: dict) -> None:
        """Miss-path store consultation for one request (blocking): graft
        the deepest affordable stored prefix before submitting.  Any
        failure degrades to a plain local prefill."""
        if not self._graft_eligible(request):
            return
        try:
            # Adapter requests graft under the adapter's salt.
            mid = self._request_model_id(request)
            salt = self.engine.adapter_salt_of(mid) if mid else 0
            self._prefix_client.maybe_graft(
                self.engine, list(request["prompt"]), salt=salt)
        except Exception:  # noqa: BLE001 - degrade, never fail
            pass

    async def _maybe_graft_async(self, request: dict) -> None:
        if not self._graft_eligible(request):
            return
        await asyncio.get_running_loop().run_in_executor(
            None, self._maybe_graft_sync, request)

    # ------------------------------------------------- overload ladder
    def _update_pressure(self) -> int:
        """Feed the engine's queue depth to the hysteresis tracker; on a
        level change apply or restore the sync-window knob and emit
        serve.shed or serve.restore.  Kill switch RAY_TPU_SERVE_DEGRADE=0
        pins level 0 (restoring a shrunk window)."""
        eng = self.engine
        if not slo.degrade_on():
            if self._overload.level:
                self._overload.level = 0
                eng.set_sync_window(None)
            return 0
        depth = eng._waiting.qsize() + len(eng._pending)
        level, prev = self._overload.update(depth)
        if level != prev:
            eng.set_sync_window(
                self._degraded_window if level >= 2 else None)
            if level > prev:
                self._sheds += 1
            else:
                self._restores += 1
            if self._runtime.tracing_enabled():
                self._runtime.emit(
                    "serve.shed" if level > prev else "serve.restore",
                    time.time(),
                    attrs={"deployment": eng.name, "level": level,
                           "from": prev, "depth": depth,
                           "sync_window": eng._k_live})
        return level

    # --------------------------------------------------- prefill/decode
    def _disagg(self, request: dict) -> bool:
        return (self._role == "prefill"
                and self._decode_dep is not None
                and self.engine.paged
                and pd_disagg_on()
                and request.get("disagg", True)
                and request.get("max_new_tokens", 32) > 1)

    def _get_decode_handle(self):
        """The decode pool's handle pair, made once per server: the base
        handle (full-generate fallback) and its kv_decode sibling.  A name
        resolves through the runtime (the null runtime raises)."""
        if self._decode_handle is None:
            dd = self._decode_dep
            if isinstance(dd, str):
                base = self._runtime.deployment_handle(
                    dd, self._app_name or "default")
            else:
                base = dd
            self._decode_kv_handle = base.options(method_name="kv_decode")
            self._decode_handle = base
        return self._decode_handle

    async def _local_generate(self, request: dict, t_start: float,
                              why: str) -> dict:
        fut = self.engine.submit(
            request["prompt"],
            max_new_tokens=request.get("max_new_tokens", 32),
            temperature=request.get("temperature", 0.0),
            eos_id=request.get("eos_id"))
        out = await asyncio.wrap_future(fut)
        out["total_s"] = time.perf_counter() - t_start
        out["pd_fallback"] = why
        return out

    async def _prefill_decode(self, request: dict) -> dict:
        """The migration path: prefill here, put the KV pages through the
        runtime, hand the ref to a decode replica.  Export error: serve
        unified locally.  Decode-pool error (including a decode deployment
        that cannot be resolved): full re-prefill on the decode pool, then
        locally as the last resort."""
        t_start = time.perf_counter()
        try:
            pre = await asyncio.wrap_future(self.engine.submit(
                request["prompt"], max_new_tokens=1,
                temperature=request.get("temperature", 0.0),
                eos_id=request.get("eos_id"), prefill_only=True))
        except Exception:  # noqa: BLE001 - export window faults
            self._pd_fallbacks += 1
            return await self._local_generate(request, t_start,
                                              "export_failed")
        exp = pre.get("kv_export")
        eos = request.get("eos_id")
        if exp is None or (eos is not None and pre["tokens"]
                           and pre["tokens"][-1] == eos):
            return {"tokens": pre["tokens"], "ttft_s": pre["ttft_s"],
                    "total_s": time.perf_counter() - t_start}
        kv = exp["kv"]
        rt = self._runtime
        # Executor threads do not inherit the handler's context: carry the
        # request's trace into the put.
        trace_ctx = rt.trace_capture() if rt.tracing_enabled() else None

        def _put():
            t0 = time.perf_counter()
            with rt.span("serve.kv_put", attrs={"bytes": kv.nbytes},
                         ctx=trace_ctx), \
                    rt.memory_tag("kv_export",
                                  label="serve/llm.py kv_export"):
                r = rt.put(kv)
            return r, (time.perf_counter() - t0) * 1000.0

        # A put may block on allocation: keep it off the event loop.
        ref, put_ms = await asyncio.get_running_loop().run_in_executor(
            None, _put)
        self._migrations += 1
        self._kv_migrate_bytes += kv.nbytes
        self._kv_migrate_put_ms += put_ms
        meta = {"prompt": list(request["prompt"]),
                "tokens": exp["tokens"], "kv_len": exp["len"],
                "page": exp["page"], "sample_seed": exp["sample_seed"],
                "max_new_tokens": request.get("max_new_tokens", 32),
                "temperature": request.get("temperature", 0.0),
                "eos_id": eos}
        # The runtime now holds the KV: drop the host copy before the
        # decode await.
        pre.pop("kv_export", None)
        exp = kv = None
        try:
            self._get_decode_handle()
            out = await self._decode_kv_handle.remote(meta, ref)
            return {"tokens": out["tokens"], "ttft_s": pre["ttft_s"],
                    "total_s": time.perf_counter() - t_start,
                    "disagg": True}
        except Exception:  # noqa: BLE001 - decode pool failed
            self._pd_fallbacks += 1
            del ref            # free the orphaned KV object
            try:
                out = await self._get_decode_handle().remote(
                    {**request, "disagg": False})
                out["pd_fallback"] = "full_reprefill"
                return out
            except Exception:  # noqa: BLE001 - decode pool gone
                return await self._local_generate(request, t_start,
                                                  "local")

    def kv_decode(self, meta: dict, kv_ref) -> dict:
        """Decode-pool entry point: pull the migrated KV (through the
        runtime when it is a ref; a numpy array or tensor as it is),
        import it into this engine's pool and run the decode phase to
        completion."""
        t0 = time.perf_counter()
        with self._runtime.span("serve.kv_pull") as sp:
            blob = kv_ref
            if self._runtime.is_ref(blob):
                blob = self._runtime.get(blob)
            blob = as_tensor(blob)
            nbytes = blob.nbytes
            sp["bytes"] = nbytes
        pull_ms = (time.perf_counter() - t0) * 1000.0
        fut = self.engine.kv_import(
            meta["prompt"], meta["tokens"], blob,
            kv_len=meta["kv_len"],
            max_new_tokens=meta.get("max_new_tokens", 32),
            temperature=meta.get("temperature", 0.0),
            eos_id=meta.get("eos_id"),
            sample_seed=meta.get("sample_seed", 0))
        with self._pd_lock:
            self._kv_pull_bytes += nbytes
            self._kv_pull_ms += pull_ms
        del blob, kv_ref       # the engine holds the tensor until scatter
        out = fut.result()
        out["migrated"] = True
        return out

    def update_weights(self, refs, version: int | None = None) -> int:
        """Replica-side weight push (online RLHF): stage a fresh param
        tree on the engine (decode keeps running; the swap lands between
        windows) and invalidate the tier-2 entries of older versions.
        `refs` is the tree, a runtime ref to it, or a list of refs to dict
        shards; refs resolve through the runtime, and are not pulled when
        RAY_TPU_RL_WEIGHT_SYNC=0 drops the update.  Returns the staged
        (or, kill-switched, current) version."""
        tree = refs
        if env_on("RAY_TPU_RL_WEIGHT_SYNC"):
            tree = resolve_tree(self._runtime, refs)
        v = self.engine.update_weights(tree, version)
        if self._prefix_client is not None:
            try:
                self._prefix_client.invalidate(v)
            except Exception:  # noqa: BLE001 - store is best-effort
                pass
        return v

    def kv_check(self) -> dict:
        """Assert the engine's block-state partition (raises on a leaked
        or double-booked block), report the tier-2 objects this server
        still owns, and after shutdown assert that count is zero."""
        out = self.engine.kv_check()
        if self._prefix_client is not None:
            n = self._prefix_client.object_count()
            out["prefix_store_objects"] = n
            if self._closed and n:
                raise AssertionError(
                    f"{n} tier-2 prefix objects leaked after shutdown "
                    "(demoted subtrees must die with the app)")
        return out

    async def __call__(self, request: dict) -> dict:
        # Under sustained overload (level >= 1) disaggregation sheds to
        # unified serving on this replica: same engine, same seed, the
        # same tokens, minus the migration round trips.
        level = self._update_pressure()
        model_id = self._request_model_id(request)
        attempts = self._LORA_ADMIT_RETRIES if model_id is not None else 1
        for attempt in range(attempts):
            if model_id is not None:
                # Page-in before the graft lookup: the store keys are
                # salted per (adapter, version).
                await asyncio.get_running_loop().run_in_executor(
                    None, self._ensure_adapter_sync, model_id,
                    self._runtime.trace_current())
            if level < 1 and attempt == 0:
                # Overloaded replicas skip the store entirely.
                await self._maybe_graft_async(request)
            # Adapter requests serve unified.
            if level < 1 and model_id is None and self._disagg(request):
                return await self._prefill_decode(request)
            fut = self.engine.submit(
                request["prompt"],
                max_new_tokens=request.get("max_new_tokens", 32),
                temperature=request.get("temperature", 0.0),
                eos_id=request.get("eos_id"),
                model_id=model_id)
            try:
                return await asyncio.wrap_future(fut)
            except AdapterLoadError as e:
                if e.reason != "not_resident" or attempt >= attempts - 1:
                    raise
                # Evicted between page-in and admission by a concurrent
                # tenant's load; the request held no blocks or lanes yet,
                # so re-page and resubmit.
                self._lora_seen.pop(model_id, None)
                self.adapter_admit_retries += 1

    def stream(self, request: dict):
        """Token-streaming generator: yields each token id as the engine
        decodes it."""
        if isinstance(request, dict) and "prompt" not in request:
            request = request.get("body") or request
        # Streaming traffic feeds the ladder too.
        level = self._update_pressure()
        model_id = self._request_model_id(request)
        attempts = self._LORA_ADMIT_RETRIES if model_id is not None else 1
        for attempt in range(attempts):
            if model_id is not None:
                # stream() runs on a pool thread: blocking is fine.
                self._ensure_adapter_sync(model_id,
                                          self._runtime.trace_current())
            if level < 1 and attempt == 0:
                self._maybe_graft_sync(request)
            q: queue.Queue = queue.Queue()
            fut = self.engine.submit(
                request["prompt"],
                max_new_tokens=request.get("max_new_tokens", 32),
                temperature=request.get("temperature", 0.0),
                eos_id=request.get("eos_id"),
                token_queue=q,
                model_id=model_id)
            while True:
                tok = q.get()
                if tok is None:
                    break
                yield tok
            # The None sentinel comes just before the future resolves:
            # wait briefly so an engine failure cannot pass for a clean
            # end of the stream.
            try:
                exc = fut.exception(timeout=5.0)
            except concurrent.futures.TimeoutError:
                exc = None
            if exc is None:
                return
            if (isinstance(exc, AdapterLoadError)
                    and exc.reason == "not_resident"
                    and attempt < attempts - 1):
                # Admission-time eviction: nothing was streamed yet.
                self._lora_seen.pop(model_id, None)
                self.adapter_admit_retries += 1
                continue
            raise exc

    def stats(self) -> dict:
        out = self.engine.stats()
        out["pd"] = {
            "role": self._role,
            "migrations": self._migrations,
            "fallbacks": self._pd_fallbacks,
            "kv_migrate_bytes": self._kv_migrate_bytes,
            "kv_migrate_put_ms": round(self._kv_migrate_put_ms, 3),
            "kv_pull_bytes": self._kv_pull_bytes,
            "kv_pull_ms": round(self._kv_pull_ms, 3),
        }
        out["overload"] = {
            "level": self._overload.level,
            "sheds": self._sheds,
            "restores": self._restores,
        }
        out["prefix_store"] = (self._prefix_client.stats()
                               if self._prefix_client is not None
                               else {"enabled": False})
        if "lora" in out:
            out["lora"]["load_errors"] = self.adapter_load_errors
            out["lora"]["admit_retries"] = self.adapter_admit_retries
        return out

    def reconfigure(self, user_config: dict) -> None:
        """Apply engine knobs (serve/schema.py's ENGINE_CONFIG_KEYS, plus
        kv_pages and paged).  The whole new configuration is validated
        before anything changes, so a rejected reconfigure leaves the
        server as it was.  Knobs that reshape device memory rebuild the
        engine: the old engine is stopped first and the requests it still
        held fail with a clear error."""
        if not user_config:
            return
        allowed = ENGINE_CONFIG_KEYS | {"kv_pages", "paged"}
        unknown = set(user_config) - allowed
        if unknown:
            raise ValueError(
                f"unknown engine_config keys {sorted(unknown)}; "
                f"valid: {sorted(allowed)}")
        cfg = dict(user_config)
        ps_given = cfg.pop("prefix_store", None)
        # Pool-role knobs live on the server and never cost a rebuild.
        new_role = cfg.pop("role", None) or self._role
        dd_given = cfg.pop("decode_deployment", None)
        new_dd = self._decode_dep if dd_given is None else dd_given
        if new_role != "prefill" and dd_given is None:
            # Moving away from prefill sheds an inherited decode target;
            # an explicit one with a non-prefill role is rejected below.
            new_dd = None
        _check_pool_role(new_role, new_dd)
        if "kv_blocks" in cfg:
            cfg["kv_pages"] = cfg.pop("kv_blocks")
        kwargs = {**self._engine_kwargs, **cfg}
        if new_role == "prefill" and not kwargs.get("paged", True):
            raise ValueError(
                "role='prefill' requires a paged engine (KV migration "
                "is page-granular)")

        def commit_roles():
            self._role = new_role
            if new_dd is not self._decode_dep:
                self._decode_dep = new_dd
                self._decode_handle = None
                self._decode_kv_handle = None

        if kwargs == self._engine_kwargs:
            commit_roles()
            if ps_given is not None:
                self._prefix_store_cfg = dict(ps_given)
                self._install_prefix_store()
            return
        old = self.engine
        old.stop()
        old.abort_pending(RuntimeError(
            "LLM engine rebuilt by reconfigure; resubmit the request"))
        self._engine_kwargs = kwargs
        # Roles commit only once the rebuild succeeded.
        self.engine = self._new_engine(kwargs)
        # The fresh engine's banks are empty: the next adapter request
        # re-pages.
        self._lora_seen.clear()
        commit_roles()
        if ps_given is not None:
            self._prefix_store_cfg = dict(ps_given)
        # Re-attach the demotion hook; the old engine's entries are
        # withdrawn.
        self._install_prefix_store()
        self.engine.start()
        if self._warmup:
            self.engine.warmup()

    def shutdown(self) -> None:
        """Deterministic close: stop the engine thread, fail whatever is
        still queued, then withdraw the tier-2 entries (after the stop, so
        the export thread's last publish cannot race the withdrawal)."""
        self.engine.stop()
        self.engine.abort_pending(
            RuntimeError("LLM engine shut down with the replica"))
        self._closed = True
        if self._prefix_client is not None:
            try:
                self._prefix_client.close()
            except Exception:  # noqa: BLE001 - controller already gone
                pass

    def __del__(self):
        # GC backstop only; the deterministic path is shutdown().
        try:
            self.engine.stop()
        except Exception:  # noqa: BLE001
            pass
