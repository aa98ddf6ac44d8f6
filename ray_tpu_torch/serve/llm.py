"""Continuous-batched LLM engine over the paged KV pool (port of the
paged mode of ray_tpu/serve/llm.py's LLMEngine).

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
    block).  Inside the window `j` is a Python int and nothing reads a
    device value on the host.
  - Sampling: token g of request s is drawn by Gumbel-max from a
    counter-based hash keyed by (engine seed, s, g), on the device.  A
    preempted-and-recomputed request therefore draws the same tokens it
    would have drawn uninterrupted.  Greedy (temperature 0) uses no
    randomness.  JAX's threefry cannot be reproduced in torch, so the
    reference and the port agree token for token only when greedy.

Kill switches shared with the reference: RAY_TPU_PREFIX_CACHE=0 disables
prefix matching, RAY_TPU_KV_PREEMPT=0 restores full-span up-front
allocation.  Not ported yet (see ROADMAP.md): KV import/export, the
prefix store and grafts, LoRA banks, live weight updates, the sync-window
knob, the dense engine, metrics/tracing hooks, LLMServer.
"""
from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.ops.paged_attention import merge_tail_pages
from ray_tpu_torch.ops.rope import rope_frequencies
from ray_tpu_torch.serve.kv_blocks import BlockManager
from ray_tpu_torch.serve.kv_router import env_on

_M32 = 0xFFFFFFFF


def _buckets_for(max_len: int, smallest: int = 32) -> list[int]:
    out, b = [], smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash on int64 tensors holding values in [0, 2^32).
    Multipliers stay below 2^31, so no product overflows int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _resolve_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "LLMEngine runs on CUDA and no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return device


@dataclass
class _Request:
    prompt: list[int]
    max_new_tokens: int
    temperature: float
    eos_id: int | None
    future: concurrent.futures.Future
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: float | None = None
    tokens: list[int] = field(default_factory=list)
    # Optional thread-safe sink for token streaming (None = end).
    token_queue: Any = None
    # KV blocks owned by this request, in table order (block i covers
    # positions [i*page, (i+1)*page)); released at finish/preempt.
    pages: list[int] = field(default_factory=list)
    # Sampling identity: token g is drawn from hash(engine, sample_seed, g).
    sample_seed: int = 0
    # First prompt position this admission prefills (below it: cached).
    prefill_from: int = 0

    def emit(self, tok: int | None) -> None:
        if self.token_queue is not None:
            self.token_queue.put(tok)


class LLMEngine:
    """Continuous-batching paged decode engine over llama-family params.

    Runs on `device` ("cuda" unless the caller passes "cpu"); on a machine
    without CUDA the default raises RuntimeError rather than running on
    the CPU."""

    def __init__(self, cfg, params=None, *, max_batch: int = 8,
                 max_len: int | None = None, seed: int = 0,
                 steps_per_sync: int = 8, page_size: int = 512,
                 kv_pages: int | None = None,
                 prefix_cache: bool | None = None,
                 kv_preempt: bool | None = None, device=None):
        self.device = _resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq
        self.steps_per_sync = max(1, steps_per_sync)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(cfg, gen)
        self.params = params
        self._prefix_cache = (prefix_cache if prefix_cache is not None
                              else env_on("RAY_TPU_PREFIX_CACHE"))
        self._preempt_on = (kv_preempt if kv_preempt is not None
                            else env_on("RAY_TPU_KV_PREEMPT"))
        # Shared page pool: device memory holds the page budget, not
        # max_len x slots.  Page 0 is the trash page idle slots point at.
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
        self._buckets = _buckets_for(self.max_len)
        self._chunk = min(16, max_batch)
        self._width_buckets = sorted({w for w in (1, 8, self._chunk)
                                      if w <= max_batch})
        # RoPE tables over the whole paged window, built once.
        self._rope = rope_frequencies(cfg.head_dim, self._maxp * page_size,
                                      cfg.rope_theta, device=self.device)
        # Decode tails [B, kvh, K, hd] per layer, allocated once and reused:
        # rows a window has not written yet are masked, and stay finite.
        tshape = (max_batch, cfg.n_kv_heads, self.steps_per_sync,
                  cfg.head_dim)
        self._tails = {kk: [torch.zeros(tshape, dtype=cfg.dtype,
                                        device=self.device)
                            for _ in range(cfg.n_layers)]
                       for kk in ("k", "v")}
        self._seed_key = int(_mix32(torch.tensor(seed + 1)).item())
        self._vocab_ids = torch.arange(cfg.vocab_size, device=self.device)

        # Slot state.  Current tokens live ON DEVICE between windows.
        self._slots: list[_Request | None] = [None] * max_batch
        self._cur = torch.zeros((max_batch,), dtype=torch.int32,
                                device=self.device)
        self._temps = np.zeros((max_batch,), np.float32)
        self._seeds = np.zeros((max_batch,), np.int32)
        self._table_dev = torch.zeros((max_batch, self._maxp),
                                      dtype=torch.int32, device=self.device)
        self._table_dirty = True
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
        self.preemptions = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0

    # ------------------------------------------------------------- public
    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               temperature: float = 0.0, eos_id: int | None = None,
               token_queue: "queue.Queue | None" = None,
               ) -> concurrent.futures.Future:
        """Thread-safe; resolves to {tokens, ttft_s, total_s}.  With
        `token_queue`, every decoded token is also pushed as produced
        (None = end)."""
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len {self.max_len}; "
                "decode past the cache end would corrupt output")
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
                           token_queue=token_queue, sample_seed=seed)
            self._waiting.put(req)
            self._wake.set()
        finally:
            with self._inflight_lock:
                self._inflight_submits -= 1
        return req.future

    def generate(self, prompt: list[int], max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 eos_id: int | None = None) -> dict:
        """Blocking convenience wrapper."""
        self.start()
        return self.submit(prompt, max_new_tokens, temperature,
                           eos_id).result()

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="llm-engine", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)

    # ----------------------------------------------------------- sampling
    def _sample_rows(self, logits, temps, seeds, gidx, any_temp: bool):
        """Per-row sampling: row b draws from hash(engine, seeds[b],
        gidx[b]) -- the stream belongs to the request, not the batch."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if not any_temp:
            return greedy
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
                                 self._dev(starts), bool(temps.any()))

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device without a sync: staged through pinned
        memory on CUDA, so uploads queue behind the device work."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -------------------------------------------------------------- decode
    def _decode_window(self, active: list[int]):
        """K decode steps for the active slots; pages stay read-only during
        the window, new rows ride the tails and merge into the pages once
        at the end.  Returns the [K, B] token block on the device without
        waiting for it: nothing here reads a device value on the host."""
        cfg, K = self.cfg, self.steps_per_sync
        if self._table_dirty:
            self._table_dev = self._dev(self._table)
            self._table_dirty = False
        starts = np.zeros((self.max_batch,), np.int32)
        for i in active:
            starts[i] = len(self._slots[i].tokens)
        ts = self.cache["pos"]
        pages = {"k": self.cache["k"], "v": self.cache["v"]}
        tails = self._tails
        temps = self._dev(self._temps)
        seeds = self._dev(self._seeds)
        starts_d = self._dev(starts)
        any_temp = bool(self._temps.any())
        table = self._table_dev
        seq = torch.empty((K, self.max_batch), dtype=torch.int32,
                          device=self.device)
        pos, toks = ts, self._cur
        for j in range(K):
            logits, _ = llama.decode_step_paged(
                self.params, pages, tails, toks, pos, ts, j, table, cfg,
                rope=self._rope)
            toks = self._sample_rows(logits, temps, seeds, starts_d + j,
                                     any_temp)
            seq[j] = toks
            pos = pos + 1
        for li in range(cfg.n_layers):
            merge_tail_pages(pages["k"][li], tails["k"][li], table, ts, K)
            merge_tail_pages(pages["v"][li], tails["v"][li], table, ts, K)
        self.cache["pos"] = pos
        self._cur = toks
        return seq

    # ----------------------------------------------------------- admission
    def _reserve_blocks(self, req: _Request,
                        copies: list[tuple[int, int]]) -> bool:
        """Match the longest cached prefix, then allocate enough fresh
        blocks to cover the prompt plus one decode window (the full span
        when preemption is off).  Returns False with no net state change
        when the pool can't cover it."""
        mgr = self._mgr
        seq = req.prompt + req.tokens       # resume includes generated
        total = len(seq)
        remaining = req.max_new_tokens - len(req.tokens)
        matched = mgr.match(seq)
        matched_tokens = len(matched) * self.page
        cover = total + (min(remaining, self.steps_per_sync)
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
        brings their first tokens to the host."""
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
            # The block pool is the admission control: the FRONT request
            # blocks FIFO when free + evictable can't cover it.
            if not self._reserve_blocks(req, copies):
                break
            self._table[free, :] = 0
            self._table[free, :len(req.pages)] = req.pages
            self._table_dirty = True
            self._pending.popleft()
            self._slots[free] = req
            self._temps[free] = req.temperature
            self._seeds[free] = req.sample_seed
            wave.append((free, req))
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
            if any(r.prefill_from > 0 for _, r in chunk):
                nxt = self._prefill_chunk_suffix(chunk)
            else:
                nxt = self._prefill_chunk_full(chunk)
            pending_waves.append((chunk, nxt))
        for chunk, nxt in pending_waves:
            firsts = nxt.cpu().numpy()[:len(chunk)]
            now = time.perf_counter()
            for (slot, req), first in zip(chunk, firsts):
                if req.first_token_at is None:
                    req.first_token_at = now
                req.tokens.append(int(first))
                req.emit(int(first))
                if self._done(req):
                    self._finish(slot)

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
             "starts": np.zeros((padded_w,), np.int32)}
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
        for _, req in chunk:
            self.prefill_tokens += (len(req.prompt) + len(req.tokens)
                                    - req.prefill_from)
        return a, padded_w, bucket

    def _prefill_chunk_full(self, chunk):
        """Full-prompt prefill (no cached prefix in the chunk)."""
        a, W, bucket = self._wave_arrays(
            chunk, [len(r.prompt) + len(r.tokens) for _, r in chunk])
        hidden, ks, vs = llama.prefill(self.params, self._dev(a["tokens"]),
                                       self.cfg)
        rows_idx = self._dev(a["last"].astype(np.int64))
        last_h = hidden[torch.arange(W, device=self.device), rows_idx]
        nxt = self._first_token(last_h, a["temps"], a["seeds"], a["starts"])
        cols = np.arange(bucket) // self.page
        page_ids = self._table[a["slots"]][:, cols]
        rows = np.tile(np.arange(bucket, dtype=np.int32) % self.page, (W, 1))
        slots = self._dev(a["slots"].astype(np.int64))
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
            self._dev(table_rows))
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

    # -------------------------------------------------------------- finish
    def _done(self, req: _Request) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None
                    and req.tokens[-1] == req.eos_id))

    def _release_slot(self, slot: int, req: _Request) -> None:
        """Commit the request's computed full blocks into the prefix
        cache, then drop its references.  KV is valid only below
        prompt+tokens-1 (the newest token's K/V is not written yet)."""
        if not req.pages:
            return
        kv_valid = len(req.prompt) + len(req.tokens) - 1
        self._mgr.commit(req.prompt + req.tokens,
                         req.pages[:kv_valid // self.page])
        self._mgr.release(req.pages)
        req.pages = []
        # The freed slot's garbage decode writes go to the trash page once
        # the zeroed table row reaches the device.
        self._table[slot, :] = 0
        self._table_dirty = True

    def _finish(self, slot: int) -> None:
        req = self._slots[slot]
        self._slots[slot] = None
        self.completed += 1
        self._release_slot(slot, req)
        now = time.perf_counter()
        req.emit(None)
        if not req.future.done():
            req.future.set_result({
                "tokens": req.tokens,
                "ttft_s": (req.first_token_at or now) - req.submitted_at,
                "total_s": now - req.submitted_at,
            })

    def _preempt_slot(self, slot: int) -> None:
        """Evict a running request: its blocks go to the prefix cache and
        it re-enters the pending queue at the FRONT."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._seeds[slot] = 0
        self._release_slot(slot, req)
        self.preemptions += 1
        self._pending.appendleft(req)

    def _ensure_decode_blocks(self) -> list[int]:
        """Fund every active slot's next window of merge positions, oldest
        request first; when the pool runs dry the NEWEST active request
        is preempted.  Returns the surviving active slots."""
        k_win = self.steps_per_sync
        active = [i for i, s in enumerate(self._slots) if s is not None]
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
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001
            # Fail every in-flight and waiting request instead of letting
            # their futures hang, then re-raise.
            self._error = e
            self._drain_requests(e)
            self._stop.set()
            raise

    def _drain_requests(self, exc: BaseException) -> None:
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
            self._admit()
            active = self._ensure_decode_blocks()
            if not active:
                self._wake.wait(timeout=0.002 if self._pending else 0.05)
                self._wake.clear()
                continue
            seq = self._decode_window(active).cpu().numpy()   # ONE sync
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
        leaked or double-booked."""
        self._mgr.check()
        return {"ok": True, "free": self._mgr.free_count(),
                "available": self._mgr.available()}

    def stats(self) -> dict:
        kv = self._mgr.stats()
        return {"completed": self.completed,
                "active": sum(s is not None for s in self._slots),
                "waiting": self._waiting.qsize() + len(self._pending),
                "max_batch": self.max_batch,
                "max_len": self.max_len,
                "preemptions": self.preemptions,
                "prefill_tokens": self.prefill_tokens,
                "decode_tokens": self.decode_tokens,
                "prefix_cache": self._prefix_cache,
                "kv_preempt": self._preempt_on,
                "sync_window": self.steps_per_sync,
                "kv": kv,
                "prefix_hits": kv["hits"],
                "prefix_misses": kv["misses"],
                "prefix_hit_tokens": kv["hit_tokens"],
                "evictions": kv["evictions"],
                "cow_copies": kv["cow_copies"]}
