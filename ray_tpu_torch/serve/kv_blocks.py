"""Paged KV-cache block manager: refcounted pool + radix prefix index.

A copy of ray_tpu/serve/kv_blocks.py (the port imports nothing of
ray_tpu); only its import of the hash helpers changed.

The host-side half of the serve engine's paged KV memory (the device
half — page pools, block-table indirection, tail merges — lives in
ops/paged_attention.py).  Three ideas, re-shaped for this engine:

  - **Refcounted blocks with copy-on-write** (vLLM's PagedAttention
    block tables, Kwon et al. 2023): a block is one device page of KV
    rows; any number of requests may READ a block, and a writer that
    does not hold the only reference gets a private copy first
    (`cow()`), so sealed KV content is immutable while shared — the
    same rule the object arena enforces for sealed objects.
  - **Radix prefix index** (SGLang's RadixAttention, Zheng et al.
    2024): finished requests commit their full blocks into a
    block-granular radix tree keyed on the page's token ids; a new
    request's longest cached prefix maps straight onto existing blocks
    and prefill runs only on the suffix.
  - **No implicit eviction of in-use blocks**: cached leaves are
    LRU-evicted ONLY at refcount 0 — a block some request still reads
    is never dropped, matching the arena's no-implicit-eviction
    invariant (spill, don't drop).  Eviction is leaf-first so the tree
    path above any referenced block stays matchable.

Every block id is exactly one of: on the FREE list, or MANAGED
(refcount > 0, cached in the tree, or both).  `check()` asserts this
partition — the allocator-hammer test calls it after every op.  Block
id 0 is the device trash page and is never managed here.

Pure host Python (no jax): unit-testable without a device, and every
decision (free-list order, LRU clock, eviction tie-breaks) is
deterministic so the engine's preemption behavior is replayable under
seeded tests.  Public methods lock internally: the engine loop owns all
mutations, but stats()/check() may be called from replica threads
(serve state API probes) while the tree is being rewritten.
"""
from __future__ import annotations

import functools
import threading

from ray_tpu_torch.serve.kv_router import (ROOT_HASH, chain_hash,
                                           summary_digest)


def _locked(fn):
    """Serialize a public method on the manager's RLock (reentrant:
    allocate → _evict_one → …, cow → allocate compose)."""
    @functools.wraps(fn)
    def inner(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return inner


class _Node:
    """One cached block: a radix-tree edge labeled by its page's token
    ids.  Children keyed by the next page's token tuple.  `hash` is the
    chained prefix hash (kv_router.chain_hash over the parent's hash +
    this page's token ids): membership of the hash alone proves the
    whole path root..node is cached — the unit the cluster router's
    prefix summaries are built from.

    Multi-LoRA keying: a non-zero `salt` (the adapter's identity salt,
    serve/lora.adapter_salt over (model_id, weight version)) prefixes
    the FIRST chunk's key, so one tree holds per-adapter subtrees whose
    chained hashes are automatically adapter-distinct — base and
    adapter KV for the same tokens never alias, and an adapter
    re-upload (new version → new salt) invalidates exactly its own
    entries by unreachability.  `toks` keeps the pure token tuple (the
    demotion path reassembles prompts from it — `key` may carry the
    salt prefix)."""

    __slots__ = ("key", "block", "parent", "children", "last_used",
                 "hash", "toks", "salt")

    def __init__(self, key: tuple | None, block: int,
                 parent: "_Node | None", *, toks: tuple | None = None,
                 salt: int = 0):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.last_used = 0
        self.toks = toks if toks is not None else key
        self.salt = salt
        self.hash = ROOT_HASH if parent is None \
            else chain_hash(parent.hash, key)


class BlockManager:
    """Host-side allocator + prefix index over `n_blocks` device pages
    of `page` tokens each (ids 1..n_blocks; id 0 = trash page)."""

    def __init__(self, n_blocks: int, page: int, *,
                 prefix_cache: bool = True):
        if n_blocks < 1:
            raise ValueError(f"need at least 1 block, got {n_blocks}")
        if page < 1:
            raise ValueError(f"page must be >= 1, got {page}")
        self.n_blocks = n_blocks
        self.page = page
        self.prefix_cache = prefix_cache
        # Guards every public method: mutations all come from the
        # engine loop, but stats()/check() arrive from replica threads.
        self._lock = threading.RLock()
        # pop() hands out 1, 2, ... in order — deterministic for tests.
        self._free = list(range(n_blocks, 0, -1))
        self._ref = [0] * (n_blocks + 1)
        self._root = _Node(None, 0, None)
        self._node_of: dict[int, _Node] = {}     # block id -> cached node
        self._clock = 0                          # logical LRU clock
        # Observability (exported via LLMEngine.stats() and the
        # Prometheus gauges in serve/llm.py).
        self.hits = 0            # match() calls that found >= 1 block
        self.misses = 0          # match() calls with chunks but no hit
        self.hit_tokens = 0      # prompt tokens served from cache
        self.evictions = 0
        self.cow_copies = 0
        self.demotions = 0       # blocks released to tier 2 (prefix store)
        # Leaf blocks with a demotion in flight (scan → export-thread
        # publish → finish): pinned via refcount, excluded from rescans.
        self._demoting: set[int] = set()
        # Memoized prefix_summary (stats() embeds it on every metrics
        # poll): rebuilt only when the cached SET changes (commit /
        # evict) — LRU-clock touches may reorder an over-cap subset,
        # which is acceptable staleness for an advisory summary.
        self._summary_cache: tuple[int, dict] | None = None

    # ------------------------------------------------------------ helpers
    def _chunks(self, tokens) -> list[tuple]:
        n = len(tokens) // self.page
        p = self.page
        return [tuple(tokens[i * p:(i + 1) * p]) for i in range(n)]

    @staticmethod
    def _keys(chunks: list[tuple], salt: int) -> list[tuple]:
        """Radix keys for a chunk list: a non-zero adapter salt
        prefixes the FIRST chunk's key (see _Node), branching the tree
        per adapter right at the root."""
        if not salt or not chunks:
            return chunks
        return [(salt,) + chunks[0]] + chunks[1:]

    @_locked
    def free_count(self) -> int:
        return len(self._free)

    @_locked
    def cached_count(self) -> int:
        return len(self._node_of)

    @_locked
    def evictable_count(self) -> int:
        """Blocks reclaimable without touching any in-use block: cached
        subtrees whose every node has refcount 0 (leaf-first eviction
        can drain exactly these)."""
        def count(node: _Node) -> tuple[int, bool]:
            total, all_free = 0, True
            for child in node.children.values():
                sub, sub_free = count(child)
                total += sub
                all_free &= sub_free
            if node is self._root:
                return total, all_free
            if all_free and self._ref[node.block] == 0:
                return total + 1, True
            return total, False

        return count(self._root)[0]

    @_locked
    def available(self) -> int:
        """Free + evictable: the admission budget the scheduler checks."""
        return len(self._free) + self.evictable_count()

    # ---------------------------------------------------------- allocate
    @_locked
    def allocate(self, n: int, *, evict: bool = True) -> list[int] | None:
        """Take `n` blocks (refcount 1 each), LRU-evicting cached
        refcount-0 leaves as needed.  Returns None (no partial effect)
        when free + evictable can't cover the request — in-use blocks
        are NEVER reclaimed; that decision (preempt) belongs to the
        scheduler, not the allocator."""
        if n <= 0:
            return []
        if len(self._free) < n:
            # Only consult the (tree-walk) evictable count when the
            # free list alone can't cover it — allocate() sits on the
            # decode hot loop and host Python is the scarce resource.
            budget = len(self._free) + (self.evictable_count()
                                        if evict else 0)
            if budget < n:
                return None
        out = []
        for _ in range(n):
            if not self._free:
                self._evict_one()
            b = self._free.pop()
            self._ref[b] = 1
            out.append(b)
        return out

    def _evict_one(self) -> None:
        """Drop the least-recently-used refcount-0 leaf."""
        victim = None
        for node in self._node_of.values():
            if node.children or self._ref[node.block] != 0:
                continue
            if victim is None or ((node.last_used, node.block)
                                  < (victim.last_used, victim.block)):
                victim = node
        if victim is None:                      # caller checked budget
            raise RuntimeError("no evictable block (allocator bug)")
        del victim.parent.children[victim.key]
        del self._node_of[victim.block]
        self._free.append(victim.block)
        self.evictions += 1
        self._summary_cache = None

    # --------------------------------------------------------- refcounts
    @_locked
    def retain(self, blocks: list[int]) -> None:
        for b in blocks:
            if self._ref[b] == 0 and b not in self._node_of:
                raise ValueError(f"retain of free block {b}")
            self._ref[b] += 1

    @_locked
    def release(self, blocks: list[int]) -> None:
        """Drop one reference per block.  A block at refcount 0 returns
        to the free list unless the radix tree caches it (then it stays
        resident but evictable — the prefix cache's whole point)."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0 and b not in self._node_of:
                self._free.append(b)

    @_locked
    def cow(self, b: int) -> tuple[int, bool]:
        """Writable version of block `b` for a caller holding one ref.

        Exclusive private block: returned as-is.  Shared (refcount > 1)
        or cached (tree-resident — sealed content other requests may
        match): allocate a fresh block, move the caller's ref onto it,
        and return (new_id, True) — the caller must device-copy the
        page before writing.  Returns (-1, False) when the pool can't
        supply the copy (caller backs off / preempts)."""
        if self._ref[b] == 1 and b not in self._node_of:
            return b, False
        nb = self.allocate(1)
        if nb is None:
            return -1, False
        self.release([b])
        self.cow_copies += 1
        return nb[0], True

    # ------------------------------------------------------------- radix
    @_locked
    def match(self, tokens, *, salt: int = 0) -> list[int]:
        """Longest cached prefix of `tokens` at block granularity.
        Takes one reference on every matched block (caller releases on
        finish/preempt) and touches the path's LRU clocks.  `salt`
        scopes the walk to one adapter's subtree (0 = base model)."""
        if not self.prefix_cache:
            return []
        chunks = self._chunks(tokens)
        node, out = self._root, []
        self._clock += 1
        for key in self._keys(chunks, salt):
            child = node.children.get(key)
            if child is None:
                break
            self._ref[child.block] += 1
            child.last_used = self._clock
            out.append(child.block)
            node = child
        if chunks:
            if out:
                self.hits += 1
                self.hit_tokens += len(out) * self.page
            else:
                self.misses += 1
        return out

    @_locked
    def commit(self, tokens, blocks: list[int], *, salt: int = 0) -> None:
        """Register a request's computed full blocks in the radix tree
        (called at finish/preempt, BEFORE release, so the blocks become
        cached rather than freed).  blocks[i] holds the KV of token
        chunk i; only chunks fully covered by both `tokens` and
        `blocks` are committed.  A chunk already in the tree keeps its
        existing block (ours stays private and frees on release) —
        first writer wins, duplicates never alias.  `salt` files the
        path under the adapter's subtree (0 = base model); KV computed
        under an adapter must never serve a base-model match."""
        if not self.prefix_cache:
            return
        chunks = self._chunks(tokens)[:len(blocks)]
        node = self._root
        self._clock += 1
        for i, key in enumerate(self._keys(chunks, salt)):
            child = node.children.get(key)
            if child is None:
                if blocks[i] in self._node_of:
                    # Same block under a different path would alias one
                    # page into two tree positions; stop committing.
                    break
                child = _Node(key, blocks[i], node, toks=chunks[i],
                              salt=salt)
                node.children[key] = child
                self._node_of[blocks[i]] = child
                self._summary_cache = None
            child.last_used = self._clock
            node = child

    @_locked
    def flush(self) -> int:
        """Invalidate the ENTIRE prefix cache (the live weight-sync
        hook: every cached page holds KV computed under the OLD policy
        — matching it after a param swap would silently attend stale
        values).  Refcount-0 cached blocks return to the free list;
        still-referenced blocks are merely un-cached — their in-flight
        readers finish under the documented staleness and the block
        frees on its last release.  Returns the number of nodes
        dropped."""
        n = len(self._node_of)
        for b in self._node_of:
            if self._ref[b] == 0:
                self._free.append(b)
        self._node_of.clear()
        self._root = _Node(None, 0, None)
        self._summary_cache = None
        return n

    # ----------------------------------------------------------- cluster
    @_locked
    def demote_scan(self, *, limit: int = 2, min_idle: int = 0,
                    watermark: int = 0, exclude=()) -> list[dict]:
        """Pick cold refcount-0 LEAVES whose subtree KV should demote
        to the tier-2 prefix store (serve/prefix_store.py).  A leaf is
        cold when its LRU clock is `min_idle` ticks stale — or, under
        pool pressure (free < `watermark`), immediately: demoting the
        next eviction victim saves its KV where plain eviction would
        destroy it.  Every candidate's WHOLE path root..leaf is pinned
        (one extra ref per block) so the exporter may gather the pages
        while serving continues; the caller MUST demote_finish() each
        candidate exactly once.  `exclude` holds leaf hashes the caller
        already knows the store won't take (publish declined) — skipped
        so a disabled store doesn't re-gather the same leaves forever.
        Coldest-first, deterministic (LRU clock, then block id)."""
        pressure = len(self._free) < watermark
        cands = []
        for node in self._node_of.values():
            if node.children or self._ref[node.block] != 0:
                continue
            if node.block in self._demoting or node.hash in exclude:
                continue
            if not pressure and self._clock - node.last_used < min_idle:
                continue
            cands.append(node)
        cands.sort(key=lambda n: (n.last_used, n.block))
        out = []
        for node in cands[:limit]:
            path = []
            cur = node
            while cur is not self._root:
                path.append(cur)
                cur = cur.parent
            path.reverse()
            blocks, tokens, hashes = [], [], []
            for nd in path:
                blocks.append(nd.block)
                tokens.extend(nd.toks)
                hashes.append(nd.hash)
            self.retain(blocks)
            self._demoting.add(node.block)
            out.append({"leaf": node.block, "blocks": blocks,
                        "tokens": tokens, "hashes": hashes,
                        "hash": node.hash, "depth": len(blocks),
                        "salt": node.salt})
        return out

    @_locked
    def demote_finish(self, leaf: int, blocks: list[int], *,
                      drop: bool) -> int:
        """Complete one demotion: release the scan's pins and — when
        the store took the entry (`drop`) — evict the maximal cold
        suffix of the path: the leaf plus every ancestor left
        childless at refcount 0 (exactly the blocks the sealed entry
        covers; hotter ancestors, referenced blocks and nodes that
        grew children mid-demotion stay in tier 1).  Returns the number
        of blocks freed.  Safe from any thread (the export thread calls
        it); a weight-swap flush mid-demotion leaves nothing to drop —
        release() already freed the pinned blocks the flush un-cached."""
        self._demoting.discard(leaf)
        self.release(blocks)
        if not drop:
            return 0
        node = self._node_of.get(leaf)
        freed = 0
        while (node is not None and node is not self._root
               and not node.children and self._ref[node.block] == 0):
            parent = node.parent
            del parent.children[node.key]
            del self._node_of[node.block]
            self._free.append(node.block)
            self.demotions += 1
            freed += 1
            self._summary_cache = None
            node = parent
        return freed

    @_locked
    def export_blocks(self, pages: list[int], n_valid_tokens: int,
                      ) -> list[int]:
        """Pin the blocks covering the first `n_valid_tokens` positions
        for a KV export: takes one extra reference on each covered
        block so the exporter may read their device pages while the
        owning request independently commits/releases, and returns the
        covered ids in table order.  Caller MUST release() them once
        the copy is sealed (the serve migration path — see
        LLMEngine.kv_export)."""
        n = -(-n_valid_tokens // self.page)
        if n > len(pages):
            raise ValueError(
                f"export of {n_valid_tokens} tokens needs {n} blocks "
                f"but the request holds {len(pages)}")
        blocks = list(pages[:n])
        self.retain(blocks)
        return blocks

    @_locked
    def prefix_summary(self, cap: int = 2048) -> dict:
        """Compact description of the cached radix tree for the cluster
        router: the chained prefix hashes of (up to `cap`, newest-LRU
        first) cached nodes plus an order-independent XOR digest.  A
        router holding this set can compute a prompt's matched-prefix
        depth without talking to the replica (kv_router.matched_depth).
        The digest changes whenever the cached set changes — the cheap
        'did serving alter the cache' probe the state API exposes.
        Memoized until commit/evict alters the set (every metrics poll
        embeds this; rebuilding per poll would tax the legacy metrics
        path even with the router switched off)."""
        if self._summary_cache is not None \
                and self._summary_cache[0] == cap:
            return self._summary_cache[1]
        nodes = self._node_of.values()
        if len(nodes) > cap:
            nodes = sorted(nodes, key=lambda n: (-n.last_used, n.block))
            nodes = nodes[:cap]
        hashes = [n.hash for n in nodes]
        # Only set-derived fields belong here: anything tracking the
        # free list would go stale under the memoization.
        out = {"page": self.page, "hashes": hashes,
               "digest": summary_digest(hashes),
               "cached": len(self._node_of)}
        self._summary_cache = (cap, out)
        return out

    # ------------------------------------------------------------ checks
    @_locked
    def check(self) -> None:
        """Assert the block-state partition (test hook): every id is
        exactly one of free / managed; refcounts non-negative; the tree
        and _node_of agree."""
        if len(set(self._free)) != len(self._free):
            raise AssertionError("duplicate ids on the free list")
        seen = set()
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.block in seen:
                raise AssertionError(f"block {node.block} twice in tree")
            seen.add(node.block)
            if self._node_of.get(node.block) is not node:
                raise AssertionError(f"_node_of stale for {node.block}")
            stack.extend(node.children.values())
        if seen != set(self._node_of):
            raise AssertionError("_node_of does not match the tree")
        for b in range(1, self.n_blocks + 1):
            free = b in self._free and self._free.count(b) == 1
            managed = self._ref[b] > 0 or b in self._node_of
            if self._ref[b] < 0:
                raise AssertionError(f"negative refcount on {b}")
            if free == managed:
                raise AssertionError(
                    f"block {b}: free={free} managed={managed} "
                    f"(ref={self._ref[b]}, cached={b in self._node_of})")

    @_locked
    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "page": self.page,
            "free": len(self._free),
            "cached": len(self._node_of),
            "evictable": self.evictable_count(),
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "evictions": self.evictions,
            "cow_copies": self.cow_copies,
            "demotions": self.demotions,
            # The cluster router's view of this cache (compiled by the
            # DeploymentHandle via controller replica_metrics).
            "prefix_summary": self.prefix_summary(),
        }
