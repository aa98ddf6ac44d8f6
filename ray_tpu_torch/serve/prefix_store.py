"""The tier-2 prefix store of the port: the directory and the server-side
client of ray_tpu/serve/prefix_store.py, with the client's transport (the
put of demoted KV, the directory verbs, the pull of a stored prefix)
going through a ServeRuntime (serve/runtime.py).

  - **StoreDirectory**: hash -> entry index over published demoted
    subtrees.  Every chain hash of an entry indexes (leaf, depth), so a
    prompt matching part of a demoted path grafts a slice.  Entries carry
    the publisher's engine seed and weight version; lookup never returns
    a mismatched one (a weight swap invalidates, never corrupts).  A byte
    cap evicts the oldest-published first.
  - **PrefixStoreClient**: owns the refs of the objects its server
    published, publishes the engine's demoted subtrees (the engine's
    demotion callback) and runs the miss path: on a shallow local radix
    match it looks up the deepest stored prefix and, when the cost model
    approves, pulls it and grafts it into the engine's pool.

The engine's demoted KV is a CPU tensor [2, L, depth, kvh, page, hd]; a
stored payload may also be a numpy array (a JAX engine's demotion), which
the graft takes as it is.

Kill switch: RAY_TPU_PREFIX_STORE=0 (read per request) and the request
key {"prefix_store": false}.  Not ported: the reference's failpoint sites
and tracing spans on the publish, fetch and graft legs, and the
directory's controller-side views (`summary`, `replicas`,
`bytes_by_deployment`: the router's view, orphan checks and their gauge;
an app is dropped with `forget(app)`).
"""
from __future__ import annotations

import os
import threading
import time

from ray_tpu_torch.serve.kv_router import (matched_depth, prefix_store_on,
                                           prompt_hashes)
from ray_tpu_torch.serve.runtime import ServeRuntime

# Cost-model seed constants of the reference (env-tunable; a deployment
# overrides them through its `prefix_store` config dict): the fixed cost
# of one migration, the prefill time a grafted token avoids, and the
# pull's bandwidth.
_DEFAULT_MIGRATE_MS = 4.7
_DEFAULT_PREFILL_US_PER_TOKEN = 40.0
_DEFAULT_BW_GBPS = 2.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, ""))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def migration_worth_it(tokens_saved: int, nbytes: int,
                       config: dict | None = None) -> bool:
    """Graft only when the prefill time avoided beats the migration cost
    (fixed per-migration overhead + the object's bytes at pull
    bandwidth).  Config keys override the env knobs override the seed
    constants."""
    cfg = config or {}
    migrate_ms = cfg.get("migrate_ms", _env_float(
        "RAY_TPU_PREFIX_STORE_MIGRATE_MS", _DEFAULT_MIGRATE_MS))
    us_per_tok = cfg.get("prefill_us_per_token", _env_float(
        "RAY_TPU_PREFIX_STORE_PREFILL_US_PER_TOKEN",
        _DEFAULT_PREFILL_US_PER_TOKEN))
    bw_gbps = cfg.get("bw_gbps", _env_float(
        "RAY_TPU_PREFIX_STORE_BW_GBPS", _DEFAULT_BW_GBPS))
    benefit_ms = tokens_saved * us_per_tok / 1000.0
    cost_ms = migrate_ms + nbytes / max(bw_gbps, 1e-6) / 1e6
    return benefit_ms > cost_ms


class StoreDirectory:
    """Index of the demoted prefix objects of every app (on the serve
    controller, or handed to a PrefixStoreClient in process).  Entries are
    keyed by the demoted leaf's chained hash; the index maps every hash
    along the chain to (leaf, depth).  The byte budget
    (RAY_TPU_PREFIX_STORE_MAX_BYTES) evicts oldest-published first."""

    def __init__(self, max_bytes: int | None = None):
        self._lock = threading.Lock()
        self._max_bytes = max_bytes if max_bytes is not None else \
            _env_int("RAY_TPU_PREFIX_STORE_MAX_BYTES", 1 << 30)
        # app -> {"entries": {leaf: entry}, "index": {hash: (leaf, depth)}}
        self._apps: dict[str, dict] = {}
        self._bytes = 0
        self.published = 0
        self.evicted = 0
        self.forgotten = 0
        self.lookups = 0
        self.lookup_hits = 0

    # ------------------------------------------------------------ write
    def publish(self, app: str, meta: dict, ref) -> dict:
        """Register one demoted subtree (`meta`: chain hashes root..leaf,
        page, engine seed, weight version, bytes, publishing replica).
        Returns {"ok", "live"}: `ok` is False when the entry did not
        survive registration (the publisher must then keep its tier-1
        copy); `live` lists the replica's entries the directory still
        holds, so the publisher can drop refs of ones evicted since.
        `ref` may arrive nested in a one-element list."""
        if isinstance(ref, list):
            ref = ref[0]
        hashes = [int(h) for h in meta["hashes"]]
        if not hashes:
            return {"ok": False, "live": []}
        leaf = hashes[-1]
        entry = {
            "ref": ref,
            "hashes": hashes,
            "page": int(meta["page"]),
            "seed": meta.get("seed"),
            "weight_version": int(meta.get("weight_version", 0)),
            "nbytes": int(meta.get("nbytes", 0)),
            "replica": meta.get("replica"),
            "deployment": meta.get("deployment"),
            "t": time.monotonic(),
        }
        replica = meta.get("replica")
        with self._lock:
            if entry["nbytes"] > self._max_bytes:
                # An entry that can never fit must not evict siblings.
                a = self._apps.get(app)
                live = [h for h, e in (a["entries"].items() if a
                                       else ()) if e["replica"] == replica]
                return {"ok": False, "live": live}
            a = self._apps.setdefault(app, {"entries": {}, "index": {}})
            old = a["entries"].pop(leaf, None)
            if old is not None:
                self._bytes -= old["nbytes"]
            a["entries"][leaf] = entry
            self._bytes += entry["nbytes"]
            self._reindex_locked(a)
            self.published += 1
            self._evict_over_cap_locked()
            # The cap may have evicted the very entry being published.
            a = self._apps.get(app)
            ok = a is not None and a["entries"].get(leaf) is entry
            live = [h for h, e in (a["entries"].items() if a else ())
                    if e["replica"] == replica]
        return {"ok": ok, "live": live}

    def _reindex_locked(self, a: dict) -> None:
        idx: dict[int, tuple[int, int]] = {}
        for leaf, e in a["entries"].items():
            for i, h in enumerate(e["hashes"]):
                idx.setdefault(h, (leaf, i + 1))
        a["index"] = idx

    def _evict_over_cap_locked(self) -> None:
        while self._bytes > self._max_bytes:
            oldest = None
            for app, a in self._apps.items():
                for leaf, e in a["entries"].items():
                    if oldest is None or e["t"] < oldest[2]["t"]:
                        oldest = (app, leaf, e)
            if oldest is None:
                return
            app, leaf, e = oldest
            a = self._apps[app]
            del a["entries"][leaf]
            self._bytes -= e["nbytes"]
            self._reindex_locked(a)
            self.evicted += 1

    def forget(self, app: str, replica: str | None = None,
               below_version: int | None = None,
               hashes: list | None = None) -> int:
        """Drop entries by replica / weight-version bound / explicit leaf
        hashes.  Returns the number dropped."""
        drop_hashes = {int(h) for h in hashes} if hashes else None
        n = 0
        with self._lock:
            a = self._apps.get(app)
            if a is None:
                return 0
            for leaf, e in list(a["entries"].items()):
                if replica is not None and e["replica"] != replica:
                    continue
                if below_version is not None \
                        and e["weight_version"] >= below_version:
                    continue
                if drop_hashes is not None and leaf not in drop_hashes:
                    continue
                del a["entries"][leaf]
                self._bytes -= e["nbytes"]
                n += 1
            if n:
                self._reindex_locked(a)
                self.forgotten += n
            if not a["entries"]:
                self._apps.pop(app, None)
        return n

    def clear(self) -> None:
        """Drop every entry (serve shutdown: the directory holds borrowed
        refs that must not outlive it)."""
        with self._lock:
            self._apps.clear()
            self._bytes = 0

    # ------------------------------------------------------------- read
    def lookup(self, app: str, hashes: list, page: int, seed,
               weight_version: int | None = None,
               min_depth: int = 0) -> dict | None:
        """Deepest stored prefix of a prompt's hash chain, filtered by
        page / seed / weight_version (a mismatched entry is skipped, never
        returned).  Only a prefix strictly deeper than `min_depth` (the
        caller's local radix depth) is returned."""
        with self._lock:
            self.lookups += 1
            a = self._apps.get(app)
            if a is None:
                return None
            for i in range(len(hashes) - 1, min_depth - 1, -1):
                hit = a["index"].get(int(hashes[i]))
                if hit is None:
                    continue
                leaf, _d = hit
                e = a["entries"].get(leaf)
                if e is None:
                    continue
                if e["page"] != page:
                    continue
                if seed is not None and e["seed"] is not None \
                        and e["seed"] != seed:
                    continue
                if weight_version is not None \
                        and e["weight_version"] != weight_version:
                    continue
                self.lookup_hits += 1
                return {"ref": e["ref"], "depth": i + 1,
                        "entry_depth": len(e["hashes"]),
                        "nbytes": e["nbytes"], "hash": leaf,
                        "weight_version": e["weight_version"],
                        "replica": e["replica"]}
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "apps": len(self._apps),
                "entries": sum(len(a["entries"])
                               for a in self._apps.values()),
                "bytes": self._bytes,
                "published": self.published,
                "evicted": self.evicted,
                "forgotten": self.forgotten,
                "lookups": self.lookups,
                "lookup_hits": self.lookup_hits,
            }


class PrefixStoreClient:
    """Server-side half: publishes demoted subtrees and runs the miss-path
    fetch and graft.  Holds the ref of every object its server published;
    `close()` drops them all and tells the directory to forget, so tier 2
    never outlives the server (the kv_check leak contract).  Directory
    calls go to an injected StoreDirectory, or to the runtime
    controller's `prefix_store_<verb>` methods; with neither, publish
    returns False and the miss path finds nothing."""

    def __init__(self, *, app: str, deployment: str, replica_id: str,
                 seed, page: int, config: dict | None = None,
                 directory: StoreDirectory | None = None,
                 runtime: ServeRuntime | None = None):
        self._app = app or "default"
        self._deployment = deployment
        self._replica_id = replica_id
        self._seed = seed
        self._page = page
        self._cfg = dict(config or {})
        self._directory = directory
        self._runtime = runtime or ServeRuntime()
        self._lock = threading.Lock()
        # leaf hash -> (ref, weight_version, nbytes): the published refs.
        self._objects: dict[int, tuple] = {}
        # Graft coalescing: entry hash -> Event of the in-flight pull;
        # concurrent requests for one prefix wait for the leader's graft.
        self._graft_inflight: dict[int, threading.Event] = {}
        self._closed = False
        self.published = 0
        self.publish_bytes = 0
        self.fetches = 0
        self.fetch_bytes = 0
        self.grafts = 0
        self.graft_tokens = 0
        self.fallbacks = 0
        self.stale_rejected = 0
        self.lookup_misses = 0
        self.cost_skipped = 0

    # -------------------------------------------------------- transport
    def _call(self, verb: str, *args, timeout: float = 10.0,
              default=None, **kwargs):
        if self._directory is not None:
            return getattr(self._directory, verb)(*args, **kwargs)
        ctrl = self._runtime.controller()
        if ctrl is None:
            return default
        try:
            ref = getattr(ctrl, "prefix_store_" + verb).remote(
                *args, **kwargs)
            return self._runtime.get(ref, timeout=timeout)
        except Exception:  # noqa: BLE001 - controller restarting
            return default

    # ---------------------------------------------------------- publish
    def publish(self, entry: dict) -> bool:
        """Demotion callback (runs on the engine's export thread): put the
        subtree's host KV through the runtime and register it.  Returns
        True when tier 2 holds the entry, the engine's cue that evicting
        the tier-1 leaf loses nothing.  entry: {tokens, kv, hashes, depth,
        page, weight_version}."""
        if self._closed or not prefix_store_on():
            return False
        if self._directory is None and self._runtime.controller() is None:
            return False
        h = int(entry["hashes"][-1])
        version = int(entry.get("weight_version", 0))
        kv = entry["kv"]
        with self._lock:
            cur = self._objects.get(h)
        if cur is not None and cur[1] == version:
            # Already put under this version: reuse the object, but always
            # re-register (the directory's copy may be gone, and True on
            # the local copy alone would drop the last copy of the prefix).
            ref, nbytes = cur[0], cur[2]
        else:
            ref, nbytes = self._runtime.put(kv), int(kv.nbytes)
        meta = {"hashes": [int(x) for x in entry["hashes"]],
                "page": int(entry["page"]), "seed": self._seed,
                "weight_version": version, "nbytes": nbytes,
                "replica": self._replica_id,
                "deployment": self._deployment}
        # Nested, so an RPC hands the directory the ref, not its value.
        reply = self._call("publish", self._app, meta, [ref],
                           default=None)
        ok = bool(reply and reply.get("ok"))
        if not ok:
            del ref
            with self._lock:
                self._objects.pop(h, None)
            return False
        with self._lock:
            if self._closed:
                # Shutdown raced the publish: withdraw at once.
                self._objects.pop(h, None)
                ok = False
            else:
                if cur is None:
                    self.published += 1
                    self.publish_bytes += nbytes
                self._objects[h] = (ref, version, nbytes)
                # Drop the refs of entries the directory evicted or forgot
                # since the last publish.
                live = {int(x) for x in reply.get("live", ())}
                live.add(h)
                for stale in [k for k in self._objects
                              if k not in live]:
                    del self._objects[stale]
        if not ok:
            self._call("forget", self._app, hashes=[h], timeout=5.0)
        return bool(ok)

    # ------------------------------------------------------------ fetch
    def maybe_graft(self, engine, prompt: list, *,
                    salt: int = 0) -> dict:
        """The miss path (blocking; callers keep it off the event loop):
        compare the local radix match with the directory and, when the
        cost model approves, pull the stored prefix and graft it into the
        engine's pool.  Every failure degrades to a local prefill.  `salt`
        is the request's adapter KV identity: a stored prefix only ever
        serves the (adapter, version) that computed it."""
        out = {"grafted": 0}
        page = engine.page
        hashes = prompt_hashes(prompt, page, salt)
        if not hashes:
            return out
        local_summary = engine._mgr.prefix_summary()
        local = matched_depth(hashes, frozenset(local_summary["hashes"]))
        max_gain = (len(hashes) - local) * page
        min_tokens = int(self._cfg.get("min_tokens", page))
        # Skip the directory round trip when even a full-depth hit could
        # not beat the migration cost.
        if max_gain < min_tokens \
                or not migration_worth_it(max_gain, 0, self._cfg):
            return out
        entry = self._call("lookup", self._app, [int(h) for h in hashes],
                           page, self._seed, engine.weight_version,
                           min_depth=local, default=None)
        if not entry:
            self.lookup_misses += 1
            return out
        depth = int(entry["depth"])
        tokens_saved = (depth - local) * page
        if tokens_saved < min_tokens or not migration_worth_it(
                tokens_saved, int(entry.get("nbytes", 0)), self._cfg):
            self.cost_skipped += 1
            return out
        h = int(entry["hash"])
        with self._lock:
            leader = self._graft_inflight.get(h)
            if leader is None:
                self._graft_inflight[h] = threading.Event()
        if leader is not None:
            leader.wait(timeout=60.0)
            return {"grafted": 0, "reason": "coalesced"}
        pulled = False
        try:
            try:
                payload = entry["ref"]
                if self._runtime.is_ref(payload):
                    payload = self._runtime.get(payload, timeout=30.0)
                from ray_tpu_torch.models.convert import as_tensor

                blob = as_tensor(payload)
                pulled = True
                self.fetches += 1
                self.fetch_bytes += int(blob.nbytes)
                res = engine.kv_graft(
                    list(prompt[:depth * page]), blob[:, :, :depth],
                    kv_len=depth * page,
                    weight_version=entry.get("weight_version"),
                    salt=salt,
                ).result(timeout=60.0)
                del blob
            except Exception:  # noqa: BLE001 - degrade, never fail
                self.fallbacks += 1
                if not pulled:
                    # A failed pull is a dead publisher's signature: scrub
                    # the entry (a live publisher re-registers it).
                    self._call("forget", self._app,
                               hashes=[entry["hash"]], timeout=5.0)
                return out
        finally:
            with self._lock:
                ev = self._graft_inflight.pop(h, None)
            if ev is not None:
                ev.set()
        if res.get("grafted"):
            self.grafts += 1
            self.graft_tokens += tokens_saved
            return res
        if res.get("reason") == "stale_version":
            self.stale_rejected += 1
        else:
            self.fallbacks += 1
        return res

    # -------------------------------------------------------- lifecycle
    def invalidate(self, current_version: int) -> int:
        """Live weight swap: drop the refs of every entry published under
        an older weight version and tell the directory to forget them."""
        dropped = 0
        with self._lock:
            for h, (_ref, v, _nbytes) in list(self._objects.items()):
                if v < current_version:
                    del self._objects[h]
                    dropped += 1
        if dropped:
            self._call("forget", self._app, replica=self._replica_id,
                       below_version=current_version, timeout=5.0)
        return dropped

    def object_count(self) -> int:
        with self._lock:
            return len(self._objects)

    def close(self) -> None:
        """Server shutdown: drop every published object's ref and withdraw
        from the directory; demoted subtrees must not outlive the app."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            had = bool(self._objects)
            self._objects.clear()
        if had:
            self._call("forget", self._app, replica=self._replica_id,
                       timeout=5.0)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "objects": len(self._objects),
                "object_bytes": sum(o[2]
                                    for o in self._objects.values()),
                "published": self.published,
                "publish_bytes": self.publish_bytes,
                "fetches": self.fetches,
                "fetch_bytes": self.fetch_bytes,
                "grafts": self.grafts,
                "graft_tokens": self.graft_tokens,
                "fallbacks": self.fallbacks,
                "stale_rejected": self.stale_rejected,
                "lookup_misses": self.lookup_misses,
                "cost_skipped": self.cost_skipped,
            }
