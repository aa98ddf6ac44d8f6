"""Cluster memory observability: per-process object ledger.

Analog of the reference's `ray memory` / `ray summary objects` pipeline
(ray: CoreWorker::ReferenceCounter callsite tracking, python/ray/util/
state/memory_utils.py) collapsed into the repo's verb/facade shape: the
owner-side reference table (worker.py `owned` / `borrows`) is already
the single source of truth for who owns what — this module adds the
cheap per-object annotations the tables don't carry (creation callsite,
semantic tag, creation time), serves the `memory` RPC verb body shared
by worker/agent/controller handlers (the `spans`/`failpoints` shape),
and houses the leak-sentinel scan the node agent runs against its
arena's pid-attributed pin table.

Design contract (the flight-recorder cost rules):

- **Always on** (kill switch ``RAY_TPU_TORCH_MEMORY_LEDGER=0``): every
  annotation site is ``if memledger.ENABLED: ...`` — one module-flag
  truth test when disabled.  The kill switch gates only the
  annotations; `collect()` still reports the owner tables (sizes,
  refcounts, locations), just untagged — harvest correctness never
  depends on the switch.
- **Lock-free note**: `_meta` is a plain dict keyed by object id;
  note/free are single GIL-atomic dict ops (put_object already holds
  the worker's _ref_lock at the creation site, but the ledger must
  also be safe from ObjectRef.__del__ on arbitrary GC threads).
- **Tags ride a contextvar**: library layers wrap their object
  creations in ``memledger.tag("kv_export", label=...)`` (through the
  public ``ray_tpu_torch.memledger`` facade) so `ray_tpu_torch.put` needs no new
  parameters and untagged puts stay zero-cost.

Tag vocabulary (extensible; these are what the serve/collective layers
stamp today): ``put`` (default), ``task_return``, ``kv_export``,
``prefix_tier2``, ``collective_chunk``, ``checkpoint``.
"""
from __future__ import annotations

import contextvars
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Callable

ENV_VAR = "RAY_TPU_TORCH_MEMORY_LEDGER"


def _env_on() -> bool:
    v = os.environ.get(ENV_VAR)
    if v is None:
        return True
    return v not in ("0", "false", "False", "")


# Module flag read by every annotation site (the failpoints ACTIVE
# discipline): True unless RAY_TPU_TORCH_MEMORY_LEDGER=0.
ENABLED = _env_on()

_pid = os.getpid()
# Process identity for harvest dedup (the spans-verb convention): bare
# pids collide across hosts, boot tokens never do.
_boot = f"{_pid:x}-{time.time_ns():x}"
# object id -> (tag, callsite, created_at wall time)
_meta: dict[bytes, tuple] = {}
# Monotonic annotation count (racy += is fine, stats only): the
# kill-switch proof — `tracked` nets to zero when refs free as fast as
# they are created, this never does.
_noted = 0
# Extra collect-time rows from subsystems whose memory is not
# object-plane objects (the serve engine's HBM KV pool): name -> fn
# returning a list of row dicts ({"object_id","size","tag","tier",...}).
_providers: dict[str, Callable[[], list]] = {}
# Active (tag, label) for object creations in this context; see tag().
_tag_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "raytpu_torch_mem_tag", default=None)
# Count of OPEN tag() contexts process-wide: the put hot path skips the
# contextvar read entirely while no tag is active anywhere (the common
# case; racy +=/-= is fine — a stale read just takes the slow branch).
_tags_open = 0

# Reply size bound: a data workload can own 100k+ objects; the verb
# reply keeps the biggest `limit` rows and reports how many it dropped.
DEFAULT_LIMIT = 5000


def set_enabled(on: bool) -> None:
    """Flip the ledger and mirror the choice into os.environ so
    processes spawned from here inherit it (same-run A/B: the bench
    runs one put/get leg with the ledger on, one with it off)."""
    global ENABLED
    ENABLED = bool(on)
    os.environ[ENV_VAR] = "1" if on else "0"


@contextmanager
def tag(tag_name: str, label: str | None = None):
    """Stamp every object created in this context with `tag_name`
    (and, when given, `label` as its callsite — library layers pass a
    semantic site like "serve/llm.py kv_export" so the grouped table
    reads by meaning, not by the facade's internal frame)."""
    global _tags_open
    token = _tag_ctx.set((tag_name, label))
    _tags_open += 1
    try:
        yield
    finally:
        _tags_open -= 1
        _tag_ctx.reset(token)


_PRIV_DIR = os.sep + "_private" + os.sep
_API_SUFFIX = os.path.join("ray_tpu_torch", "api.py")
# (code object id, lineno) -> formatted site: a put loop hits ONE site
# thousands of times — format it once.  Companion cache classifies code
# objects as runtime-internal, replacing two string scans per frame hop
# with one dict hit (the walk sits on the put hot path; the string work
# was the measurable part of the ledger's overhead).
_site_cache: dict[tuple, str] = {}
_internal_code: dict[int, bool] = {}


def _is_internal(code) -> bool:
    k = id(code)
    v = _internal_code.get(k)
    if v is None:
        fn = code.co_filename
        v = _PRIV_DIR in fn or fn.endswith(_API_SUFFIX)
        if len(_internal_code) < 8192:
            _internal_code[k] = v
    return v


def _raw_site(depth: int = 2):
    """The creating USER/library frame as a raw (code, lineno) pair —
    the put-hot-path half of callsite capture: walk out of the runtime
    internals (worker.py, api.py) and stop.  Formatting is deferred to
    harvest time (_fmt_site); the string work measurably dominated the
    ledger's put overhead."""
    try:
        f = sys._getframe(depth)
    except ValueError:
        return "?"
    hops = 0
    while f is not None and hops < 24 and _is_internal(f.f_code):
        f = f.f_back
        hops += 1
    if f is None:
        return "?"
    return (f.f_code, f.f_lineno)


def _fmt_site(cs) -> str:
    """Format a stored callsite: strings pass through (explicit labels,
    "(task) fn" sites); raw (code, lineno) pairs become
    "pkg/file.py:line fn", cached per site."""
    if type(cs) is str:
        return cs
    code, lineno = cs
    key = (code, lineno)
    site = _site_cache.get(key)
    if site is None:
        parts = code.co_filename.split(os.sep)
        site = (f"{os.sep.join(parts[-2:])}:{lineno} "
                f"{code.co_name}")
        if len(_site_cache) < 4096:
            _site_cache[key] = site
    return site


def note_create(oid: bytes, tag_name: str | None = None,
                callsite: str | None = None) -> None:
    """Annotate one owned-object creation.  Explicit args beat the
    contextvar; with neither, the tag is "put" and the callsite is
    walked from the stack."""
    if not ENABLED:
        return
    ctx = _tag_ctx.get() if _tags_open else None
    if tag_name is None:
        tag_name = ctx[0] if ctx else "put"
    if callsite is None:
        # depth 2 = note_create's caller; runtime frames (worker.py,
        # api.py) are walked out inside _raw_site.
        callsite = (ctx[1] if ctx and ctx[1] else _raw_site(2))
    global _noted
    _noted += 1
    _meta[oid] = (tag_name, callsite, time.time())


def note_put(oid: bytes) -> None:
    """Specialized note_create for the put hot path (worker.put_object
    calls this once per put): no optional-argument branching; the tag
    contextvar is consulted only while some tag() context is open."""
    global _noted
    _noted += 1
    if _tags_open:
        ctx = _tag_ctx.get()
        if ctx is not None:
            _meta[oid] = (ctx[0], ctx[1] or _raw_site(2), time.time())
            return
    _meta[oid] = ("put", _raw_site(2), time.time())


def note_free(oid: bytes) -> None:
    _meta.pop(oid, None)


def register_provider(name: str, fn: Callable[[], list]) -> None:
    """Attach collect-time rows for memory that is not an object-plane
    object (e.g. an engine's resident HBM KV pool).  `fn` returns row
    dicts; it runs on the harvest path only and its failures are
    swallowed per provider."""
    _providers[name] = fn


def unregister_provider(name: str) -> None:
    _providers.pop(name, None)


def _proc_label() -> str:
    from ray_tpu_torch._private import spans

    return spans.proc_label()


def stats() -> dict:
    return {"enabled": ENABLED, "tracked": len(_meta), "noted": _noted,
            "providers": sorted(_providers)}


def collect(limit: int = DEFAULT_LIMIT) -> dict:
    """The `memory` verb's local reply: this process's owner-side
    reference table joined with the ledger annotations, its borrower
    table, and any provider rows.  Works in every process — one
    without a CoreWorker (agent/controller) just reports no objects."""
    out: dict[str, Any] = {"pid": _pid, "boot": _boot,
                           "proc": _proc_label(), "node": "",
                           "addr": "", "objects": [], "borrows": [],
                           "provider_rows": [], "truncated": 0,
                           **stats()}
    try:
        from ray_tpu_torch._private.worker import _global_worker

        w = _global_worker
    except Exception:  # noqa: BLE001 - no runtime in this process
        w = None
    now = time.time()
    if w is not None and not w._shutdown.is_set():
        out["node"] = w.node_id
        # set on the IO loop after server start — absent very early
        out["addr"] = getattr(w, "address", "")
        with w._ref_lock:
            owned = [(oid, rec.size, rec.state, list(rec.locations),
                      rec.local_refs, rec.borrowers, len(rec.contained))
                     for oid, rec in w.owned.items()]
            borrows = [(oid, e.get("count", 0), e.get("owner", ""))
                       for oid, e in w.borrows.items()]
        if len(owned) > limit:
            # Keep the biggest rows — they are the ones a memory hunt
            # is after — and say how many were dropped (no silent cap).
            owned.sort(key=lambda t: -t[1])
            out["truncated"] = len(owned) - limit
            owned = owned[:limit]
        rows = []
        for oid, size, state, locations, lrefs, nborrow, ncont in owned:
            m = _meta.get(oid)
            rows.append({
                "object_id": oid.hex(), "size": size, "state": state,
                "locations": locations, "local_refs": lrefs,
                "borrowers": nborrow, "contained": ncont,
                "tag": m[0] if m else "untracked",
                "callsite": _fmt_site(m[1]) if m else "?",
                "age_s": round(now - m[2], 3) if m else None})
        out["objects"] = rows
        out["borrows"] = [{"object_id": oid.hex(), "count": c,
                           "owner": owner}
                          for oid, c, owner in borrows]
    for name, fn in list(_providers.items()):
        try:
            for row in fn() or ():
                out["provider_rows"].append({"provider": name, **row})
        except Exception:  # noqa: BLE001 - a broken provider must not
            pass           # poison the whole harvest

    return out


def control(h: dict) -> dict:
    """The `memory` RPC verb body, shared by worker/agent/controller
    handlers.  ops: collect (default; optional `limit`), stats,
    enable (flip the ledger live — same-run A/B)."""
    op = h.get("op", "collect")
    if op == "collect":
        return collect(limit=int(h.get("limit") or DEFAULT_LIMIT))
    if op == "stats":
        return {"pid": _pid, "boot": _boot, "proc": _proc_label(),
                **stats()}
    if op == "enable":
        set_enabled(bool(h.get("on", True)))
        return {"pid": _pid, "boot": _boot, "proc": _proc_label(),
                **stats()}
    raise ValueError(f"memory verb: unknown op {op!r}")


# ------------------------------------------------------- leak sentinel
def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True        # exists, just not ours


def sentinel_scan(backend) -> dict:
    """One leak-sentinel pass over a node store backend: cross-reference
    the arena's pid-attributed read pins against live pids, and
    creating-state blocks against their creators.  Pure report — the
    agent's existing sweep_dead (which runs AFTER this in the reaper
    cycle) does the reclaiming, so a flagged orphan pin is gone by the
    next scan and the gauge returns to zero.

    Dead-pid checks are local-host truth (pins are taken by same-host
    mappers only), so this leg can never false-positive: a pin whose
    holder no longer exists is orphaned by definition.  Owner
    reachability for sealed objects needs the cluster-wide owner
    tables and is computed at harvest time instead
    (utils/state.summarize_objects)."""
    out = {"t": time.time(), "objects": 0, "pinned_objects": 0,
           "arena_orphan_pins": 0, "arena_orphan_pin_bytes": 0,
           "orphan_pin_pids": [], "creating_dead_creator": 0,
           "creating_dead_creator_bytes": 0, "supported": False}
    scan = getattr(backend, "scan_objects", None)
    if scan is None:
        return out
    try:
        objs = scan()
        pins = getattr(backend, "scan_pins", lambda: [])()
    except Exception:  # noqa: BLE001 - racing backend teardown
        return out
    out["supported"] = True
    sizes: dict[bytes, int] = {}
    for o in objs:
        sizes[o["object_id"]] = o["size"]
        if o["pins"]:
            out["pinned_objects"] += 1
        if not o["sealed"] and not _pid_alive(o["creator_pid"]):
            # A crash between alloc and seal (the arena.alloc/copy
            # failpoint windows): only the dead-pid sweep can reclaim
            # this block — flag it first.
            out["creating_dead_creator"] += 1
            out["creating_dead_creator_bytes"] += o["size"]
    out["objects"] = len(objs)
    dead_pids: dict[int, bool] = {}
    for oid, pid in pins:
        dead = dead_pids.get(pid)
        if dead is None:
            dead = dead_pids[pid] = not _pid_alive(pid)
        if dead:
            out["arena_orphan_pins"] += 1
            out["arena_orphan_pin_bytes"] += sizes.get(oid, 0)
            if pid not in out["orphan_pin_pids"]:
                out["orphan_pin_pids"].append(pid)
    return out


def _after_fork_child() -> None:
    # Annotations and providers belong to the parent; the child owns
    # nothing yet and registers its own.
    global _pid, _boot, _noted
    _pid = os.getpid()
    _boot = f"{_pid:x}-{time.time_ns():x}"
    _noted = 0
    _meta.clear()
    _providers.clear()


os.register_at_fork(after_in_child=_after_fork_child)
