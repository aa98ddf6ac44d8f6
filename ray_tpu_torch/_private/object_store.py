"""Object storage: per-node store + per-worker in-process memory store.

Analog of the reference's two-tier object storage:
  - small objects live in the owner's in-process memory store and travel
    inline in RPC replies (ray: CoreWorkerMemoryStore memory_store.h:43,
    max_direct_call_object_size)
  - large objects live in a per-node store served by the node agent, located
    via the owner, and pulled node-to-node in chunks
    (ray: plasma store store_runner.h:14 + ObjectManager::Push
    object_manager.cc:339, 64MB chunks)

The node store backend here is the dict backend: the agent holds each
object's frames in its own memory, and workers put and get them over RPC.
The reference's shared-memory arena (`native/store.cc`) is a later slice
of the port (ROADMAP.md queue 1, "the native arena and the zygote").
"""
from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger(__name__)


@dataclass
class MemoryEntry:
    event: asyncio.Event
    # Exactly one of (value-present, frames, error, locations) materializes.
    has_value: bool = False
    value: Any = None
    frames: list[bytes] | None = None
    error: BaseException | None = None
    locations: list[str] = field(default_factory=list)  # node agent addrs
    # Lazily-attached wakeup for SYNC getters waiting off the IO loop
    # (worker.py _get_objects_fast): fill sites publish fields, then
    # wake() both waiter kinds.  Plain threading.Event — safe to set
    # from the loop thread, waitable from any.
    t_event: "Any" = None

    def resolved(self) -> bool:
        return (self.has_value or self.error is not None
                or self.frames is not None or bool(self.locations))

    def wake(self) -> None:
        self.event.set()
        t = self.t_event
        if t is not None:
            t.set()


class MemoryStore:
    """In-process store of object id -> resolved value/frames/locations.

    Futures-based: getters wait on the entry's event until the task that
    produces the object completes (ray: GetRequest in memory_store.cc).
    Entry creation is thread-safe: the IO loop and sync caller threads
    (put/get fast paths) both materialize entries.
    """

    def __init__(self) -> None:
        import threading

        self._entries: dict[bytes, MemoryEntry] = {}
        self._lock = threading.Lock()

    def entry(self, object_id: bytes) -> MemoryEntry:
        e = self._entries.get(object_id)
        if e is None:
            with self._lock:
                e = self._entries.get(object_id)
                if e is None:
                    e = MemoryEntry(event=asyncio.Event())
                    self._entries[object_id] = e
        return e

    def get_if_exists(self, object_id: bytes) -> MemoryEntry | None:
        return self._entries.get(object_id)

    def reset(self, object_id: bytes) -> MemoryEntry:
        """Clear an entry for re-resolution (lineage reconstruction)
        WITHOUT replacing the object: existing waiters keep their
        reference and wake on the refill."""
        e = self.entry(object_id)
        e.has_value, e.value, e.frames, e.error = False, None, None, None
        e.locations = []
        e.event.clear()
        if e.t_event is not None:
            e.t_event.clear()
        return e

    def put_value(self, object_id: bytes, value: Any) -> None:
        e = self.entry(object_id)
        e.has_value = True
        e.value = value
        e.wake()

    def put_frames(self, object_id: bytes, frames: list[bytes]) -> None:
        e = self.entry(object_id)
        e.frames = frames
        e.wake()

    def put_error(self, object_id: bytes, err: BaseException) -> None:
        e = self.entry(object_id)
        e.error = err
        e.wake()

    def put_locations(self, object_id: bytes, locations: list[str]) -> None:
        e = self.entry(object_id)
        e.locations = list(locations)
        e.wake()

    def ready(self, object_id: bytes) -> bool:
        e = self._entries.get(object_id)
        return e is not None and e.event.is_set()

    def delete(self, object_id: bytes) -> None:
        self._entries.pop(object_id, None)

    def __len__(self) -> int:
        return len(self._entries)


class _DictBackend:
    """The node store: object id -> frames in the agent's memory."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.used = 0
        self._data: dict[bytes, list[bytes]] = {}
        self._lru: dict[bytes, float] = {}
        self._pinned: dict[bytes, int] = {}

    def put(self, oid: bytes, frames: list[bytes]) -> bool:
        size = sum(len(f) for f in frames)
        if oid in self._data:
            return True
        if self.used + size > self.capacity:
            # No implicit eviction (data loss); the StoreRunner spills the
            # LRU object to disk and retries (plasma → spill discipline).
            return False
        self._data[oid] = frames
        self._lru[oid] = time.monotonic()
        self.used += size
        return True

    def get(self, oid: bytes) -> list[bytes] | None:
        frames = self._data.get(oid)
        if frames is not None:
            self._lru[oid] = time.monotonic()
        return frames

    def contains(self, oid: bytes) -> bool:
        return oid in self._data

    def delete(self, oid: bytes) -> bool:
        frames = self._data.pop(oid, None)
        self._lru.pop(oid, None)
        self._pinned.pop(oid, None)
        if frames is not None:
            self.used -= sum(len(f) for f in frames)
        return True

    def pin(self, oid: bytes, delta: int) -> None:
        self._pinned[oid] = max(0, self._pinned.get(oid, 0) + delta)

    def scan_objects(self) -> list[dict]:
        """Ledger view (native scan_objects shape).  The dict backend
        has no creating state or pid attribution — every entry reads as
        sealed, created by this process."""
        return [{"object_id": oid,
                 "size": sum(len(f) for f in frames),
                 "lru_tick": self._lru.get(oid, 0.0),
                 "sealed": True,
                 "pins": self._pinned.get(oid, 0),
                 "creator_pid": os.getpid()}
                for oid, frames in self._data.items()]

    def scan_pins(self) -> list[tuple[bytes, int]]:
        return []      # no pid-attributed pins without the native arena

    def oldest(self) -> bytes | None:
        """LRU unpinned object id — the next spill candidate
        (ray: plasma LRU eviction_policy.h:105)."""
        candidates = [oid for oid in self._lru
                      if self._pinned.get(oid, 0) == 0]
        if not candidates:
            return None
        return min(candidates, key=lambda o: self._lru[o])

    def stats(self) -> dict:
        return {"used": self.used, "capacity": self.capacity,
                "num_objects": len(self._data)}

    def close(self) -> None:
        self._data.clear()


def _spill_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _align64(n: int) -> int:
    return (n + 63) & ~63


def _bundle_layout(frame_lens: list[int]) -> tuple[int, list[int]]:
    """Return (total size, per-frame offsets) for a frame bundle (the
    reference arena's layout, kept for spill files)."""
    header = 4 + 8 * len(frame_lens)
    offsets = []
    pos = _align64(header)
    for ln in frame_lens:
        offsets.append(pos)
        pos = _align64(pos + ln)
    return pos, offsets


class StoreRunner:
    """Node-agent-side object store service (ray: PlasmaStoreRunner embedded
    in the raylet, store_runner.h:14) with disk spilling: when the arena is
    full, LRU objects spill to files and restore on demand (ray:
    LocalObjectManager local_object_manager.h:41 + external_storage.py)."""

    def __init__(self, node_id: str, config):
        import tempfile

        self.node_id = node_id
        self.config = config
        self.backend = _DictBackend(config.object_store_memory)
        self._clients = None
        self.spill_dir = os.path.join(
            tempfile.gettempdir(),
            f"ray_tpu_torch_spill_{node_id[:8]}_{os.getpid()}")
        self.spilled: dict[bytes, str] = {}     # oid -> file path
        self.spilled_bytes = 0
        # Deletes refused because a zero-copy reader still pins the object
        # are retried from the agent's reaper loop (retry_deletes); without
        # this the dead object would linger, get spilled under pressure,
        # and leak on disk forever.
        self._pending_deletes: set[bytes] = set()
        # Serializes spill-to-disk decisions across concurrent async puts
        # (the file writes themselves run off-loop in a thread).
        self._spill_lock = asyncio.Lock()

    def register_handlers(self, server, clients) -> None:
        self._clients = clients
        server.register("store_put", self.rpc_store_put)
        server.register("store_get", self.rpc_store_get)
        server.register("store_contains", self.rpc_store_contains)
        server.register("store_delete", self.rpc_store_delete)
        server.register("store_stats", self.rpc_store_stats)

    # -------------------------------------------------------------- spill
    def _write_spill_file(self, oid: bytes, frames: list) -> tuple[str, int]:
        """Serialize a frame bundle to the spill dir; returns (path, bytes).

        The on-disk layout is IDENTICAL to the arena bundle layout
        (aligned frame offsets): chunked node-to-node pulls serve raw
        slices from either source interchangeably."""
        import struct as _struct

        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, oid.hex())
        lens = [len(fr) for fr in frames]
        total, offsets = _bundle_layout(lens)
        with open(path, "wb") as f:
            f.write(_struct.pack("<I", len(frames)))
            f.write(_struct.pack(f"<{len(lens)}Q", *lens))
            for fr, fo in zip(frames, offsets):
                f.seek(fo)
                f.write(fr)
            f.truncate(total)
        return path, total

    async def _spill_one(self) -> bool:
        """Write the LRU object's frames to disk and drop it from memory.
        The file write runs off the event loop: spilling a few GB
        synchronously would stall the agent's heartbeat loop past
        node_death_timeout_s and turn memory pressure into node death."""
        oid = self.backend.oldest()
        if oid is None:
            return False
        if oid in self._pending_deletes:
            # Tombstoned (delete was refused while pinned): free it now
            # instead of wasting disk on a dead object.
            if self.backend.delete(oid):
                self._pending_deletes.discard(oid)
                return True
        copy_fn = getattr(self.backend, "get_bundle_copy", None)
        if copy_fn is not None:
            # Explicitly-unpinned copy read: the subsequent delete must not
            # depend on GC collecting a zero-copy view's finalizer.
            data = copy_fn(oid)
            if data is None:
                return False
            path, size = await asyncio.to_thread(self._write_spill_raw,
                                                 oid, data)
        else:
            frames = self.backend.get(oid)
            if frames is None:
                return False
            path, size = await asyncio.to_thread(self._write_spill_file,
                                                 oid, frames)
            del frames      # dict backend: plain bytes, nothing pinned
        if not self.backend.contains(oid):
            # Deleted while the file write was in flight: the object is
            # dead — registering the spill file would resurrect it (and
            # leak the file forever).  Memory was freed by the delete, so
            # this still counts as progress for the caller's retry loop.
            self._pending_deletes.discard(oid)
            try:
                os.unlink(path)
            except OSError:
                pass
            return True
        if not self.backend.delete(oid):
            # Raced with a reader pinning it: the arena copy stays
            # authoritative; drop the file so nothing double-counts.
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self.spilled[oid] = path
        self.spilled_bytes += size
        logger.info("spilled %s (%d B) to %s", oid.hex()[:12], size, path)
        return True

    def _write_spill_raw(self, oid: bytes, data: bytes) -> tuple[str, int]:
        """Write an already-laid-out frame bundle (the arena's raw bytes)
        straight to the spill file — the two layouts are identical."""
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, oid.hex())
        with open(path, "wb") as f:
            f.write(data)
        return path, len(data)

    def _read_spilled(self, oid: bytes) -> list[bytes] | None:
        path = self.spilled.get(oid)
        if path is None:
            return None
        import struct as _struct

        try:
            with open(path, "rb") as f:
                (n,) = _struct.unpack("<I", f.read(4))
                lens = _struct.unpack(f"<{n}Q", f.read(8 * n))
                _, offsets = _bundle_layout(list(lens))
                out = []
                for ln, fo in zip(lens, offsets):
                    f.seek(fo)
                    out.append(f.read(ln))
                return out
        except OSError:
            return None

    def _delete_spilled(self, oid: bytes) -> None:
        path = self.spilled.pop(oid, None)
        if path:
            try:
                self.spilled_bytes -= os.path.getsize(path)
                os.unlink(path)
            except OSError:
                pass

    async def put_with_spill(self, oid: bytes, frames: list) -> bool:
        """Insert, spilling LRU objects to disk until it fits (ray: plasma
        CreateRequestQueue backpressure → spill).  All disk I/O runs off
        the event loop (see _spill_one): heartbeats share this loop."""
        # Duplicate puts (client retry, task re-execution) are a success,
        # NOT a reason to spill: the native backend's put returns False
        # for already-present ids exactly like for a full arena.
        if self.backend.contains(oid) or oid in self.spilled:
            return True
        if self.backend.put(oid, frames):
            return True
        async with self._spill_lock:
            # Re-check after the lock wait: a concurrent duplicate put may
            # have landed this oid (in arena or on disk) meanwhile.
            if self.backend.contains(oid) or oid in self.spilled:
                return True
            if self.backend.put(oid, frames):
                return True
            for _ in range(4096):
                if not await self._spill_one():
                    break
                if self.backend.put(oid, frames):
                    return True
            # Arena can't hold it even after spilling: spill the new
            # object itself straight to disk.
            path, size = await asyncio.to_thread(self._write_spill_file,
                                                 oid, frames)
            self.spilled[oid] = path
            self.spilled_bytes += size
            return True

    async def rpc_store_put(self, h: dict, blobs: list) -> dict:
        ok = await self.put_with_spill(bytes.fromhex(h["object_id"]),
                                       list(blobs))
        return {"ok": ok}

    async def rpc_store_get(self, h: dict, _b: list) -> tuple[dict, list]:
        oid = bytes.fromhex(h["object_id"])
        frames = self.backend.get(oid)
        if frames is None:
            # Restore from disk (ray: spilled_object_reader.cc); best
            # effort re-insert so repeat readers hit memory.  Off-loop:
            # restoring a multi-GB object inline would stall heartbeats.
            restored = await asyncio.to_thread(self._read_spilled, oid)
            if restored is None:
                return {"found": False}, []
            if self.backend.put(oid, restored):
                self._delete_spilled(oid)
            return {"found": True}, restored
        return {"found": True}, list(frames)

    async def rpc_store_contains(self, h: dict, _b: list) -> dict:
        return {"found": self.backend.contains(bytes.fromhex(h["object_id"]))}

    async def rpc_store_delete(self, h: dict, _b: list) -> dict:
        oid = bytes.fromhex(h["object_id"])
        if not self.backend.delete(oid):
            # Refused: a zero-copy reader still pins it.  Tombstone so the
            # reaper retries after the pin releases — otherwise the dead
            # object lingers, gets spilled under pressure, and leaks.
            self._pending_deletes.add(oid)
        self._delete_spilled(oid)
        return {}

    def retry_deletes(self) -> int:
        """Retry tombstoned deletes (called from the agent's reaper loop,
        after sweep_dead has reclaimed crashed readers' pins)."""
        done = 0
        for oid in list(self._pending_deletes):
            if self.backend.delete(oid):
                self._pending_deletes.discard(oid)
                self._delete_spilled(oid)
                done += 1
        return done

    def memory_report(self, limit: int = 5000) -> dict:
        """Node-store half of the `memory` verb: every arena entry with
        size/pins/creator-pid attribution (native scan; the dict backend
        degrades to sizes only), plus spill state.  Bounded like the
        ledger reply — biggest rows survive, the drop count is
        reported."""
        entries = []
        scan = getattr(self.backend, "scan_objects", None)
        if scan is not None:
            try:
                entries = scan()
            except Exception:  # noqa: BLE001 - racing close
                entries = []
        truncated = 0
        if len(entries) > limit:
            entries.sort(key=lambda e: -e["size"])
            truncated = len(entries) - limit
            entries = entries[:limit]
        pin_scan = getattr(self.backend, "scan_pins", None)
        pins: list = []
        if pin_scan is not None:
            try:
                pins = pin_scan()
            except Exception:  # noqa: BLE001
                pins = []
        pin_pids: dict[str, list[int]] = {}
        for oid, pid in pins:
            pin_pids.setdefault(oid.hex(), []).append(pid)
        # Creator liveness is LOCAL-host truth (creators map this
        # host's arena), answered here so the harvest side can gate the
        # unreachable-owner gauge on it without remote pid access.
        from ray_tpu_torch._private.memledger import _pid_alive

        alive: dict[int, bool] = {}
        for e in entries:
            pid = e["creator_pid"]
            if pid not in alive:
                alive[pid] = _pid_alive(pid)
        return {
            "stats": self.backend.stats(),
            "objects": [{"object_id": e["object_id"].hex(),
                         "size": e["size"], "sealed": e["sealed"],
                         "pins": e["pins"],
                         "pin_pids": pin_pids.get(e["object_id"].hex(),
                                                  []),
                         "creator_pid": e["creator_pid"],
                         "creator_alive": alive[e["creator_pid"]]}
                        for e in entries],
            "truncated": truncated,
            "spilled": [{"object_id": oid.hex(), "path": path,
                         "size": _spill_size(path)}
                        for oid, path in list(self.spilled.items())],
            "spilled_bytes": self.spilled_bytes,
            "pending_deletes": len(self._pending_deletes),
        }

    async def rpc_store_stats(self, h: dict, _b: list) -> dict:
        out = {**self.backend.stats(),
               "spilled_objects": len(self.spilled),
               "spilled_bytes": self.spilled_bytes}
        if h.get("sweep"):
            # Chaos-test hook: reclaim + report pins of crash-killed
            # processes right now (the reaper also does this on a 5s
            # cadence).  0 == nothing was leaked at call time.
            sweep = getattr(self.backend, "sweep_dead", None)
            out["swept_dead_pins"] = int(sweep()) if sweep else 0
        return out

    def close(self) -> None:
        self.backend.close()
        import shutil

        shutil.rmtree(self.spill_dir, ignore_errors=True)
