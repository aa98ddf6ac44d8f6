"""Application metrics API: Counter / Gauge / Histogram (port of
ray_tpu/utils/metrics.py).

Analog of ray: python/ray/util/metrics.py (Counter/Gauge/Histogram over the
C++ OpenCensus registry, src/ray/stats/metric_defs.cc).  Metrics are
buffered per process and flushed to the controller KV every
FLUSH_PERIOD_S (namespace "metrics", key the worker id, a JSON
{"ts", "metrics": [snapshot, ...]}) by a daemon thread that starts with
the first metric.  The port has no zygote, so no fork hooks; the
telemetry timeline, which samples the same walk in the reference, is a
later slice of the port (ROADMAP.md queue 1).

A metric may instead live in a registry of the caller's (`registry=`, a
dict by name): `serve.runtime.Recorder` keeps its own that way, and
nothing flushes it.
"""
from __future__ import annotations

import threading
import time
from typing import Sequence

_registry_lock = threading.Lock()
_registry: dict[str, "Metric"] = {}
_flusher: threading.Thread | None = None
FLUSH_PERIOD_S = 2.0


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] | None = None, *,
                 registry: dict | None = None):
        if not name:
            raise ValueError("metric name must be non-empty")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: dict[str, str] = {}
        # (tag tuple) -> value
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            (_registry if registry is None else registry)[name] = self
        if registry is None:
            _ensure_flusher()

    def set_default_tags(self, tags: dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: dict | None) -> tuple:
        merged = {**self._default_tags, **(tags or {})}
        unknown = set(merged) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys {unknown}; declared "
                             f"{self.tag_keys}")
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def remove(self, tags: dict | None = None) -> None:
        """Drop one tagged series from this metric.  Short-lived tag
        values (a per-replica tag under an autoscaler that cycles
        replicas all day) MUST be removed at teardown or the registry,
        and every snapshot flushed from it, grows without bound."""
        k = self._key(tags)
        with self._lock:
            self._values.pop(k, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name, "description": self.description,
                "type": type(self).__name__.lower(),
                "tag_keys": list(self.tag_keys),
                "values": [
                    {"tags": dict(zip(self.tag_keys, k)), "value": v}
                    for k, v in self._values.items()],
            }


class Counter(Metric):
    """Monotonic counter (ray: util/metrics.py Counter)."""

    def inc(self, value: float = 1.0, tags: dict | None = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    """Last-value gauge (ray: util/metrics.py Gauge)."""

    def set(self, value: float, tags: dict | None = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    """Bucketed histogram (ray: util/metrics.py Histogram)."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] | None = None,
                 tag_keys: Sequence[str] | None = None, *,
                 registry: dict | None = None):
        super().__init__(name, description, tag_keys, registry=registry)
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1.0, 10.0, 100.0])
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, tags: dict | None = None) -> None:
        k = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            counts[i] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._values[k] = self._sums[k]   # snapshot shows the sum

    def remove(self, tags: dict | None = None) -> None:
        k = self._key(tags)
        with self._lock:
            self._values.pop(k, None)
            self._counts.pop(k, None)
            self._sums.pop(k, None)

    def snapshot(self) -> dict:
        base = super().snapshot()
        with self._lock:
            base["boundaries"] = self.boundaries
            base["counts"] = [
                {"tags": dict(zip(self.tag_keys, k)), "counts": c}
                for k, c in self._counts.items()]
        return base


def get_or_create(cls, name: str, description: str = "",
                  tag_keys: Sequence[str] | None = None, *,
                  registry: dict | None = None, **kwargs):
    """Idempotent metric handle: return the registered metric when one
    of the same name and type exists, else create it.  Library code
    that may instantiate many times per process (e.g. one serve LLM
    engine per replica, many per test run) must use this instead of the
    constructor — re-constructing replaces the registry entry and
    silently drops the accumulated series.  `registry` as for
    `Metric`."""
    reg = _registry if registry is None else registry
    with _registry_lock:
        m = reg.get(name)
    if m is None:
        # The constructor registers itself (under the lock); two racing
        # creators both construct, the registry keeps the last writer —
        # re-read and return THAT one so every caller holds the same
        # handle and no series is silently dropped.
        cls(name, description, tag_keys=tag_keys, registry=registry,
            **kwargs)
        with _registry_lock:
            m = reg[name]
    if type(m) is not cls:
        raise TypeError(
            f"metric {name!r} already registered as "
            f"{type(m).__name__}, requested {cls.__name__}")
    return m


KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def of_kind(kind: str, name: str, description: str = "",
            tag_keys: Sequence[str] = (), boundaries=None, *,
            registry: dict | None = None) -> Metric:
    """`get_or_create` by kind name ("counter", "gauge" or "histogram"):
    the runtimes' `metric` face."""
    cls = KINDS.get(kind)
    if cls is None:
        raise ValueError(f"metric kind {kind!r}: want one of "
                         f"{sorted(KINDS)}")
    kw = {"boundaries": boundaries} if cls is Histogram else {}
    return get_or_create(cls, name, description, tag_keys,
                         registry=registry, **kw)


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED sequence (0.0
    for empty) — the one summary-stat helper shared by the trace
    attribution and task-summary surfaces."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def registry_snapshots(registry: dict | None = None) -> list[dict]:
    """Snapshot every registered metric (of `registry` when given) under
    the registry lock (the flush loop's walk)."""
    with _registry_lock:
        return [m.snapshot() for m in
                (_registry if registry is None else registry).values()]


def _ensure_flusher() -> None:
    """Push local metric snapshots to the controller KV (the metrics-agent
    export path, collapsed)."""
    global _flusher
    with _registry_lock:
        if _flusher is not None:
            return
        _flusher = threading.Thread(target=_flush_loop, daemon=True,
                                    name="metrics-flush")
        _flusher.start()


def _flush_loop() -> None:
    import json

    while True:
        time.sleep(FLUSH_PERIOD_S)
        try:
            from ray_tpu_torch._private.worker import _global_worker

            core = _global_worker
            if core is None or core._shutdown.is_set():
                continue
            snaps = registry_snapshots()
            if not snaps:
                continue
            core.call(core.controller_addr, "kv_put",
                      {"ns": "metrics", "key": core.worker_id},
                      [json.dumps({"ts": time.time(),
                                   "metrics": snaps}).encode()],
                      timeout=10.0)
        except Exception:  # noqa: BLE001 - metrics must never crash work
            pass
