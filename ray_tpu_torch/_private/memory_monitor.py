"""Host memory monitor + OOM worker-killing policy.

Analog of the reference's MemoryMonitor (ray: src/ray/common/memory_monitor.h:52,
polled every 250ms against `memory_usage_threshold`, ray_config_def.h:65-78)
and the raylet killing policies (ray: src/ray/raylet/worker_killing_policy
_retriable_fifo.h — prefer retriable, newest first; spare actors while task
workers remain).

Reads cgroup v2 limits when the process is containerized, /proc/meminfo
otherwise — the same dual source the reference uses.
"""
from __future__ import annotations

import logging
import time

logger = logging.getLogger(__name__)

_CGROUP_CUR = "/sys/fs/cgroup/memory.current"
_CGROUP_MAX = "/sys/fs/cgroup/memory.max"


def _read_int(path: str) -> int | None:
    try:
        with open(path) as f:
            raw = f.read().strip()
        if raw == "max":
            return None
        return int(raw)
    except (OSError, ValueError):
        return None


def _cgroup_reclaimable() -> int:
    """Reclaimable page cache inside the cgroup (inactive_file): counted
    in memory.current but freed under pressure, so it must not trigger
    kills (ray: MemoryMonitor subtracts it, memory_monitor.cc)."""
    try:
        with open("/sys/fs/cgroup/memory.stat") as f:
            for line in f:
                if line.startswith("inactive_file "):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return 0


def memory_usage_fraction() -> float:
    """Used/total for the tightest enclosing limit (cgroup else host)."""
    cur, cap = _read_int(_CGROUP_CUR), _read_int(_CGROUP_MAX)
    if cur is not None and cap is not None and cap > 0:
        return max(0, cur - _cgroup_reclaimable()) / cap
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1]) * 1024
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        return 0.0
    return 1.0 - avail / total


def pick_oom_victim(workers: list) -> object | None:
    """Choose the worker to kill under memory pressure.

    Policy (ray: worker_killing_policy_retriable_fifo.h): prefer leased
    task workers (their tasks retry via the submitter's retry budget) over
    actor workers (stateful; restart costs more), and within a class kill
    the NEWEST first — it has done the least work.  Idle/starting workers
    hold no task and are never victims (they die via the idle reaper).
    """
    leased = [w for w in workers if w.state == "leased"
              and not w.is_device_worker]
    actors = [w for w in workers if w.state == "actor"
              and not w.is_device_worker]
    pool = leased or actors
    if not pool:
        return None
    return max(pool, key=lambda w: w.started_at)


class MemoryMonitor:
    """Threshold tracker with a kill cooldown (a kill takes a moment to
    return memory; re-killing every poll would cascade)."""

    def __init__(self, threshold: float, min_kill_interval_s: float = 2.0):
        self.threshold = threshold
        self.min_kill_interval_s = min_kill_interval_s
        self._last_kill = 0.0

    def should_kill(self, usage: float | None = None) -> bool:
        usage = memory_usage_fraction() if usage is None else usage
        if usage < self.threshold:
            return False
        now = time.monotonic()
        if now - self._last_kill < self.min_kill_interval_s:
            return False
        self._last_kill = now
        return True
