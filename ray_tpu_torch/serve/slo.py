"""The overload policy the replica, the LLM server and the engine need,
copied from ray_tpu/serve/slo.py (the port imports nothing of ray_tpu).

  - **Priority tiers** honored at the replica's admission
    (`request_priority`, `queue_budget`): a HIGH request may use 2x the
    queue budget, LOW only half, so under overload the best-effort tier
    is shed first.
  - **degrade_on**: the RAY_TPU_SERVE_DEGRADE kill switch (read per
    call; off = never shed disaggregation or shrink sync windows).
  - **LatencyWindow**: bounded recent latency samples by key, behind the
    engine's `stats()["slo"]` percentiles.
  - **OverloadTracker**: the hysteresis ladder over the engine's queue
    depth (level 1 sheds disaggregation to unified serving, level 2 also
    shrinks the decode sync window).

The autoscaling policies (`slo_desired`, `pd_rebalance`) belong to the
controller's autoscaler, which is not ported yet (ROADMAP.md queue 1:
serve).
"""
from __future__ import annotations

import collections
import threading
import time

from ray_tpu_torch.serve.kv_router import env_on


# Priority tiers (smaller = more important).  A request's tier comes
# from handle.options(priority=...) or a {"serve_priority": n} key in a
# dict-shaped request payload.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2


def queue_budget(priority: int, max_queued: int) -> int:
    """Per-tier admission queue budget: HIGH gets 2x headroom, LOW
    half (shed first).  A budget of 0 means NO queueing for that tier
    (the request still admits whenever an execution slot is free —
    admission compares ongoing against max_ongoing + budget)."""
    if max_queued <= 0:
        return 0
    if priority <= PRIORITY_HIGH:
        return 2 * max_queued
    if priority >= PRIORITY_LOW:
        return max_queued // 2
    return max_queued


def request_priority(priority, args: tuple = (), kwargs: dict | None
                     = None) -> int:
    """Resolve a request's tier: the handle-level option wins; else a
    {"serve_priority": n} key in a dict payload — a RESERVED key, not
    the app's own "priority" field (an application convention where
    bigger = more urgent would silently invert into the shed-first
    tier); else NORMAL."""
    if priority is not None:
        return int(priority)
    for v in list(args) + list((kwargs or {}).values()):
        if isinstance(v, dict):
            p = v.get("serve_priority")
            if isinstance(p, int) and not isinstance(p, bool):
                return p
    return PRIORITY_NORMAL


def degrade_on() -> bool:
    """RAY_TPU_SERVE_DEGRADE kill switch (replica-side; off = never
    shed disagg / shrink sync windows)."""
    return env_on("RAY_TPU_SERVE_DEGRADE")


def percentiles(samples) -> dict | None:
    """{p50, p90, p99, mean, n} over an iterable of ms samples (None
    when empty).  Nearest-rank on the sorted copy."""
    vals = sorted(samples)
    if not vals:
        return None
    n = len(vals)

    def pct(q: float) -> float:
        return vals[min(n - 1, int(q * n))]

    return {"p50": round(pct(0.50), 3), "p90": round(pct(0.90), 3),
            "p99": round(pct(0.99), 3),
            "mean": round(sum(vals) / n, 3), "n": n}


class LatencyWindow:
    """Recent latency samples by key ('ttft_ms', 'queue_ms', ...).

    Samples are (monotonic_t, ms) pairs and snapshot() drops anything
    older than `max_age_s`, so a spike's tail ages out.  A lock guards
    observe/snapshot: copying a deque another thread appends to raises."""

    def __init__(self, maxlen: int = 512, max_age_s: float = 60.0,
                 clock=time.monotonic):
        self._maxlen = maxlen
        self.max_age_s = max_age_s
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, collections.deque] = {}

    def observe(self, key: str, ms: float) -> None:
        now = self._clock()
        with self._lock:
            d = self._series.get(key)
            if d is None:
                d = self._series.setdefault(
                    key, collections.deque(maxlen=self._maxlen))
            d.append((now, float(ms)))

    def snapshot(self) -> dict:
        cutoff = self._clock() - self.max_age_s
        with self._lock:
            fresh = {key: [ms for t, ms in d if t >= cutoff]
                     for key, d in self._series.items()}
        out = {}
        for key, vals in fresh.items():
            p = percentiles(vals)
            if p is not None:
                out[key] = p
        return out


class OverloadTracker:
    """Hysteresis ladder over a scalar pressure signal (queue depth).

    Levels: 0 = normal, 1 = overloaded (shed disagg to unified),
    2 = severely overloaded (also shrink the decode sync window).
    A level is ENTERED only after the signal holds above its threshold
    for `on_s` continuous seconds; it STEPS DOWN one level after
    `off_s` continuous seconds below that level's own entry threshold,
    and `off_s` at-or-below `lo` resets straight to 0.  Every transition
    needs sustain, so a one-tick spike or dip flaps nothing.  `clock` is
    injectable (tests drive it by hand)."""

    def __init__(self, hi: float, hi2: float | None = None,
                 lo: float | None = None, on_s: float = 0.25,
                 off_s: float = 1.0, clock=time.monotonic):
        self.hi = hi
        self.hi2 = hi2 if hi2 is not None else 2 * hi
        self.lo = lo if lo is not None else max(0.0, hi / 2)
        self.on_s = on_s
        self.off_s = off_s
        self.level = 0
        self._clock = clock
        self._hi_since: float | None = None
        self._hi2_since: float | None = None
        self._lo_since: float | None = None
        self._below_hi_since: float | None = None
        self._below_hi2_since: float | None = None
        self._last_update: float | None = None

    def _stamp(self, name: str, armed: bool, now: float) -> None:
        # Explicit None checks: a start stamp may legitimately be 0.0
        # (fake clocks under test).
        if armed:
            if getattr(self, name) is None:
                setattr(self, name, now)
        else:
            setattr(self, name, None)

    def update(self, depth: float) -> tuple[int, int]:
        """Feed one pressure sample; returns (level, previous_level)."""
        now = self._clock()
        # Updates only arrive with traffic.  A long gap with LOW depth at
        # its end counts as sustained calm (the calm stamps are
        # backdated), never toward the pressure stamps.
        gap = None if self._last_update is None \
            else now - self._last_update
        self._last_update = now
        calm_t = now - self.off_s \
            if gap is not None and gap >= self.off_s else now
        self._stamp("_hi_since", depth >= self.hi, now)
        self._stamp("_hi2_since", depth >= self.hi2, now)
        self._stamp("_lo_since", depth <= self.lo, calm_t)
        self._stamp("_below_hi_since", depth < self.hi, calm_t)
        self._stamp("_below_hi2_since", depth < self.hi2, calm_t)

        def held(stamp, dur):
            return stamp is not None and now - stamp >= dur

        prev = self.level
        level = prev
        if held(self._hi2_since, self.on_s):
            level = 2
        elif held(self._hi_since, self.on_s):
            level = max(level, 1)
        # Step-down: sustained below the CURRENT level's entry threshold
        # (without it, steady pressure in (lo, hi) would pin a level).
        if level == 2 and held(self._below_hi2_since, self.off_s):
            level = 1
        if level == 1 and held(self._below_hi_since, self.off_s):
            level = 0
        if held(self._lo_since, self.off_s):
            level = 0
        self.level = level
        return level, prev
