"""Launch counters of the kernel wrappers.

Each wrapper calls `count(wrapper, route)` where it launches its kernel:
that adds one to `wrapper.launches` and, with a route, to
`wrapper.launches_by_route[route]`.  A CUDA graph capture launches
nothing, so inside `deferred()` the calling thread's counts go into the
returned Counter instead; `credit(rec)` adds them where the captured
kernels do run, at each replay.  Deferral is per thread: a launch another
thread makes during a capture counts at once and never joins the graph's
credit."""
from __future__ import annotations

import collections
import contextlib
import threading

_tls = threading.local()
_lock = threading.Lock()


def count(fn, route: str | None = None) -> None:
    """One launch of wrapper `fn` (on dtype route `route`, if it has
    routes)."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec[fn, None] += 1
        if route is not None:
            rec[fn, route] += 1
        return
    with _lock:
        fn.launches += 1
        if route is not None:
            fn.launches_by_route[route] += 1


@contextlib.contextmanager
def deferred():
    """Hold this thread's launch counts back for the block; yields the
    Counter {(wrapper, route or None): launches} they go into."""
    prev = getattr(_tls, "rec", None)
    rec = _tls.rec = collections.Counter()
    try:
        yield rec
    finally:
        _tls.rec = prev


def credit(rec) -> None:
    """Add a deferred Counter to the wrappers' counts (one replay of what
    it recorded)."""
    with _lock:
        for (fn, route), n in rec.items():
            if route is None:
                fn.launches += n
            else:
                fn.launches_by_route[route] += n
