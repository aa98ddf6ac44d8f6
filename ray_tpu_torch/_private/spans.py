"""Cluster flight recorder: always-on per-process span ring buffer.

Analog of ray's two-piece tracing story — OpenTelemetry spans around
every task (ray: python/ray/util/tracing/tracing_helper.py) plus the
core worker's task-event buffer aggregated centrally (ray:
src/ray/core_worker task events -> GCS) — collapsed into one mechanism:
every process keeps a fixed-size ring of completed spans, each stamped
with a W3C-style trace context (trace_id / span_id / parent) that rides
the existing task "trace" header across worker→agent→controller→replica
hops.  Harvest is pull-based: the `spans` RPC verb (same
controller→agents→workers broadcast fan-out as the `failpoints` verb)
drains every buffer; `ray_tpu_torch.tracing.harvest()` merges them by
trace_id into one connected timeline per serve request / train step.

Design contract (the tentpole's cost rules):

- **Always on** (kill switch ``RAY_TPU_TORCH_TRACE=0``): every instrumented
  site is ``if spans.ENABLED: ...`` — one module-flag truth test when
  disabled, the failpoints discipline.
- **Lock-light emit**: the ring is a preallocated list + an
  ``itertools.count`` cursor (``next()`` is GIL-atomic), so recording a
  span is a dict build + one list-slot store — no lock, no allocation
  beyond the record, safe from any thread including the rpc IO thread
  (it never blocks).
- **Bounded**: ``RAY_TPU_TORCH_TRACE_BUFFER`` slots per process (default
  4096); older spans are overwritten, never flushed synchronously.
- **Cross-process**: trace context propagates through the task header
  (worker._build_task_payload consults `task_trace_context()`; the
  executing worker adopts the header via `adopt_task_trace` /
  the ``current_trace`` fallback), so a span opened on the driver
  parents spans recorded inside replicas on other hosts with zero new
  wire fields.

Clock: spans carry wall time (`time.time()`, shared across processes on
a host — the same basis as the task-event timeline), so buffers from
different processes merge onto one timeline directly.
"""
from __future__ import annotations

import contextvars
import itertools
import os
import time
from contextlib import contextmanager

ENV_VAR = "RAY_TPU_TORCH_TRACE"
BUF_VAR = "RAY_TPU_TORCH_TRACE_BUFFER"


def _env_on() -> bool:
    v = os.environ.get(ENV_VAR)
    if v is None:
        return True
    return v not in ("0", "false", "False", "")


# Module flag read by every instrumented site (the failpoints ACTIVE
# discipline): True unless RAY_TPU_TORCH_TRACE=0.
ENABLED = _env_on()

_CAPACITY = max(256, int(os.environ.get(BUF_VAR, "4096") or "4096"))
_buf: list = [None] * _CAPACITY
_cursor = itertools.count()
_emitted = 0                    # approximate (racy +=); stats only
_pid = os.getpid()
_span_seq = itertools.count(1)
_proc_label: str | None = None
# Process identity for harvest dedup: bare pid collides across HOSTS
# (containerized nodes all start at low pids), so replies carry a
# boot token — same interpreter through several fan-out legs → same
# token; same pid on two hosts → different tokens.
_boot = f"{_pid:x}-{time.time_ns():x}"

# Current trace context: (trace_id, span_id).  A ContextVar so async
# replica handlers carry their own request's context across awaits —
# the per-task worker attributes can't (they are process-global and
# async actor methods interleave).
_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "raytpu_torch_span_ctx", default=None)


def set_enabled(on: bool) -> None:
    """Flip the recorder and mirror the choice into os.environ so
    processes spawned from here inherit it (same-run A/B: the bench
    runs one workload leg with the recorder on, one with it off)."""
    global ENABLED
    ENABLED = bool(on)
    os.environ[ENV_VAR] = "1" if on else "0"


def set_process_label(label: str) -> None:
    """Name this process in harvest output ("driver", "agent:<node>",
    "worker:<id>", "controller") — attached once per harvest reply,
    not per span."""
    global _proc_label
    _proc_label = label


def proc_label() -> str:
    return _proc_label or f"pid:{_pid}"


def _new_id() -> str:
    """Process-unique, cheap, process-stable span/trace id (16 hex
    chars: pid + per-process counter — never `hash()`, never random
    state that a fork would duplicate)."""
    return f"{_pid & 0xFFFFFFFF:08x}{next(_span_seq) & 0xFFFFFFFF:08x}"


def _append(rec: dict) -> None:
    global _emitted
    i = next(_cursor)
    _buf[i % _CAPACITY] = rec
    _emitted = i + 1


def current() -> tuple | None:
    """The active (trace_id, span_id), from the contextvar when a span
    is open here, else from the executing task's "trace" header — the
    hop that makes any code running inside a task automatically part of
    its submitter's trace."""
    c = _ctx.get()
    if c is not None:
        return c
    try:
        from ray_tpu_torch._private.worker import _global_worker

        w = _global_worker
        tc = w.current_trace if w is not None else None
    except Exception:  # noqa: BLE001 - no runtime in this process
        return None
    if tc:
        return (tc["trace_id"], tc["span_id"])
    return None


# The recorder-facing alias (library code reads better with it).
capture = current


def task_trace_context() -> dict | None:
    """The active context shaped like the task header's "trace" dict,
    for worker._build_task_payload: a task submitted under an open span
    joins the span's trace with the span as its parent."""
    c = _ctx.get()
    if c is None:
        return None
    return {"trace_id": c[0], "span_id": c[1]}


def adopt_task_trace(trace: dict | None):
    """Install a task header's trace context into the current
    (async) execution context; returns a reset token (or None).  Sync
    executor paths don't need this — they set the call's task context
    (actor_state.EXECUTING_TASK, read as worker.current_trace) and
    `current()` falls back to it — but async actor methods interleave
    on one loop, so each handler task must carry its own copy."""
    if not trace:
        return None
    return _ctx.set((trace["trace_id"], trace["span_id"]))


@contextmanager
def context(ctx: tuple | None):
    """Install an explicit (trace_id, span_id) context for a block —
    how threads executing deferred work (collective op threads, engine
    loops) re-join the request that submitted it."""
    if ctx is None:
        yield
        return
    token = _ctx.set(tuple(ctx))
    try:
        yield
    finally:
        _ctx.reset(token)


def _clean_attrs(attrs: dict | None) -> dict:
    """header-safe attrs: the harvest verb ships records over RPC, so
    one exotic value must not poison a whole buffer."""
    if not attrs:
        return {}
    out = {}
    for k, v in attrs.items():
        if isinstance(v, bool) or v is None or isinstance(v, str):
            out[str(k)] = v
        elif isinstance(v, (int, float)):
            out[str(k)] = v
        else:
            out[str(k)] = str(v)
    return out


def emit(name: str, t0: float, t1: float | None = None,
         ctx: tuple | None = None, attrs: dict | None = None) -> None:
    """Record one completed span.  `ctx` is an explicit (trace_id,
    parent_span_id) pair — e.g. captured at request submission and
    replayed from the engine loop thread; None uses `current()`; with
    no context anywhere the span roots its own trace."""
    if not ENABLED:
        return
    c = ctx if ctx is not None else current()
    if c is not None:
        tid, par = c
    else:
        tid, par = _new_id(), ""
    _append({"tid": tid, "sid": _new_id(), "par": par or "",
             "name": name, "t0": t0,
             "t1": time.time() if t1 is None else t1,
             "pid": _pid, "attrs": _clean_attrs(attrs)})


def emit_task(trace: dict | None, name: str, t0: float,
              err: str | None = None) -> None:
    """Record a task-execution span from its header trace: span_id IS
    the task id, so spans recorded inside the task (which parent to the
    header's span_id) connect to it across the process boundary."""
    if not ENABLED or not trace:
        return
    rec = {"tid": trace["trace_id"], "sid": trace["span_id"],
           "par": trace.get("parent_span") or "", "name": name,
           "t0": t0, "t1": time.time(), "pid": _pid, "attrs": {}}
    if err:
        rec["attrs"] = {"error": err}
    _append(rec)


def emit_stamps(prefix: str, stamps: dict, order: tuple,
                ctx: tuple | None = None,
                attrs: dict | None = None) -> None:
    """Bridge a legacy tracer record (monotonic-clock stamp sequence,
    e.g. the hop/put tracers' dicts) into child spans: one span per
    consecutive stamp pair, re-anchored onto the wall clock at publish
    time so they land on the merged timeline."""
    if not ENABLED:
        return
    present = [(k, stamps[k]) for k in order
               if isinstance(stamps.get(k), (int, float))]
    if len(present) < 2:
        return
    offset = time.time() - time.monotonic()
    c = ctx if ctx is not None else current()
    parent_tid, parent_sid = c if c is not None else (_new_id(), "")
    # One parent span for the whole stamped operation...
    psid = _new_id()
    _append({"tid": parent_tid, "sid": psid, "par": parent_sid,
             "name": prefix, "t0": present[0][1] + offset,
             "t1": present[-1][1] + offset, "pid": _pid,
             "attrs": _clean_attrs(attrs)})
    # ...and one child per stamp-to-stamp segment.
    for (a, ta), (b, tb) in zip(present, present[1:]):
        _append({"tid": parent_tid, "sid": _new_id(), "par": psid,
                 "name": f"{prefix}.{a}->{b}", "t0": ta + offset,
                 "t1": tb + offset, "pid": _pid, "attrs": {}})


@contextmanager
def span(name: str, attrs: dict | None = None, ctx: tuple | None = None):
    """Record a span around a block; nested spans (and tasks submitted
    inside the block) parent to it.  Yields the span's mutable attrs
    dict so the block can annotate what it learned (replica picked,
    cache score, bytes moved):

        with spans.span("serve.route") as sp:
            rid = pick(...)
            sp["replica"] = rid
    """
    if not ENABLED:
        yield {}
        return
    parent = ctx if ctx is not None else current()
    sid = _new_id()
    tid = parent[0] if parent is not None else _new_id()
    par = parent[1] if parent is not None else ""
    token = _ctx.set((tid, sid))
    live_attrs = dict(attrs) if attrs else {}
    t0 = time.time()
    err = None
    try:
        yield live_attrs
    except BaseException as e:  # noqa: BLE001 - recorded, re-raised
        err = f"{type(e).__name__}"
        raise
    finally:
        _ctx.reset(token)
        if err is not None:
            live_attrs["error"] = err
        _append({"tid": tid, "sid": sid, "par": par, "name": name,
                 "t0": t0, "t1": time.time(), "pid": _pid,
                 "attrs": _clean_attrs(live_attrs)})


def snapshot(trace_id: str | None = None) -> list[dict]:
    """Copy the live ring (oldest-first-ish; callers sort by t0).  The
    list() copy is a C-level slice under the GIL — concurrent emits may
    land or miss, never tear a record."""
    out = [r for r in list(_buf) if r is not None]
    if trace_id:
        out = [r for r in out if r["tid"] == trace_id]
    return out


def clear() -> None:
    # Cursor and emitted reset WITH the buffer: `dropped` counts ring
    # overwrites since the last clear, not spans a harvest collected
    # (a fresh count may race one in-flight emit; the stats are
    # advisory).
    global _buf, _cursor, _emitted
    _buf = [None] * _CAPACITY
    _cursor = itertools.count()
    _emitted = 0


def stats() -> dict:
    return {"enabled": ENABLED, "capacity": _CAPACITY,
            "emitted": _emitted,
            "buffered": sum(1 for r in _buf if r is not None),
            "dropped": max(0, _emitted - _CAPACITY)}


def control(h: dict) -> dict:
    """The `spans` RPC verb body, shared by worker/agent/controller
    handlers.  ops: collect (drain-free read, optional trace_id filter
    and clear), clear, stats, enable (flip the recorder live)."""
    op = h.get("op", "collect")
    if op == "collect":
        out = snapshot(h.get("trace_id"))
        if h.get("clear"):
            clear()
        return {"spans": out, "pid": _pid, "boot": _boot,
                "proc": proc_label(), **stats()}
    if op == "clear":
        clear()
        return {"pid": _pid, "boot": _boot, "proc": proc_label(),
                **stats()}
    if op == "enable":
        set_enabled(bool(h.get("on", True)))
        return {"pid": _pid, "boot": _boot, "proc": proc_label(),
                **stats()}
    if op == "stats":
        return {"pid": _pid, "boot": _boot, "proc": proc_label(),
                **stats()}
    raise ValueError(f"spans verb: unknown op {op!r}")


def _after_fork_child() -> None:
    # The ring's contents belong to the parent; the child records its
    # own.  Ids re-key on the child pid so they stay process-unique.
    global _pid, _buf, _cursor, _span_seq, _emitted, _proc_label, _boot
    _pid = os.getpid()
    _buf = [None] * _CAPACITY
    _cursor = itertools.count()
    _span_seq = itertools.count(1)
    _emitted = 0
    _proc_label = None
    _boot = f"{_pid:x}-{time.time_ns():x}"


os.register_at_fork(after_in_child=_after_fork_child)
