"""User-facing profiling spans recorded into the task-event timeline.

Analog of ray: python/ray/_private/profiling.py (`profiling.profile`
context) — spans land in the same controller-side event buffer the task
state transitions use (ray: TaskEventBuffer task_event_buffer.h:206), so
`ray_tpu_torch.timeline()` / the CLI's Chrome-trace export interleaves them
with task lifecycle events.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

# Stamp order of one traced sync call, caller-side entry to caller-side
# return.  Not every stamp appears on every path: the fused fast path
# stamps caller_post/caller_wake (no event loop on the caller's critical
# path), the loop path stamps loop_call/caller_loop_wake instead.
HOP_ORDER = (
    "caller_entry",       # API entry on the caller thread (arm time)
    "caller_post",        # fused path: posted straight to the IO thread
    "loop_call",          # loop path: RpcClient.call ran on the loop
    "io_send",            # IO thread handed the frames to the socket
    "peer_recv",          # executee IO thread read the frames off the socket
    "peer_dispatch",      # executee loop picked the request up
    "exec_start",         # executor thread entered user code
    "exec_end",           # executor thread left user code
    "handler_done",       # executee loop finished the handler
    "reply_io_send",      # executee IO thread sent the reply
    "reply_recv",         # caller IO thread received the reply
    "caller_loop_wake",   # loop path: reply future resolved on the loop
    "caller_wake",        # fused path: blocked caller thread released
    "caller_done",        # API returned on the caller thread
)


def arm_hop_trace(methods: tuple = ("actor_call",)) -> None:
    """Trace the next outgoing RPC whose method matches (one-shot).
    See `hop_trace` for the usual usage."""
    from ray_tpu_torch._private import rpc

    rpc.arm_hop_trace(methods)


def last_hop_trace() -> dict | None:
    """Raw stamps (name -> monotonic seconds) of the most recent traced
    call, cleared on read."""
    from ray_tpu_torch._private import rpc

    return rpc.take_hop_trace()


@contextmanager
def hop_trace(methods: tuple = ("actor_call",)):
    """Trace ONE sync call's per-hop latency:

        with profiling.hop_trace() as rec:
            ray_tpu_torch.get(counter.inc.remote())
        table = profiling.hop_breakdown_us(rec)

    The yielded dict gains "hops" (raw stamps) and "caller_done" when the
    block exits; feed it to `hop_breakdown_us` for per-hop microseconds."""
    from ray_tpu_torch._private import rpc

    rec: dict = {}
    rpc.arm_hop_trace(methods)
    try:
        yield rec
    finally:
        rec["caller_done"] = time.monotonic()
        rec["hops"] = rpc.take_hop_trace()
        rpc.disarm_hop_trace()


def hop_breakdown_us(rec: dict) -> dict:
    """Per-hop latency table (microseconds between consecutive observed
    stamps, in HOP_ORDER) for a completed `hop_trace` record.  Empty when
    the traced call never fired (e.g. the value resolved locally)."""
    hops = dict(rec.get("hops") or {})
    if not hops:
        return {}
    if "caller_done" in rec:
        hops["caller_done"] = rec["caller_done"]
    present = [(k, hops[k]) for k in HOP_ORDER if k in hops]
    if len(present) < 2:
        return {}
    out: dict = {}
    prev_name, prev_t = present[0]
    for name, t in present[1:]:
        out[f"{prev_name}->{name}_us"] = round((t - prev_t) * 1e6, 1)
        prev_name, prev_t = name, t
    out["total_us"] = round((present[-1][1] - present[0][1]) * 1e6, 1)
    return out


# ------------------------------------------------------------ put tracer
# Stamp order of one traced `ray_tpu_torch.put`, API entry to API return.  The
# arena path stamps every stage; the inline path stops at owner_reg_done
# (no arena involved); the RPC fallback stamps store_rpc_done instead of
# alloc/copy/seal.  Like the hop tracer: opt-in, one call at a time, zero
# cost when disarmed (one `is not None` check per put).
PUT_ORDER = (
    "put_entry",        # put_object entry on the caller thread
    "serialize_done",   # value pickled (out-of-band buffers captured)
    "owner_reg_done",   # owner record + contained-ref pins registered
    "alloc_done",       # arena block allocated (mutex wait included)
    "copy_done",        # frame bytes copied into the arena
    "seal_done",        # object sealed (visible to readers)
    "store_rpc_done",   # RPC fallback: agent store_put round trip done
    "put_done",         # put_object returned (memory-store publication)
)

_put_armed: bool = False
_put_last: dict | None = None


def arm_put_trace() -> None:
    """One-shot: trace the next `ray_tpu_torch.put` in this process."""
    global _put_armed
    _put_armed = True


def consume_put_arm() -> dict | None:
    """Claim the armed put trace (called by worker.put_object)."""
    global _put_armed
    if not _put_armed:
        return None
    _put_armed = False
    return {"put_entry": time.monotonic()}


def publish_put_trace(rec: dict) -> None:
    global _put_last
    _put_last = dict(rec)
    # Flight-recorder bridge: the armed put breakdown also lands in the
    # merged timeline (arena.put_stages + per-stage children), not only
    # in this driver-local slot.
    try:
        from ray_tpu_torch._private import spans

        if spans.ENABLED:
            spans.emit_stamps(
                "arena.put_stages", rec, PUT_ORDER,
                attrs={k: rec[k] for k in ("path", "bytes")
                       if k in rec})
    except Exception:  # noqa: BLE001 - tracing must never fail a put
        pass


def take_put_trace() -> dict | None:
    """The most recent completed put trace, cleared on read."""
    global _put_last
    trace, _put_last = _put_last, None
    return trace


@contextmanager
def put_trace():
    """Trace ONE put's per-stage latency:

        with profiling.put_trace() as rec:
            ref = ray_tpu_torch.put(big_array)
        table = profiling.put_breakdown_us(rec)

    The yielded dict gains "stages" (raw monotonic stamps plus path
    metadata) when the block exits; feed it to `put_breakdown_us`."""
    global _put_armed
    rec: dict = {}
    arm_put_trace()
    try:
        yield rec
    finally:
        rec["stages"] = take_put_trace()
        _put_armed = False


def put_breakdown_us(rec: dict) -> dict:
    """Per-stage latency table (microseconds between consecutive observed
    stamps, in PUT_ORDER) for a completed `put_trace` record, plus path
    metadata ("path", "bytes", "stream", "parallel_chunks") and the copy
    stage's effective bandwidth.  Empty when no put fired."""
    stages = dict(rec.get("stages") or {})
    if not stages:
        return {}
    present = [(k, stages[k]) for k in PUT_ORDER if k in stages]
    if len(present) < 2:
        return {}
    out: dict = {}
    prev_name, prev_t = present[0]
    for name, t in present[1:]:
        out[f"{prev_name}->{name}_us"] = round((t - prev_t) * 1e6, 1)
        prev_name, prev_t = name, t
    out["total_us"] = round((present[-1][1] - present[0][1]) * 1e6, 1)
    for key in ("path", "bytes", "stream", "parallel_chunks"):
        if key in stages:
            out[key] = stages[key]
    copy_us = out.get("alloc_done->copy_done_us")
    if copy_us and stages.get("bytes"):
        out["copy_gib_per_s"] = round(
            stages["bytes"] / (copy_us / 1e6) / (1 << 30), 2)
    return out


# ----------------------------------------------------- collective tracer
# Per-collective phase and byte accounting, as the hop and put tracers:
# opt-in, one collective at a time per process, one `is not None` check
# per collective when disarmed.  A collective's phases REPEAT per hop
# (send/pull/reduce x (world-1) steps x pipeline chunks), so the record
# carries accumulated durations and byte counters, not a stamp order:
#
#   schedule      "ring" | "tree"
#   op/bytes/world/rank/seq   what ran
#   sent_bytes    payload bytes this rank put or deposited (a ring
#                 allreduce's is 2*N*(world-1)/world)
#   recv_bytes    payload bytes this rank pulled or took
#   send_us/pull_us/reduce_us/wait_us   accumulated phase time; pulls run
#                 on the prefetch pool, so the sums can exceed total_us
#   hops          transport steps this rank took
COLLECTIVE_PHASES = ("send_us", "pull_us", "reduce_us", "wait_us")

_collective_armed: bool = False
_collective_last: dict | None = None


def arm_collective_trace() -> None:
    """One-shot: trace the next collective op in this process."""
    global _collective_armed
    _collective_armed = True


def blank_collective_rec() -> dict:
    """A live phase-accumulator record (the consume_collective_arm
    shape), which the always-on per-op collective spans hand to the
    schedules when no one-shot trace is armed."""
    return {"t0": time.monotonic(), "sent_bytes": 0, "recv_bytes": 0,
            "send_us": 0.0, "pull_us": 0.0, "reduce_us": 0.0,
            "wait_us": 0.0, "hops": 0}


def consume_collective_arm() -> dict | None:
    """Claim the armed trace (the collective module calls it at op
    entry); returns a live record the schedule mutates in place."""
    global _collective_armed
    if not _collective_armed:
        return None
    _collective_armed = False
    return blank_collective_rec()


def publish_collective_trace(rec: dict) -> None:
    global _collective_last
    rec["total_us"] = round((time.monotonic() - rec.pop("t0")) * 1e6, 1)
    _collective_last = dict(rec)
    # The armed record also lands in the merged timeline.
    try:
        from ray_tpu_torch._private import spans

        if spans.ENABLED:
            t1 = time.time()
            spans.emit(
                "collective.trace", t1 - rec["total_us"] / 1e6, t1,
                attrs={k: rec[k] for k in
                       ("schedule", "op", "bytes", "world", "rank",
                        "hops", "sent_bytes", "recv_bytes", "send_us",
                        "pull_us", "reduce_us", "wait_us") if k in rec})
    except Exception:  # noqa: BLE001 - tracing must never fail an op
        pass


def take_collective_trace() -> dict | None:
    """The most recent completed collective trace, cleared on read."""
    global _collective_last
    trace, _collective_last = _collective_last, None
    return trace


@contextmanager
def collective_trace():
    """Trace ONE collective's phase and byte breakdown:

        with profiling.collective_trace() as rec:
            collective.allreduce(x, group_name="g")
        table = profiling.collective_breakdown_us(rec)

    The yielded dict gains "phases" when the block exits; feed it to
    `collective_breakdown_us`."""
    global _collective_armed
    rec: dict = {}
    arm_collective_trace()
    try:
        yield rec
    finally:
        rec["phases"] = take_collective_trace()
        _collective_armed = False


def collective_breakdown_us(rec: dict) -> dict:
    """Flat phase table of a completed `collective_trace` record:
    accumulated microseconds per phase, the byte counters and the
    schedule.  Empty when no collective fired."""
    phases = dict(rec.get("phases") or {})
    if not phases:
        return {}
    out: dict = {}
    for key in ("schedule", "op", "bytes", "world", "rank", "hops",
                "sent_bytes", "recv_bytes"):
        if key in phases:
            out[key] = phases[key]
    for key in COLLECTIVE_PHASES:
        if phases.get(key):
            out[key] = round(phases[key], 1)
    if "total_us" in phases:
        out["total_us"] = phases["total_us"]
        if phases.get("bytes"):
            out["gib_per_s"] = round(
                phases["bytes"] / (phases["total_us"] / 1e6) / (1 << 30),
                3)
    return out


@contextmanager
def profile(event_name: str, extra_data: dict | None = None):
    """Record a named span attributed to the current task (or the driver).

    with ray_tpu_torch.profiling.profile("shuffle-partition"):
        ...
    """
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    owner = core.current_task_id or "driver"
    name = event_name if not extra_data else \
        f"{event_name} {extra_data}"
    core._record_event(owner, "PROFILE_BEGIN", name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        core._record_event(
            owner, "PROFILE_END",
            f"{name} ({(time.perf_counter() - t0) * 1e3:.2f}ms)")
