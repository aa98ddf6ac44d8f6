"""Public face of the cluster flight recorder (port of ray_tpu/tracing.py).

Library layers (serve, train, rl, collective) build only on core
primitives and public surfaces, never on runtime internals: this module
is the public surface for recording spans in library code and for
harvesting the cluster's buffers into one connected timeline.  See
`ray_tpu_torch/_private/spans.py` for the recorder and the
``RAY_TPU_TORCH_TRACE`` / ``RAY_TPU_TORCH_TRACE_BUFFER`` env knobs.

Instrumentation:

    from ray_tpu_torch import tracing

    if tracing.ENABLED:
        with tracing.span("my.stage", attrs={"bytes": n}) as sp:
            ...
            sp["replica"] = rid

Harvest / export (driver-side):

    spans = tracing.harvest()              # every process's buffer
    trees = tracing.trace_trees(spans)     # trace_id -> connected tree
    tracing.export_chrome_file("/tmp/t.json", spans)
    tracing.export_otlp_file("/tmp/o.json", spans)

The reference's `export_otlp_http` (a POST to a collector) is not ported:
the export documents are written to files.
"""
from __future__ import annotations

from ray_tpu_torch._private import spans as _impl

# Recorder surface.
span = _impl.span
context = _impl.context
emit = _impl.emit
current = _impl.current
capture = _impl.capture


def __getattr__(name):
    # ENABLED is a mutable module flag: read it live off the
    # implementation module (an import-time snapshot would never flip),
    # as the recorder's other names (set_enabled, snapshot, stats, ...).
    return getattr(_impl, name)


# ------------------------------------------------------------- harvest
def harvest(trace_id: str | None = None, clear_buffers: bool = False,
            timeout: float = 20.0, with_diagnostics: bool = False):
    """Collect every process's span buffer — this process's directly,
    the cluster's through the controller's `spans` verb (the same
    controller→agents→workers broadcast fan-out as the failpoints
    verb) — and return one flat span list, each record annotated with
    the owning process's label.

    With ``with_diagnostics=True``, returns ``(spans, diagnostics)``
    where diagnostics carries each process's ring stats — above all
    the per-process `dropped` count (ring overwrites): a 4096-slot
    ring wrapped under sustained serve load must read as TRUNCATED,
    never as a silently partial tree — plus any fan-out legs that
    failed to reply (`errors`)."""
    merged: list[dict] = []
    seen: set = set()
    procs: list[dict] = []
    errors: list[str] = []

    def _take(reply) -> None:
        # In-process topologies (cluster_utils: driver, agents and the
        # controller can share one interpreter) return the SAME ring
        # through several fan-out legs — dedupe by the process's boot
        # token (falling back to pid for older replies; bare pid alone
        # collides across hosts, where every container starts at low
        # pids).
        if not isinstance(reply, dict) or "spans" not in reply:
            if isinstance(reply, dict) and reply.get("error"):
                errors.append(str(reply["error"]))
            return
        key = reply.get("boot") or reply.get("pid")
        if key in seen:
            return
        seen.add(key)
        proc = reply.get("proc", "?")
        procs.append({"proc": proc, "pid": reply.get("pid"),
                      "dropped": reply.get("dropped", 0),
                      "emitted": reply.get("emitted", 0),
                      "buffered": reply.get("buffered", 0),
                      "capacity": reply.get("capacity", 0)})
        for rec in reply.get("spans", ()):
            if trace_id and rec.get("tid") != trace_id:
                continue
            merged.append({**rec, "proc": proc})

    _take(_impl.control({"op": "collect", "trace_id": trace_id,
                         "clear": clear_buffers}))
    try:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        reply, _ = w.call(w.controller_addr, "spans",
                          {"op": "collect", "broadcast": True,
                           "trace_id": trace_id,
                           "clear": clear_buffers},
                          timeout=timeout)
    except Exception as e:  # noqa: BLE001 - no cluster: local buffer only
        errors.append(f"controller: {e!r}")
        reply = {}
    _take(reply)
    for node in (reply.get("nodes") or {}).values():
        if not isinstance(node, dict):
            continue
        _take(node)
        for wrep in (node.get("workers") or {}).values():
            _take(wrep)
    for drep in (reply.get("drivers") or {}).values():
        # Other jobs' drivers hold the spans that ROOT their serve
        # requests; a confirmed-gone driver is no data, not a hole.
        if isinstance(drep, dict) and drep.get("gone"):
            continue
        _take(drep)
    merged.sort(key=lambda r: r.get("t0", 0.0))
    if with_diagnostics:
        dropped = sum(p["dropped"] for p in procs)
        return merged, {"procs": procs, "errors": errors,
                        "dropped_total": dropped,
                        # A wrapped ring anywhere means parent links may
                        # be gone: trees built from this harvest can be
                        # partial for a reason the data itself shows.
                        "truncated": dropped > 0 or bool(errors)}
    return merged


def traces(spans_list: list[dict]) -> dict[str, list[dict]]:
    """Group a harvested span list by trace_id (insertion keeps t0
    order from harvest)."""
    out: dict[str, list[dict]] = {}
    for rec in spans_list:
        out.setdefault(rec["tid"], []).append(rec)
    return out


def trace_trees(spans_list: list[dict]) -> dict[str, list[dict]]:
    """trace_id -> list of root span nodes, each
    {"span": rec, "children": [...]} — the connected per-request tree.
    A span whose parent is missing from the harvest (overwritten ring
    slot, dead process) becomes a root rather than vanishing."""
    out: dict[str, list[dict]] = {}
    for tid, recs in traces(spans_list).items():
        nodes = {r["sid"]: {"span": r, "children": []} for r in recs}
        roots = []
        for r in recs:
            node = nodes[r["sid"]]
            parent = nodes.get(r.get("par") or "")
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        out[tid] = roots
    return out


def connected(spans_list: list[dict], trace_id: str) -> bool:
    """True when the trace forms ONE tree: a single root every other
    span reaches through parent links (the acceptance shape for a
    disaggregated serve request)."""
    trees = trace_trees(spans_list).get(trace_id, [])
    return len(trees) == 1


# ---------------------------------------------------- critical path
def critical_path(tree: dict, until: float | None = None) -> list[dict]:
    """The blocking chain through one request tree (a
    `trace_trees` node): the root's wall interval partitioned into
    chronological segments, each attributed to the DEEPEST span that
    was the last thing still running at that moment — "what was p99
    TTFT actually waiting on."  Works across process boundaries for
    free: child spans recorded in other processes hang off the same
    parent links (PD-disagg's router → prefill → decode included).
    `until` overrides the analyzed window's end (e.g. the first-token
    time for a TTFT-only decomposition): it may CLAMP the window or
    EXTEND it past the root's own close — a root that closes at
    handoff (a submit wrapper, a dispatch span) still umbrellas the
    work its descendants finish later, so the root counts as active
    over the whole analyzed window.

    Attribution rule: at every instant of the root's interval, the
    DEEPEST span active at that instant owns the time (ties between
    siblings go to the later starter — "what was running now", not
    "what started first"); instants no descendant covers are the
    owning span's self time.  Crucially, a child's interval is NOT
    clipped to its parent's — dispatch spans (serve.route, an RPC
    send) close at handoff while the handler they started keeps
    running, so interval nesting does not hold across hops.  Segment
    durations sum exactly to the root's duration by construction —
    the invariant the e2e test pins against observed wall time.

    Returns [{"name", "proc", "sid", "t0", "t1", "ms", "depth"}...]
    time-sorted, adjacent same-span segments merged."""
    root = tree["span"]
    lo = root["t0"]
    hi = root["t1"] if until is None else until
    if hi <= lo:
        return []
    # (depth, tree order, effective end, rec) for every span in the
    # tree.  The ROOT's effective end is the window end — it umbrellas
    # the whole request even when its own record closed at handoff.
    # Request trees are tens of spans; the O(points x spans) sweep is
    # noise.
    nodes: list[tuple[int, int, float, dict]] = []

    def _collect(node: dict, depth: int) -> None:
        rec = node["span"]
        eff_t1 = hi if not nodes else rec["t1"]
        nodes.append((depth, len(nodes), eff_t1, rec))
        for c in node["children"]:
            _collect(c, depth + 1)

    _collect(tree, 0)
    points = {lo, hi}
    for _d, _o, eff_t1, rec in nodes:
        for t in (rec["t0"], eff_t1):
            if lo < t < hi:
                points.add(t)
    bounds = sorted(points)
    segs: list[dict] = []
    for a, b in zip(bounds, bounds[1:]):
        best = None
        for depth, order, eff_t1, rec in nodes:
            if rec["t0"] <= a and eff_t1 >= b:
                key = (depth, rec["t0"], order)
                if best is None or key > best[0]:
                    best = (key, depth, rec)
        # The root covers the whole window by construction, so best is
        # never None.
        _key, depth, rec = best
        if segs and segs[-1]["sid"] == rec["sid"] \
                and segs[-1]["t1"] == a:
            segs[-1]["t1"] = b
            segs[-1]["ms"] = (b - segs[-1]["t0"]) * 1000.0
        else:
            segs.append({"name": rec["name"],
                         "proc": rec.get("proc", "?"),
                         "sid": rec["sid"], "t0": a, "t1": b,
                         "ms": (b - a) * 1000.0, "depth": depth})
    return segs


def _pct(sorted_vals: list[float], q: float) -> float:
    from ray_tpu_torch.utils.metrics import percentile

    return percentile(sorted_vals, q)


def _tree_end(node: dict) -> float:
    """The umbrella end of a tree: the max t1 over every span.  A root
    that closes at handoff (a submit wrapper, a dispatch span) still
    owns the work its descendants finish later — ranking or
    attributing by the root's own t1 would report such a request as
    sub-millisecond (see the critical_path non-nesting note)."""
    end = node["span"]["t1"]
    for c in node["children"]:
        end = max(end, _tree_end(c))
    return end


def attribution(trees: dict[str, list[dict]]) -> dict:
    """Aggregate the critical paths of many request trees into a
    per-stage latency decomposition — the "p99 TTFT = queue 41% /
    prefill 33% / kv_pull 19%" answer.  Only CONNECTED traces (one
    root) contribute: a fragmented tree's chain would attribute hidden
    time to the wrong stage.

    Returns {"requests", "skipped_disconnected",
             "total_ms": {"p50","p99"},
             "stages": {name: {"p50_ms","p99_ms","share_pct",
                               "count"}}} with stage shares summing to
    ~100 (share = the stage's critical-path time across all requests
    over all requests' total time)."""
    per_stage: dict[str, list[float]] = {}
    totals: list[float] = []
    skipped = 0
    for _tid, roots in trees.items():
        if len(roots) != 1:
            skipped += 1
            continue
        path = critical_path(roots[0], until=_tree_end(roots[0]))
        if not path:
            skipped += 1
            continue
        by_stage: dict[str, float] = {}
        for seg in path:
            by_stage[seg["name"]] = by_stage.get(seg["name"], 0.0) \
                + seg["ms"]
        for name, ms in by_stage.items():
            per_stage.setdefault(name, []).append(ms)
        totals.append(sum(by_stage.values()))
    grand = sum(totals)
    stages = {}
    for name, vals in per_stage.items():
        vals.sort()
        stages[name] = {
            "p50_ms": round(_pct(vals, 0.50), 3),
            "p99_ms": round(_pct(vals, 0.99), 3),
            "share_pct": round(100.0 * sum(vals) / grand, 1)
            if grand > 0 else 0.0,
            "count": len(vals),
        }
    totals.sort()
    return {"requests": len(totals),
            "skipped_disconnected": skipped,
            "total_ms": {"p50": round(_pct(totals, 0.50), 3),
                         "p99": round(_pct(totals, 0.99), 3)},
            "stages": dict(sorted(
                stages.items(),
                key=lambda kv: -kv[1]["share_pct"]))}


def slowest(trees: dict[str, list[dict]], n: int = 10,
            prefix: str | None = None) -> list[dict]:
    """The N worst connected requests by UMBRELLA duration (root start
    → last descendant end — a handoff-closed root must not rank its
    request as sub-millisecond), each with its critical path — the
    reference's `ray-tpu slow` row shape.  `prefix` filters on the
    root span's name (e.g. "serve.").  Paths are computed only for the
    surviving N — a busy harvest holds hundreds of task-rooted trees
    whose sweeps would otherwise be discarded."""
    rows = []
    for tid, roots in trees.items():
        if len(roots) != 1:
            continue
        root = roots[0]["span"]
        if prefix and not root["name"].startswith(prefix):
            continue
        end = _tree_end(roots[0])
        rows.append({
            "trace_id": tid, "name": root["name"],
            "proc": root.get("proc", "?"),
            "ms": round((end - root["t0"]) * 1000.0, 3),
            "t0": root["t0"], "_tree": roots[0], "_end": end,
        })
    rows.sort(key=lambda r: -r["ms"])
    rows = rows[:n]
    for r in rows:
        r["path"] = critical_path(r.pop("_tree"), until=r.pop("_end"))
    return rows


# -------------------------------------------------------------- export
def chrome_trace(spans_list: list[dict]) -> dict:
    """Chrome trace JSON (the chrome://tracing "traceEvents" shape, the
    same document family as /api/v0/timeline): one complete ("X") event
    per span, grouped by process."""
    events = []
    for r in spans_list:
        events.append({
            "name": r["name"], "ph": "X", "cat": "raytpu",
            "ts": r["t0"] * 1e6,
            "dur": max(0.0, (r["t1"] - r["t0"]) * 1e6),
            "pid": r.get("proc", r.get("pid", 0)),
            "tid": r["tid"][:16],
            "args": {**r.get("attrs", {}), "trace_id": r["tid"],
                     "span_id": r["sid"], "parent": r.get("par", "")},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def otlp_document(spans_list: list[dict],
                  service_name: str = "ray_tpu_torch") -> dict:
    """OTLP/JSON export (the `resourceSpans` envelope of
    utils/tracing.py, fed from recorder spans instead of task events).
    The document is the reference's with the port's names
    ("ray_tpu_torch" where the reference says "ray_tpu")."""
    from ray_tpu_torch.utils import tracing as _ut

    return _ut.otlp_from_recorder(spans_list, service_name)


def export_chrome_file(path: str,
                       spans_list: list[dict] | None = None) -> int:
    import json

    if spans_list is None:
        spans_list = harvest()
    doc = chrome_trace(spans_list)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


def export_otlp_file(path: str,
                     spans_list: list[dict] | None = None,
                     service_name: str = "ray_tpu_torch") -> int:
    import json

    if spans_list is None:
        spans_list = harvest()
    doc = otlp_document(spans_list, service_name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["resourceSpans"][0]["scopeSpans"][0]["spans"])
