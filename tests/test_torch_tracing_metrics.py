"""The tracing and metric faces of the port (ray_tpu_torch/tracing.py,
ray_tpu_torch/utils/tracing.py, ray_tpu_torch/utils/metrics.py), on the
CPU.

Against the reference, with no cluster: on one fixed span list the port's
`trace_trees`, `connected`, `critical_path`, `attribution`, `slowest`,
`chrome_trace` and `otlp_document` equal `ray_tpu.tracing`'s, and for one
sequence of calls the port's metric snapshots, of the process registry
and of a LocalRuntime recorder's, equal
`ray_tpu.utils.metrics.registry_snapshots()`'s.  (The OTLP document is
compared with the reference's names put in the port's namespace:
"ray_tpu_torch" for "ray_tpu".)

On one cluster of the port, booted for the module and shut down after
it (every get and wait has a deadline of 60 s or less): a span opened in
the driver and continued in a task and in an actor comes back connected
from `harvest()`, and a counter an actor increments through
`ClusterRuntime`'s metric face reaches the controller's KV."""
import json
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import tracing
from ray_tpu_torch.utils import metrics as um

T = 60.0


def _span(tid, sid, par, name, t0, t1, proc, **attrs):
    return {"tid": tid, "sid": sid, "par": par, "name": name, "t0": t0,
            "t1": t1, "pid": 7, "proc": proc, "attrs": attrs}


# Two requests: a router hop that closes at handoff (its children run on
# past it), a task span recorded in another process, and a trace whose
# parent was lost (two roots).
SPANS = [
    _span("a" * 16, "01", "", "serve.request", 100.0, 100.9, "driver",
          route="/gen"),
    _span("a" * 16, "02", "01", "serve.route", 100.05, 100.1, "driver",
          replica=2),
    _span("a" * 16, "03", "02", "serve.prefill", 100.1, 100.6, "worker:1",
          tokens=384, ok=True),
    _span("a" * 16, "04", "03", "kv.pull", 100.2, 100.35, "worker:1",
          bytes=1 << 20, ratio=0.5),
    _span("a" * 16, "05", "01", "serve.decode", 100.6, 101.4, "worker:2",
          error="TimeoutError"),
    _span("b" * 16, "11", "", "rl.weight_sync", 200.0, 200.5, "driver",
          version=3, mode="remote_learner"),
    _span("b" * 16, "12", "11", "collective.broadcast:0", 200.1, 200.45,
          "worker:3", schedule="tree", sent_bytes=889292800),
    _span("c" * 16, "21", "zz", "orphan", 300.0, 300.2, "worker:4"),
    _span("c" * 16, "22", "", "root", 300.1, 300.3, "driver"),
]


def test_tree_functions_equal_reference():
    from ray_tpu import tracing as ref

    spans = [dict(s) for s in SPANS]
    trees = tracing.trace_trees(spans)
    assert trees == ref.trace_trees(spans)
    assert [tracing.connected(spans, t) for t in ("a" * 16, "b" * 16,
                                                  "c" * 16)] == \
        [ref.connected(spans, t) for t in ("a" * 16, "b" * 16,
                                           "c" * 16)] == [True, True, False]
    root = trees["a" * 16][0]
    for until in (None, 100.5, 101.4):
        assert tracing.critical_path(root, until) == \
            ref.critical_path(root, until)
    assert tracing.attribution(trees) == ref.attribution(trees)
    assert tracing.slowest(trees, 2) == ref.slowest(trees, 2)
    assert tracing.slowest(trees, prefix="rl.") == \
        ref.slowest(trees, prefix="rl.")
    assert tracing.traces(spans) == ref.traces(spans)
    assert tracing.chrome_trace(spans) == ref.chrome_trace(spans)
    # The OTLP document is the reference's with the port's names.
    assert tracing.otlp_document(spans) == _renamed(
        ref.otlp_document(spans, "ray_tpu_torch"))
    assert tracing.otlp_document(spans, "svc") == _renamed(
        ref.otlp_document(spans, "svc"))
    assert '"ray_tpu_torch.proc"' in json.dumps(tracing.otlp_document(spans))


def _renamed(doc: dict) -> dict:
    """`doc` with its "ray_tpu." names (attribute keys, the SDK and scope
    names) in the port's namespace."""
    return json.loads(json.dumps(doc).replace('"ray_tpu.',
                                              '"ray_tpu_torch.'))


def test_file_exports(tmp_path):
    spans = [dict(s) for s in SPANS]
    n = tracing.export_chrome_file(str(tmp_path / "c.json"), spans)
    assert n == len(SPANS) == len(json.loads(
        (tmp_path / "c.json").read_text())["traceEvents"])
    n = tracing.export_otlp_file(str(tmp_path / "o.json"), spans)
    doc = json.loads((tmp_path / "o.json").read_text())
    assert n == len(doc["resourceSpans"][0]["scopeSpans"][0]["spans"])
    assert not hasattr(tracing, "export_otlp_http")


def _drive(mod, prefix):
    """One sequence of calls on a metrics module; returns its snapshots
    of the metrics it made."""
    c = mod.get_or_create(mod.Counter, f"{prefix}_c", "a counter",
                          ("worker",))
    c.inc(2.0, {"worker": "w0"})
    c.inc(tags={"worker": "w1"})
    assert mod.get_or_create(mod.Counter, f"{prefix}_c") is c
    g = mod.Gauge(f"{prefix}_g", "a gauge", tag_keys=("k",))
    g.set_default_tags({"k": "d"})
    g.set(0.25)
    g.set(3, {"k": "x"})
    h = mod.Histogram(f"{prefix}_h", "a histogram",
                      boundaries=[1.0, 0.1, 10.0], tag_keys=("op",))
    for v in (0.05, 0.5, 5.0, 50.0, 0.1):
        h.observe(v, {"op": "sum"})
    h.observe(2.0, {"op": "max"})
    h.remove({"op": "max"})
    with pytest.raises(ValueError):
        c.inc(-1.0)
    with pytest.raises(ValueError):
        c.inc(tags={"nope": "x"})
    with pytest.raises(TypeError):
        mod.get_or_create(mod.Gauge, f"{prefix}_c")
    names = {f"{prefix}_c", f"{prefix}_g", f"{prefix}_h"}
    return sorted((s for s in mod.registry_snapshots()
                   if s["name"] in names), key=lambda s: s["name"])


def test_metric_snapshots_equal_reference():
    from ray_tpu.utils import metrics as ref

    prefix = f"tm_{time.time_ns()}"
    got = _drive(um, prefix)
    want = _drive(ref, prefix)
    assert len(got) == 3 and got == want
    assert [um.percentile(v, q) for v, q in (([], 0.5), ([1, 2, 3], 0.5),
                                             ([1, 2, 3], 0.99))] == \
        [ref.percentile(v, q) for v, q in (([], 0.5), ([1, 2, 3], 0.5),
                                           ([1, 2, 3], 0.99))]


def test_recorder_metrics_equal_reference():
    """LocalRuntime's recorder keeps the same metric classes in a registry
    of its own: the same calls through its `metric` face give the
    reference's snapshots, and none of them reaches the process
    registry that the flush loop walks."""
    from ray_tpu.utils import metrics as ref
    from ray_tpu_torch.serve.runtime import LocalRuntime

    prefix = f"tr_{time.time_ns()}"

    def drive(make):
        c = make("counter", f"{prefix}_c", "a counter", ("worker",))
        c.inc(2.0, {"worker": "w0"})
        c.inc(tags={"worker": "w1"})
        assert make("counter", f"{prefix}_c") is c
        g = make("gauge", f"{prefix}_g", "a gauge", ("k",))
        g.set(0.25)
        g.set(3, {"k": "x"})
        h = make("histogram", f"{prefix}_h", "a histogram", ("op",),
                 [1.0, 0.1, 10.0])
        for v in (0.05, 0.5, 5.0, 50.0, 0.1):
            h.observe(v, {"op": "sum"})
        with pytest.raises(TypeError):
            make("gauge", f"{prefix}_c")

    def ref_make(kind, name, description="", tag_keys=(), boundaries=None):
        cls = {"counter": ref.Counter, "gauge": ref.Gauge,
               "histogram": ref.Histogram}[kind]
        kw = {"boundaries": boundaries} if kind == "histogram" else {}
        return ref.get_or_create(cls, name, description, tag_keys, **kw)

    rt = LocalRuntime()
    drive(rt.metric)
    drive(ref_make)
    with pytest.raises(ValueError):
        rt.metric("summary", f"{prefix}_s")
    want = {s["name"]: s for s in ref.registry_snapshots()
            if s["name"].startswith(prefix)}
    assert len(want) == 3 and rt.recorder.metrics() == want
    assert not [s for s in um.registry_snapshots()
                if s["name"].startswith(prefix)]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(resources={"CPU": 4})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def test_span_continues_in_task_and_actor(cluster):
    """A span opened in the driver parents the spans recorded inside a
    task and an actor method (each in a worker process); the harvest
    brings every process's spans back as one connected tree."""
    @cluster.remote
    def child():
        from ray_tpu_torch import tracing as tr

        with tr.span("t.task_work", attrs={"n": 1}):
            return tr.current()[0]

    class Traced:
        def work(self):
            from ray_tpu_torch.serve.runtime import ClusterRuntime

            rt = ClusterRuntime()
            assert rt.tracing_enabled()
            with rt.span("t.actor_work", attrs={"k": "v"}) as sp:
                sp["seen"] = True
                rt.emit("t.actor_emit", time.time() - 0.01)
                return rt.trace_current()[0]

    actor = cluster.remote(Traced).options(num_cpus=0.5).remote()
    try:
        with tracing.span("t.driver_root") as sp:
            tid = tracing.current()[0]
            sp["driver"] = True
            in_task = cluster.get(child.remote(), timeout=T)
            in_actor = cluster.get(actor.work.remote(), timeout=T)
        assert in_task == in_actor == tid
        spans, diag = tracing.harvest(trace_id=tid, timeout=T,
                                      with_diagnostics=True)
        names = {s["name"] for s in spans}
        assert {"t.driver_root", "t.task_work", "t.actor_work",
                "t.actor_emit"} <= names, names
        assert len({s["proc"] for s in spans}) >= 3
        assert tracing.connected(spans, tid), spans
        (root,) = tracing.trace_trees(spans)[tid]
        assert root["span"]["name"] == "t.driver_root"
        work = [s for s in spans if s["name"] == "t.actor_work"]
        assert work[0]["attrs"] == {"k": "v", "seen": True}
        assert not diag["errors"]
    finally:
        cluster.kill(actor)


def test_counter_flushed_from_actor_reaches_controller_kv(cluster):
    class Counting:
        def count(self, n):
            import ray_tpu_torch as _rt
            from ray_tpu_torch.serve.runtime import ClusterRuntime

            c = ClusterRuntime().metric("counter", "t_actor_steps",
                                        "steps counted", ("who",))
            c.inc(n, {"who": "a"})
            ClusterRuntime().metric("histogram", "t_actor_ms", "",
                                    (), boundaries=[1.0]).observe(0.5)
            return _rt.get_runtime_context().get_worker_id()

    from ray_tpu_torch._private.worker import global_worker

    actor = cluster.remote(Counting).options(num_cpus=0.5).remote()
    try:
        wid = cluster.get(actor.count.remote(3.0), timeout=T)
        cluster.get(actor.count.remote(4.0), timeout=T)
        core = global_worker()
        deadline = time.monotonic() + 20.0
        snap = None
        while time.monotonic() < deadline:
            reply, blobs = core.call(core.controller_addr, "kv_get",
                                     {"ns": "metrics", "key": wid},
                                     timeout=T)
            if reply["found"]:
                snap = {m["name"]: m for m in
                        json.loads(bytes(blobs[0]))["metrics"]}
                if "t_actor_steps" in snap and \
                        snap["t_actor_steps"]["values"][0]["value"] == 7.0:
                    break
            time.sleep(0.25)
        assert snap is not None, "no flush reached the controller's KV"
        assert snap["t_actor_steps"]["values"] == [
            {"tags": {"who": "a"}, "value": 7.0}]
        assert snap["t_actor_steps"]["type"] == "counter"
        assert snap["t_actor_ms"]["counts"] == [{"tags": {},
                                                 "counts": [2, 0]}]
    finally:
        cluster.kill(actor)
