"""The port's core runtime (ray_tpu_torch: `_private/`, `api.py`) on the
CPU.

One cluster of the port boots for the module (`ray_tpu_torch.init(
resources={"CPU": 4, "GPU": 1})`: its controller, node agent, plain
workers and device worker are processes of their own) and is shut down
at the module's end.  Every get and wait has a timeout: the reference
tests run against `_Port`, which is `ray_tpu_torch` with a default
timeout on `get` and `wait`.

- The reference's own test functions of tests/test_core_tasks.py and
  tests/test_actor.py run against the port, each called with the port as
  its `ray_shared`.  Seven of them import `ray_tpu` inside a task or
  reach its internals (two check `ray_tpu.object_ref.ObjectRefGenerator`);
  each has a rewrite here on `ray_tpu_torch`, named in its docstring.
- The process layout: the controller, the agent, a plain worker and the
  device worker load no jax, ray_tpu, zmq, msgpack, cloudpickle or
  psutil; plain workers see CUDA_VISIBLE_DEVICES == ""; `num_gpus`
  actors share the device worker's pid.
- Tensors cross processes bitwise, with dtype and shape, in a plain
  worker and in the device worker.
- `num_gpus=1` on a node with no GPU parks as `num_tpus=1` does on a
  chipless ray_tpu node (the same scenario on both runtimes)."""
import inspect

import numpy as np
import pytest
import torch

import ray_tpu_torch
import test_actor as _ref_actor
import test_core_tasks as _ref_tasks

T = 60.0
FORBIDDEN = {"jax", "jaxlib", "ray_tpu", "zmq", "msgpack", "cloudpickle",
             "psutil"}

# Reference tests that import ray_tpu inside a task or reach its
# internals: each is rewritten below on ray_tpu_torch.
REWRITTEN = {"test_nested_tasks", "test_invalid_option",
             "test_runtime_context", "test_handle_passing",
             "test_retransmitted_call_does_not_reexecute",
             "test_dynamic_generator_returns",
             "test_dynamic_generator_empty_and_nongen"}


class _Port:
    """ray_tpu_torch, with a default timeout on every get and wait."""

    def __getattr__(self, name):
        return getattr(ray_tpu_torch, name)

    def get(self, refs, *, timeout=None):
        return ray_tpu_torch.get(refs, timeout=T if timeout is None
                                 else timeout)

    def wait(self, refs, *, num_returns=1, timeout=None, fetch_local=True):
        return ray_tpu_torch.wait(refs, num_returns=num_returns,
                                  timeout=T if timeout is None else timeout)


@pytest.fixture(scope="module")
def port():
    ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    try:
        yield _Port()
    finally:
        ray_tpu_torch.shutdown()


def _reference_tests(module) -> list:
    return [pytest.param(fn, id=name)
            for name, fn in inspect.getmembers(module, inspect.isfunction)
            if name.startswith("test_") and name not in REWRITTEN]


@pytest.mark.parametrize("ref_test", _reference_tests(_ref_tasks))
def test_reference_core_task(port, ref_test):
    ref_test(port)


@pytest.mark.parametrize("ref_test", _reference_tests(_ref_actor))
def test_reference_actor(port, ref_test):
    ref_test(port)


# ------------------------------------------------------------ rewrites
def test_nested_tasks(port):
    """Rewrite of tests/test_core_tasks.py::test_nested_tasks: the outer
    task imports ray_tpu_torch, not ray_tpu."""
    @port.remote
    def inner(x):
        return x * 2

    @port.remote
    def outer(x):
        import ray_tpu_torch as rt
        return rt.get(inner.remote(x), timeout=60.0) + 1

    assert port.get(outer.remote(5)) == 11


def test_invalid_option():
    """Rewrite of tests/test_core_tasks.py::test_invalid_option on
    ray_tpu_torch.remote."""
    with pytest.raises(ValueError):
        @ray_tpu_torch.remote(bogus_option=1)
        def f():
            pass


def test_runtime_context(port):
    """Rewrite of tests/test_core_tasks.py::test_runtime_context: the task
    reads ray_tpu_torch.get_runtime_context()."""
    @port.remote
    def ctx():
        import ray_tpu_torch as rt
        c = rt.get_runtime_context()
        return c.worker_id, c.task_id

    wid, tid = port.get(ctx.remote())
    assert wid and tid


def test_handle_passing(port):
    """Rewrite of tests/test_actor.py::test_handle_passing: the task that
    receives the handle imports ray_tpu_torch."""
    @port.remote
    class Store:
        def __init__(self):
            self.v = 0

        def set(self, v):
            self.v = v

        def get(self):
            return self.v

    @port.remote
    def writer(handle, v):
        import ray_tpu_torch as rt
        rt.get(handle.set.remote(v), timeout=60.0)
        return True

    s = Store.remote()
    assert port.get(writer.remote(s, 42))
    assert port.get(s.get.remote()) == 42


def test_retransmitted_call_does_not_reexecute(port):
    """Rewrite of tests/test_actor.py::
    test_retransmitted_call_does_not_reexecute on ray_tpu_torch's
    internals: a resend of an executed seqno is answered from the
    receiver's reply cache, and the counter does not advance."""
    from ray_tpu_torch._private.ids import TaskID
    from ray_tpu_torch._private.worker import (_empty_args_frames,
                                               global_worker)

    @port.remote
    class Counter:
        def __init__(self):
            self.v = 0

        def inc(self):
            self.v += 1
            return self.v

    c = Counter.remote()
    assert port.get([c.inc.remote() for _ in range(3)]) == [1, 2, 3]

    core = global_worker()
    st = core._actor_state(c._actor_id)
    assert st.address, "actor address should be resolved after calls"
    header = {"task_id": TaskID.from_random().hex(),
              "function_id": "", "num_returns": 1, "resources": {},
              "owner_addr": core.address, "arg_refs": [],
              "name": "",
              "actor_id": c._actor_id, "method": "inc",
              "caller": core.worker_id, "seqno": 0}
    reply, _ = core.call(st.address, "actor_call", header,
                         _empty_args_frames(), timeout=30.0)
    assert reply.get("status") != "error", reply
    assert port.get(c.inc.remote()) == 4


def test_dynamic_generator_returns(port):
    """Rewrite of tests/test_core_tasks.py::test_dynamic_generator_returns:
    the generator is the port's ObjectRefGenerator."""
    from ray_tpu_torch.object_ref import ObjectRefGenerator

    @port.remote(num_returns="dynamic")
    def produce(n):
        for i in range(n):
            yield {"i": i, "big": np.full(300_000, i, np.uint8)}

    gen = port.get(produce.remote(4))
    assert isinstance(gen, ObjectRefGenerator) and len(gen) == 4
    for i, ref in enumerate(gen):
        item = port.get(ref)
        assert item["i"] == i
        assert item["big"][0] == i and len(item["big"]) == 300_000

    @port.remote
    def total(item):
        return int(item["big"].sum())

    assert port.get(total.remote(gen[2])) == 2 * 300_000


def test_dynamic_generator_empty_and_nongen(port):
    """Rewrite of tests/test_core_tasks.py::
    test_dynamic_generator_empty_and_nongen with the port's
    ObjectRefGenerator."""
    from ray_tpu_torch.object_ref import ObjectRefGenerator

    @port.remote(num_returns="dynamic")
    def empty():
        return iter(())

    gen = port.get(empty.remote())
    assert isinstance(gen, ObjectRefGenerator) and len(gen) == 0

    @port.remote(num_returns="dynamic")
    def not_iterable():
        return 42

    with pytest.raises(Exception, match="iterable|generator"):
        port.get(not_iterable.remote())


# ------------------------------------------------------ process layout
# The helpers that run in workers are defined inside the tests, so they
# travel by value and the workers never import this module.
def test_process_layout(port):
    from ray_tpu_torch import api
    from ray_tpu_torch._private.worker import global_worker

    def layout():
        import os
        import sys

        names = list(sys.modules)
        return {"pid": os.getpid(),
                "modules": sorted({m.split(".")[0] for m in names}),
                "private": sorted(m for m in names if m.startswith(
                    "ray_tpu_torch._private.")),
                "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_worker": os.environ.get(
                    "RAY_TPU_TORCH_IS_DEVICE_WORKER")}

    class Probe:
        def layout(self):
            return layout()

        def gpu_ids(self):
            import ray_tpu_torch as rt

            return rt.get_gpu_ids()

    core = global_worker()
    heads = {p.pid for p in api._head_processes}
    ctl, _ = core.call(core.controller_addr, "modules", {}, timeout=T)
    agent, _ = core.call(core.agent_addr, "modules", {}, timeout=T)
    assert {ctl["pid"], agent["pid"]} == heads

    plain = port.get(port.remote(layout).remote())
    assert plain["cuda_visible"] == "" and plain["device_worker"] == "0"

    probe = port.remote(Probe)
    a = probe.options(num_gpus=1).remote()
    first = port.get(a.layout.remote())
    assert first["device_worker"] == "1"
    assert first["cuda_visible"] != ""
    port.kill(a)
    b, c = (probe.options(num_gpus=0.5).remote() for _ in range(2))
    second = port.get([b.layout.remote(), c.layout.remote()])
    # One device worker hosts every num_gpus actor, one after another and
    # side by side.
    assert {first["pid"]} == {s["pid"] for s in second}
    assert len({first["pid"], plain["pid"], ctl["pid"], agent["pid"]}) == 4
    # No CUDA device on this host: the device worker reports none.
    assert port.get(b.gpu_ids.remote()) == []
    for who, mods in (("controller", ctl["modules"]),
                      ("agent", agent["modules"]),
                      ("plain worker", plain["modules"]),
                      ("device worker", first["modules"])):
        assert not FORBIDDEN & set(mods), (who, FORBIDDEN & set(mods))
    # Neither head process imports torch; a plain worker pays for it only
    # when a tensor reaches it (none has reached one yet in this module).
    for who in (ctl, agent, plain):
        assert "torch" not in who["modules"], who["pid"]
    # The startup helpers each process really loads: stack dumps
    # everywhere, the memory monitor in the agent only.
    stack = "ray_tpu_torch._private.stack_dump"
    monitor = "ray_tpu_torch._private.memory_monitor"
    for who in (ctl, agent, plain, first):
        assert stack in who["private"], who["pid"]
    assert monitor in agent["private"]
    assert monitor not in ctl["private"] + plain["private"]
    port.kill(b)
    port.kill(c)


# ------------------------------------------------------- tensor travel
def _trees():
    g = torch.Generator().manual_seed(0)
    big = torch.randn(300, 300, generator=g)          # 360 KB > inline
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 7, generator=g).to(torch.bfloat16),
        "int64": torch.arange(-5, 7, dtype=torch.int64).reshape(3, 4),
        "view": torch.randn(6, 8, generator=g)[:, ::2].t(),
        "empty": torch.empty(0, 3, dtype=torch.float16),
        "scalar": torch.tensor(2.5, dtype=torch.float64),
        "bool": torch.tensor([True, False, True]),
        "tree": {"a": [torch.ones(2, dtype=torch.int8),
                       (np.arange(3), torch.zeros(1, 2))],
                 "b": "text"},
        "big": big,
        "big_bf16": big.to(torch.bfloat16),
    }


def _same(a, b, path="") -> None:
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert b.device.type == "cpu", path
        bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        ac, bc = a.contiguous(), b.contiguous()
        if a.dtype == torch.bool:
            ac, bc = ac.to(torch.uint8), bc.to(torch.uint8)
        assert torch.equal(ac.view(bits) if a.numel() else ac,
                           bc.view(bits) if b.numel() else bc), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_tensors_round_trip_bitwise(port):
    from ray_tpu_torch._private.config import Config

    def echo_fn(x):
        return x

    class Echo:
        def echo(self, x):
            return x

    trees = _trees()
    assert trees["big"].numel() * 4 > Config().max_inline_object_size
    echo = port.remote(echo_fn)
    dev = port.remote(Echo).options(num_gpus=1).remote()
    for name, value in trees.items():
        _same(value, port.get(echo.remote(value)), f"plain:{name}")
        _same(value, port.get(dev.echo.remote(value)), f"device:{name}")
    # A put from the driver, got in a worker and sent back.
    ref = port.put(trees)
    _same(trees, port.get(echo.remote(ref)), "put")
    port.kill(dev)


# ---------------------------------------------- no GPU on the node
def _park(rt, get_timeout_error, option: str) -> dict:
    """Submit a task and an actor that each ask for one accelerator, on a
    node that has none; report what get and wait saw."""
    def f():
        return 1

    class A:
        def ping(self):
            return 1

    task = rt.remote(f).options(**{option: 1}).remote()
    actor = rt.remote(A).options(**{option: 1}).remote()
    call = actor.ping.remote()
    seen = {}
    for what, ref in (("task", task), ("actor", call)):
        try:
            rt.get(ref, timeout=1.5)
            seen[what] = "ran"
        except get_timeout_error:
            seen[what] = "parked"
    done, rest = rt.wait([task, call], num_returns=1, timeout=0.5)
    seen["wait"] = (len(done), len(rest))
    rt.cancel(task)
    rt.kill(actor)
    return seen


def test_num_gpus_without_a_gpu_parks_as_num_tpus_without_a_chip(
        port, ray_shared):
    """Last in the module: it reboots the port's cluster without a GPU
    (and restores the module's cluster after)."""
    import ray_tpu

    want = _park(ray_tpu, ray_tpu.GetTimeoutError, "num_tpus")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(resources={"CPU": 2})
    try:
        assert "GPU" not in ray_tpu_torch.cluster_resources()
        got = _park(port, ray_tpu_torch.GetTimeoutError, "num_gpus")
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(resources={"CPU": 4, "GPU": 1})
    assert want == got == {"task": "parked", "actor": "parked",
                           "wait": (0, 2)}


# ------------------------------------------------------ code by value
_RECEIVER = """
import pickle, sys
sys.path.insert(0, sys.argv[1])
fn, Cls, DC = pickle.loads(sys.stdin.buffer.read())
obj = Cls(2)
print(fn(5), obj.double, Cls.make(3).v, Cls.twice(4), obj.hello(),
      DC(1).y, "test_torch_runtime_core" in sys.modules)
"""


def test_code_travels_by_value_to_a_process_that_cannot_import_it():
    """Functions and classes defined in a test (`<locals>`) cross to a
    fresh interpreter that cannot import this module: closures, defaults,
    the globals the code names (a module by reference), recursion,
    property, classmethod, staticmethod, zero-argument super() and a
    dataclass."""
    import dataclasses
    import os
    import subprocess
    import sys

    from ray_tpu_torch._private import serialization

    scale = 10

    def fact(n):
        return 1 if n <= 1 else n * fact(n - 1)

    def fn(x, k=2, *, extra=1):
        return int(np.asarray(fact(x) + scale * k + extra))

    class Base:
        def hello(self):
            return "base"

    class Cls(Base):
        def __init__(self, v):
            self.v = v

        @property
        def double(self):
            return 2 * self.v

        @classmethod
        def make(cls, v):
            return cls(v)

        @staticmethod
        def twice(x):
            return 2 * x

        def hello(self):
            return "cls+" + super().hello()

    @dataclasses.dataclass
    class DC:
        x: int
        y: int = 7

    blob = serialization.dumps_function((fn, Cls, DC))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _RECEIVER, repo],
                         input=blob, capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    assert out.stdout.decode().split() == [
        "141", "4", "3", "8", "cls+base", "7", "False"]
    # In this process a class shipped by value comes back as itself.
    assert serialization.loads_function(
        serialization.dumps_function(Cls)) is Cls


def test_tensor_lands_on_the_default_device_as_a_jax_array_does(
        monkeypatch):
    """A jax array's pickle lands on the receiving process's default
    device; the port's tensor lands on the CPU outside the device worker,
    and on CUDA in it only where CUDA is there."""
    import pickle

    import jax
    import jax.numpy as jnp

    from ray_tpu_torch._private import serialization

    back = pickle.loads(pickle.dumps(jnp.arange(3.0)))
    assert isinstance(back, jax.Array)
    assert back.devices() == {jax.devices()[0]}
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    rebuild, (buf, dtype, shape, _, grad, param) = \
        serialization._tensor_reduce(t)
    for flag in ("0", "1"):
        monkeypatch.setenv("RAY_TPU_TORCH_IS_DEVICE_WORKER", flag)
        out = rebuild(buf, dtype, shape, True, grad, param)
        want = "cuda" if flag == "1" and torch.cuda.is_available() \
            else "cpu"
        assert out.device.type == want and torch.equal(out.cpu(), t)
