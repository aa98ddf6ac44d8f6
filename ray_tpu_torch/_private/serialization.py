"""Value serialization for tasks, actors, and objects.

Analog of the reference's SerializationContext
(ray: python/ray/_private/serialization.py:114): pickle protocol 5 with
out-of-band buffers, so large numpy arrays and torch tensors are carried
as raw frames rather than copied into the pickle stream.

Code travels by value where it cannot be imported by name: a function or
class defined in `__main__`, inside another function (`<locals>`), or
otherwise unreachable by `module.qualname`.  `_Pickler.reducer_override`
ships such a function as its code object (`marshal`), the globals its
code names, its defaults, closure cells and `__dict__`; such a class as
its bases and namespace.  Everything importable pickles by reference, as
the standard pickler does.  A class shipped by value keeps one identity
per process: pickling it tags it with an id, and unpickling an id this
process already knows returns the class it has (instances sent back to
the driver are instances of the driver's class).

torch tensors travel as a dtype, a shape and one out-of-band buffer over
their bytes (a uint8 view, so bf16 needs no numpy dtype); torch is
imported only when a tensor is met.  A CUDA tensor is copied to the host
when it is serialized and lands on the receiving process's default
device: `cuda` in the device worker, the CPU elsewhere — what a jax
array's `__reduce__` does (it lands on the receiver's default device).

ObjectRefs embedded in values are hooked at (de)serialization time so the
owner can track borrowers, mirroring the reference's reducer hooks for
ObjectRef (ray: python/ray/_private/serialization.py _object_ref_reducer).
"""
from __future__ import annotations

import builtins
import io
import marshal
import os
import pickle
import sys
import threading
import types
import uuid
import weakref
from typing import Any, Callable


class SerializedValue:
    """A pickled value plus its out-of-band buffers.

    frames[0] is the pickle stream; frames[1:] are raw PickleBuffer payloads.
    """

    __slots__ = ("frames", "contained_refs")

    def __init__(self, frames: list[bytes], contained_refs: list):
        self.frames = frames
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        return sum(len(f) for f in self.frames)

    def to_payload(self) -> list[bytes]:
        return self.frames


# Thread-local capture of ObjectRefs encountered while pickling a value.
_capture = threading.local()


def _note_ref(ref) -> None:
    lst = getattr(_capture, "refs", None)
    if lst is not None:
        lst.append(ref)


# ------------------------------------------------------------ code by value
def _importable(obj) -> bool:
    """True when `module.qualname` resolves to obj itself in this process
    (then the receiver can import it by name)."""
    mod = getattr(obj, "__module__", None)
    qual = getattr(obj, "__qualname__", None)
    if not mod or not qual or mod == "__main__" or "<locals>" in qual:
        return False
    m = sys.modules.get(mod)
    if m is None:
        return False
    cur = m
    for part in qual.split("."):
        cur = getattr(cur, part, None)
        if cur is None:
            return False
    return cur is obj


def _code_names(code: types.CodeType, out: set) -> set:
    out.update(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _code_names(c, out)
    return out


_EMPTY_CELL = "__rtt_empty_cell__"


def _make_function(code_bytes: bytes, name: str, n_cells: int):
    code = marshal.loads(code_bytes)
    cells = tuple(types.CellType() for _ in range(n_cells)) or None
    return types.FunctionType(code, {"__builtins__": builtins}, name, None,
                              cells)


def _function_setstate(fn, state: dict) -> None:
    fn.__globals__.update(state["globals"])
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__dict__.update(state["dict"])
    fn.__module__ = state["module"]
    fn.__qualname__ = state["qualname"]
    fn.__doc__ = state["doc"]
    for cell, value in zip(fn.__closure__ or (), state["cells"]):
        if value is not _EMPTY_CELL:
            cell.cell_contents = value


def _function_reduce(fn: types.FunctionType):
    g = fn.__globals__
    names = _code_names(fn.__code__, set())
    globs = {k: g[k] for k in names if k in g and k != "__builtins__"}
    cells = []
    for c in fn.__closure__ or ():
        try:
            cells.append(c.cell_contents)
        except ValueError:
            cells.append(_EMPTY_CELL)
    state = {"globals": globs, "defaults": fn.__defaults__,
             "kwdefaults": fn.__kwdefaults__, "dict": dict(fn.__dict__),
             "module": fn.__module__, "qualname": fn.__qualname__,
             "doc": fn.__doc__, "cells": cells}
    return (_make_function,
            (marshal.dumps(fn.__code__), fn.__name__,
             len(fn.__closure__ or ())),
            state, None, None, _function_setstate)


# class id -> class, for classes shipped by value (both directions).
_class_by_id: "weakref.WeakValueDictionary[str, type]" = \
    weakref.WeakValueDictionary()
_id_by_class: "weakref.WeakKeyDictionary[type, str]" = \
    weakref.WeakKeyDictionary()
_fresh: "weakref.WeakSet[type]" = weakref.WeakSet()
_class_lock = threading.Lock()

# Entries of a class __dict__ that the class statement makes itself.
_SKIP_CLASS_KEYS = frozenset({"__dict__", "__weakref__", "__module__",
                              "__qualname__", "__doc__", "_abc_impl"})


def _make_class(class_id: str, metaclass, name: str, bases: tuple,
                base_ns: dict):
    with _class_lock:
        cls = _class_by_id.get(class_id)
        if cls is None:
            cls = types.new_class(name, bases, {"metaclass": metaclass},
                                  lambda ns: ns.update(base_ns))
            _class_by_id[class_id] = cls
            _id_by_class[cls] = class_id
            _fresh.add(cls)
    return cls


def _class_setstate(cls, state: dict) -> None:
    with _class_lock:
        if cls not in _fresh:
            return              # this process already had the class
        _fresh.discard(cls)
    for k, v in state.items():
        setattr(cls, k, v)


def _class_reduce(cls: type):
    with _class_lock:
        class_id = _id_by_class.get(cls)
        if class_id is None:
            class_id = uuid.uuid4().hex
            _id_by_class[cls] = class_id
            _class_by_id[class_id] = cls
    ns = cls.__dict__
    base_ns = {"__module__": cls.__module__, "__qualname__": cls.__qualname__,
               "__doc__": cls.__doc__}
    slots = ns.get("__slots__")
    if slots is not None:
        base_ns["__slots__"] = slots
        slot_names = {slots} if isinstance(slots, str) else set(slots)
    else:
        slot_names = set()
    state = {k: v for k, v in ns.items()
             if k not in _SKIP_CLASS_KEYS and k not in slot_names
             and k != "__slots__"}
    return (_make_class,
            (class_id, type(cls), cls.__name__, cls.__bases__, base_ns),
            state, None, None, _class_setstate)


# --------------------------------------------------------------- tensors
def _device_worker() -> bool:
    return os.environ.get("RAY_TPU_TORCH_IS_DEVICE_WORKER") == "1"


def _rebuild_tensor(buf, dtype: str, shape: tuple, was_cuda: bool,
                    requires_grad: bool, parameter: bool = False):
    import torch

    dt = getattr(torch, dtype)
    if not len(memoryview(buf)):
        t = torch.empty(shape, dtype=dt)
    else:
        raw = memoryview(buf)
        if raw.readonly:
            raw = bytearray(raw)      # torch.frombuffer wants it writable
        t = torch.frombuffer(raw, dtype=torch.uint8).view(dt).reshape(shape)
    if was_cuda and _device_worker() and torch.cuda.is_available():
        t = t.to("cuda")
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


def _tensor_reduce(t):
    import torch

    if t.layout != torch.strided or t.is_quantized or t.is_nested:
        return NotImplemented
    host = t.detach()
    was_cuda = host.device.type == "cuda"
    host = host.cpu().contiguous()
    dtype = str(host.dtype).removeprefix("torch.")
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), dtype, tuple(host.shape), was_cuda,
             bool(t.requires_grad), isinstance(t, torch.nn.Parameter)))


def _is_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(obj, torch.Tensor)


class _Pickler(pickle.Pickler):
    def __init__(self, file, buffer_callback):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)

    def reducer_override(self, obj):
        from ray_tpu_torch.object_ref import ObjectRef

        if isinstance(obj, ObjectRef):
            _note_ref(obj)
            return (ObjectRef._from_serialized, (obj.binary(), obj.owner_addr))
        custom = _custom_serializers.get(obj.__class__)
        if custom is not None:
            ser, deser = custom
            # The DESERIALIZER function rides the pickle stream (by value
            # when it is not importable), so receiving workers need no
            # registration (ray: util/serialization.py
            # register_serializer — same one-sided contract).
            return (deser, (ser(obj),))
        t = type(obj)
        if t is types.FunctionType:
            if _importable(obj):
                return NotImplemented
            return _function_reduce(obj)
        if isinstance(obj, type):
            if _importable(obj) or obj.__module__ == "builtins":
                return NotImplemented
            return _class_reduce(obj)
        if t is property:
            return (property, (obj.fget, obj.fset, obj.fdel, obj.__doc__))
        if t is classmethod or t is staticmethod:
            return (t, (obj.__func__,))
        if t is types.MappingProxyType:
            return (_mappingproxy, (dict(obj),))
        if t is types.ModuleType:
            return (_import_module, (obj.__name__,))
        if _is_tensor(obj):
            return _tensor_reduce(obj)
        return NotImplemented


def _mappingproxy(d: dict):
    return types.MappingProxyType(d)


def _import_module(name: str):
    import importlib

    return importlib.import_module(name)


# Exact-type custom reducers (ray: SerializationContext
# _register_cloudpickle_serializer).  Keyed by class; subclasses do NOT
# inherit the serializer (matching the reference).
_custom_serializers: dict = {}


_SAFE_SCALARS = frozenset({type(None), bool, int, float, complex, str,
                           bytes, bytearray})
_SAFE_CONTAINERS = frozenset({list, tuple, set, frozenset})

try:
    import numpy as _np
except Exception:  # noqa: BLE001
    _np = None


def _stdlib_picklable(v: Any) -> bool:
    """True when the C pickler provably produces the SAME result the
    by-value pickler would: exact builtin scalar/container types,
    object-free numpy arrays, and ObjectRefs.  Everything else (instances
    of user classes — possibly defined in __main__ — functions, tensors,
    subclasses) takes the by-value pickler."""
    t = v.__class__
    if t in _SAFE_SCALARS:
        return True
    if t is dict:
        return all(_stdlib_picklable(k) and _stdlib_picklable(x)
                   for k, x in v.items())
    if t in _SAFE_CONTAINERS:
        return all(_stdlib_picklable(x) for x in v)
    if _np is not None and t is _np.ndarray:
        return not v.dtype.hasobject
    from ray_tpu_torch.object_ref import ObjectRef

    return t is ObjectRef


def serialize(value: Any) -> SerializedValue:
    buffers: list[pickle.PickleBuffer] = []
    _capture.refs = []
    try:
        fast = False
        try:
            fast = _stdlib_picklable(value)
        except RecursionError:
            fast = False
        if fast:
            # Hot path: the C pickler with no reducer hook.  ObjectRef
            # capture still works — its __reduce__ calls _note_ref.
            stream = pickle.dumps(value, protocol=5,
                                  buffer_callback=buffers.append)
        else:
            sink = io.BytesIO()
            _Pickler(sink, buffers.append).dump(value)
            stream = sink.getvalue()
        frames: list = [stream]
        for b in buffers:
            raw = b.raw()   # 1-D C-contiguous "B" view (raises otherwise)
            # Large buffers stay zero-copy views into the source object
            # all the way to the wire.  Small ones are snapshotted: cheap,
            # and frees the source immediately.
            frames.append(raw if raw.nbytes >= 1 << 20 else raw.tobytes())
        return SerializedValue(frames, list(_capture.refs))
    finally:
        _capture.refs = None


def _note_deser_ref(ref) -> None:
    """Capture ObjectRefs materialized during a deserialize_with_refs call
    (borrower tracking, ray: serialization.py ObjectRef deserializer hook)."""
    lst = getattr(_capture, "deser_refs", None)
    if lst is not None:
        lst.append(ref)


def deserialize(frames: list[bytes | memoryview]) -> Any:
    bufs = [pickle.PickleBuffer(f) for f in frames[1:]]
    return pickle.loads(frames[0], buffers=bufs)


def deserialize_with_refs(frames: list[bytes | memoryview]) -> tuple[Any, list]:
    """Deserialize and also return the ObjectRefs contained in the value
    (the executing side of the borrow protocol)."""
    bufs = [pickle.PickleBuffer(f) for f in frames[1:]]
    _capture.deser_refs = []
    try:
        value = pickle.loads(frames[0], buffers=bufs)
        return value, list(_capture.deser_refs)
    finally:
        _capture.deser_refs = None


def dumps_function(fn: Callable) -> bytes:
    """Pickle a remote function/actor class for export to the controller KV
    (ray: python/ray/_private/function_manager.py:195 export): one in-band
    stream, code by value where it is not importable."""
    sink = io.BytesIO()
    _Pickler(sink, None).dump(fn)
    return sink.getvalue()


def loads_function(b: bytes) -> Callable:
    return pickle.loads(b)
