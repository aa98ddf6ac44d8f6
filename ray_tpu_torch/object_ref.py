"""ObjectRef: a future for a value in the distributed object store.

Analog of ray.ObjectRef (ray: python/ray/_raylet.pyx ObjectRef).  A ref
carries its owner's RPC address so any holder can resolve it by asking the
owner (the reference's ownership model: reference_count.cc /
ownership_based_object_directory.cc).  Local in-scope refs participate in
owner-side reference counting via the release hook installed by the worker.
"""
from __future__ import annotations

from typing import Any, Callable

# Called as hook(object_id) on ref drop; the worker resolves the owner
# from its owned/borrows tables.
_release_hook: Callable[[bytes], None] | None = None


def set_release_hook(hook: Callable[[bytes], None] | None) -> None:
    global _release_hook
    _release_hook = hook


class ObjectRef:
    __slots__ = ("_id", "_owner_addr", "__weakref__")

    def __init__(self, object_id: bytes, owner_addr: str = ""):
        self._id = object_id
        self._owner_addr = owner_addr

    @classmethod
    def _from_serialized(cls, object_id: bytes, owner_addr: str) -> "ObjectRef":
        ref = cls(object_id, owner_addr)
        from ray_tpu_torch._private.serialization import _note_deser_ref

        _note_deser_ref(ref)
        # On the owner, every deserialized copy is a live local reference —
        # without this, `del copy` would release a count the original never
        # granted and free the object early.
        try:
            from ray_tpu_torch._private.worker import _global_worker

            if _global_worker is not None:
                _global_worker._note_deserialized_own_ref(object_id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
        return ref

    def binary(self) -> bytes:
        return self._id

    def hex(self) -> str:
        return self._id.hex()

    @property
    def owner_addr(self) -> str:
        return self._owner_addr

    def future(self):
        """concurrent.futures.Future view of this ref (asyncio interop)."""
        from ray_tpu_torch._private.worker import global_worker

        return global_worker().ref_future(self)

    def __await__(self):
        import asyncio

        from ray_tpu_torch._private.worker import global_worker

        fut = asyncio.wrap_future(global_worker().ref_future(self))
        return fut.__await__()

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()[:16]}…)"

    def __del__(self):
        if _release_hook is not None:
            try:
                _release_hook(self._id)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    def __reduce__(self):
        # Used by the C-pickler fast path in serialization.serialize (and
        # plain pickling elsewhere).  _note_ref records the ref for borrow
        # tracking when a serialize() capture is active; it is a no-op
        # otherwise.
        from ray_tpu_torch._private.serialization import _note_ref

        _note_ref(self)
        return (ObjectRef._from_serialized, (self._id, self._owner_addr))


class StreamingObjectRefGenerator:
    """Iterator over a streaming generator task's item refs, yielding each
    ref AS the task produces it — the task may still be running (ray:
    streaming ObjectRefGenerator, python/ray/_raylet.pyx:277).

    `next()` blocks until the next item is announced; raises the task's
    error (after all successfully produced items) or StopIteration."""

    def __init__(self, task_id: bytes, gen_ref: "ObjectRef", core):
        self._task_id = task_id
        # Holding the return-0 ref keeps the items pinned (they are its
        # contained refs once the task completes).
        self._gen_ref = gen_ref
        self._core = core
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        try:
            ref = self._core.stream_next(self._task_id, self._index)
        except StopAsyncIteration:
            raise StopIteration from None
        self._index += 1
        return ref

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        import asyncio

        loop = asyncio.get_running_loop()
        idx = self._index
        ref = await loop.run_in_executor(
            None, lambda: self._core.stream_next(self._task_id, idx))
        self._index += 1
        return ref

    def task_done_ref(self) -> "ObjectRef":
        """Ref resolving (at task completion) to an ObjectRefGenerator of
        all items — the dynamic-generator compatibility view."""
        return self._gen_ref

    def __repr__(self):
        return (f"StreamingObjectRefGenerator("
                f"{self._task_id.hex()[:12]}…, next={self._index})")

    def __del__(self):
        try:
            self._core.drop_stream(self._task_id)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class ObjectRefGenerator:
    """The resolved value of a num_returns="dynamic" task: an iterable of
    ObjectRefs, one per yielded item (ray: DynamicObjectRefGenerator —
    python/ray/_raylet.pyx ObjectRefGenerator).

    Pickles as its ref list, so passing a generator to another task moves
    the refs through the normal borrower protocol.
    """

    __slots__ = ("_refs",)

    def __init__(self, refs: list):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self) -> int:
        return len(self._refs)

    def __getitem__(self, i: int):
        return self._refs[i]

    def __repr__(self) -> str:
        return f"ObjectRefGenerator({len(self._refs)} refs)"

    def __reduce__(self):
        return (ObjectRefGenerator, (self._refs,))
