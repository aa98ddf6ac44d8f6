"""Binary IDs for all runtime entities.

TPU-native analog of the reference's ID scheme (ray: src/ray/common/id.h):
every entity gets a fixed-width random/derived binary id with a cheap hex
form for logging.  We keep ids at 16 bytes (vs ray's 28) — collisions are
negligible and header framing stays small.

Task/Object id derivation mirrors the reference's "object = task id + return
index" scheme (ray: src/ray/common/id.h ObjectID::FromIndex) so lineage
reconstruction can map an object back to the task that created it without a
lookup table.
"""
from __future__ import annotations

import hashlib
import os

ID_SIZE = 16

NIL = b"\x00" * ID_SIZE

# Random ids are minted thousands of times per second on the task-submit
# hot path; a urandom syscall each (~10µs) is measurable.  Instead: one
# urandom prefix per process + an itertools counter (next() is atomic
# under the GIL — submit_task runs on arbitrary user threads), reseeded
# after fork (forked workers would otherwise mint the parent's stream).
import itertools as _itertools

_prefix = os.urandom(ID_SIZE - 8)
_counter = _itertools.count(1)


def _reseed() -> None:
    global _prefix, _counter
    _prefix = os.urandom(ID_SIZE - 8)
    _counter = _itertools.count(1)


os.register_at_fork(after_in_child=_reseed)


def random_id() -> bytes:
    # Counter FIRST: log lines and reprs truncate to the leading hex
    # chars, and a leading shared prefix made every id minted by one
    # process display identically ("actor 5023caf8" named three distinct
    # entities in one debugging session).  4 counter bytes (big-endian,
    # mint-ordered) then the process prefix, so a 12-char truncation
    # shows BOTH which-id and which-process; counter bits ≥2^32 spill
    # into the tail.
    n = next(_counter)
    return ((n & 0xFFFFFFFF).to_bytes(4, "big") + _prefix
            + (n >> 32).to_bytes(4, "big"))


def hex_id(b: bytes) -> str:
    return b.hex()


class BaseID:
    __slots__ = ("_bytes",)
    _kind = "id"

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != ID_SIZE:
            raise ValueError(f"{self._kind} must be {ID_SIZE} bytes, got {id_bytes!r}")
        self._bytes = id_bytes

    @classmethod
    def nil(cls):
        return cls(NIL)

    @classmethod
    def from_random(cls):
        return cls(random_id())

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == NIL

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return hash((self._kind, self._bytes))

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    _kind = "job"


class NodeID(BaseID):
    _kind = "node"


class WorkerID(BaseID):
    _kind = "worker"


class ActorID(BaseID):
    _kind = "actor"


class TaskID(BaseID):
    _kind = "task"


class PlacementGroupID(BaseID):
    _kind = "pg"


class ObjectID(BaseID):
    """Object ids are derived from (task id, return index) for lineage."""

    _kind = "object"

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        h = hashlib.blake2b(
            task_id.binary() + index.to_bytes(4, "little"), digest_size=ID_SIZE
        )
        return cls(h.digest())

    @classmethod
    def for_put(cls, owner: WorkerID, seqno: int) -> "ObjectID":
        h = hashlib.blake2b(
            b"put" + owner.binary() + seqno.to_bytes(8, "little"), digest_size=ID_SIZE
        )
        return cls(h.digest())
