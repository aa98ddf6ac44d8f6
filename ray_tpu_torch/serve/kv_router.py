"""The host-side hashing and switch helpers the paged engine needs, copied
from ray_tpu/serve/kv_router.py (the port imports nothing of ray_tpu).

The RAY_TPU_* switch names are kept, so one environment drives the
reference engine and the port alike.
"""
from __future__ import annotations

import hashlib
import os

# Root of every hash chain (the empty prefix).
ROOT_HASH = 0


def env_on(name: str, default: bool = True) -> bool:
    """Shared kill-switch truthiness rule."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


def chain_hash(parent: int, chunk) -> int:
    """Hash of one cached block given its parent's hash: 64-bit blake2b
    over (parent_hash || token ids), deterministic across processes."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent).to_bytes(8, "little"))
    h.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                      for t in chunk))
    return int.from_bytes(h.digest(), "little")


def summary_digest(hashes) -> int:
    """Order-independent digest of a hash set (XOR fold)."""
    d = 0
    for h in hashes:
        d ^= int(h)
    return d
