"""The host-side hashing helpers and kill switches the paged engine and the
LLM server need, copied from ray_tpu/serve/kv_router.py (the port imports
nothing of ray_tpu).

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


def pd_disagg_on() -> bool:
    """RAY_TPU_PD_DISAGG kill switch for prefill/decode disaggregation."""
    return env_on("RAY_TPU_PD_DISAGG")


def prefix_store_on() -> bool:
    """RAY_TPU_PREFIX_STORE kill switch for the tier-2 prefix store; the
    engine reads it per demotion scan."""
    return env_on("RAY_TPU_PREFIX_STORE")


def lora_on() -> bool:
    """RAY_TPU_LORA kill switch for multi-LoRA serving (per request: off =
    every request serves the base model)."""
    return env_on("RAY_TPU_LORA")


def lora_router_on() -> bool:
    """RAY_TPU_LORA_ROUTER gates only the router's adapter-residency
    scoring."""
    return env_on("RAY_TPU_LORA_ROUTER")


def chain_hash(parent: int, chunk) -> int:
    """Hash of one cached block given its parent's hash: 64-bit blake2b
    over (parent_hash || token ids), deterministic across processes."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent).to_bytes(8, "little"))
    h.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                      for t in chunk))
    return int.from_bytes(h.digest(), "little")


def prompt_hashes(tokens, page: int, salt: int = 0) -> list[int]:
    """Chained hashes of a prompt's full blocks.  A non-zero adapter
    `salt` prefixes the first block's hashed tokens, as BlockManager keys
    salted subtrees."""
    n = len(tokens) // page
    out, h = [], ROOT_HASH
    for i in range(n):
        chunk = tokens[i * page:(i + 1) * page]
        if salt and i == 0:
            chunk = (salt,) + tuple(chunk)
        h = chain_hash(h, chunk)
        out.append(h)
    return out


def matched_depth(hashes: list[int], cached: frozenset) -> int:
    """Longest prefix (in blocks) of the chained `hashes` present in a
    cached-hash set; chaining makes membership of h_i imply the path."""
    depth = 0
    for h in hashes:
        if h not in cached:
            break
        depth += 1
    return depth


def summary_digest(hashes) -> int:
    """Order-independent digest of a hash set (XOR fold)."""
    d = 0
    for h in hashes:
        d ^= int(h)
    return d
