"""The jax-free multi-LoRA helpers the paged engine needs, copied from
ray_tpu/serve/lora.py, and the typed rejection it raises.

Hot adapters are device-resident bank rows inside the engine
(serve/llm.py): per-target [L, n_slots, din, r] / [L, n_slots, r, dout]
tensors that a per-row slot index gathers inside the decode step
(models/llama._lora_proj).  `adapter_salt(model_id, version)` keys the
radix tree and the prefix store per (adapter, version), so a re-upload
makes the old version's KV unreachable instead of wrong.

The adapter directory, its client and the server's page-in path come
with the LLMServer slice.
"""
from __future__ import annotations

import hashlib

from ray_tpu_torch.serve.kv_router import lora_on, lora_router_on  # noqa: F401


class AdapterLoadError(RuntimeError):
    """A multi-LoRA request's adapter could not be made resident: the
    weights failed validation, every adapter slot is busy, or it was not
    resident at admission.  Raised before the request takes a batch
    slot, so a failed load is a clean rejection, never a wedged loop."""

    def __init__(self, message: str = "adapter load failed",
                 model_id: str = "", deployment: str = "",
                 reason: str = ""):
        self.model_id = model_id
        self.deployment = deployment
        self.reason = reason
        super().__init__(
            f"{message} (model_id={model_id!r}, "
            f"deployment={deployment!r}, reason={reason!r})")
        self._message = message

    def __reduce__(self):
        return (AdapterLoadError,
                (self._message, self.model_id, self.deployment,
                 self.reason))


def adapter_salt(model_id: str, version: int) -> int:
    """KV-identity salt for (adapter, version): a non-zero 63-bit blake2b
    int, stable across processes, that prefixes the first radix chunk of
    every prompt served under this adapter.  The version is inside the
    salt, so a re-upload invalidates old KV by unreachability."""
    h = hashlib.blake2b(digest_size=8)
    h.update(model_id.encode())
    h.update(int(version).to_bytes(8, "little", signed=True))
    return (int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)) or 1


def _adapter_nbytes(adapter: dict) -> int:
    n = 0
    for ab in adapter.get("targets", {}).values():
        for arr in ab.values():
            n += int(getattr(arr, "nbytes", 0))
    return n


def _validate_adapter(adapter: dict) -> int:
    """Shape-contract check at publish time (the engine re-validates
    against its own config at load).  Returns the adapter's rank."""
    if not isinstance(adapter, dict) or "targets" not in adapter:
        raise ValueError(
            "adapter must be {'rank': int, 'targets': {name: {'a', "
            "'b'}}} (see models/llama.init_lora_adapter)")
    rank = int(adapter.get("rank", 0))
    for t, ab in adapter["targets"].items():
        a, b = ab.get("a"), ab.get("b")
        if a is None or b is None:
            raise ValueError(f"adapter target {t!r} missing 'a'/'b'")
        if a.ndim != 3 or b.ndim != 3 or a.shape[2] != b.shape[1]:
            raise ValueError(
                f"adapter target {t!r}: want a [L, din, r] / "
                f"b [L, r, dout], got {tuple(a.shape)} / {tuple(b.shape)}")
        if rank and a.shape[2] != rank:
            raise ValueError(
                f"adapter target {t!r}: rank {a.shape[2]} != declared "
                f"rank {rank}")
        rank = rank or int(a.shape[2])
    if rank < 1:
        raise ValueError("adapter has no targets")
    return rank
