"""The multi-LoRA registry of the port, copied from ray_tpu/serve/lora.py
with its runtime calls going through a ServeRuntime (serve/runtime.py),
and the typed rejection the engine and server raise.

Hot adapters are device-resident bank rows inside the engine
(serve/llm.py): per-target [L, n_slots, din, r] / [L, n_slots, r, dout]
tensors that a per-row slot index gathers inside the decode step
(models/llama._lora_proj).  `adapter_salt(model_id, version)` keys the
radix tree and the prefix store per (adapter, version), so a re-upload
makes the old version's KV unreachable instead of wrong.

Cold adapters are published to an `AdapterDirectory` (model_id ->
payload ref, version, rank; every publish bumps the version).  A
`LoraClient` publishes and looks up, either on a directory injected in
process or through the runtime's controller (`lora_<verb>`);
`resolve_entry` pulls a looked-up payload through the runtime when it is
a ref.  Not ported: the directory's `summary` view (read by the
adapter-aware routing, not ported yet), the client's `fetch`, `summary`
and `stats`, and the module-level driver helpers (`publish_adapter`,
`delete_adapter`, `list_adapters`), which need a cluster-wide default
client.
"""
from __future__ import annotations

import hashlib
import threading
import time

from ray_tpu_torch.serve.kv_router import lora_on, lora_router_on  # noqa: F401
from ray_tpu_torch.serve.runtime import ServeRuntime


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


class AdapterDirectory:
    """Registry of published adapters (on the serve controller, or handed
    to a LoraClient in process).  Each entry holds the payload's ref."""

    def __init__(self):
        self._lock = threading.Lock()
        # model_id -> {"ref", "version", "rank", "nbytes", "tenant", "t"}
        self._adapters: dict[str, dict] = {}
        self.published = 0
        self.forgotten = 0
        self.lookups = 0
        self.lookup_misses = 0

    def publish(self, model_id: str, meta: dict, ref) -> dict:
        """Register (or re-upload) one adapter.  Every publish of a
        model_id bumps its version, so adapter_salt(model_id, version) and
        with it every cached KV key rolls over with the weights.  `ref`
        may arrive nested in a one-element list (how it crosses an RPC as
        a ref)."""
        if isinstance(ref, list):
            ref = ref[0]
        with self._lock:
            old = self._adapters.get(model_id)
            version = (old["version"] + 1) if old else 1
            self._adapters[model_id] = {
                "ref": ref,
                "version": version,
                "rank": int(meta.get("rank", 0)),
                "nbytes": int(meta.get("nbytes", 0)),
                "tenant": meta.get("tenant"),
                "t": time.monotonic(),
            }
            self.published += 1
        return {"version": version,
                "salt": adapter_salt(model_id, version)}

    def lookup(self, model_id: str) -> dict | None:
        with self._lock:
            self.lookups += 1
            e = self._adapters.get(model_id)
            if e is None:
                self.lookup_misses += 1
                return None
            return {"ref": e["ref"], "version": e["version"],
                    "rank": e["rank"], "nbytes": e["nbytes"],
                    "salt": adapter_salt(model_id, e["version"])}

    def forget(self, model_id: str) -> bool:
        with self._lock:
            e = self._adapters.pop(model_id, None)
            if e is not None:
                self.forgotten += 1
            return e is not None

    def clear(self) -> None:
        """Drop every entry (serve shutdown: the entries hold the
        adapters' primary refs)."""
        with self._lock:
            self._adapters.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "adapters": len(self._adapters),
                "bytes": sum(e["nbytes"]
                             for e in self._adapters.values()),
                "published": self.published,
                "forgotten": self.forgotten,
                "lookups": self.lookups,
                "lookup_misses": self.lookup_misses,
            }


class LoraClient:
    """Publish / fetch half used by drivers (upload) and servers
    (page-in): calls an injected in-process AdapterDirectory, or the
    runtime controller's `lora_<verb>` methods.  With neither, lookups
    return their defaults and publish raises."""

    def __init__(self, directory: AdapterDirectory | None = None,
                 runtime: ServeRuntime | None = None):
        self._directory = directory
        self._runtime = runtime or ServeRuntime()

    def _call(self, verb: str, *args, timeout: float = 10.0,
              default=None, **kwargs):
        if self._directory is not None:
            return getattr(self._directory, verb)(*args, **kwargs)
        ctrl = self._runtime.controller()
        if ctrl is None:
            return default
        try:
            ref = getattr(ctrl, "lora_" + verb).remote(*args, **kwargs)
            return self._runtime.get(ref, timeout=timeout)
        except Exception:  # noqa: BLE001 - controller restarting
            return None

    def publish(self, model_id: str, adapter: dict, *,
                tenant: str | None = None) -> dict:
        """Seal an adapter through the runtime and register it.  Returns
        {"version", "salt"}."""
        if not model_id or not isinstance(model_id, str):
            raise ValueError(f"model_id must be a non-empty string, "
                             f"got {model_id!r}")
        rank = _validate_adapter(adapter)
        meta = {"rank": rank, "nbytes": _adapter_nbytes(adapter),
                "tenant": tenant}
        ref = self._runtime.put(adapter)
        # Nested, so an RPC hands the directory the ref, not its value.
        reply = self._call("publish", model_id, meta, [ref], default=None)
        if reply is None:
            raise RuntimeError(
                f"adapter publish failed: no adapter directory reachable "
                f"for {model_id!r}")
        return reply

    def delete(self, model_id: str) -> bool:
        return bool(self._call("forget", model_id, default=False))

    def lookup(self, model_id: str) -> dict | None:
        """Directory metadata only ({"ref", "version", "rank", "nbytes",
        "salt"}), no payload pull."""
        return self._call("lookup", model_id, default=None)


def resolve_entry(entry: dict, runtime: ServeRuntime | None = None,
                  timeout: float = 30.0) -> dict:
    """A directory entry's adapter: pulled through `runtime` when the
    payload is one of its refs, else the payload itself."""
    payload = entry["ref"]
    if runtime is not None and runtime.is_ref(payload):
        payload = runtime.get(payload, timeout=timeout)
    return payload
