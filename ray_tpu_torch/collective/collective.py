"""Collective groups over the object plane (port of
ray_tpu/collective/collective.py): the reference's public functions and
group-name semantics, on the port's runtime.

Schedules (`ring.py`): tensors of at least `ring.RING_MIN_BYTES`
(256 KiB) take the ring reduce-scatter + allgather, 2*N*(world-1)/world
bytes per rank, chunks hopping peer to peer as object-plane puts;
smaller ones a binomial tree with the payload inline.  A group's named
rendezvous actor (`rendezvous.py`) carries only mailbox matching, refs
and small inline tensors, never bulk payload.  Below the threshold an
allgather is one matched exchange, and so is a barrier.  The reference's
legacy gather path and its kill switch RAY_TPU_RING_COLLECTIVES are not
ported: the ring and the tree are the one path.

Tensors: numpy arrays and CPU torch tensors are reduced on the host; a
CUDA tensor is copied to the host first, as the reference's `np.asarray`
copies a device array.  Results keep the input's dtype (bf16 included)
and kind: numpy in, numpy out; a tensor in, a CPU tensor out.

Membership is per member, not per process.  The reference keeps one
registry per process because each of its actors is a process; the port's
device worker hosts every "GPU" actor of its host, so the registry is
keyed by (group name, the calling actor's id from
`get_runtime_context().get_actor_id()`), a driver or task keeping the
per-process key.  Each member has its own rank, seq counter and ordered
op thread.

Async variants (`allreduce_async`, ...) return a wait()-able
`CollectiveWork`; per member, ops run on one thread in submission (seq)
order, with the caller's trace context re-installed.  Every exchange has
a deadline (`init_collective_group`'s `timeout_s`, 120 s unless given):
a rank that dies mid-collective surfaces on the survivors as an error
naming the missing rank(s).  Each op records a `collective.<op>` span with its phase sums and bytes, and
`profiling.collective_trace()` arms the one-shot per-op breakdown.

The packed pytree broadcast (`broadcast_pytree`, the RLHF weight sync):
a llama param tree is a dozen to hundreds of leaves; one broadcast per
leaf would pay the group's hop latency per leaf, so every rank packs the
leaves into one contiguous uint8 buffer and the group moves that once.
The leaves go in `train/session.py` `flatten`'s order (dict keys sorted,
lists in order, None no leaf), which is jax's `tree_flatten` order: a JAX
learner's buffer and the port's hold the same bytes in the same places,
so either side can send to the other.  It runs over this module's groups,
or over a runtime's collective face when given one (`serve/runtime.py`:
`runtime.broadcast_async(payload, src_rank, group_name)` over a group the
members joined with `runtime.init_collective_group`).  The source rank
gets its own tree back.  Every other rank passes a tree of the same
structure, leaf shapes and dtypes (torch tensors or numpy arrays, of which
only shape and dtype are read: `torch.empty` will do) and gets CPU torch
tensors viewed from the received buffer, since numpy has no bf16.  A
byte count that differs from the template's raises instead of
mis-slicing.
"""
from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import tracing
from ray_tpu_torch._private import failpoints, memledger, profiling
from ray_tpu_torch.collective import ring as _ring
from ray_tpu_torch.collective.rendezvous import _Rendezvous
from ray_tpu_torch.serve.runtime import COLLECTIVE_TIMEOUT_S, ServeRuntime
from ray_tpu_torch.train.session import flatten, unflatten

# Group registry, keyed by (group name, member): see the module
# docstring.  Not thread-local: an actor's methods may run on any thread
# of its pool (max_concurrency > 1).
_registry_lock = threading.Lock()
_registry: dict[tuple, "_GroupState"] = {}


def _member() -> str | None:
    """The calling actor's id; None for a driver or a task (the
    per-process key)."""
    from ray_tpu_torch.runtime_context import get_runtime_context

    return get_runtime_context().get_actor_id()


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    dt = np.dtype(x.dtype)
    if dt.name == "bfloat16":             # ml_dtypes' bf16 (a JAX leaf)
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(x.shape, dtype=np.int64)) * np.dtype(x.dtype).itemsize


def _as_bytes(x) -> torch.Tensor:
    """A leaf's bytes as a flat uint8 tensor on the leaf's device."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(x)
        return torch.from_numpy(a.reshape(-1).view(np.uint8))
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def pack(leaves: list) -> np.ndarray:
    """The leaves' bytes, concatenated in order, as one numpy uint8 array
    (one device-to-host copy when the leaves are on one CUDA device)."""
    parts = [_as_bytes(x) for x in leaves]
    cuda = [p.device for p in parts if p.device.type == "cuda"]
    if cuda:
        flat = torch.cat([p.to(cuda[0]) for p in parts]).cpu()
    else:
        flat = torch.cat(parts) if parts \
            else torch.empty(0, dtype=torch.uint8)
    return flat.numpy()


def unpack(flat, template: list) -> list:
    """CPU torch tensors with the template leaves' shapes and dtypes,
    viewed from `flat` (numpy or a uint8 tensor) in order."""
    if isinstance(flat, torch.Tensor):
        buf = flat.reshape(-1).view(torch.uint8)
    else:
        a = np.asarray(flat).reshape(-1).view(np.uint8)
        with warnings.catch_warnings():
            # A payload from a shared object store is read-only; the
            # views are only read (the engine copies them at its swap).
            warnings.filterwarnings("ignore", message=".*not writable.*")
            buf = torch.from_numpy(a)
    out, off = [], 0
    for x in template:
        n = _nbytes(x)
        dtype = _torch_dtype(x)
        part = buf[off:off + n]
        if off % dtype.itemsize:
            part = part.clone()           # a dtype view needs alignment
        out.append(part.view(dtype).reshape(tuple(x.shape)))
        off += n
    return out


class CollectiveWork:
    """Handle returned by the *_async collectives: `wait()`/`result()`
    block for (and return) the collective's result; exceptions from the
    schedule (timeouts naming missing ranks, a destroyed group, ...)
    re-raise here."""

    def __init__(self, fut, seq: int):
        self._fut = fut
        self.seq = seq

    def wait(self, timeout: float | None = None):
        return self._fut.result(timeout)

    # get-style alias
    def result(self, timeout: float | None = None):
        return self.wait(timeout)

    def done(self) -> bool:
        return self._fut.done()


class _GroupState:
    """One member's state in one group: its rank, seq counter, ordered op
    thread and prefetch pool."""

    def __init__(self, name: str, world_size: int, rank: int, rendezvous,
                 timeout_s: float):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.rendezvous = rendezvous
        self.seq = 0
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        # One op thread: execution order == seq (submission) order, for
        # the sync and async forms alike.
        self._ops = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"col-{name}-r{rank}")
        # Prefetch pool: a hop's sub-chunk pulls run concurrently (their
        # round trips overlap) while the reduce consumes them in order.
        self.prefetcher = ThreadPoolExecutor(
            max_workers=max(2, _ring.PIPELINE_CHUNKS),
            thread_name_prefix=f"col-pf-{name}-r{rank}")

    def submit(self, fn) -> CollectiveWork:
        """Assign the next seq under the lock and queue `fn(seq)` on the
        ordered op thread.  The caller's trace context is captured HERE
        (call time, caller thread) and re-installed around the op: the op
        thread otherwise has no idea which request or step asked."""
        ctx = tracing.capture() if tracing.ENABLED else None

        def run(seq: int):
            with tracing.context(ctx):
                return fn(seq)

        with self._lock:
            self.seq += 1
            seq = self.seq
            fut = self._ops.submit(run, seq)
        return CollectiveWork(fut, seq)

    def close(self) -> None:
        self._ops.shutdown(wait=False)
        self.prefetcher.shutdown(wait=False)


def _rdv_name(group_name: str) -> str:
    return f"collective_rdv:{group_name}"


def init_collective_group(world_size: int, rank: int,
                          backend: str = "object_store",
                          group_name: str = "default",
                          timeout_s: float | None = None) -> None:
    """Join a collective group as `rank`; every member calls it, from its
    own actor, task or driver (ray: collective.py:120).  `backend` is
    accepted for the reference's signature; the object plane is the one
    transport.

    Re-using a group NAME for a new incarnation needs
    `destroy_collective_group` in between (it drains and kills the
    rendezvous, so the re-create binds a FRESH actor).  Without a
    destroy, a same-world re-init reuses the detached rendezvous and
    `configure` scrubs stale slots only when world_size CHANGED: an
    unconditional clear would race a concurrent group creation."""
    if rank < 0 or rank >= world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    if timeout_s is None:
        timeout_s = COLLECTIVE_TIMEOUT_S
    rdv = ray_tpu_torch.remote(_Rendezvous).options(
        name=_rdv_name(group_name), get_if_exists=True,
        lifetime="detached", max_concurrency=max(64, world_size * 8),
        num_cpus=0).remote(world_size)
    # A stale rendezvous (same name, earlier incarnation) must not carry
    # its old world_size or pending slots into this group.
    ray_tpu_torch.get(rdv.configure.remote(world_size),
                      timeout=timeout_s + 30.0)
    key = (group_name, _member())
    with _registry_lock:
        old = _registry.pop(key, None)
        _registry[key] = _GroupState(group_name, world_size, rank, rdv,
                                     timeout_s)
    if old is not None:
        old.close()


def create_collective_group(actors: list, world_size: int, ranks: list[int],
                            backend: str = "object_store",
                            group_name: str = "default",
                            timeout: float | None = None) -> None:
    """Driver-side declaration (ray: collective.py create_collective_group):
    each actor exposes `init_collective_group(world_size, rank, backend,
    group_name)`, typically calling this module's.  Waits at most
    `timeout` seconds (COLLECTIVE_TIMEOUT_S, 120 s, when None)."""
    refs = [a.init_collective_group.remote(world_size, r, backend, group_name)
            for a, r in zip(actors, ranks)]
    if timeout is None:
        timeout = COLLECTIVE_TIMEOUT_S
    ray_tpu_torch.get(refs, timeout=timeout)


def deregister_collective_group(group_name: str = "default") -> None:
    """Drop the CALLER's state in the group (op thread, prefetch pool)
    without touching the shared rendezvous: at a membership epoch change
    the driver destroys the stale group, and each surviving member only
    forgets its own handle before joining the next one."""
    with _registry_lock:
        g = _registry.pop((group_name, _member()), None)
    if g is not None:
        g.close()


def destroy_collective_group(group_name: str = "default",
                             reason: str | None = None) -> None:
    """Tear the group down for every member (ray: collective.py
    destroy_collective_group).  Call after every rank is done, or to
    UNPARK ranks waiting on a dead peer: `reason` becomes the error every
    parked waiter raises.  Works from any process, the driver that formed
    the group with create_collective_group included: the named rendezvous
    is drained (parked waiters get the error, slots are cleared), killed,
    and its name waited (at most 10 s) to release."""
    with _registry_lock:
        g = _registry.pop((group_name, _member()), None)
    rdv = g.rendezvous if g is not None else None
    if g is not None:
        g.close()
    if rdv is None:
        try:
            rdv = ray_tpu_torch.get_actor(_rdv_name(group_name))
        except Exception:  # noqa: BLE001 - never created / already gone
            rdv = None
    if rdv is None:
        return
    try:
        ray_tpu_torch.get(rdv.drain.remote(
            reason or f"collective group {group_name!r} destroyed"),
            timeout=10.0)
    except Exception:  # noqa: BLE001 - best effort before the kill
        pass
    try:
        ray_tpu_torch.kill(rdv)
    except Exception:  # noqa: BLE001 - another member already killed it
        pass
    # An immediate re-create of the same name would otherwise bind the
    # DYING actor (the controller hides it only once it is DEAD).
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor(_rdv_name(group_name))
        except Exception:  # noqa: BLE001 - gone
            break
        time.sleep(0.1)


def get_rank(group_name: str = "default") -> int:
    """The caller's rank in `group_name`, -1 outside it."""
    g = _registry.get((group_name, _member()))
    return g.rank if g else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _registry.get((group_name, _member()))
    return g.world_size if g else -1


def _group(group_name: str) -> _GroupState:
    g = _registry.get((group_name, _member()))
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized for this "
            f"member; call init_collective_group first")
    return g


# -------------------------------------------------------------- tensors
def _host(tensor) -> tuple[torch.Tensor, str]:
    """(a contiguous CPU tensor, the input's kind: "torch" or "numpy")."""
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().contiguous(), "torch"
    a = np.ascontiguousarray(tensor)
    with warnings.catch_warnings():
        # A read-only input (a view of the object store) is only read.
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(a), "numpy"


def _as_kind(t: torch.Tensor, kind: str):
    return t.numpy() if kind == "numpy" else t


# ------------------------------------------------------------- exchange
def _exchange(g: _GroupState, op: str, value, seq: int) -> dict:
    """Every rank's `value`, by rank, through one matched exchange on the
    rendezvous: each deposits a ref and waits (deadline `g.timeout_s`,
    naming the missing ranks) for all of them."""
    if failpoints.ACTIVE:
        failpoints.fire("collective.chunk_send")
    with memledger.tag("collective_chunk",
                       label="collective/collective.py exchange"):
        ref = ray_tpu_torch.put(value)
    # The ref rides inside a list: a top-level ref argument would be
    # resolved to its value before the call, and the rendezvous must pass
    # the ref through untouched.
    refs = ray_tpu_torch.get(g.rendezvous.exchange.remote(
        (op, seq), g.rank, [ref], g.timeout_s),
        timeout=g.timeout_s + 30.0)
    return {r: ray_tpu_torch.get(refs[r][0], timeout=g.timeout_s)
            for r in sorted(refs)}


# --------------------------------------------------------- schedule pick
def _pick_schedule(nbytes: int) -> str:
    return "ring" if nbytes >= _ring.RING_MIN_BYTES else "tree"


def _traced(g: _GroupState, schedule: str, op: str, x: torch.Tensor,
            seq: int, fn):
    """Run one collective body with phase accounting around it: the
    one-shot tracer when armed, and, while spans are on, a recorder span
    per op carrying the send/pull/reduce/wait sums the schedules stamp
    into the record."""
    rec = profiling.consume_collective_arm()
    armed = rec is not None
    if not armed and tracing.ENABLED:
        rec = profiling.blank_collective_rec()
    if rec is not None:
        rec.update(schedule=schedule, op=op, bytes=int(x.nbytes),
                   world=g.world_size, rank=g.rank, seq=seq)
    t_span0 = time.time()
    err = None
    try:
        return fn(rec)
    except BaseException as e:  # noqa: BLE001 - recorded, re-raised
        err = type(e).__name__
        raise
    finally:
        if armed:
            # publish also bridges the record into the recorder.
            profiling.publish_collective_trace(rec)
        elif rec is not None:
            attrs = {k: rec[k] for k in
                     ("schedule", "op", "bytes", "world", "rank", "seq",
                      "hops", "sent_bytes", "recv_bytes") if k in rec}
            for k in profiling.COLLECTIVE_PHASES:
                if rec.get(k):
                    attrs[k] = round(rec[k], 1)
            if err:
                attrs["error"] = err
            tracing.emit(f"collective.{op}", t_span0, attrs=attrs)


# ------------------------------------------------------------- public API
def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    """ray: collective.py:258.  The reduction over every rank's tensor
    (same shape and dtype on every rank), of the input's dtype and kind."""
    return allreduce_async(tensor, group_name, op).wait()


def allreduce_async(tensor, group_name: str = "default",
                    op: str = "sum") -> CollectiveWork:
    """Async allreduce: a wait()-able CollectiveWork, so the caller
    overlaps the sync with other work.  Per member, ops run in submission
    order."""
    g = _group(group_name)
    x, kind = _host(tensor)
    if op not in _ring.BINARY_OPS:
        raise ValueError(f"unknown reduce op {op!r}; valid: "
                         f"{sorted(_ring.BINARY_OPS)}")
    schedule = _pick_schedule(x.nbytes)

    def run(seq: int):
        def body(rec):
            if schedule == "ring":
                return _ring.ring_allreduce(g, x, op, seq, rec)
            return _ring.tree_allreduce(g, x, op, seq, rec)
        return _as_kind(_traced(g, schedule, f"allreduce:{op}", x, seq,
                                body), kind)

    return g.submit(run)


def allgather(tensor, group_name: str = "default") -> list:
    return allgather_async(tensor, group_name).wait()


def allgather_async(tensor,
                    group_name: str = "default") -> CollectiveWork:
    """Every rank's tensor, by rank.  The ring path (at least the ring
    threshold) needs same-shape, same-dtype tensors on every rank (the
    MPI_Allgather contract); below it, one matched exchange, which takes
    any shapes."""
    g = _group(group_name)
    x, kind = _host(tensor)
    schedule = "ring" if _pick_schedule(x.nbytes) == "ring" \
        else "gather"

    def run(seq: int):
        def body(rec):
            if schedule == "ring":
                return _ring.ring_allgather(g, x, seq, rec)
            parts = _exchange(g, "allgather", x, seq)
            if rec is not None:
                rec["sent_bytes"] += x.nbytes
                rec["recv_bytes"] += sum(v.nbytes for r, v in parts.items()
                                         if r != g.rank)
                rec["hops"] += 1
            return [parts[r] for r in sorted(parts)]
        outs = _traced(g, schedule, "allgather", x, seq, body)
        return [_as_kind(o, kind) for o in outs]

    return g.submit(run)


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    """Each rank gets its 1/world slice (along dim 0, numpy's
    `array_split`) of the reduction (ray: collective.reducescatter)."""
    return reducescatter_async(tensor, group_name, op).wait()


def reducescatter_async(tensor, group_name: str = "default",
                        op: str = "sum") -> CollectiveWork:
    g = _group(group_name)
    x, kind = _host(tensor)
    schedule = _pick_schedule(x.nbytes)

    def run(seq: int):
        def body(rec):
            if schedule == "ring":
                return _ring.ring_reducescatter(g, x, op, seq, rec)
            # Latency regime: tree-allreduce then slice, the same hop
            # count as a dedicated halving schedule at these sizes.
            reduced = _ring.tree_allreduce(g, x, op, seq, rec)
            return torch.tensor_split(reduced, g.world_size,
                                      dim=0)[g.rank].clone()
        return _as_kind(_traced(g, schedule, f"reducescatter:{op}", x,
                                seq, body), kind)

    return g.submit(run)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return broadcast_async(tensor, src_rank, group_name).wait()


def broadcast_async(tensor, src_rank: int = 0,
                    group_name: str = "default") -> CollectiveWork:
    """Rank `src_rank`'s tensor on every rank (the others' `tensor` is
    not read and may be None), of the source's dtype, shape and kind.
    Receivers do not know the size, so the topology is always the tree;
    each edge ships large payloads by ref."""
    g = _group(group_name)
    if g.rank == src_rank:
        x, kind = _host(tensor)
    else:
        x, kind = torch.zeros(0), "torch"

    def run(seq: int):
        def body(rec):
            return _ring.tree_broadcast(
                g, x if g.rank == src_rank else None, src_rank, seq, rec,
                kind)
        out, got_kind = _traced(g, "tree", f"broadcast:{src_rank}", x,
                                seq, body)
        return _as_kind(out, got_kind)

    return g.submit(run)


def barrier(group_name: str = "default") -> None:
    """Return once every rank has reached it (one matched exchange)."""
    g = _group(group_name)

    def run(seq: int):
        _exchange(g, "barrier", np.zeros(0), seq)

    g.submit(run).wait()


def send(tensor, dst_rank: int, group_name: str = "default",
         tag: int = 0) -> None:
    """P2P send (ray: collective.send): `tensor` (of its kind) to
    `dst_rank`'s `recv` with the same tag, in order."""
    g = _group(group_name)
    with memledger.tag("collective_chunk",
                       label="collective/collective.py send"):
        ref = ray_tpu_torch.put(tensor)
    ray_tpu_torch.get(g.rendezvous.put_p2p.remote(
        (g.rank, dst_rank, tag), [ref]), timeout=g.timeout_s + 30.0)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    """P2P recv (ray: collective.recv): the next `send` from `src_rank`
    with this tag; waits at most the group's timeout."""
    g = _group(group_name)
    wrapped = ray_tpu_torch.get(g.rendezvous.take_p2p.remote(
        (src_rank, g.rank, tag), g.timeout_s),
        timeout=g.timeout_s + 30.0)
    return ray_tpu_torch.get(wrapped[0], timeout=g.timeout_s)


# ----------------------------------------------- packed pytree broadcast
class _Unpacked:
    """Waitable of broadcast_pytree_async: the tree, unpacked at the first
    wait on the WAITER's thread (unpacking must not queue behind other
    collectives on the group's op thread)."""

    _UNSET = object()

    def __init__(self, inner, fn):
        self._inner, self._fn = inner, fn
        self._out = _Unpacked._UNSET

    def wait(self, timeout: float | None = None):
        if self._out is _Unpacked._UNSET:
            self._out = self._fn(self._inner.wait(timeout))
        return self._out


def broadcast_pytree(tree, src_rank: int = 0, group_name: str = "default",
                     *, runtime: ServeRuntime | None = None,
                     timeout: float | None = None):
    """`tree` with rank `src_rank`'s leaf values, on every rank of
    `group_name` (see the module docstring)."""
    return broadcast_pytree_async(tree, src_rank, group_name,
                                  runtime=runtime).wait(timeout)


def broadcast_pytree_async(tree, src_rank: int = 0,
                           group_name: str = "default", *,
                           runtime: ServeRuntime | None = None):
    """Start the packed broadcast over this module's group `group_name`,
    or over `runtime`'s collective face when given; returns a waitable
    whose `.wait(timeout)` gives the tree.  The source packs before this
    returns, so it may change its tree at once; the pack is recorded as a
    `collective.pack` span (its bytes in the attrs) on the runtime's
    tracing face, or this process's recorder."""
    rank = runtime.get_rank(group_name) if runtime is not None \
        else _group(group_name).rank
    is_src = rank == src_rank
    leaves: list = []
    spec = flatten(tree, leaves)
    total = sum(_nbytes(x) for x in leaves)
    payload = None
    if is_src:
        span = runtime.span if runtime is not None else tracing.span
        with span("collective.pack", attrs={"bytes": total,
                                            "leaves": len(leaves)}):
            payload = pack(leaves)
    bcast = runtime.broadcast_async if runtime is not None \
        else broadcast_async
    work = bcast(payload, src_rank, group_name)

    def finish(flat):
        if is_src:
            return tree
        got = np.asarray(flat).nbytes if not isinstance(flat, torch.Tensor) \
            else flat.numel() * flat.element_size()
        if got != total:
            raise RuntimeError(
                f"broadcast_pytree: received {got} bytes but "
                f"this rank's template tree holds {total} — src and "
                "receiver param trees have drifted (different model "
                "config / stale template?)")
        return unflatten(spec, unpack(flat, leaves))

    return _Unpacked(work, finish)
