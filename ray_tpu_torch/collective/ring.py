"""Bandwidth-optimal pipelined collective schedules over the object plane
(port of ray_tpu/collective/ring.py).

- **Ring** (large tensors): reduce-scatter + allgather (Thakur et al.
  2005; Horovod).  Each rank moves 2*N*(world-1)/world bytes whatever the
  world size; every chunk hops peer to peer as object-plane puts, with
  the hop's payload split into sub-chunks whose pulls run concurrently on
  a prefetch pool while the local reduce consumes them in order
  (transport of sub-chunk k+1 overlaps the reduce of k).  The rendezvous
  mailbox carries ONE message per hop (the sub-chunk ref list), so a
  hop's control cost is one round trip.
- **Binomial tree** (small tensors): 2*ceil(log2 world) hops with the
  payload inline in the mailbox message; under the size threshold round
  trips dominate, so no put/pull indirection at all.

Tensors: every schedule works on a contiguous CPU torch tensor and keeps
its dtype (bf16 included, which numpy lacks).  A sub-chunk travels as a
numpy uint8 view of its bytes (`_wire`): one put, no conversion, and the
receiver reinterprets the bytes as the dtype it already knows (`_unwire`;
ring members hold same-dtype tensors by the group contract, and a
broadcast message names its dtype and shape).  Inline payloads ride as
the tensors themselves.

Reduction order: the ring accumulates chunk c along the ring (rank c+1,
c+2, ... c), the tree along the binomial recursion; both are exact for
min/max, any integer dtype, and float values without rounding (integers
within the mantissa).  Float sums that round may differ in the last
ULPs between schedules, as with any collective library.

Library-layer code: it reaches the runtime only through its public
surface (`ray_tpu_torch.put` / `get` / `ObjectRef`) and the
failpoint and memory-ledger hooks.
"""
from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private import failpoints, memledger

# Schedule threshold: tensors of at least RING_MIN_BYTES take the ring,
# smaller ones the tree.  Every member of a group must pick the same
# schedule for the same op, so this and the pipeline shape are constants
# rather than per-process settings.
RING_MIN_BYTES = 256 * 1024
# Sub-chunks per ring hop: the reduce of sub-chunk k overlaps the
# transport of sub-chunk k+1 (prefetch pool); each sub-chunk is kept at
# least PIPELINE_MIN_BYTES so per-object overhead stays amortized.
PIPELINE_CHUNKS = 4
PIPELINE_MIN_BYTES = 1 << 20

# Binary reduce ops: the ring and tree paths fold pairwise.
BINARY_OPS = {
    "sum": torch.add,
    "prod": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


def _wire(t: torch.Tensor) -> np.ndarray:
    """A contiguous tensor's bytes as a numpy uint8 view (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _unwire(a, dtype: torch.dtype) -> torch.Tensor:
    """Bytes received as numpy uint8 (often a read-only view of the
    object store, only read here) as a flat tensor of `dtype`."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.asarray(a).reshape(-1)).view(dtype)


def _nbytes(x) -> int:
    return int(getattr(x, "nbytes", 0))


def _bcast_by_ref(nbytes: int) -> bool:
    """Broadcast payload transport: inline through the mailbox below the
    ring threshold, object-plane refs above it: bulk bytes never ride the
    rendezvous actor."""
    return nbytes >= RING_MIN_BYTES


def _now() -> float:
    return time.monotonic()


# Tracer records are mutated from the op thread AND the prefetch-pool
# threads (concurrent sub-chunk pulls); dict `+=` is not atomic across
# bytecode boundaries, and recv_bytes is the schedule proof the tests
# check, so every accumulation takes the lock.
_REC_LOCK = threading.Lock()


def _acc(rec: dict | None, key: str, t0: float) -> None:
    if rec is not None:
        with _REC_LOCK:
            rec[key] += (_now() - t0) * 1e6


def _count(rec: dict | None, key: str, nbytes: int) -> None:
    if rec is not None:
        with _REC_LOCK:
            rec[key] += int(nbytes)


def _split_subchunks(chunk: torch.Tensor) -> list[torch.Tensor]:
    """Sub-chunks of one ring hop's payload (a 1-D tensor): enough
    pieces that pulls pipeline, each big enough that per-object overhead
    stays amortized."""
    if chunk.nbytes <= 0:
        return [chunk]
    p = max(1, min(PIPELINE_CHUNKS, chunk.nbytes // PIPELINE_MIN_BYTES))
    return list(torch.tensor_split(chunk, p))


def _put_wire(parts: list[torch.Tensor], label: str) -> list:
    with memledger.tag("collective_chunk", label=label):
        return [ray_tpu_torch.put(_wire(c)) for c in parts]


def _deposit(g, key: tuple, msg, nbytes: int, *, rec: dict | None,
             pending: list) -> None:
    """Hand one hop's message to the peer through the rendezvous mailbox.
    Fire-and-forget: deposits pipeline behind each other, and `_settle`
    confirms them in one batch at op end."""
    if failpoints.ACTIVE:
        failpoints.fire("collective.chunk_send")
    t0 = _now()
    pending.append(g.rendezvous.put_p2p.remote(key, msg))
    _acc(rec, "send_us", t0)
    _count(rec, "sent_bytes", nbytes)


def _submit_take(g, key: tuple):
    """Start a mailbox take; the actor side bounds the wait and names
    the missing peer on timeout (not a hang)."""
    return g.rendezvous.take_p2p.remote(key, g.timeout_s)


def _pull_one(g, ref, rec: dict | None):
    """Pull one sub-chunk through the object plane (prefetch-pool
    thread: pulls run concurrently and overlap the in-order reduce)."""
    t0 = _now()
    val = ray_tpu_torch.get(ref, timeout=g.timeout_s)
    _acc(rec, "pull_us", t0)
    _count(rec, "recv_bytes", _nbytes(val))
    return val


def _as_parts(g, parts: list, rec: dict | None) -> list:
    """One hop's payload parts in order: pull futures for by-ref
    sub-chunks (the pulls run concurrently on the prefetch pool,
    overlapping the in-order reduce), values for inline payloads."""
    if parts and isinstance(parts[0], ray_tpu_torch.ObjectRef):
        return [g.prefetcher.submit(_pull_one, g, r, rec) for r in parts]
    _count(rec, "recv_bytes", sum(_nbytes(v) for v in parts))
    return parts


def _take_msg(g, key: tuple, rec: dict | None):
    """Take one hop's mailbox message (tree paths: receive-only ranks)."""
    t0 = _now()
    msg = ray_tpu_torch.get(_submit_take(g, key),
                            timeout=g.timeout_s + 30.0)
    _acc(rec, "wait_us", t0)
    if rec is not None:
        rec["hops"] += 1
    return msg


def _swap_msg(g, put_key: tuple, msg: list, take_key: tuple,
              rec: dict | None) -> list:
    """ONE `swap` round trip: deposit the outgoing hop message, return
    the incoming one."""
    if failpoints.ACTIVE:
        failpoints.fire("collective.chunk_send")
    t0 = _now()
    incoming = ray_tpu_torch.get(
        g.rendezvous.swap.remote(put_key, msg, take_key, g.timeout_s),
        timeout=g.timeout_s + 30.0)
    _acc(rec, "wait_us", t0)
    if rec is not None:
        rec["hops"] += 1
    return incoming


def _swap_hop(g, put_key: tuple, payload: list[torch.Tensor],
              take_key: tuple, rec: dict | None, holds: list) -> list:
    """One ring hop: put the outgoing sub-chunks, swap their refs for
    the incoming hop's message, hand back in-order payload parts.  The
    put handles stay in `holds` until the op's completion ack proves the
    peer pulled them."""
    t0 = _now()
    msg = _put_wire(payload, "collective/ring.py ring hop")
    holds.extend(msg)
    _acc(rec, "send_us", t0)
    _count(rec, "sent_bytes", sum(c.nbytes for c in payload))
    return _as_parts(g, _swap_msg(g, put_key, msg, take_key, rec), rec)


def _consume(part):
    return part.result() if hasattr(part, "result") else part


def _settle(g, pending: list, holds: list, seq: int,
            rec: dict | None, *, ack: bool) -> None:
    """Op epilogue: confirm every mailbox deposit landed, then (ring
    paths) the neighbor completion ack: the downstream peer deposits its
    ack only after it consumed everything we sent, so our chunk refs can
    drop without racing its pulls.  The ack is one swap: ours to the
    upstream peer, the downstream's back."""
    t0 = _now()
    if pending:
        ray_tpu_torch.get(pending, timeout=g.timeout_s + 30.0)
    if ack and g.world_size > 1:
        me, w = g.rank, g.world_size
        up, down = (me - 1) % w, (me + 1) % w
        ray_tpu_torch.get(g.rendezvous.swap.remote(
            (seq, "ack", 0, me, up), [True],
            (seq, "ack", 0, down, me), g.timeout_s),
            timeout=g.timeout_s + 30.0)
    _acc(rec, "wait_us", t0)
    holds.clear()


def _reduce_into(binop, incoming: torch.Tensor, own: torch.Tensor,
                 rec: dict | None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    if failpoints.ACTIVE:
        failpoints.fire("collective.reduce")
    t0 = _now()
    # out= writes straight into the caller's slice of the result: no
    # per-hop intermediate tensors allocated, copied, then concatenated.
    res = binop(incoming, own) if out is None \
        else binop(incoming, own, out=out)
    _acc(rec, "reduce_us", t0)
    return res


# --------------------------------------------------------------- ring
def _ring_reduce_scatter(g, chunk_views: list[torch.Tensor], op: str,
                         seq: int, rec: dict | None, holds: list,
                         out_final: torch.Tensor,
                         phase: str = "rs") -> torch.Tensor:
    """Ring reduce-scatter over world_size flat chunks.  W-1 hops; at
    step s rank r forwards the partial for chunk (r-s-1) mod W to r+1 and
    folds its own contribution into chunk (r-s-2) mod W, so rank r ends
    owning the fully reduced chunk r, written into `out_final` (a caller
    slice) on the last hop.  Each intermediate hop reduces into a buffer
    of its own, never one reused: a put hands a peer in the same process
    (two members in the device worker) the buffer itself, not a copy.
    Bytes per rank: N*(world-1)/world."""
    w, r = g.world_size, g.rank
    binop = BINARY_OPS[op]
    dtype = out_final.dtype
    nxt, prv = (r + 1) % w, (r - 1) % w
    acc: torch.Tensor | None = None
    for s in range(w - 1):
        send_idx = (r - s - 1) % w
        recv_idx = (r - s - 2) % w
        send_data = chunk_views[send_idx] if s == 0 else acc
        own = chunk_views[recv_idx]
        target = out_final if s == w - 2 \
            else torch.empty(len(own), dtype=dtype)
        incoming = _swap_hop(
            g, (seq, phase, s, r, nxt),
            _split_subchunks(send_data),
            (seq, phase, s, prv, r), rec, holds)
        own_subs = torch.tensor_split(own, len(incoming))
        tgt_subs = torch.tensor_split(target, len(incoming))
        for part, own_sub, tgt_sub in zip(incoming, own_subs, tgt_subs):
            _reduce_into(binop, _unwire(_consume(part), dtype), own_sub,
                         rec, out=tgt_sub)
        acc = target
    if acc is None:          # world_size == 1
        out_final.copy_(chunk_views[0])
        acc = out_final
    return acc


def _ring_allgather_chunks(g, slices: list[torch.Tensor], my_idx: int,
                           seq: int, rec: dict | None, holds: list,
                           phase: str = "ag") -> None:
    """Ring allgather into pre-placed output slices: `slices[my_idx]`
    already holds this rank's chunk; W-1 store-and-forward hops fill the
    rest in place (at step s rank r forwards chunk (r-s) mod W and
    receives chunk (r-s-1) mod W).  Hops re-put the forwarded bytes, so
    every pull hits the neighbor and the borrow chain stays one hop deep.
    Bytes per rank: the sum of the other chunks."""
    w, r = g.world_size, g.rank
    nxt, prv = (r + 1) % w, (r - 1) % w
    for s in range(w - 1):
        send_idx = (r - s) % w
        recv_idx = (r - s - 1) % w
        parts = _swap_hop(
            g, (seq, phase, s, r, nxt),
            _split_subchunks(slices[send_idx]),
            (seq, phase, s, prv, r), rec, holds)
        dst = slices[recv_idx]
        vals = [_unwire(_consume(p), dst.dtype) for p in parts]
        got = sum(v.numel() for v in vals)
        if got != dst.numel():
            raise ValueError(
                f"ring allgather requires same-shape, same-dtype tensors "
                f"on every rank (hop {s}: got {got} elements for chunk "
                f"{recv_idx}, expected {dst.numel()})")
        t0 = _now()
        for val, tgt in zip(vals, torch.tensor_split(dst, len(vals))):
            # Copy out of the store's read view into the output slice
            # (the view's pin drops with it).
            tgt.copy_(val)
        _acc(rec, "reduce_us", t0)


def ring_allreduce(g, x: torch.Tensor, op: str, seq: int,
                   rec: dict | None) -> torch.Tensor:
    """Ring allreduce = reduce-scatter + allgather over the flattened
    tensor: 2*N*(world-1)/world bytes per rank.  Both phases write
    straight into one pre-allocated result; the allgather forwards
    result slices, so no intermediate copies."""
    w = g.world_size
    if w == 1:
        return x.clone()
    flat = x.reshape(-1)
    chunk_views = list(torch.tensor_split(flat, w))
    result = torch.empty_like(flat)
    out_slices = list(torch.tensor_split(result, w))
    holds: list = []
    _ring_reduce_scatter(g, chunk_views, op, seq, rec, holds,
                         out_final=out_slices[g.rank])
    _ring_allgather_chunks(g, out_slices, g.rank, seq, rec, holds)
    _settle(g, [], holds, seq, rec, ack=True)
    return result.reshape(x.shape)


def ring_reducescatter(g, x: torch.Tensor, op: str, seq: int,
                       rec: dict | None) -> torch.Tensor:
    """Ring reduce-scatter: rank r gets the reduction's r-th
    `tensor_split(..., world, dim=0)` slice (numpy's `array_split`).
    Bytes per rank: N*(world-1)/world."""
    w = g.world_size
    axis_chunks = torch.tensor_split(x, w, dim=0)
    if w == 1:
        return axis_chunks[0].clone()
    chunk_views = [c.reshape(-1) for c in axis_chunks]
    out = torch.empty(axis_chunks[g.rank].shape, dtype=x.dtype)
    holds: list = []
    _ring_reduce_scatter(g, chunk_views, op, seq, rec, holds,
                         out_final=out.reshape(-1))
    _settle(g, [], holds, seq, rec, ack=True)
    return out


def ring_allgather(g, x: torch.Tensor, seq: int,
                   rec: dict | None) -> list[torch.Tensor]:
    """Ring allgather of same-shape per-rank tensors (the group contract,
    as in MPI_Allgather): W-1 store-and-forward hops, N*(world-1) bytes
    per rank."""
    w = g.world_size
    if w == 1:
        return [x.clone()]
    outs = [torch.empty_like(x) for _ in range(w)]
    outs[g.rank].copy_(x)
    holds: list = []
    _ring_allgather_chunks(g, [o.reshape(-1) for o in outs], g.rank,
                           seq, rec, holds)
    _settle(g, [], holds, seq, rec, ack=True)
    return outs


# --------------------------------------------------------- binomial tree
def tree_allreduce(g, x: torch.Tensor, op: str, seq: int,
                   rec: dict | None) -> torch.Tensor:
    """Binomial-tree allreduce for the latency regime: reduce to rank 0
    (ceil(log2 W) hops), broadcast back down (as many).  Payloads ride
    inline in the mailbox message: no put/pull round trips."""
    w, r = g.world_size, g.rank
    acc = x
    if w == 1:
        return acc.clone()
    binop = BINARY_OPS[op]
    pending: list = []
    # -- reduce up --
    mask = 1
    while mask < w:
        if r & mask:
            _deposit(g, (seq, "tr", mask, r, r - mask), [acc], acc.nbytes,
                     rec=rec, pending=pending)
            break
        src = r + mask
        if src < w:
            incoming = _consume(_as_parts(g, _take_msg(
                g, (seq, "tr", mask, src, r), rec), rec)[0])
            acc = _reduce_into(binop, acc, incoming, rec)
        mask <<= 1
    peel = (r & -r) if r else 0
    # -- broadcast down (mirror) --
    if r != 0:
        parent = r - peel
        acc = _consume(_as_parts(g, _take_msg(
            g, (seq, "tb", peel, parent, r), rec), rec)[0])
    m = (peel >> 1) if r else 1
    if r == 0:
        while m < w:
            m <<= 1
        m >>= 1
    while m >= 1:
        child = r + m
        if child < w:
            _deposit(g, (seq, "tb", m, r, child), [acc], acc.nbytes,
                     rec=rec, pending=pending)
        m >>= 1
    _settle(g, pending, [], seq, rec, ack=False)
    return acc.clone()


def tree_broadcast(g, x: torch.Tensor | None, src: int, seq: int,
                   rec: dict | None,
                   kind: str = "torch") -> tuple[torch.Tensor, str]:
    """Binomial-tree broadcast from `src`, ceil(log2 W) hops; returns
    the source's tensor and its `kind` ("numpy" or "torch": what the
    source was given, which receivers learn from the message).  Receivers do not know the size, so the TOPOLOGY cannot be
    size-gated, but the transport per edge is: a sender ships small
    payloads inline and large ones as object-plane sub-chunk refs, each
    message headed by the payload's dtype and shape; receivers follow
    what arrives.  Bulk bytes never ride the rendezvous actor."""
    w, r = g.world_size, g.rank
    vr = (r - src) % w
    if w == 1:
        return x.clone(), kind
    pending: list = []
    holds: list = []
    peel = (vr & -vr) if vr else 0
    if vr != 0:
        parent_vr = vr - peel
        (dtype, shape, kind), parts = _take_msg(
            g, (seq, "bc", peel, (parent_vr + src) % w, r), rec)
        parts = [_consume(p) for p in _as_parts(g, parts, rec)]
        if parts and isinstance(parts[0], torch.Tensor):
            data = parts[0]
        else:
            dt = getattr(torch, dtype)
            flat = _unwire(parts[0], dt) if len(parts) == 1 else \
                torch.cat([_unwire(p, dt) for p in parts])
            data = flat.reshape(shape)
        meta = (dtype, shape, kind)
    else:
        data = x
        meta = (str(x.dtype).removeprefix("torch."), tuple(x.shape), kind)
    m = (peel >> 1) if vr else 1
    if vr == 0:
        while m < w:
            m <<= 1
        m >>= 1
    by_ref = data.dim() > 0 and _bcast_by_ref(data.nbytes)
    if by_ref:
        payload = _put_wire(
            _split_subchunks(data.reshape(-1)),
            "collective/ring.py broadcast")
        holds.extend(payload)
    else:
        payload = [data]
    children = []
    while m >= 1:
        child_vr = vr + m
        if child_vr < w:
            child = (child_vr + src) % w
            _deposit(g, (seq, "bc", m, r, child), (meta, payload),
                     data.nbytes, rec=rec, pending=pending)
            children.append(child)
        m >>= 1
    if by_ref and vr != 0:
        # Consumed ack to the parent: its chunk refs may drop.
        _deposit(g, (seq, "bca", 0, r, (parent_vr + src) % w), [True], 0,
                 rec=rec, pending=pending)
    _settle(g, pending, holds if not (by_ref and children) else [],
            seq, rec, ack=False)
    if by_ref and children:
        # Our holds drop only after every child consumed what we sent
        # (the ring paths' neighbor ack, here per child).
        for child in children:
            ray_tpu_torch.get(_submit_take(g, (seq, "bca", 0, child, r)),
                              timeout=g.timeout_s + 30.0)
        holds.clear()
    return data.clone(), meta[2]
