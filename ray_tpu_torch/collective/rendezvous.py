"""The rendezvous actor of a collective group (port of `_Rendezvous` in
ray_tpu/collective/collective.py).

One named, detached async actor per group (`collective_rdv:<group>`,
num_cpus=0) matches the members' mailbox deposits and takes and their
per-(seq, op) exchanges; every wait has a deadline and names what never
arrived.  It lives in a module of its own, apart from the schedules,
because it runs in a plain worker process of its own: this module imports
only the standard library, so that process never loads torch.
"""
from __future__ import annotations


class _Rendezvous:
    """Named actor: neighbor mailbox + per-(seq, op) contribution
    matching.  Async actor so waiting ranks don't block each other (ray's
    rendezvous is the NCCL unique-id store, collective_group/
    nccl_collective_group.py _rendezvous helpers).  It never touches bulk
    payload: only refs and small inline tensors ride through it."""

    def __init__(self, world_size: int):
        import asyncio

        self.world_size = world_size
        # (seq, op) -> {"refs": {rank: obj}, "event": asyncio.Event,
        #               "taken": int, "error": str | None}
        self.pending: dict = {}
        self.p2p: dict = {}
        self.asyncio = asyncio

    async def configure(self, world_size: int) -> None:
        """Re-arm for a (re-)created group: a mismatched world_size means a
        new incarnation reused this detached actor's name — old pending
        slots would release collectives early or hand back stale refs."""
        if world_size != self.world_size:
            self.world_size = world_size
            self.pending.clear()
            self.p2p.clear()

    def _slot(self, key):
        slot = self.pending.get(key)
        if slot is None:
            slot = {"refs": {}, "event": self.asyncio.Event(), "taken": 0,
                    "error": None}
            self.pending[key] = slot
        return slot

    async def exchange(self, key, rank: int, ref,
                       timeout_s: float | None = None) -> dict:
        """Deposit rank's contribution; wait for all; return all refs.
        Deadline-bounded: on timeout each waiter raises a diagnostic
        naming the ranks that never arrived (satellite: a crashed rank
        must not block its peers forever)."""
        key = tuple(key)
        slot = self._slot(key)
        slot["refs"][rank] = ref
        if len(slot["refs"]) == self.world_size:
            slot["event"].set()
        try:
            if timeout_s is None:
                await slot["event"].wait()
            else:
                await self.asyncio.wait_for(slot["event"].wait(),
                                            timeout_s)
        except self.asyncio.TimeoutError:
            present = sorted(slot["refs"])
            missing = sorted(set(range(self.world_size))
                             - set(slot["refs"]))
            # Late arrivals must not complete against a half-abandoned
            # slot; drop it so they fail fast on their own timeout.
            self.pending.pop(key, None)
            raise TimeoutError(
                f"collective exchange {key} timed out after {timeout_s}s:"
                f" missing ranks {missing} (present: {present}, "
                f"world_size {self.world_size})") from None
        if slot["error"]:
            raise RuntimeError(slot["error"])
        refs = dict(slot["refs"])
        slot["taken"] += 1
        if slot["taken"] == self.world_size:
            self.pending.pop(key, None)
        return refs

    def _p2p_queue(self, key):
        q = self.p2p.get(tuple(key))
        if q is None:
            # asyncio.Queue gives FIFO matching of repeated sends with the
            # same (src, dst, tag) — no lost messages on rapid re-send.
            q = self.asyncio.Queue()
            self.p2p[tuple(key)] = q
        return q

    async def put_p2p(self, key, ref) -> None:
        await self._p2p_queue(key).put(ref)

    async def take_p2p(self, key, timeout_s: float | None = None):
        """Take one mailbox message; deadline-bounded with a diagnostic
        naming the key (whose src rank never delivered) on timeout."""
        key = tuple(key)
        q = self._p2p_queue(key)
        try:
            if timeout_s is None:
                msg = await q.get()
            else:
                msg = await self.asyncio.wait_for(q.get(), timeout_s)
        except self.asyncio.TimeoutError:
            if q.empty():
                self.p2p.pop(key, None)
            raise TimeoutError(
                f"collective p2p take {key} timed out after "
                f"{timeout_s}s: the sending rank never deposited "
                f"(crashed mid-collective? ranks disagreeing on the "
                f"schedule — e.g. heterogeneous tensor sizes straddling "
                f"ring.RING_MIN_BYTES?)") from None
        if q.empty():
            self.p2p.pop(key, None)
        if isinstance(msg, dict) and msg.get("__drained__"):
            raise RuntimeError(msg["__drained__"])
        return msg

    async def swap(self, put_key, msg, take_key,
                   timeout_s: float | None = None):
        """One ring hop's mailbox work in ONE round trip: deposit the
        outgoing message, then await the incoming one.  Every rank's
        swap deposits before it waits, so the ring always progresses."""
        await self._p2p_queue(put_key).put(msg)
        return await self.take_p2p(take_key, timeout_s)

    async def drain(self, reason: str) -> int:
        """Fail every parked waiter with `reason` and clear all slots —
        destroy_collective_group calls this before killing the actor so
        blocked peers get a diagnostic error instead of ActorDiedError."""
        n = 0
        for slot in self.pending.values():
            slot["error"] = reason
            slot["event"].set()
            n += 1
        for q in self.p2p.values():
            # One marker per parked getter is enough; extras are GC'd
            # with the actor.
            for _ in range(8):
                q.put_nowait({"__drained__": reason})
            n += 1
        self.pending.clear()
        self.p2p.clear()
        return n
