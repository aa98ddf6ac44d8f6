"""Async RPC + pub/sub over TCP, driven by one process-wide IO thread.

Analog of the reference's gRPC layer (ray: src/ray/rpc/grpc_server.h,
client_call.h) and pub/sub (ray: src/ray/pubsub/publisher.h), on the
standard library alone: non-blocking sockets under one `selectors` loop.

Wire format: a message is a list of frames, sent as
  [u32 n][u64 len_0 .. len_{n-1}][frame_0 .. frame_{n-1}]
The first frame of a request or reply is the packed metadata:
  request:  [meta = pack([msgid, method, header]), *blobs]
  reply:    [meta = pack([msgid, ok(bool), header]), *blobs]
            on error: [pack([msgid, False, None]), pickled (exc, tb)]
msgid == 0 marks a one-way notification (no reply is sent).  `pack` is
pickle over a tree of plain values in which tuples become lists, as
msgpack would hand them back.

One listening socket per server; one connection per peer on the client,
which reconnects (every 0.1 s) while its peer is down and queues sends
meanwhile.  Replies are matched to futures by msgid.  Received frames
below 64 KiB are `bytes`; larger ones are writable `bytearray`s, so a
tensor or array lands without a further copy.

Threading model:
  - ALL sockets of the process live on ONE dedicated IO thread.
  - Senders post closures to the IO thread; a burst of posts costs one
    wake.  Per-connection send order is post order (the client-pipelining
    protocol relies on per-connection ordering).
  - Inbound messages are handed to each component's asyncio loop in
    arrival order through a batched call_soon_threadsafe (one loop wake
    per burst).  Handlers and reply futures run on their component's loop.
Multiple components in one process (the driver, agents, and controller
each run their own loop) share the one IO thread; each component's
sockets close with it.
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import errno
import logging
import os
import pickle
import selectors
import socket
import struct
import threading
import time
import traceback
from collections import deque
from typing import Any, Awaitable, Callable

from ray_tpu_torch._private import failpoints

logger = logging.getLogger(__name__)

Blobs = list[bytes]
Handler = Callable[[dict, Blobs], Awaitable[tuple[dict, Blobs] | dict | None]]


# ------------------------------------------------------------- hop tracer
# Opt-in per-hop latency stamps for ONE call at a time: monotonic-clock
# stamps ride the RPC header under "_hops" (CLOCK_MONOTONIC is system-wide
# on Linux, so stamps from different processes on one host compare
# directly).  Arm from the caller thread right before the API call; the
# next outgoing RPC whose method matches consumes the arm, every layer it
# crosses appends its stamp in place, the server echoes the dict back in
# the reply header, and the completed trace lands in _hop_last for
# profiling.last/take.  Zero cost when disarmed: one `is not None` check
# per call.
_hop_armed: dict | None = None
_hop_last: dict | None = None
# Generation guard: a late reply from an ABANDONED traced call (the
# hop_trace block timed out and exited) must not publish stale stamps
# over the next trace.  arm and disarm both bump the generation; a
# publish whose trace carries an older generation is dropped.
_hop_gen = 0


def arm_hop_trace(methods: tuple = ("actor_call",)) -> None:
    """One-shot: trace the next outgoing RPC whose method is in
    `methods`.  Stamps `caller_entry` now (the caller-thread API entry)."""
    global _hop_armed, _hop_gen
    _hop_gen += 1
    _hop_armed = {"methods": tuple(methods), "gen": _hop_gen,
                  "caller_entry": time.monotonic()}


def _consume_hop_arm(method: str) -> dict | None:
    """Claim the armed trace for this call (any thread; GIL-atomic swap)."""
    global _hop_armed
    armed = _hop_armed
    if armed is None or method not in armed["methods"]:
        return None
    _hop_armed = None
    return {"_gen": armed["gen"], "caller_entry": armed["caller_entry"]}


def take_hop_trace() -> dict | None:
    """The most recent completed trace (stamp name -> monotonic seconds),
    cleared on read."""
    global _hop_last
    trace, _hop_last = _hop_last, None
    return trace


def disarm_hop_trace() -> None:
    """Invalidate any still-pending arm AND any still-in-flight traced
    call (the traced block is over): a stale arm would be consumed by a
    later unrelated call, and a stale reply would publish over the next
    trace."""
    global _hop_armed, _hop_gen
    _hop_gen += 1
    _hop_armed = None


def _publish_hop_trace(hops: dict) -> None:
    global _hop_last
    if hops.get("_gen") != _hop_gen:
        return          # superseded trace: drop, don't impersonate
    _hop_last = dict(hops)
    # Flight-recorder bridge: the armed hop breakdown also lands in the
    # merged timeline as rpc.hop child spans (one per stamp pair).
    try:
        from ray_tpu_torch._private import profiling, spans

        if spans.ENABLED:
            spans.emit_stamps("rpc.hop", hops, profiling.HOP_ORDER)
    except Exception:  # noqa: BLE001 - tracing must never fail a call
        pass


# ----------------------------------------------------------- header codec
def _plain(x):
    """The value msgpack would hand back: tuples become lists, subclasses
    of the scalar types (IntEnum, numpy float64, ...) their base type."""
    t = type(x)
    if t is dict:
        return {k: _plain(v) for k, v in x.items()}
    if t is list or t is tuple:
        return [_plain(v) for v in x]
    if t in (str, int, float, bool, bytes) or x is None:
        return x
    for base in (bool, int, float, str, bytes):
        if isinstance(x, base):
            return base(x)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    raise TypeError(f"can not serialize {t.__name__!r} object in an rpc "
                    "header")


def pack_header(h) -> bytes:
    return pickle.dumps(_plain(h), protocol=5)


def unpack_header(b) -> Any:
    return pickle.loads(b)


def process_modules() -> dict:
    """This process's pid, the sorted top-level packages in sys.modules
    and the runtime's own `_private` modules it loaded (answered by the
    controller's and the agent's `modules` verb)."""
    import sys

    names = list(sys.modules)
    return {"pid": os.getpid(),
            "modules": sorted({m.split(".")[0] for m in names}),
            "private": sorted(m for m in names
                              if m.startswith("ray_tpu_torch._private."))}


class RpcError(Exception):
    pass


class RemoteError(RpcError):
    """Raised client-side when the remote handler threw; carries the cause."""

    def __init__(self, method: str, cause: BaseException | str):
        super().__init__(f"remote call {method!r} failed: {cause!r}")
        self.method = method
        self.cause = cause

    def __reduce__(self):
        # Default exception pickling replays args=(message,) into the
        # two-arg __init__ and explodes at UNPICKLE time — which kills
        # whatever recv loop touches the frame.  Rebuild from the real
        # fields (relay chains pickle these: proxy → client).
        return (RemoteError, (self.method, self.cause))


# ConnectionLost lives in the public exceptions module (serve's
# dead-replica requeue classifies on it without touching transport
# internals); re-exported here for its many transport-layer users.
from ray_tpu_torch.exceptions import ConnectionLost  # noqa: E402


# ------------------------------------------------------------ connections
_BIG = 1 << 16          # frames at least this long arrive as bytearray
_RECV_CHUNK = 1 << 18
_IOV_MAX = 512
_RECONNECT_S = 0.1
_U32 = struct.Struct("<I")


def _encode(frames) -> list:
    """Wire buffers of one message: the length block, then the frames."""
    views = [f if isinstance(f, (bytes, bytearray)) else memoryview(f).cast("B")
             for f in frames]
    head = _U32.pack(len(views)) + struct.pack(
        f"<{len(views)}Q", *(len(v) for v in views))
    return [head, *views]


class _Conn:
    """One TCP connection, touched only by the IO thread.

    `on_frames(frames)` gets each complete message; `on_close(conn)` runs
    once when the peer goes away.  A client connection (`address` set)
    reconnects after a loss and keeps its queued messages."""

    def __init__(self, io: "IoThread", sock: socket.socket | None,
                 on_frames, on_close=None, address: str | None = None,
                 max_queue: int = 0):
        self.io = io
        self.sock = sock
        self.on_frames = on_frames
        self.on_close = on_close
        self.address = address
        self.label = address or "?"
        self.max_queue = max_queue      # 0: unbounded
        self.connected = sock is not None
        self.closed = False
        self.outq: deque = deque()      # messages: [list of buffers]
        self._cur: list | None = None   # buffers of the message on the wire
        self._rbuf = bytearray()
        self._lens: list | None = None
        self._frames: list = []
        self._big: bytearray | None = None
        self._bigmv: memoryview | None = None
        self._bigoff = 0
        self._events = 0

    # ------------------------------------------------------------ setup
    def connect(self) -> None:
        host, port = self.address.rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        err = s.connect_ex((host, int(port)))
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            s.close()
            self.io._later(_RECONNECT_S, self._retry)
            return
        self.sock = s
        self.connected = False
        self._watch(selectors.EVENT_WRITE)

    def _retry(self) -> None:
        if not self.closed and self.sock is None:
            self.connect()

    def _watch(self, events: int) -> None:
        if events == self._events:
            return
        sel = self.io._sel
        if self._events == 0:
            sel.register(self.sock, events, self)
        elif events == 0:
            sel.unregister(self.sock)
        else:
            sel.modify(self.sock, events, self)
        self._events = events

    def _want(self) -> int:
        ev = selectors.EVENT_READ if self.connected else 0
        if not self.connected or self.outq or self._cur is not None:
            ev |= selectors.EVENT_WRITE
        return ev

    # ----------------------------------------------------------- events
    def on_event(self, mask: int) -> None:
        if not self.connected and mask & selectors.EVENT_WRITE:
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._lost()
                return
            self.connected = True
        if mask & selectors.EVENT_READ and not self._read():
            return
        if mask & selectors.EVENT_WRITE and self.connected:
            self.flush()
            return
        if not self.closed and self.sock is not None:
            self._watch(self._want())

    def send(self, frames) -> None:
        if self.closed:
            return
        if self.max_queue and len(self.outq) >= self.max_queue:
            return                       # slow subscriber: drop, as PUB
        self.outq.append(_encode(frames))
        depth = len(self.outq)
        if depth >= 256 and (depth & (depth - 1)) == 0:
            logger.warning("rpc send queue to %s at depth %d (peer not "
                           "draining)", self.label, depth)
        if self.connected:
            self.flush()

    def flush(self) -> None:
        while True:
            if self._cur is None:
                if not self.outq:
                    break
                self._cur = self.outq.popleft()
            bufs = self._cur[:_IOV_MAX]
            try:
                n = self.sock.sendmsg(bufs)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._lost()
                return
            # Drop what went out; keep the rest of a partial buffer.
            i = 0
            while i < len(self._cur):
                ln = len(self._cur[i])
                if n < ln:
                    if n:
                        self._cur[i] = memoryview(self._cur[i])[n:]
                    break
                n -= ln
                i += 1
            del self._cur[:i]
            if not self._cur:
                self._cur = None
        self._watch(self._want())

    def _read(self) -> bool:
        for _ in range(IoThread._RECV_BURST):
            try:
                if self._big is not None:
                    n = self.sock.recv_into(self._bigmv[self._bigoff:])
                else:
                    chunk = self.sock.recv(_RECV_CHUNK)
                    n = len(chunk)
            except (BlockingIOError, InterruptedError):
                return True
            except OSError:
                self._lost()
                return False
            if n == 0:
                self._lost()
                return False
            if self._big is not None:
                self._bigoff += n
                if self._bigoff < len(self._big):
                    continue
                self._frames.append(self._big)
                self._big = self._bigmv = None
            else:
                self._rbuf += chunk
            self._parse()
            if self.closed:
                return False
        return True

    def _parse(self) -> None:
        rb = self._rbuf
        while True:
            if self._lens is None:
                if len(rb) < 4:
                    return
                (n,) = _U32.unpack_from(rb, 0)
                if len(rb) < 4 + 8 * n:
                    return
                self._lens = list(struct.unpack_from(f"<{n}Q", rb, 4))
                del rb[:4 + 8 * n]
                self._frames = []
            while len(self._frames) < len(self._lens):
                ln = self._lens[len(self._frames)]
                if ln >= _BIG:
                    if len(rb) >= ln:
                        self._frames.append(rb[:ln])
                        del rb[:ln]
                        continue
                    big = bytearray(ln)
                    big[:len(rb)] = rb
                    self._big, self._bigmv = big, memoryview(big)
                    self._bigoff = len(rb)
                    rb.clear()
                    return
                if len(rb) < ln:
                    return
                self._frames.append(bytes(rb[:ln]))
                del rb[:ln]
            frames, self._frames, self._lens = self._frames, [], None
            self.io._deliver(self, frames)

    def _lost(self) -> None:
        """The connection broke: drop the message on the wire; a client
        reconnects and keeps the rest of its queue."""
        self._drop_sock()
        self._cur = None
        self._rbuf.clear()
        self._lens, self._frames = None, []
        self._big = self._bigmv = None
        if self.address is not None and not self.closed:
            self.io._later(_RECONNECT_S, self._retry)
            return
        self.close()

    def _drop_sock(self) -> None:
        if self.sock is not None:
            if self._events:
                try:
                    self.io._sel.unregister(self.sock)
                except (KeyError, ValueError):
                    pass
            self._events = 0
            try:
                self.sock.close()
            except OSError:
                pass
        self.sock = None
        self.connected = False

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        self._drop_sock()
        self.outq.clear()
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:  # noqa: BLE001
                logger.exception("connection close callback failed")


class _Listener:
    """A listening socket; each accepted connection gets `on_frames`."""

    def __init__(self, io: "IoThread", host: str, port: int | None,
                 on_frames, max_queue: int = 0):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # Fixed port: a restarted controller comes back at the SAME
        # address so agents and clients reconnect transparently.
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port or 0))
        s.listen(1024)
        s.setblocking(False)
        self.sock = s
        self.port = s.getsockname()[1]
        self.io = io
        self.on_frames = on_frames
        self.max_queue = max_queue
        self.conns: set[_Conn] = set()
        self.closed = False

    def on_event(self, _mask: int) -> None:
        for _ in range(64):
            try:
                s, peer = self.sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            s.setblocking(False)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(self.io, s, None, on_close=self.conns.discard,
                         max_queue=self.max_queue)
            conn.label = f"{peer[0]}:{peer[1]}"
            conn.on_frames = (lambda frames, c=conn:
                              self.on_frames([c, *frames]))
            self.conns.add(conn)
            conn._watch(conn._want())

    def close(self) -> None:
        self.closed = True
        try:
            self.io._sel.unregister(self.sock)
        except (KeyError, ValueError):
            pass
        self.sock.close()
        for c in list(self.conns):
            c.close()


# --------------------------------------------------------------- IO thread
class IoThread:
    """The process's transport thread.

    Connections are created and used only on this thread: components post
    closures (`post`), a burst of posts costs one wake.  Sends never block:
    a connection keeps its own queue, drained when the socket is writable
    — a slow peer never stalls the whole process's transport."""

    # Per-connection fairness cap per poll iteration: a flood on one
    # connection must not starve the others' recvs.
    _RECV_BURST = 256

    def __init__(self) -> None:
        self._timers: list = []         # (due, fn), few and short-lived
        self._sel = selectors.DefaultSelector()
        self._cmds: deque = deque()
        self._lock = threading.Lock()
        self._wake_pending = False
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="raytpu-io")
        self._thread.start()

    # ------------------------------------------------------- cross-thread
    def post(self, fn) -> None:
        """Run fn() on the IO thread; safe from any thread.  Posts made
        while a wake is already pending ride the same drain."""
        with self._lock:
            self._cmds.append(fn)
            if self._wake_pending:
                return
            self._wake_pending = True
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass

    def connect(self, address: str, on_frames,
                max_queue: int = 0) -> _Conn:
        """A client connection to `address` (connects on the IO thread)."""
        conn = _Conn(self, None, on_frames, address=address,
                     max_queue=max_queue)
        self.post(conn.connect)
        return conn

    def listen(self, host: str, port: int | None, on_frames,
               max_queue: int = 0) -> _Listener:
        """Bind now (the caller needs the port); accept on the IO thread."""
        lst = _Listener(self, host, port, on_frames, max_queue)
        self.post(lambda: self._sel.register(
            lst.sock, selectors.EVENT_READ, lst))
        return lst

    def unregister(self, target) -> None:
        """Close a connection or listener on the IO thread."""
        self.post(target.close)

    def send(self, conn: _Conn, frames, copy: bool = True) -> None:
        """Post a send; per-connection order is post order."""
        self.post(lambda: self._send_now(conn, frames, copy))

    def queue_depths(self) -> dict[str, int]:
        """Per-connection send-queue depths (label -> queued messages): a
        wedged-but-alive peer grows a queue here, observable before it
        becomes an OOM.  Racy snapshot, fine for a gauge."""
        out: dict[str, int] = {}
        for key in list(self._sel.get_map().values()):
            conn = key.data
            if isinstance(conn, _Conn) and conn.outq:
                out[conn.label] = len(conn.outq)
        return out

    # --------------------------------------------------------- IO-thread
    def _later(self, delay: float, fn) -> None:
        self._timers.append((time.monotonic() + delay, fn))

    def _send_now(self, conn: _Conn, frames, copy: bool = True) -> None:
        # Failpoint window: every outbound message of this process
        # crosses here on the IO thread (drop = the message vanishes in
        # flight; crash = the process dies with sends queued).
        if failpoints.ACTIVE and failpoints.fire("rpc.io_send"):
            return
        conn.send(frames)

    def _deliver(self, conn: _Conn, frames) -> None:
        # Failpoint window: every inbound message lands here (drop = the
        # message was lost on the wire).  An injected `error` degrades to
        # drop-with-log: there is no caller on the IO thread to deliver
        # it to.
        if failpoints.ACTIVE:
            try:
                if failpoints.fire("rpc.io_recv"):
                    return
            except Exception:  # noqa: BLE001
                logger.exception("rpc.io_recv failpoint: injected error "
                                 "-> message dropped")
                return
        try:
            conn.on_frames(frames)
        except Exception:  # noqa: BLE001
            logger.exception("io recv callback failed")

    def _run(self) -> None:
        while not self._closed:
            timeout = 1.0
            now = time.monotonic()
            if self._timers:
                timeout = min(timeout, max(0.0, min(
                    d for d, _ in self._timers) - now))
            try:
                events = self._sel.select(timeout)
            except OSError:
                return
            if self._timers:
                now = time.monotonic()
                due = [fn for d, fn in self._timers if d <= now]
                self._timers = [(d, fn) for d, fn in self._timers if d > now]
                for fn in due:
                    try:
                        fn()
                    except Exception:  # noqa: BLE001
                        logger.exception("io timer failed")
            try:
                while self._wake_r.recv(4096):
                    pass
            except OSError:
                pass
            while True:
                with self._lock:
                    if not self._cmds:
                        self._wake_pending = False
                        break
                    fns = list(self._cmds)
                    self._cmds.clear()
                for fn in fns:
                    try:
                        fn()
                    except Exception:  # noqa: BLE001
                        logger.exception("io command failed")
            for key, mask in events:
                target = key.data
                if target is None:
                    continue
                if getattr(target, "closed", False):
                    continue
                try:
                    target.on_event(mask)
                except Exception:  # noqa: BLE001
                    logger.exception("io event failed")

    def close(self) -> None:
        self._closed = True
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass


_io: IoThread | None = None
_io_pid: int | None = None
_io_lock = threading.Lock()


def io_thread() -> IoThread:
    """Process-singleton IO thread (pid-checked: a forked child must
    never reuse the parent's dead thread or its sockets)."""
    global _io, _io_pid
    if _io is not None and _io_pid == os.getpid():
        return _io
    with _io_lock:
        if _io is None or _io_pid != os.getpid():
            _io = IoThread()
            _io_pid = os.getpid()
    return _io


def queue_depths() -> dict[str, int]:
    """Process-wide per-connection send-queue gauge (empty when no IO
    thread has started)."""
    if _io is None or _io_pid != os.getpid():
        return {}
    return _io.queue_depths()


def _reset_io() -> None:
    global _io, _io_pid, _io_lock
    _io = None
    _io_pid = None
    _io_lock = threading.Lock()


os.register_at_fork(after_in_child=_reset_io)


class LoopPoster:
    """Batched call_soon_threadsafe onto one component's loop: a burst of
    inbound messages costs ONE self-pipe write, and callbacks run in post
    order (the ordering contract inbound dispatch relies on)."""

    def __init__(self, loop) -> None:
        self.loop = loop
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._scheduled = False

    def post(self, fn) -> None:
        with self._lock:
            self._pending.append(fn)
            if self._scheduled:
                return
            self._scheduled = True
        try:
            self.loop.call_soon_threadsafe(self._drain)
        except RuntimeError:
            # Loop closed mid-shutdown: drop.
            with self._lock:
                self._scheduled = False
                self._pending.clear()

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._scheduled = False
                    return
                fns = list(self._pending)
                self._pending.clear()
            for fn in fns:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    logger.exception("posted rpc callback failed")


class RpcServer:
    """Listening server dispatching to registered async handlers.

    Handlers run concurrently as tasks on the loop that called start(),
    created in arrival order (a handler's synchronous prefix observes
    per-connection request order — the client pipelining contract)."""

    def __init__(self, ctx: Any = None, host: str = "127.0.0.1",
                 port: int | None = None):
        self._io = io_thread()
        self._poster: LoopPoster | None = None
        self._loop = None
        self._closed = False
        self._handlers: dict[str, Handler] = {}
        # Bound now, accepting once start() registers the listener: a
        # connection made before that waits in the backlog.
        self._lst = _Listener(self._io, host, port, self._on_frames)
        self.address = f"{host}:{self._lst.port}"

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_all(self, obj: Any, prefix: str = "rpc_") -> None:
        """Register every `rpc_<name>` coroutine method of obj as <name>."""
        for attr in dir(obj):
            if attr.startswith(prefix):
                self.register(attr[len(prefix):], getattr(obj, attr))

    def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._poster = LoopPoster(self._loop)
        lst = self._lst
        self._io.post(lambda: self._io._sel.register(
            lst.sock, selectors.EVENT_READ, lst))

    def _on_frames(self, frames) -> None:               # IO thread
        # Recv stamp taken unconditionally (one clock read per message):
        # a traced request needs the IO-thread arrival time.
        t_recv = time.monotonic()
        self._poster.post(lambda: self._loop.create_task(
            self._dispatch(frames, t_recv)))

    def _reply(self, conn: _Conn, out: list) -> None:
        self._io.send(conn, out)

    async def _dispatch(self, frames, t_recv: float = 0.0) -> None:
        conn = frames[0]
        msgid, method = 0, "?"
        try:
            msgid, method, header = unpack_header(frames[1])
            blobs = frames[2:]
            handler = self._handlers.get(method)
            if handler is None:
                raise RpcError(f"no handler for {method!r}")
            hops = header.get("_hops") if isinstance(header, dict) else None
            if isinstance(hops, dict):
                hops["peer_recv"] = t_recv
                hops["peer_dispatch"] = time.monotonic()
            result = await handler(header or {}, blobs)
            if msgid == 0:
                return
            # Failpoint window: the handler RAN (state mutated) but the
            # reply is lost before it reaches the wire — the hardest
            # at-most-once window (drop = caller waits; crash = process
            # dies with the side effect applied).
            if failpoints.ACTIVE and await failpoints.fire_async(
                    "rpc.reply_dispatch"):
                return
            if result is None:
                rh, rb = {}, []
            elif isinstance(result, tuple):
                rh, rb = result
            else:
                rh, rb = result, []
            if isinstance(hops, dict):
                # Echo the (executor-stamped) trace back in the reply
                # header, and stamp the actual reply send on the IO
                # thread — so pack there, where the time is taken.
                hops["handler_done"] = time.monotonic()
                rh = dict(rh or {})
                rh["_hops"] = hops
                rb = list(rb)

                def _send_traced():
                    hops["reply_io_send"] = time.monotonic()
                    self._io._send_now(
                        conn, [pack_header([msgid, True, rh]), *rb])

                self._io.post(_send_traced)
                return
            self._reply(conn, [pack_header([msgid, True, rh]), *rb])
        except Exception as e:  # noqa: BLE001 - errors cross the wire
            if msgid == 0:
                logger.exception("one-way handler %s failed", method)
                return
            tb = traceback.format_exc()
            try:
                payload = pickle.dumps((e, tb))
            except Exception:
                payload = pickle.dumps((RpcError(str(e)), tb))
            self._reply(conn, [pack_header([msgid, False, None]), payload])

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._io.unregister(self._lst)


async def probe_dead_peers(clients: "ClientPool",
                           by_addr: dict[str, list],
                           fails: dict[str, int],
                           on_dead,
                           strikes: int = 3,
                           timeout: float = 3.0) -> None:
    """Shared liveness-probe discipline (a reconnecting client never
    surfaces peer death): ping each address holding resources; after
    `strikes` consecutive failures, drop its client and hand its items to
    on_dead(addr, items).  Used by the agents' lease-submitter reaper and
    the controller's PG-owner reaper — tune it here, not in copies."""
    for addr in list(fails):
        if addr not in by_addr:
            del fails[addr]
    for addr, items in by_addr.items():
        try:
            await clients.get(addr).call("ping", {}, timeout=timeout)
            fails.pop(addr, None)
            continue
        except Exception:  # noqa: BLE001 - unreachable peer
            n = fails.get(addr, 0) + 1
            fails[addr] = n
            if n < strikes:
                continue
        clients.drop(addr)
        await on_dead(addr, items)
        fails.pop(addr, None)


class RpcClient:
    """One connection to a peer; call() returns (header, blobs).

    Must be constructed on the asyncio loop that will await its calls
    (futures resolve there); sends travel via the IO thread."""

    def __init__(self, ctx: Any = None, address: str = ""):
        # Call sites pass (None, address) or just the address.
        if isinstance(ctx, str) and not address:
            ctx, address = None, ctx
        self.address = address
        self._io = io_thread()
        self._pending: dict[int, Any] = {}
        self._next_id = 1
        # msgid allocation is shared with call_direct_start, which runs
        # on arbitrary caller threads (the sync fast path).
        self._id_lock = threading.Lock()
        self._loop = asyncio.get_running_loop()
        self._poster = LoopPoster(self._loop)
        self._closed = False
        self._conn = self._io.connect(address, self._on_frames)

    def _alloc_msgid(self) -> int:
        with self._id_lock:
            msgid = self._next_id
            self._next_id += 1
        return msgid

    def _send(self, frames) -> None:
        self._io.send(self._conn, frames)

    def _on_frames(self, frames) -> None:               # IO thread
        t_recv = time.monotonic()
        # A malformed or unpicklable reply must fail ITS caller, not
        # kill the transport (which would hang every pending call).
        try:
            msgid, ok, header = unpack_header(frames[0])
        except Exception:  # noqa: BLE001
            logger.warning("dropping malformed reply frame from %s",
                           self.address)
            return
        fut = self._pending.pop(msgid, None)            # GIL-atomic
        if fut is None:
            return
        hops = getattr(fut, "_hops", None)
        if hops is not None:
            hops["reply_recv"] = t_recv
            srv = (header or {}).get("_hops")
            if isinstance(srv, dict):
                hops.update(srv)
        if isinstance(fut, concurrent.futures.Future):
            # Sync-direct caller (call_direct_start): resolve ON the IO
            # thread — a set_result wake is cheap, and skipping the loop
            # handoff is the point of the fast path.  Error payloads
            # unpickle on the CALLER's thread, never here.
            if hops is not None:
                hops["caller_wake"] = time.monotonic()
                _publish_hop_trace(hops)
            if ok:
                fut.set_result(("ok", header or {}, frames[1:]))
            else:
                fut.set_result(
                    ("err", frames[1] if len(frames) > 1 else b"", []))
            return
        if ok:
            result = (header or {}, frames[1:])

            def _resolve():
                if fut.done():
                    return
                if hops is not None:
                    hops["caller_loop_wake"] = time.monotonic()
                    _publish_hop_trace(hops)
                fut.set_result(result)

            self._poster.post(_resolve)
        else:
            # Unpickle LOOP-side: reconstructing arbitrary exception
            # classes (imports, __setstate__) on the process-wide IO
            # thread would stall every connection's transport.
            payload = frames[1] if len(frames) > 1 else b""

            def _fail():
                if fut.done():
                    return
                try:
                    exc, tb = pickle.loads(payload)
                except Exception as e:  # noqa: BLE001 - unpicklable
                    exc = RpcError(f"remote error (unpicklable): {e!r}")
                fut.set_exception(
                    RemoteError(getattr(fut, "_method", "?"), exc))
            self._poster.post(_fail)

    def _register_and_send(self, method: str, header: dict | None,
                           blobs: Blobs | None
                           ) -> tuple[int, asyncio.Future]:
        """Shared preamble of call()/call_with_resend(): closed check,
        msgid alloc, pending registration, hop-trace arm, first send."""
        if self._closed:
            raise ConnectionLost(self.address)
        msgid = self._alloc_msgid()
        fut: asyncio.Future = self._loop.create_future()
        fut._method = method
        self._pending[msgid] = fut
        hops = _consume_hop_arm(method) if _hop_armed is not None else None
        if hops is not None:
            hops["loop_call"] = time.monotonic()
            fut._hops = hops
            self._send_traced(msgid, method, dict(header or {}), hops,
                              list(blobs or []))
        else:
            self._send([pack_header([msgid, method, header]),
                        *(blobs or [])])
        return msgid, fut

    async def call(
        self,
        method: str,
        header: dict | None = None,
        blobs: Blobs | None = None,
        timeout: float | None = None,
    ) -> tuple[dict, Blobs]:
        msgid, fut = self._register_and_send(method, header, blobs)
        if timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(msgid, None)

    def _send_traced(self, msgid: int, method: str, header: dict,
                     hops: dict, blobs: list) -> None:
        """Traced request: the header packs ON the IO thread so the
        io_send stamp is the moment the bytes actually go out."""
        header["_hops"] = hops

        def _go():
            hops["io_send"] = time.monotonic()
            self._io._send_now(
                self._conn, [pack_header([msgid, method, header]), *blobs])

        self._io.post(_go)

    async def call_with_resend(
        self,
        method: str,
        header: dict | None = None,
        blobs: Blobs | None = None,
        resend_s: float = 60.0,
    ) -> tuple[dict, Blobs]:
        """call() with a lost-reply watchdog — the loop-thread analog of
        resend_direct: if no reply lands within resend_s, re-send the
        SAME msgid and keep waiting.  The pending entry stays registered
        across deadlines, so a reply already in flight when the watchdog
        fires still resolves the call.  Whichever reply copy arrives
        first wins; a late duplicate pops no pending entry and is
        dropped."""
        msgid, fut = self._register_and_send(method, header, blobs)
        attempt = 0
        try:
            while True:
                try:
                    return await asyncio.wait_for(asyncio.shield(fut),
                                                  resend_s)
                except asyncio.TimeoutError:
                    if self._closed:
                        raise ConnectionLost(self.address)
                    attempt += 1
                    logger.warning(
                        "no reply from %s for %s after %.1fs; resending "
                        "msgid=%d (attempt %d — the receiver dedupes by "
                        "seqno)", self.address, method, resend_s, msgid,
                        attempt)
                    self._send([pack_header([msgid, method, header]),
                                *(blobs or [])])
        finally:
            self._pending.pop(msgid, None)

    def call_direct_start(self, method: str, header: dict | None = None,
                          blobs: Blobs | None = None
                          ) -> concurrent.futures.Future:
        """Loop-bypassing request from a NON-loop thread (the sync
        fast path): the send posts straight to the IO thread and the
        reply resolves the returned concurrent future ON the IO thread,
        so a blocked caller wakes without any event-loop handoff.

        The future resolves to ("ok", header, blobs) or ("err",
        pickled (exc, tb), []); transport loss surfaces as a
        ConnectionLost exception set by close().  A caller that stops
        waiting (timeout) must LEAVE the msgid registered: the reply
        still resolves this future, and downstream bookkeeping (the
        worker's loop-side finalize) depends on consuming it."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        fut._method = method
        # Closed-check + registration ATOMIC with close()'s drain (both
        # under _id_lock): this entry point runs on arbitrary user
        # threads, and an insert landing after close() snapshotted
        # _pending would orphan the future forever.
        with self._id_lock:
            if self._closed:
                raise ConnectionLost(self.address)
            msgid = self._next_id
            self._next_id += 1
            fut._rpc_msgid = msgid
            self._pending[msgid] = fut
        hops = _consume_hop_arm(method) if _hop_armed is not None else None
        if hops is not None:
            hops["caller_post"] = time.monotonic()
            fut._hops = hops
            self._send_traced(msgid, method, dict(header or {}), hops,
                              list(blobs or []))
        else:
            self._send([pack_header([msgid, method, header]),
                        *(blobs or [])])
        return fut

    def resend_direct(self, fut: concurrent.futures.Future, method: str,
                      header: dict | None = None,
                      blobs: Blobs | None = None) -> None:
        """Re-send a call_direct_start request with its ORIGINAL msgid
        (lost-reply watchdog): the peer's seqno dedupe serves the cached
        reply, and whichever copy of the reply arrives first resolves
        the still-registered future.  Safe from any thread."""
        if self._closed:
            raise ConnectionLost(self.address)
        self._send([pack_header([fut._rpc_msgid, method, header]),
                    *(blobs or [])])

    async def notify(self, method: str, header: dict | None = None,
                     blobs: Blobs | None = None) -> None:
        if self._closed:
            raise ConnectionLost(self.address)
        self._send([pack_header([0, method, header]), *(blobs or [])])

    def close(self) -> None:
        if self._closed:
            return
        with self._id_lock:
            # Atomic with call_direct_start's closed-check+insert: no
            # future can slip in after this drain.
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()

        # Sync-direct futures (concurrent.futures) resolve from any
        # thread — fail them NOW so a blocked caller thread wakes even
        # if the loop is already gone; asyncio futures must resolve on
        # their loop.
        sync_pending: list = []
        loop_pending: list = []
        for f in pending:
            (sync_pending if isinstance(f, concurrent.futures.Future)
             else loop_pending).append(f)
        for f in sync_pending:
            try:
                if not f.done():
                    f.set_exception(ConnectionLost(self.address))
            except Exception:  # noqa: BLE001 - resolution race
                pass

        def _fail_all():
            for fut in loop_pending:
                try:
                    if not fut.done():
                        fut.set_exception(ConnectionLost(self.address))
                except Exception:  # noqa: BLE001 - resolution race
                    pass
        if loop_pending:
            self._poster.post(_fail_all)
        self._io.unregister(self._conn)


class ClientPool:
    """Lazily-created RpcClient per peer address (ray: rpc client pools)."""

    def __init__(self, ctx: Any = None):
        self._clients: dict[str, RpcClient] = {}

    def get(self, address: str) -> RpcClient:
        cli = self._clients.get(address)
        if cli is None or cli._closed:
            cli = RpcClient(address=address)
            self._clients[address] = cli
        return cli

    def drop(self, address: str) -> None:
        cli = self._clients.pop(address, None)
        if cli:
            cli.close()

    def close(self) -> None:
        for cli in self._clients.values():
            cli.close()
        self._clients.clear()


# A subscriber that stops reading loses messages past this many queued,
# as a PUB socket drops at its high-water mark.
_PUB_HWM = 10000


class Publisher:
    """Fan-out of [topic, payload] to every connected Subscriber; topics
    are utf8 prefixes, filtered on the subscriber (ray: pubsub
    publisher).  A message sent before a subscriber connected is not
    delivered to it."""

    def __init__(self, ctx: Any = None, host: str = "127.0.0.1",
                 port: int | None = None):
        self._io = io_thread()
        # Fixed port: a restarted controller's publisher comes back at
        # the same endpoint, so existing subscribers reconnect.
        self._lst = self._io.listen(host, port, lambda frames: None,
                                    max_queue=_PUB_HWM)
        self.address = f"{host}:{self._lst.port}"
        self._closed = False

    async def publish(self, topic: str, payload: dict) -> None:
        if self._closed:
            return
        frames = [topic.encode(), pack_header(payload)]
        lst = self._lst

        def _fan():
            for conn in list(lst.conns):
                self._io._send_now(conn, frames)
        self._io.post(_fan)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._io.unregister(self._lst)


class Subscriber:
    """Connection to a Publisher with per-topic-prefix async callbacks.

    Callbacks for one subscriber run SEQUENTIALLY in arrival order (a
    dispatcher task drains a queue) — resource-view updates and
    worker-death broadcasts rely on in-order delivery."""

    def __init__(self, ctx: Any = None, address: str = ""):
        if isinstance(ctx, str) and not address:
            ctx, address = None, ctx
        self._io = io_thread()
        self._callbacks: list[
            tuple[str, Callable[[str, dict], Awaitable[None]]]] = []
        self._prefixes: tuple = ()
        self._loop = asyncio.get_running_loop()
        self._poster = LoopPoster(self._loop)
        self._queue: deque = deque()
        self._wake: asyncio.Event = asyncio.Event()
        self._task = self._loop.create_task(self._dispatch_loop())
        self._closed = False
        self._conn = self._io.connect(address, self._on_frames)

    def subscribe(self, prefix: str,
                  callback: Callable[[str, dict], Awaitable[None]]) -> None:
        self._callbacks.append((prefix, callback))
        self._prefixes = tuple(p.encode() for p, _ in self._callbacks)

    def _on_frames(self, frames) -> None:               # IO thread
        if len(frames) != 2 or not frames[0].startswith(self._prefixes):
            return
        self._queue.append(frames)                      # GIL-atomic
        self._poster.post(self._wake.set)

    async def _dispatch_loop(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            while self._queue:
                topic_b, payload_b = self._queue.popleft()
                try:
                    topic = topic_b.decode()
                    payload = unpack_header(payload_b)
                except Exception:  # noqa: BLE001
                    continue
                for prefix, cb in self._callbacks:
                    if topic.startswith(prefix):
                        try:
                            await cb(topic, payload)
                        except asyncio.CancelledError:
                            raise
                        except Exception:
                            logger.exception(
                                "subscriber callback failed for %s", topic)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._task.cancel()
        self._io.unregister(self._conn)
