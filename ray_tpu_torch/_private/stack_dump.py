"""Live stack dumps for every runtime process (`ray-tpu stack`).

Analog of ray: `ray stack` (python/ray/scripts/scripts.py), which
py-spy-attaches to local worker processes.  py-spy is not in this
environment; instead every runtime process installs a SIGUSR1
faulthandler at startup that appends all-thread stacks to a per-pid file
under <tmp>/ray_tpu_torch_stacks/.  A driver signals every live runtime
process and prints the fresh dumps — the "what is everyone doing right now"
debugging tool for hangs.
"""
from __future__ import annotations

import os
import signal
import sys
import tempfile
import time

STACK_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_stacks")

_LOOPS = None          # weakref.WeakSet of event loops to introspect


def register_loop(loop) -> None:
    """Make an event loop's COROUTINE stacks visible to `ray-tpu stack`.
    faulthandler sees only threads; a runtime wedged inside a pending
    await (an un-replied RPC, a lost fill) shows every thread idle in
    poll/select — the round-5 10k-args wedge was invisible until this.
    Called by controller/agent/worker loop startup."""
    global _LOOPS
    import weakref

    if _LOOPS is None:
        _LOOPS = weakref.WeakSet()
    _LOOPS.add(loop)


def _dump_loop_tasks(loop, fileobj) -> None:
    """Coroutine stacks for one loop — runs ON that loop (scheduled via
    call_soon_threadsafe), so task state isn't raced and a wedged MAIN
    thread can't block the dump."""
    import asyncio

    try:
        tasks = asyncio.all_tasks(loop)
        fileobj.write(f"\n--- asyncio tasks: {len(tasks)} "
                      f"(loop {id(loop):#x}) ---\n")
        for t in tasks:
            try:
                fileobj.write(f"task {t.get_name()}: {t.get_coro()!r}\n")
                for fr in t.get_stack(limit=16):
                    fileobj.write(
                        f"  at {fr.f_code.co_filename}:{fr.f_lineno} "
                        f"in {fr.f_code.co_name}\n")
            except Exception as e:  # noqa: BLE001
                fileobj.write(f"  <stack unavailable: {e!r}>\n")
        fileobj.flush()
    except Exception:  # noqa: BLE001
        pass


def _dump_asyncio_tasks(fileobj) -> None:
    """SIGUSR2 body: write a synchronous task-count summary (best-effort
    — racing the loop is acceptable for one line), then schedule the
    full per-task dump ONTO each registered loop so it runs loop-side
    even when this handler's thread is about to block again."""
    import asyncio

    for loop in list(_LOOPS or ()):
        try:
            n = len(asyncio.all_tasks(loop))
            fileobj.write(f"\n[usr2] loop {id(loop):#x}: {n} tasks; "
                          "full stacks follow when the loop runs\n")
            fileobj.flush()
            loop.call_soon_threadsafe(_dump_loop_tasks, loop, fileobj)
        except Exception:  # noqa: BLE001
            continue


def install(role: str) -> None:
    """Register SIGUSR1 (all-thread stacks) + SIGUSR2 (asyncio coroutine
    stacks) handlers.  Called from controller/agent/worker/client-host/
    client-proxy startup; idempotent.

    The pid file appears (via rename) only AFTER every handler is
    registered: the collector signals exactly the pids that have a
    file, and both signals' default disposition is Term — a half-
    registered process must stay invisible.  The header advertises
    `usr2=1` so the collector never sends SIGUSR2 to a process from an
    older build that only registered SIGUSR1."""
    import faulthandler

    tmp = None
    try:
        os.makedirs(STACK_DIR, exist_ok=True)
        path = os.path.join(STACK_DIR, f"{os.getpid()}_{role}.txt")
        tmp = path + ".reg"
        f = open(tmp, "w", buffering=1)   # noqa: SIM115 - held for life
        faulthandler.register(signal.SIGUSR1, file=f, all_threads=True)
    except (OSError, ValueError, AttributeError):
        # No SIGUSR1 handler at all: stay invisible to collect() (the
        # signal's default disposition is Term).
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return

    usr2 = True
    try:
        def _on_usr2(signum, frame):
            try:
                _dump_asyncio_tasks(f)
            except Exception:  # noqa: BLE001
                pass

        signal.signal(signal.SIGUSR2, _on_usr2)
    except (ValueError, OSError):
        # signal.signal off the MAIN thread raises ValueError.  SIGUSR1
        # (faulthandler.register works from any thread) is live, so
        # still publish — just without the usr2 marker, and collect()
        # will not send the unhandled (default-Term) SIGUSR2.
        usr2 = False
    try:
        f.write(f"# {role} pid={os.getpid()} {'usr2=1 ' if usr2 else ''}"
                f"argv={sys.argv[:3]}\n")
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def collect(timeout_s: float = 3.0) -> str:
    """Signal every REGISTERED runtime process and return the fresh
    dumps (driver side of `ray-tpu stack`).  Only pids with a stack file
    are signalled — a process that has not registered its handler yet
    would be KILLED by SIGUSR1's default disposition."""
    t_signal = time.time()
    try:
        names = sorted(os.listdir(STACK_DIR))
    except OSError:
        names = []
    pids, live_names = [], []
    for name in names:
        try:
            pid = int(name.split("_", 1)[0])
        except ValueError:
            continue
        # Send SIGUSR2 only to processes ADVERTISING a handler for it:
        # the default disposition is Term, and a leftover process from
        # an older build (SIGUSR1-only) must not be killed by its own
        # debugger.
        wants_usr2 = False
        try:
            with open(os.path.join(STACK_DIR, name)) as hf:
                wants_usr2 = "usr2=1" in hf.readline()
        except OSError:
            pass
        try:
            os.kill(pid, signal.SIGUSR1)
            if wants_usr2:
                os.kill(pid, signal.SIGUSR2)     # coroutine stacks too
            pids.append(pid)
            live_names.append(name)
        except (ProcessLookupError, PermissionError):
            # Dead pid from an earlier session: clean its file up.
            try:
                os.unlink(os.path.join(STACK_DIR, name))
            except OSError:
                pass
    time.sleep(min(timeout_s, 0.2 + 0.05 * len(pids)))
    chunks = [f"signalled {len(pids)} runtime processes: {pids}"]
    for name in live_names:
        path = os.path.join(STACK_DIR, name)
        try:
            if os.path.getmtime(path) < t_signal - 1.0:
                continue                      # no fresh dump arrived
            size = os.path.getsize(path)
            with open(path) as f:
                if size > 8192:
                    f.seek(size - 8192)
                content = f.read()
        except OSError:
            continue
        chunks.append(f"===== {name} =====\n" + content)
    return "\n".join(chunks)
