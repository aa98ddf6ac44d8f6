"""Deterministic fault injection at named runtime sites.

The chaos suites (test_chaos.py, test_chaos_adversarial.py) kill
processes at *random* times, so the genuinely hard windows — a reply
dropped after an actor mutated state, an agent dying mid-actor-wave —
are hit by luck and never
reproduce on failure.  This module makes those windows addressable: the
runtime compiles `fire("site.name")` calls into each hard window, and a
test (or an operator) arms a site with an action.  The style follows the
`fail` crate / FoundationDB's BUGGIFY and ray's ResourceKillerActor
nightly suites, but sites are *named program points*, not processes.

Syntax (env var or programmatic):

    RAY_TPU_TORCH_FAILPOINTS="site=action[,site=action...]"

where `action` is a `+`-chained `[modifier+]base`:

    bases:      crash            SIGKILL the process (no cleanup runs)
                error[:ExcName]  raise (default FailpointError; ExcName
                                 resolved from builtins or
                                 ray_tpu_torch.exceptions)
                delay:ms         sleep that many milliseconds in place
                drop             fire() returns True; the site drops the
                                 operation (message/reply/heartbeat)
                off              never fires (counters still advance)
    modifiers:  nth:k            fire on exactly the k-th hit (1-based),
                                 then disarm the site
                prob:p           fire each hit with probability p, from
                                 a per-site seeded RNG
                                 (RAY_TPU_TORCH_FAILPOINTS_SEED, default 0)

Examples:
    RAY_TPU_TORCH_FAILPOINTS="agent.create_actors=crash"
    RAY_TPU_TORCH_FAILPOINTS="rpc.io_send=nth:3+drop,agent.heartbeat=prob:0.5+drop"

Cost when disabled: every site is `if failpoints.ACTIVE and
failpoints.fire(...)` — one module-attribute truth test; the function
call only happens while something is armed.

Propagation: `configure()`/`arm()` mirror the table into
``os.environ["RAY_TPU_TORCH_FAILPOINTS"]``, so worker processes spawned after
arming inherit it (the agent spawns workers with `{**os.environ, ...}`),
and fork()ed children inherit both env and module state (hit counters
reset in the child via `os.register_at_fork`).  Already-running
processes are reached through the `failpoints` RPC verb (`control()`
below), registered on the worker, the node agent (broadcast=True fans
out to its workers), and the controller (broadcast=True fans out to all
agents).
"""
from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
import zlib

logger = logging.getLogger(__name__)

ENV_VAR = "RAY_TPU_TORCH_FAILPOINTS"
SEED_VAR = "RAY_TPU_TORCH_FAILPOINTS_SEED"

# Module flag read by every compiled-in site.  True ONLY while at least
# one site is armed — the disabled-path cost contract.
ACTIVE = False


class FailpointError(RuntimeError):
    """Default exception injected by `error` actions."""


class _Site:
    __slots__ = ("name", "base", "exc_name", "delay_ms", "nth", "prob",
                 "rng", "hits", "fired", "spec")

    def __init__(self, name: str, spec: str, seed: int):
        self.name = name
        self.spec = spec
        self.base = "error"
        self.exc_name = None
        self.delay_ms = 0.0
        self.nth = 0          # 0 = every hit
        self.prob = -1.0      # <0 = unconditional
        self.hits = 0
        self.fired = 0
        # Per-site deterministic stream: same seed + same site + same
        # hit sequence => same decisions, in any process.
        self.rng = random.Random(seed ^ zlib.crc32(name.encode()))
        for part in spec.split("+"):
            part = part.strip()
            if not part:
                continue
            op, _, arg = part.partition(":")
            if op == "nth":
                self.nth = int(arg)
            elif op == "prob":
                self.prob = float(arg)
            elif op == "delay":
                self.base, self.delay_ms = "delay", float(arg)
            elif op == "error":
                self.base, self.exc_name = "error", (arg or None)
            elif op in ("crash", "drop", "off"):
                self.base = op
            else:
                raise ValueError(
                    f"failpoint {name!r}: unknown action part {part!r}")


# site name -> _Site.  Guarded by _lock for mutation AND for the
# multi-item reads in spec()/counters() (fire() on another thread can
# disarm a one-shot mid-iteration); fire()'s own single-key get stays
# lockless (GIL-atomic; a racing re-configure swaps the whole dict).
# RLock: spec() is also called from _sync_env_and_flag under the lock.
_sites: dict[str, _Site] = {}
_lock = threading.RLock()


def _resolve_exc(name: str | None):
    if not name:
        return FailpointError
    import builtins

    cls = getattr(builtins, name, None)
    if cls is None:
        try:
            from ray_tpu_torch import exceptions as _exc

            cls = getattr(_exc, name, None)
        except Exception:  # noqa: BLE001 - exceptions module optional here
            cls = None
    if cls is None:
        try:
            from ray_tpu_torch._private import rpc as _rpc

            cls = getattr(_rpc, name, None)
        except Exception:  # noqa: BLE001
            cls = None
    if not (isinstance(cls, type) and issubclass(cls, BaseException)):
        raise ValueError(f"failpoint error class {name!r} not found")
    return cls


def _evaluate(site: str) -> _Site | None:
    """Shared hit/one-shot/probability accounting for fire()/fire_async().
    Returns the site iff its base action should run this hit."""
    s = _sites.get(site)
    if s is None:
        return None
    # Counter read-modify-writes are NOT GIL-atomic: two executor
    # threads (max_concurrency>1 actors) hitting a `nth:k` site
    # concurrently could both observe the k-th hit (fires twice) or
    # lose an update and skip k entirely (never fires).  The lock is
    # an RLock, so _disarm_after_nth re-acquiring is fine; unarmed
    # sites never reach here (dict miss above, behind the ACTIVE flag).
    with _lock:
        if _sites.get(site) is not s:
            return None         # raced a disarm/re-arm: spec changed
        s.hits += 1
        if s.base == "off":
            return None
        if s.nth:
            if s.hits != s.nth:
                return None
            # One-shot: k-th hit fires, then the site disarms itself and
            # scrubs THIS process's env copy.  A crash action can only
            # scrub the dying process — the spawner's armed env would
            # re-arm every replacement (a crash loop); the spawner closes
            # that hole via on_child_sigkill() when it reaps the victim.
            _disarm_after_nth(site)
        if 0.0 <= s.prob < 1.0 and s.rng.random() >= s.prob:
            return None
        s.fired += 1
        return s


def _crash(site: str) -> None:
    logger.warning("failpoint %s: SIGKILL pid %d", site, os.getpid())
    # Hard death, like a real crash: no finally blocks, no atexit,
    # no flushing — the recovery machinery must cope with exactly
    # this.
    os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(60)      # never returns; belt over suspenders


def fire(site: str) -> bool:
    """Evaluate one armed-or-not site.  Returns True when the site's
    action is `drop` and it fired — the call site skips the operation.
    Only called behind the `ACTIVE` module flag; an unarmed site while
    others are armed is a dict miss.  Sites inside coroutines must use
    fire_async() instead — a `delay` here blocks the whole event loop,
    turning "delay this operation" into "stall the process" (only the
    rpc.io_* sites want that semantics, and they run on the IO thread)."""
    s = _evaluate(site)
    if s is None:
        return False
    if s.base == "crash":
        _crash(site)
    if s.base == "delay":
        time.sleep(s.delay_ms / 1e3)
        return False
    if s.base == "drop":
        logger.warning("failpoint %s: dropping operation", site)
        return True
    raise _resolve_exc(s.exc_name)(f"injected by failpoint {site!r}")


async def fire_async(site: str) -> bool:
    """fire() for sites compiled into coroutines: a `delay` action
    suspends only the operation that hit the site (asyncio.sleep), not
    the whole event loop — e.g. `controller.actor_wave=delay:5000`
    slows that actor wave while heartbeats and other RPCs keep
    flowing.  crash/error/drop semantics are identical to fire()."""
    s = _evaluate(site)
    if s is None:
        return False
    if s.base == "crash":
        _crash(site)
    if s.base == "delay":
        import asyncio

        await asyncio.sleep(s.delay_ms / 1e3)
        return False
    if s.base == "drop":
        logger.warning("failpoint %s: dropping operation", site)
        return True
    raise _resolve_exc(s.exc_name)(f"injected by failpoint {site!r}")


def _disarm_after_nth(site: str) -> None:
    with _lock:
        s = _sites.pop(site, None)
        if s is not None:
            # Keep counters visible after the one-shot: tests read them
            # through control() to prove the fault fired.
            _spent[site] = s
        _sync_env_and_flag()


# One-shot sites that already fired (counters survive for inspection).
_spent: dict[str, _Site] = {}


def _sync_env_and_flag() -> None:
    """Mirror the armed table into os.environ (spawn propagation) and
    recompute the ACTIVE flag.  Callers hold _lock."""
    global ACTIVE
    spec_str = spec()
    if spec_str:
        os.environ[ENV_VAR] = spec_str
    else:
        os.environ.pop(ENV_VAR, None)
    ACTIVE = bool(_sites)


def spec() -> str:
    """The armed table as an env-var spec string."""
    with _lock:
        return ",".join(f"{s.name}={s.spec}" for s in _sites.values())


def configure(spec_str: str, seed: int | None = None) -> None:
    """Replace the whole armed table from a spec string (env syntax).
    An empty string disarms everything."""
    if seed is None:
        seed = int(os.environ.get(SEED_VAR, "0") or "0")
    new: dict[str, _Site] = {}
    for pair in (spec_str or "").split(","):
        pair = pair.strip()
        if not pair:
            continue
        site, sep, action = pair.partition("=")
        if not sep:
            raise ValueError(f"failpoint spec {pair!r}: expected "
                             f"site=action")
        new[site.strip()] = _Site(site.strip(), action.strip(), seed)
    with _lock:
        global _sites
        _sites = new
        _spent.clear()
        # Mirror the seed too: spawned children re-parse the spec from
        # env, and a prob: site rebuilt under a different seed would
        # fire on a different schedule than the process that armed it.
        if new:
            os.environ[SEED_VAR] = str(seed)
        else:
            os.environ.pop(SEED_VAR, None)
        _sync_env_and_flag()
    if new:
        logger.info("failpoints armed: %s (seed=%d)", spec_str, seed)


def arm(site: str, action: str, seed: int | None = None) -> None:
    """Arm (or re-arm) one site without touching the others."""
    if seed is None:
        seed = int(os.environ.get(SEED_VAR, "0") or "0")
    with _lock:
        _sites[site] = _Site(site, action, seed)
        _spent.pop(site, None)
        os.environ[SEED_VAR] = str(seed)
        _sync_env_and_flag()


def disarm(site: str) -> None:
    with _lock:
        _sites.pop(site, None)
        _spent.pop(site, None)
        _sync_env_and_flag()


def reset() -> None:
    """Disarm everything and clear counters."""
    configure("")


def reload_from_env() -> None:
    """Re-sync the armed table from os.environ.  Needed by bootstrap
    paths that APPLY env after import (a process that imported this
    module before `os.environ.update()`), so the import-time arming
    above never saw it."""
    try:
        configure(os.environ.get(ENV_VAR, ""))
    except Exception:  # noqa: BLE001 - a typo must not kill the worker
        logger.exception("ignoring malformed %s=%r", ENV_VAR,
                         os.environ.get(ENV_VAR))


def on_child_sigkill() -> None:
    """A child of THIS process died by SIGKILL while one-shot (`nth`)
    crash sites are armed here: presume the child just fired one.  The
    dying process scrubbed its OWN env, but this process — whose env the
    replacement will inherit — still has the site armed, so without this
    hook every replacement would crash at ITS k-th hit too, turning
    "fire exactly once" into a crash loop.  Called by the node agent's
    reaper on a -SIGKILL worker exit.  Recurring crash sites (plain
    `crash`, `prob:p+crash`) are intentionally left armed — crashing
    every process at the site is their contract."""
    if not ACTIVE:
        return
    with _lock:
        # agent./controller.-scoped sites can only fire in THIS process,
        # never in a worker child — scrubbing them here would silently
        # cancel an agent-side crash that hasn't happened yet.
        doomed = [n for n, s in _sites.items()
                  if s.base == "crash" and s.nth
                  and not n.startswith(("agent.", "controller."))]
        if not doomed:
            return
        for n in doomed:
            # Counters stay as-is: the fire happened in the CHILD's
            # process, not here — only the arming is scrubbed.
            _spent[n] = _sites.pop(n)
            logger.warning(
                "failpoint %s: disarmed after a child died by SIGKILL "
                "(one-shot crash presumed fired in the child)", n)
        _sync_env_and_flag()


def counters() -> dict:
    """Per-site {hits, fired} — one-shot sites that already fired are
    included (tests assert the fault actually happened)."""
    out = {}
    with _lock:
        for table in (_sites, _spent):
            for name, s in table.items():
                out[name] = {"hits": s.hits, "fired": s.fired,
                             "action": s.spec}
    return out


def control(h: dict) -> dict:
    """The `failpoints` RPC verb body, shared by worker/agent/controller
    handlers.  ops: set (replace table from h["spec"]), arm (one site),
    clear, counters (read-only)."""
    op = h.get("op", "set")
    if op == "set":
        configure(h.get("spec", ""), seed=h.get("seed"))
    elif op == "arm":
        arm(h["site"], h["action"], seed=h.get("seed"))
    elif op == "clear":
        reset()
    elif op != "counters":
        raise ValueError(f"failpoints verb: unknown op {op!r}")
    return {"armed": spec(), "counters": counters(), "pid": os.getpid()}


def _after_fork_child() -> None:
    # Armed state propagates into the child (that is the point); the
    # counters are per-process accounting and restart at zero.
    for table in (_sites, _spent):
        for s in table.values():
            s.hits = 0
            s.fired = 0


os.register_at_fork(after_in_child=_after_fork_child)

# Arm from the environment at import: spawned workers/agents inherit the
# parent's armed table with zero plumbing.
if os.environ.get(ENV_VAR):
    try:
        configure(os.environ[ENV_VAR])
    except Exception:  # noqa: BLE001 - a typo must not kill the runtime
        logger.exception("ignoring malformed %s=%r", ENV_VAR,
                         os.environ.get(ENV_VAR))
