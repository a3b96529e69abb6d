"""Deterministic fault injection into the live broker and client.

The port of ``vtpu.runtime.faults``, whole: the same spec, the same seed
and the same call sequence fire the same faults as ``vtpu``'s, so a
schedule found against one package replays against the other.  The
broker and its client plant the hook points; a test (or an operator
rehearsing a failure) sets ``VTPU_FAULTS`` and the process meets real
socket drops, journal write errors, a real ``kill -9`` or the broker's
device-fault exit (``exit3``, code 3) exactly where the recovery code
claims to cope.

Spec grammar (``VTPU_FAULTS``)::

    spec     := point (';' point)*
    point    := fault '@' site [':' params]
    params   := key '=' value (',' key '=' value)*

    VTPU_FAULTS='sock_drop@EXEC_BATCH:p=0.01;sigkill_broker@dispatch:after=500'
    VTPU_FAULTS='fsync_eio@journal:nth=3;reply_delay@GET:ms=50'

Sites are free-form lowercase tokens checked at the hook points the
runtime plants (verb kinds like ``put``/``get``/``exec_batch`` fire as
the request is read; ``dispatch`` in the scheduler's dispatch loop;
``reply`` before every reply write; ``journal``/``fsync`` in the
journal's write path; ``connect``/``recv``/``send`` in the client).
Comparison is case-insensitive, so specs may name wire verbs in their
constant spelling (``EXEC_BATCH``).

Faults:

    sock_drop       raise ConnectionError (the peer-died path)
    connect_refuse  raise ConnectionRefusedError (client connect)
    recv_trunc      raise ConnectionError (mid-frame disconnect)
    reply_delay     sleep ``ms`` milliseconds
    delay           alias of reply_delay
    fsync_eio       raise OSError(EIO)
    enospc          raise OSError(ENOSPC)
    write_short     write HALF the pending journal frame, then raise
                    OSError(EIO) — the torn-write artifact the CRC'd
                    replay must survive (journal sites only)
    sigkill_broker  os.kill(self, SIGKILL) — the real kill -9
    exit3           os._exit(3) (the broker's device-fault and claim
                    watchdog exit)

Triggers (at most one per point; default = always):

    p=<float>    fire with probability p, from a SEEDED rng
    nth=<int>    fire exactly on the nth hit of the site
    after=<int>  fire on every hit from the nth on
    every=<int>  fire on every nth hit
    limit=<int>  cap total fires of this point (combinable)

Determinism: every point owns a ``random.Random`` seeded from
``VTPU_FAULTS_SEED`` (default 0) + the point's position and spelling,
so the same spec + seed + call sequence always fires the same faults: a
failing schedule replays from its printed seed alone.

Zero overhead when off: with ``VTPU_FAULTS`` unset, ``fire()`` is one
module-global load and a None check.
"""

from __future__ import annotations

import errno
import os
import random
import time
from typing import Any, Dict, List, Optional

_TRIGGER_KEYS = ("p", "nth", "after", "every", "limit", "ms")


class FaultSpecError(ValueError):
    """Unparseable VTPU_FAULTS spec — raised at plan build time (never
    from a hot-path fire)."""


class _Point:
    """One ``fault@site:params`` entry: trigger state + the action."""

    __slots__ = ("fault", "site", "params", "hits", "fires", "rng")

    def __init__(self, fault: str, site: str, params: Dict[str, float],
                 seed: int, index: int):
        self.fault = fault
        self.site = site
        self.params = params
        self.hits = 0
        self.fires = 0
        # Deterministic per-point stream: spec + seed fully determine
        # the fault schedule for a fixed call sequence.
        self.rng = random.Random(f"{seed}:{index}:{fault}@{site}")

    def should_fire(self) -> bool:
        self.hits += 1
        limit = self.params.get("limit")
        if limit is not None and self.fires >= limit:
            return False
        nth = self.params.get("nth")
        if nth is not None:
            return self.hits == int(nth)
        after = self.params.get("after")
        if after is not None:
            return self.hits >= int(after)
        every = self.params.get("every")
        if every is not None:
            return self.hits % max(int(every), 1) == 0
        p = self.params.get("p")
        if p is not None:
            return self.rng.random() < p
        return True

    def act(self, fh: Any = None, data: Optional[bytes] = None) -> None:
        self.fires += 1
        f = self.fault
        if f in ("reply_delay", "delay"):
            time.sleep(self.params.get("ms", 10.0) / 1e3)
            return
        if f == "sock_drop":
            raise ConnectionError(
                f"vtpu-chaos: injected sock_drop at {self.site!r}")
        if f in ("connect_refuse", "conn_refuse"):
            raise ConnectionRefusedError(
                f"vtpu-chaos: injected connect_refuse at {self.site!r}")
        if f == "recv_trunc":
            raise ConnectionError(
                f"vtpu-chaos: injected recv truncation at {self.site!r}")
        if f == "fsync_eio":
            raise OSError(errno.EIO,
                          f"vtpu-chaos: injected EIO at {self.site!r}")
        if f == "enospc":
            raise OSError(errno.ENOSPC,
                          f"vtpu-chaos: injected ENOSPC at {self.site!r}")
        if f == "write_short":
            # Torn write: half the frame reaches the file, then the
            # "device" errors — the caller's repair path (journal
            # truncate-to-boundary) and the CRC'd replay both get a
            # real artifact to chew on.
            if fh is not None and data:
                fh.write(data[:max(len(data) // 2, 1)])
                fh.flush()
            raise OSError(errno.EIO,
                          f"vtpu-chaos: injected short write at "
                          f"{self.site!r}")
        if f == "sigkill_broker":
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
            return  # unreachable
        if f == "exit3":
            os._exit(3)
        raise FaultSpecError(f"unknown fault {f!r}")


class FaultPlan:
    """Parsed VTPU_FAULTS spec: the per-site fault points."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.points: List[_Point] = []
        self.by_site: Dict[str, List[_Point]] = {}
        for i, raw in enumerate(s for s in spec.split(";") if s.strip()):
            raw = raw.strip()
            head, _, tail = raw.partition(":")
            fault, at, site = head.partition("@")
            if not at or not fault or not site:
                raise FaultSpecError(
                    f"bad fault point {raw!r} (want fault@site[:k=v,..])")
            params: Dict[str, float] = {}
            if tail:
                for kv in tail.split(","):
                    k, eq, v = kv.partition("=")
                    k = k.strip()
                    if not eq or k not in _TRIGGER_KEYS:
                        raise FaultSpecError(
                            f"bad fault param {kv!r} in {raw!r}")
                    try:
                        params[k] = float(v)
                    except ValueError as e:
                        raise FaultSpecError(
                            f"bad fault param {kv!r} in {raw!r}") from e
            pt = _Point(fault.strip().lower(), site.strip().lower(),
                        params, seed, i)
            self.points.append(pt)
            self.by_site.setdefault(pt.site, []).append(pt)

    def fire(self, site: str, fh: Any = None,
             data: Optional[bytes] = None) -> None:
        pts = self.by_site.get(site.lower())
        if not pts:
            return
        for pt in pts:
            if pt.should_fire():
                pt.act(fh=fh, data=data)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """{spec-point: {hits, fires}} for reports and tests."""
        out: Dict[str, Dict[str, int]] = {}
        for pt in self.points:
            out[f"{pt.fault}@{pt.site}"] = {"hits": pt.hits,
                                            "fires": pt.fires}
        return out


# Module singleton: _UNSET until the first fire()/plan() resolves the
# env.  Tests swap specs with reload().
_UNSET = object()
_plan: Any = _UNSET


def _load() -> Optional[FaultPlan]:
    global _plan
    spec = os.environ.get("VTPU_FAULTS", "").strip()
    if not spec:
        _plan = None
        return None
    try:
        seed = int(os.environ.get("VTPU_FAULTS_SEED", "0") or 0)
    except ValueError:
        seed = 0
    _plan = FaultPlan(spec, seed)
    return _plan


def plan() -> Optional[FaultPlan]:
    """The active plan (None when VTPU_FAULTS is unset)."""
    p = _plan
    if p is _UNSET:
        p = _load()
    return p


def reload() -> Optional[FaultPlan]:
    """Re-read VTPU_FAULTS/VTPU_FAULTS_SEED (tests; a child process
    inherits the env before its first import and never needs this)."""
    global _plan
    _plan = _UNSET
    return plan()


def fire(site: str, fh: Any = None, data: Optional[bytes] = None) -> None:
    """Hook point: no-op unless a plan is active and ``site`` matches.
    May sleep, raise (ConnectionError / OSError), or kill the process —
    exactly what the real fault would do at that seam."""
    p = _plan
    if p is _UNSET:
        p = _load()
    if p is None:
        return
    p.fire(site, fh=fh, data=data)
