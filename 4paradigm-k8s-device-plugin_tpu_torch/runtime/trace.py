"""Request tracing, the flight recorder, and the card claim's forensics.

The port of ``vtpu.runtime.trace``, whole but for one name: the lease
sidecar's default path is CUDA's (below).  Without it the broker is a
black box under load: a slow execute could have spent its time in the
scheduler queue, the device-time token bucket, or on the card, and
nothing recorded which.  With ``VTPU_TRACE=1``:

  - **Span model.**  Every request carries an optional ``trace`` stamp
    ({id, ts}) from the client (``runtime/client.py`` adds it ONLY when
    tracing is on: tracing off adds zero protocol fields).  The broker
    stamps each EXECUTE at enqueue, at its first wait on the token
    bucket, at dispatch and when its CUDA event completes (one event per
    item while tracing is on), and the metering thread folds them into
    one span whose queue/bucket/device phases partition the request's
    wall time exactly (wall-clock deltas, so they sum to the total by
    construction; the metered ``busy_us`` rides along as the billing
    view).

  - **Flight recorder.**  Completed spans land in per-tenant ring
    buffers (``VTPU_TRACE_RING`` spans each, default 256) plus
    cumulative latency histograms, Chrome-trace exportable
    (``vtpu-smi trace --dump chrome.json``: chrome://tracing or
    Perfetto).

  - **Slow-op watchdog.**  When an op's device-phase wall time exceeds
    ``VTPU_SLOW_OP_FACTOR`` x its learned cost EMA (default 8), the
    recorder captures a context record: queue depth, bucket level, HBM
    headroom, co-tenants.

  - **Claim forensics.**  libtpu's per-process chip lock blocks silently
    when another process holds it; the CUDA driver admits many
    processes, but ``torch.cuda.init()`` and a card's first context can
    hang too (a wedged driver, an MPS server that does not answer).
    Every claimer writes a *lease sidecar* (holder pid, cmdline, stage,
    heartbeat mtime), so the broker's claim watchdog and ``vtpu-smi
    leases`` name the process that holds the node's cards instead of
    guessing.  The default path is ``vtpu-cuda.lease.json`` in the temp
    directory (``vtpu``'s sits beside libtpu's lockfile);
    ``VTPU_LEASE_SIDECAR`` overrides it.

``vtpu``'s hot-path half is the native per-process event ring
(``shim/core.py`` TraceRing): under ``VTPU_TRACE`` the region library
writes a process's token-bucket waits and refused memory admits into
``<region>.trace.<pid>``, and ``vtpu-smi trace --dump`` merges them into
the Chrome trace beside the spans.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils import logging as log

# -- env knobs (utils/envspec.py ENV_FLAGS) ------------------------------


def trace_enabled() -> bool:
    """VTPU_TRACE=1 turns the subsystem on end to end (client stamps,
    broker recorder).  Off by default: zero protocol fields, no
    recorder writes, no per-item CUDA events."""
    return os.environ.get("VTPU_TRACE", "0").strip() not in ("", "0")


def ring_spans() -> int:
    """Flight-recorder depth per tenant (spans kept)."""
    try:
        return max(int(os.environ.get("VTPU_TRACE_RING", "256")), 8)
    except ValueError:
        return 256


def slow_op_factor() -> float:
    """Device-phase wall time > factor x learned EMA triggers a context
    capture.  <= 0 disables the watchdog."""
    try:
        return float(os.environ.get("VTPU_SLOW_OP_FACTOR", "8"))
    except ValueError:
        return 8.0


def new_trace_id() -> str:
    """16-hex-char trace id (64 random bits — Dapper-sized)."""
    return os.urandom(8).hex()


# -- flight recorder ------------------------------------------------------

# Latency histogram bucket upper bounds (us).  Cumulative counters per
# tenant so Prometheus histogram semantics hold (le-buckets never
# decrease).
HIST_BOUNDS_US = (1_000, 5_000, 10_000, 50_000, 100_000, 500_000,
                  1_000_000, 5_000_000, 30_000_000)
MAX_CAPTURES = 64


class FlightRecorder:
    """Per-tenant span ring buffers + cumulative latency histograms +
    slow-op captures.  Thread-safe; every method is O(1)-ish and takes
    only its own lock (never broker locks — callers may hold those)."""

    def __init__(self, enabled: Optional[bool] = None,
                 depth: Optional[int] = None,
                 slow_factor: Optional[float] = None):
        self.enabled = trace_enabled() if enabled is None else enabled
        self.depth = ring_spans() if depth is None else depth
        self.slow_factor = (slow_op_factor() if slow_factor is None
                            else slow_factor)
        self.mu = threading.Lock()
        self._spans: Dict[str, collections.deque] = {}
        self._captures: Dict[str, collections.deque] = {}
        # tenant -> {"count", "sum_us", "buckets": [..], "queue_us",
        # "bucket_us", "device_us"} — cumulative since tenant creation.
        self._hist: Dict[str, Dict[str, Any]] = {}

    # -- write path --

    def record(self, tenant: str, span: Dict[str, Any],
               est_us: float = 0.0,
               context_fn: Optional[Callable[[], Dict[str, Any]]] = None,
               ) -> Optional[Dict[str, Any]]:
        """Append one completed span.  When the device-phase wall time
        exceeds ``slow_factor`` x the estimate, ``context_fn()`` is
        invoked (outside the recorder lock) and its dict is attached to
        a capture record.  Returns the capture (or None)."""
        if not self.enabled:
            return None
        capture = None
        total = float(span.get("total_us", 0.0))
        device = float(span.get("device_us", 0.0))
        if (self.slow_factor > 0 and context_fn is not None
                and est_us > 0 and device > self.slow_factor * est_us):
            try:
                ctx = context_fn()
            except Exception as e:  # noqa: BLE001 - forensics best-effort
                ctx = {"error": f"{type(e).__name__}: {e}"}
            capture = {"ts": time.time(), "tenant": tenant,
                       "span": dict(span), "est_us": round(est_us, 1),
                       "factor": round(device / est_us, 2),
                       "context": ctx}
        with self.mu:
            self._spans.setdefault(
                tenant, collections.deque(maxlen=self.depth)).append(span)
            h = self._hist.setdefault(tenant, {
                "count": 0, "sum_us": 0.0,
                "buckets": [0] * (len(HIST_BOUNDS_US) + 1),
                "queue_us": 0.0, "bucket_us": 0.0, "device_us": 0.0})
            h["count"] += 1
            h["sum_us"] += total
            for i, b in enumerate(HIST_BOUNDS_US):
                if total <= b:
                    h["buckets"][i] += 1
                    break
            else:
                h["buckets"][-1] += 1
            h["queue_us"] += float(span.get("queue_us", 0.0))
            h["bucket_us"] += float(span.get("bucket_us", 0.0))
            h["device_us"] += device
            if capture is not None:
                self._captures.setdefault(
                    tenant,
                    collections.deque(maxlen=MAX_CAPTURES)).append(capture)
        if capture is not None:
            log.warn(
                "slow-op: tenant %s key %s took %.0fms on-device "
                "(%.1fx its %.0fus estimate); context captured",
                tenant, span.get("key"), device / 1e3,
                capture["factor"], est_us)
        return capture

    def forget(self, tenant: str) -> None:
        """Tenant torn down: its rings go with it (histograms too — a
        reused name is a NEW tenant and counters must not resurrect)."""
        with self.mu:
            self._spans.pop(tenant, None)
            self._captures.pop(tenant, None)
            self._hist.pop(tenant, None)

    # -- read path --

    def snapshot(self, tenant: Optional[str] = None,
                 limit: int = 0) -> Dict[str, Any]:
        """TRACE-verb reply body: spans + captures per tenant."""
        with self.mu:
            names = [tenant] if tenant else list(self._spans.keys()
                                                 | self._captures.keys())
            out = {}
            for name in names:
                spans = list(self._spans.get(name, ()))
                if limit > 0:
                    spans = spans[-limit:]
                out[name] = {
                    "spans": spans,
                    "captures": list(self._captures.get(name, ())),
                }
            return out

    def summary(self, tenant: str) -> Optional[Dict[str, Any]]:
        """Cumulative per-tenant numbers for STATS / Prometheus: the
        latency histogram plus queue/bucket/device wait counters."""
        with self.mu:
            h = self._hist.get(tenant)
            if h is None:
                return None
            return {
                "latency_count": h["count"],
                "latency_sum_us": round(h["sum_us"], 1),
                "latency_buckets": list(h["buckets"]),
                "latency_bounds_us": list(HIST_BOUNDS_US),
                "queue_wait_us_total": round(h["queue_us"], 1),
                "bucket_wait_us_total": round(h["bucket_us"], 1),
                "device_us_total": round(h["device_us"], 1),
                "slow_captures": len(self._captures.get(tenant, ())),
            }


# -- Chrome-trace / Perfetto export ---------------------------------------


def chrome_trace(tenants: Dict[str, Any],
                 ring_events: Optional[List[Dict[str, Any]]] = None,
                 ) -> Dict[str, Any]:
    """Flight-recorder snapshot -> Chrome Trace Event JSON (the format
    chrome://tracing and Perfetto both load).  One process row per
    chip, one thread row per tenant; each span becomes three complete
    ("X") events — queue, bucket, device — laid end to end, so the
    phase split is visible at a glance.  Optional shim ring events
    (rate waits / mem stalls) become instant events on their own row."""
    events: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for tenant, body in sorted(tenants.items()):
        tid = tids.setdefault(tenant, len(tids) + 1)
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": f"tenant:{tenant}"}})
        for span in body.get("spans", ()):
            ts = float(span.get("ts", 0.0)) * 1e6  # epoch s -> us
            chip = int(span.get("chip", 0))
            name = str(span.get("key", "execute"))
            trace_id = span.get("trace")
            args = {k: span.get(k) for k in
                    ("trace", "steps", "busy_us", "est_us", "error")
                    if span.get(k) is not None}
            off = ts
            for phase in ("queue", "bucket", "device"):
                dur = float(span.get(f"{phase}_us", 0.0))
                if dur <= 0:
                    continue
                ev = {"ph": "X", "name": f"{name}/{phase}",
                      "cat": "vtpu," + phase, "pid": chip, "tid": tid,
                      "ts": round(off, 1), "dur": round(dur, 1),
                      "args": args}
                if trace_id:
                    ev["id"] = trace_id
                events.append(ev)
                off += dur
        for cap in body.get("captures", ()):
            events.append({
                "ph": "i", "name": "slow-op capture", "cat": "vtpu,slow",
                "pid": int(cap.get("span", {}).get("chip", 0)),
                "tid": tid, "ts": round(float(cap.get("ts", 0.0)) * 1e6, 1),
                "s": "g", "args": cap})
    for ev in ring_events or ():
        events.append({
            "ph": "i", "name": ev.get("kind", "event"),
            "cat": "vtpu,shim", "pid": int(ev.get("dev", 0)),
            "tid": 0, "ts": round(float(ev.get("t_ns", 0)) / 1e3, 1),
            "s": "t", "args": ev})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "vtpu-trace"}}


# -- claim forensics --------------------------------------------------------
#
# A claim of the node's cards (torch.cuda.init(), a card's first context)
# can BLOCK with no error and no holder name.  The sidecar is the
# claimer's calling card —
# written next to the lease by every cooperating claimer, heartbeated
# while held, removed on clean release.  Diagnosis reads it and judges
# the recorded holder's liveness, so a wedged claim reports "held by
# pid 1234 (python -m vtpu_torch.runtime.server ...), heartbeat 3s ago" or
# "STALE: holder pid 1234 is dead" instead of a blind timeout.

# Heartbeats older than this mark the sidecar stale even when the pid
# looks alive (the holder may be wedged itself).
LEASE_STALE_S = 60.0

# Writers beat this often (runtime/server.py _lease_tick).  A holder
# silent for 3 consecutive intervals is not
# coming back on its own — the takeover threshold.
LEASE_HEARTBEAT_S = 5.0
LEASE_TAKEOVER_S = 3 * LEASE_HEARTBEAT_S


def lease_sidecar_path() -> str:
    """Default: ``vtpu-cuda.lease.json`` in the temp directory, named
    for the CUDA claim (``vtpu``'s sits beside libtpu's lockfile);
    override with VTPU_LEASE_SIDECAR (tests, several brokers on one
    host)."""
    return os.environ.get("VTPU_LEASE_SIDECAR", os.path.join(
        tempfile.gettempdir(), "vtpu-cuda.lease.json"))


def _my_cmdline() -> str:
    try:
        with open("/proc/self/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(
                errors="replace").strip()
    except OSError:
        return "?"


def write_lease_sidecar(stage: str, path: Optional[str] = None,
                        extra: Optional[Dict[str, Any]] = None) -> bool:
    """Record this process as the chip-lease claimer.  Atomic
    (tmp+rename); best-effort — forensics must never fail the claim.

    A sidecar naming a LIVE, heartbeating FOREIGN holder is never
    overwritten: in the contended-claim scenario this feature exists
    for, the blocked claimer must preserve the holder's calling card —
    clobbering it would leave its own watchdog diagnosing "no sidecar
    found" about the very process that wedged it.  Dead or stale
    holders' records (and our own) are replaced."""
    path = path or lease_sidecar_path()
    cur = read_lease_sidecar(path)
    if cur is not None and int(cur.get("pid", -1)) != os.getpid():
        holder = int(cur.get("pid", -1))
        if pid_alive(holder) and \
                float(cur.get("heartbeat_age_s", 0.0)) <= LEASE_STALE_S:
            log.debug("lease sidecar %s kept: live holder pid %d",
                      path, holder)
            return False
    rec = {"pid": os.getpid(), "cmdline": _my_cmdline(), "stage": stage,
           "created": time.time()}
    if extra:
        rec.update(extra)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)
        return True
    except OSError as e:
        log.debug("lease sidecar %s unwritable: %s", path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def heartbeat_lease_sidecar(path: Optional[str] = None) -> None:
    """Touch the sidecar's mtime — the "still holding it" signal the
    staleness judgment reads.  Only the recorded holder may beat."""
    path = path or lease_sidecar_path()
    try:
        with open(path) as f:
            rec = json.load(f)
        if int(rec.get("pid", -1)) != os.getpid():
            return
        os.utime(path, None)
    except (OSError, ValueError):
        pass


def clear_lease_sidecar(path: Optional[str] = None) -> None:
    """Clean release: remove the sidecar iff this process wrote it."""
    path = path or lease_sidecar_path()
    try:
        with open(path) as f:
            rec = json.load(f)
        if int(rec.get("pid", -1)) == os.getpid():
            os.unlink(path)
    except (OSError, ValueError):
        pass


def takeover_lease_sidecar(path: Optional[str] = None,
                           stage: str = "takeover") -> bool:
    """Reclaim a dead or silent holder's sidecar record.

    The reclaim rule: holder pid provably dead, OR heartbeat silent
    past LEASE_TAKEOVER_S (3 missed beats) —
    either way nobody is coming back for the lease, and a claimer that
    keeps deferring to the corpse burns its whole wait budget.  A live
    holder inside the heartbeat window is never touched.

    Unlike write_lease_sidecar (which keeps any holder fresher than
    LEASE_STALE_S as a courtesy), this writes unconditionally once the
    takeover judgment is made — the caller has decided.  The previous
    holder is recorded in the new sidecar for the audit trail.
    Returns True iff the record now names this process."""
    path = path or lease_sidecar_path()
    rec = read_lease_sidecar(path)
    prev: Dict[str, Any] = {}
    if rec is not None and int(rec.get("pid", -1)) != os.getpid():
        pid = int(rec.get("pid", -1))
        age = float(rec.get("heartbeat_age_s", 0.0))
        if pid_alive(pid) and age <= LEASE_TAKEOVER_S:
            return False
        prev = {"took_over_pid": pid,
                "took_over_cmdline": rec.get("cmdline", "?"),
                "took_over_heartbeat_age_s": round(age, 1)}
    new = {"pid": os.getpid(), "cmdline": _my_cmdline(),
           "stage": stage, "created": time.time()}
    new.update(prev)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(new, f)
        os.replace(tmp, path)
        return True
    except OSError as e:
        log.debug("lease takeover of %s failed: %s", path, e)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def read_lease_sidecar(path: Optional[str] = None
                       ) -> Optional[Dict[str, Any]]:
    path = path or lease_sidecar_path()
    try:
        with open(path) as f:
            rec = json.load(f)
        if not isinstance(rec, dict):
            return None
        rec["heartbeat_age_s"] = max(
            time.time() - os.stat(path).st_mtime, 0.0)
        return rec
    except (OSError, ValueError):
        return None


def pid_alive(pid: int) -> bool:
    """Provable-death check shared with journal recovery
    (runtime/server.py imports this): only ESRCH counts as dead — EPERM
    or any doubt keeps the process alive ('never reclaim live state on
    doubt', the native region's rule)."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM: exists but not ours
    return True


def diagnose_lease(path: Optional[str] = None,
                   exclude_pid: Optional[int] = None) -> Dict[str, Any]:
    """Judge the lease sidecar: who holds (or last held) the chip, are
    they alive, how fresh is their heartbeat.  ``exclude_pid`` ignores
    a sidecar this process wrote itself (the watchdog diagnosing its
    OWN wedged claim must look for the OTHER holder)."""
    rec = read_lease_sidecar(path)
    if rec is None or (exclude_pid is not None
                       and int(rec.get("pid", -1)) == exclude_pid):
        return {"present": False}
    pid = int(rec.get("pid", -1))
    alive = pid_alive(pid)
    age = float(rec.get("heartbeat_age_s", 0.0))
    return {
        "present": True,
        "pid": pid,
        "cmdline": rec.get("cmdline", "?"),
        "stage": rec.get("stage", "?"),
        "alive": alive,
        "heartbeat_age_s": round(age, 1),
        # STALE = nobody is coming back for this lease: holder dead, or
        # silent past the heartbeat window (wedged — a settle wait may
        # still pay off, but operators should consider reaping it).
        "stale": (not alive) or age > LEASE_STALE_S,
    }


def format_lease_diagnosis(diag: Dict[str, Any]) -> str:
    """One log-greppable line naming the culprit."""
    if not diag.get("present"):
        return ("no chip-lease sidecar found (holder predates vtpu-trace "
                "or claims from another host/container)")
    state = "LIVE" if diag.get("alive") else "DEAD"
    stale = " STALE" if diag.get("stale") else ""
    return (f"chip lease held by pid {diag.get('pid')} [{state}{stale}] "
            f"({diag.get('cmdline')}), stage={diag.get('stage')}, "
            f"heartbeat {diag.get('heartbeat_age_s')}s ago")
