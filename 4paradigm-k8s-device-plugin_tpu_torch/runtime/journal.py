"""Crash-safe broker state journal: write-ahead log + snapshot compaction.

The port of ``vtpu.runtime.journal``, whole.  A frame is byte-identical
to ``vtpu``'s for the same record, so either package's ``load_state``
reads the other's log, and ``_apply_record`` replays every op ``vtpu``
writes, those of modules the port has not taken yet (``credit``,
``migrate``) too.

The broker (``runtime/server.py``) keeps per-tenant HBM ledgers, cost
EMAs, the card's calibration and the tenant bindings in its process
memory.  On CUDA a device fault ends the broker (exit 3), so without
the journal every fault would zero every tenant's quota state.  The
journal keeps it the database way:

  - every state-changing event (tenant bind/close, PUT/DELETE ledger
    entries, program registration, learned cost-EMA samples, the card's
    calibration, epoch bumps) is appended to ``journal.log`` as one
    CRC-framed JSON line and flushed to the OS before the reply is sent:
    a SIGKILL'd broker loses at most the line being written;
  - tensor payloads and program graphs land in a content-addressed
    ``blobs/`` store (sha256-named, deduplicated), so a PUT array is
    restorable after a crash, not just its accounting;
  - every ``snapshot_every`` records the log is compacted: the log
    rotates FIRST (appends during the build are kept in the new log),
    then the full-state snapshot is written tmp+fsync+rename and the old
    log segment is deleted.  Replaying a record whose effect is already
    in the snapshot is idempotent by construction.

Corruption contract (``load_state``): a torn FINAL line of the newest
log segment is the expected kill -9 artifact and is dropped silently; a
bad line anywhere else, a CRC mismatch, or an unreadable snapshot raises
``JournalCorrupt``; the broker then quarantines the directory and boots
a fresh epoch (fail closed: no guessed quota state), which clients see
as the typed ``VtpuStateLost``.

Durability note: ``flush()`` survives process death (the page cache
holds the bytes); it does NOT survive machine death.  Set
``VTPU_JOURNAL_FSYNC=1`` to fsync every append when the journal dir is
on persistent media and whole-node crashes must be covered too.  A
directory on a tmpfs keeps the same contract as one on disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import logging as log
from . import faults

LOG_NAME = "journal.log"
SNAP_NAME = "snapshot.json"
BLOBS_DIR = "blobs"
# A blob younger than this is never GC'd even when unreferenced by the
# snapshot: its PUT record may be racing the compaction.
BLOB_GC_MIN_AGE_S = 60.0


class JournalCorrupt(RuntimeError):
    """The journal cannot be trusted — the caller must fail closed
    (fresh epoch, no recovered state), never guess."""


def _apply_record(state: Dict[str, Any], rec: Dict[str, Any]) -> None:
    """Replay one record onto the snapshot-shaped state dict.  Must stay
    idempotent: compaction rotates the log before the snapshot build, so
    a record may be both replayed and already reflected."""
    op = rec.get("op")
    tenants = state.setdefault("tenants", {})
    if op == "epoch":
        state["epoch"] = rec.get("epoch")
    elif op == "chip":
        state.setdefault("chips", {})[str(rec.get("index"))] = \
            rec.get("lat_us")
    elif op == "bind":
        t = tenants.setdefault(rec["name"], {"arrays": {}, "exes": {},
                                             "ema": {}, "execs": 0})
        for k in ("devices", "slots", "priority", "over", "hbm", "core",
                  "spill", "pid", "pidns"):
            if k in rec:
                t[k] = rec[k]
    elif op == "close":
        tenants.pop(rec.get("name"), None)
    elif op == "put":
        t = tenants.get(rec.get("name"))
        if t is not None:
            t.setdefault("arrays", {})[rec["id"]] = {
                k: rec[k] for k in ("sha", "shape", "dtype", "nbytes",
                                    "charges", "spilled") if k in rec}
    elif op == "del":
        t = tenants.get(rec.get("name"))
        if t is not None:
            t.get("arrays", {}).pop(rec.get("id"), None)
    elif op == "compile":
        t = tenants.get(rec.get("name"))
        if t is not None:
            t.setdefault("exes", {})[rec["id"]] = rec.get("sha")
    elif op == "resize":
        # Live quota resize (admin RESIZE): the post-resize grant is
        # what recovery must re-seed — replayed onto the same keys the
        # bind record established, so _recover_from_journal needs no
        # special case.
        t = tenants.get(rec.get("name"))
        if t is not None:
            if rec.get("hbm") is not None:
                t["hbm"] = rec["hbm"]
            if rec.get("core") is not None:
                t["core"] = rec["core"]
    elif op == "migrate":
        # Live tenant migration (vtpu's admin MIGRATE): the
        # post-migrate placement is what recovery must re-seed.  Array
        # charges are POSITIONAL (chip-list index), so they stay valid
        # across the device swap — only devices/slots move.
        t = tenants.get(rec.get("name"))
        if t is not None:
            if rec.get("devices") is not None:
                t["devices"] = rec["devices"]
            if rec.get("slots") is not None:
                t["slots"] = rec["slots"]
            if rec.get("hbm") is not None:
                t["hbm"] = rec["hbm"]
    elif op == "ema":
        t = tenants.get(rec.get("name"))
        if t is not None:
            t.setdefault("ema", {})[rec["key"]] = rec.get("ema")
            if rec.get("execs") is not None:
                t["execs"] = rec["execs"]
    elif op == "credit":
        # vtpu's burst-credit bank: the
        # newest balance wins whole — counters are cumulative, so
        # replaying an older record over a newer would re-mint spent
        # credit.
        t = tenants.get(rec.get("name"))
        if t is not None:
            t["credit"] = {"us": rec.get("us", 0.0),
                           "minted": rec.get("minted", 0.0),
                           "spent": rec.get("spent", 0.0)}
    elif op == "suspend":
        # Admin SUSPEND or an auto-preemption park (auto=True, with
        # the preemptor's name): recovery re-freezes / re-parks the
        # tenant instead of silently unfreezing it across a crash.
        t = tenants.get(rec.get("name"))
        if t is not None:
            t["suspended"] = {"auto": bool(rec.get("auto")),
                              "by": rec.get("by")}
    elif op == "resume":
        t = tenants.get(rec.get("name"))
        if t is not None:
            t.pop("suspended", None)
    elif op == "slo":
        # The SLO plane's state (runtime/slo.py export_state): the
        # newest record wins whole — sketches are cumulative, so
        # replaying an older one over a newer would rewind counters.
        t = tenants.get(rec.get("name"))
        if t is not None and rec.get("state") is not None:
            t["slo"] = rec["state"]
    elif op == "wedge":
        # The claim watchdog's dying words (runtime/server.py
        # claim_watchdog): which claim stage hung and who held the chip
        # lease.  The respawned broker reports it at recovery so the
        # os._exit(3) restart is attributable, not silent.
        state["last_wedge"] = {k: rec.get(k) for k in
                               ("stage", "ts", "diagnosis")}
    # Unknown ops are skipped (forward compatibility): an old broker
    # replaying a newer journal must not lose the records it DOES know.


class Journal:
    """Append-only journal + blob store + snapshot, under one lock.

    Lock ordering: callers hold broker-side locks (state.mu / tenant.mu)
    and then call in here; nothing in this class calls back out, so the
    journal mutex is always innermost.
    """

    def __init__(self, dirpath: str,
                 snapshot_every: Optional[int] = None,
                 fsync: Optional[bool] = None,
                 apply_fn: Optional[Callable[[Dict[str, Any],
                                              Dict[str, Any]],
                                             None]] = None):
        self.dir = dirpath
        # Record interpreter used by load_state: the broker ledger's
        # _apply_record by default, but other journaled state machines
        # (vtpu's cluster coordinator's placement ledger) supply their own
        # and inherit the framing/snapshot/fence/replication machinery
        # unchanged.
        self.apply_fn = apply_fn if apply_fn is not None \
            else _apply_record
        os.makedirs(os.path.join(dirpath, BLOBS_DIR), exist_ok=True)
        if snapshot_every is None:
            snapshot_every = int(os.environ.get(
                "VTPU_JOURNAL_SNAPSHOT_EVERY", "4096"))
        self.snapshot_every = max(int(snapshot_every), 1)
        if fsync is None:
            fsync = os.environ.get("VTPU_JOURNAL_FSYNC", "0") == "1"
        self.fsync = bool(fsync)
        self.mu = threading.Lock()
        self.log_path = os.path.join(dirpath, LOG_NAME)
        self.snap_path = os.path.join(dirpath, SNAP_NAME)
        self._fh = open(self.log_path, "ab")
        self._records_since = 0
        self._appended_total = 0
        # Write-failure hardening: a failed append
        # (EIO / ENOSPC / short write) truncates the log back to the
        # last good record boundary so later appends can never land
        # after a torn line (mid-log damage is the one artifact replay
        # must refuse).  When even the truncate fails the journal is
        # quarantined and disabled — fail closed, never guess.
        self._write_errors = 0
        self._broken = False
        # Optional epoch fence (runtime/replication.py Fence.check): a
        # callable raising FencedEpoch when a standby has taken over.
        # Checked BEFORE every write, so a fenced (stale) primary can
        # never journal — and therefore never ack — a state change.
        self.fence: Optional[Callable[[], None]] = None
        # Replication tap (runtime/replication.py ReplicationHub, set by
        # REPL_SYNC when a standby subscribes): fed the raw framed bytes
        # of every DURABLE append, in log order, under self.mu, and each
        # new blob's content (put_blob, feed_blob); the hub only queues:
        # no I/O, no locks.
        self.repl_tap: Optional[Any] = None
        self._last_snapshot_ts: Optional[float] = None
        try:
            st = os.stat(self.snap_path)
            self._last_snapshot_ts = st.st_mtime
        except OSError:
            pass

    # -- framing -----------------------------------------------------------

    @staticmethod
    def _frame(rec: Dict[str, Any]) -> bytes:
        payload = json.dumps(rec, separators=(",", ":"),
                             sort_keys=True).encode()
        return b"%08x %s\n" % (zlib.crc32(payload), payload)

    @staticmethod
    def _parse_lines(data: bytes, tail_tolerant: bool
                     ) -> List[Dict[str, Any]]:
        """Decode CRC-framed lines.  ``tail_tolerant`` drops a torn or
        CRC-bad FINAL line (the kill -9 artifact); damage anywhere else
        is corruption."""
        out: List[Dict[str, Any]] = []
        lines = data.split(b"\n")
        trailing_complete = data.endswith(b"\n")
        if trailing_complete:
            lines = lines[:-1]
        for i, line in enumerate(lines):
            last = i == len(lines) - 1
            try:
                crc_hex, payload = line.split(b" ", 1)
                if int(crc_hex, 16) != zlib.crc32(payload):
                    raise ValueError("crc mismatch")
                rec = json.loads(payload)
                if not isinstance(rec, dict):
                    raise ValueError("record is not a map")
            except (ValueError, json.JSONDecodeError) as e:
                if tail_tolerant and last:
                    log.warn("journal: dropping torn final record (%s)",
                             e)
                    return out
                raise JournalCorrupt(
                    f"bad journal record at line {i + 1}: {e}") from e
            out.append(rec)
        return out

    # -- write path --------------------------------------------------------

    def append(self, rec: Dict[str, Any]) -> None:
        frame = self._frame(rec)
        with self.mu:
            self._append_locked(frame, 1)

    def append_many(self, recs) -> None:
        """Append a run of records in ONE buffered write + flush (the
        metering loop's per-batch EMA samples): identical durability to
        per-record append — every frame is CRC'd individually and a
        torn tail still drops only the final record on replay."""
        if not recs:
            return
        frames = b"".join(self._frame(r) for r in recs)
        with self.mu:
            self._append_locked(frames, len(recs))

    def _append_locked(self, data: bytes, n: int) -> None:
        """Write + flush one framed run under self.mu, with write-error
        hardening: on any OSError (real EIO/ENOSPC or an injected one —
        ``VTPU_FAULTS`` ``write_short@journal``/``enospc@journal``) the log
        is truncated back to the pre-write boundary so the failure
        leaves no torn MID-log line behind (which replay would — and
        must — refuse as corruption).  The error still propagates: the
        request that could not be journaled is failed, never silently
        acked undurable."""
        if self._broken:
            raise OSError("journal is disabled after an unrecoverable "
                          "write failure (quarantined)")
        # Epoch fence: once a standby has bumped the
        # fence generation, this instance may never journal again — and
        # since every mutating ack is journal-before-reply, a fenced
        # stale primary can never ack.  Raises FencedEpoch (an OSError)
        # so callers fail the request typed, never silently.
        if self.fence is not None:
            self.fence()
        # flush() reaches the OS page cache: enough to survive the
        # broker's own death (SIGKILL, os._exit).  fsync covers
        # machine death, at a per-record syscall cost.
        try:
            off = self._fh.tell()
        except OSError:
            off = None
        try:
            faults.fire("journal", fh=self._fh, data=data)
            self._fh.write(data)
            self._fh.flush()
            if self.fsync:
                faults.fire("fsync")
                os.fsync(self._fh.fileno())
        except OSError:
            self._write_errors += 1
            self._repair_locked(off)
            raise
        self._records_since += n
        self._appended_total += n
        # Fan out AFTER the durable write: a record that failed (and
        # was truncated back) must never reach a follower.
        tap = self.repl_tap
        if tap is not None:
            tap.feed(data, n)

    def _repair_locked(self, off: Optional[int]) -> None:
        """Truncate the log back to the last good boundary after a
        failed write; quarantine + disable when the repair itself fails
        (an unreadable log must never be trusted OR extended)."""
        try:
            if off is None:
                raise OSError("pre-write offset unknown")
            self._fh.seek(off)
            self._fh.truncate()
            self._fh.flush()
        except OSError as e:
            log.error("journal: cannot repair after failed append "
                      "(%s); quarantining and disabling the journal", e)
            self._broken = True
            self._quarantine_locked()

    def journal_broken(self) -> bool:
        return self._broken

    def appended_total(self) -> int:
        """Monotonic count of records ever appended by THIS instance —
        the replication stream's sequence base."""
        with self.mu:
            return self._appended_total

    def bootstrap_payload(self, attach: Optional[Callable[[], None]]
                          = None) -> Tuple[bytes, bytes, int]:
        """(snapshot bytes, log bytes incl. a crashed compaction's
        rotated segment, sequence) — one consistent cut for a standby's
        REPL_SYNC bootstrap.  ``attach`` (the hub registering the
        follower's stream queue; pure in-memory work) runs under the
        SAME self.mu critical section as the file read, so no append
        can land between the bootstrap cut and the first streamed
        record: the stream resumes exactly where the bootstrap ends."""
        with self.mu:
            snap = b""
            try:
                with open(self.snap_path, "rb") as f:
                    snap = f.read()
            except OSError:
                pass
            log = b""
            for name in (LOG_NAME + ".old", LOG_NAME):
                try:
                    with open(os.path.join(self.dir, name), "rb") as f:
                        log += f.read()
                except OSError:
                    pass
            if attach is not None:
                attach()
            return snap, log, self._appended_total

    def snapshot_due(self) -> bool:
        with self.mu:
            return self._records_since >= self.snapshot_every

    def put_blob(self, data: bytes, sha: Optional[str] = None) -> str:
        """Store ``data`` content-addressed; returns its sha256 hex.
        Idempotent — an existing blob is never rewritten."""
        if sha is None:
            sha = hashlib.sha256(data).hexdigest()
        path = os.path.join(self.dir, BLOBS_DIR, sha)
        if not os.path.exists(path):
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(data)
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, path)
            # Replicate the blob content too: the
            # WAL records only carry the sha — a standby restoring
            # arrays/programs at takeover needs the bytes.  Written
            # blobs always precede their journal record, so the
            # follower has the content by the time the record lands.
            tap = self.repl_tap
            if tap is not None:
                tap.feed_blob(sha, data)
        return sha

    def blob_names(self) -> List[str]:
        """Names in the content-addressed store (bootstrap shipping)."""
        try:
            return [n for n in os.listdir(os.path.join(self.dir,
                                                       BLOBS_DIR))
                    if ".tmp." not in n]
        except OSError:
            return []

    def get_blob(self, sha: str) -> Optional[bytes]:
        if not sha or "/" in sha:
            return None
        try:
            with open(os.path.join(self.dir, BLOBS_DIR, sha), "rb") as f:
                return f.read()
        except OSError:
            return None

    # -- compaction --------------------------------------------------------

    def write_snapshot(self, build_fn: Callable[[], Dict[str, Any]]
                       ) -> None:
        """Rotate the log, build the snapshot via ``build_fn`` (appends
        during the build go to the fresh log and replay idempotently),
        then commit tmp+fsync+rename and drop the rotated segment."""
        old = self.log_path + ".old"
        with self.mu:
            self._fh.close()
            # A leftover .old from a crashed compaction still holds
            # unsnapshotted records — fold it in, never overwrite it.
            if os.path.exists(old):
                with open(old, "ab") as dst, \
                        open(self.log_path, "rb") as src:
                    dst.write(src.read())
                os.unlink(self.log_path)
            else:
                os.replace(self.log_path, old)
            self._fh = open(self.log_path, "ab")
            self._records_since = 0
        snap = build_fn()
        data = json.dumps(snap, separators=(",", ":"),
                          sort_keys=True).encode()
        with self.mu:
            tmp = self.snap_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            try:
                dirfd = os.open(self.dir, os.O_RDONLY)
                try:
                    os.fsync(dirfd)
                finally:
                    os.close(dirfd)
            except OSError:
                pass
            try:
                os.unlink(old)
            except OSError:
                pass
            self._last_snapshot_ts = time.time()
        self._gc_blobs(snap)

    def _gc_blobs(self, snap: Dict[str, Any]) -> None:
        referenced = set()
        for t in snap.get("tenants", {}).values():
            for am in t.get("arrays", {}).values():
                referenced.add(am.get("sha"))
            referenced.update(t.get("exes", {}).values())
        bdir = os.path.join(self.dir, BLOBS_DIR)
        cutoff = time.time() - BLOB_GC_MIN_AGE_S
        try:
            names = os.listdir(bdir)
        except OSError:
            return
        for name in names:
            if name in referenced:
                continue
            path = os.path.join(bdir, name)
            try:
                if os.stat(path).st_mtime < cutoff:
                    os.unlink(path)
            except OSError:
                pass

    # -- read path ---------------------------------------------------------

    def load_state(self) -> Optional[Dict[str, Any]]:
        """Snapshot + replay -> the recovered state dict, or None when
        the journal is empty (first boot).  Raises JournalCorrupt on any
        non-tail damage."""
        snap: Optional[Dict[str, Any]] = None
        if os.path.exists(self.snap_path):
            try:
                with open(self.snap_path, "rb") as f:
                    snap = json.loads(f.read())
                if not isinstance(snap, dict):
                    raise ValueError("snapshot is not a map")
            except (ValueError, json.JSONDecodeError, OSError) as e:
                raise JournalCorrupt(f"unreadable snapshot: {e}") from e
        state: Dict[str, Any] = snap if snap is not None else {}
        state.setdefault("tenants", {})
        state.setdefault("chips", {})
        segments: List[Tuple[str, bool]] = []
        old = self.log_path + ".old"
        if os.path.exists(old):
            # Crash mid-compaction: the rotated segment replays first,
            # and only the NEWEST segment may have a torn tail.
            segments.append((old, False))
        segments.append((self.log_path, True))
        # With a rotated segment present, a torn tail in it would mean
        # the crash happened during its own appends — impossible, the
        # rotation only happens after those lines were flushed; still,
        # tolerate a torn tail ONLY on the last segment read.
        any_records = snap is not None
        for path, _ in segments:
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue
            if not data:
                continue
            recs = self._parse_lines(data,
                                     tail_tolerant=(path == segments[-1][0]))
            any_records = any_records or bool(recs)
            for rec in recs:
                self.apply_fn(state, rec)
        return state if any_records else None

    def quarantine(self) -> None:
        """Move the corrupt journal aside (``<name>.corrupt.<ts>``) so
        the fresh epoch starts from an empty, trustworthy directory."""
        with self.mu:
            self._quarantine_locked()

    def _quarantine_locked(self) -> None:
        ts = int(time.time())
        self._fh.close()
        for name in (LOG_NAME, LOG_NAME + ".old", SNAP_NAME):
            path = os.path.join(self.dir, name)
            if os.path.exists(path):
                try:
                    os.replace(path, f"{path}.corrupt.{ts}")
                except OSError as e:
                    log.warn("journal: cannot quarantine %s: %s",
                             name, e)
        self._fh = open(self.log_path, "ab")
        self._records_since = 0

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self.mu:
            size = 0
            for name in (LOG_NAME, LOG_NAME + ".old", SNAP_NAME):
                try:
                    size += os.stat(os.path.join(self.dir, name)).st_size
                except OSError:
                    pass
            age = (time.time() - self._last_snapshot_ts
                   if self._last_snapshot_ts else -1.0)
            return {
                "dir": self.dir,
                "size_bytes": size,
                "records_since_snapshot": self._records_since,
                "records_appended": self._appended_total,
                "last_snapshot_age_s": round(age, 1),
                "fsync": self.fsync,
                # Write-error hardening counters:
                # repaired append failures / quarantined-and-disabled.
                "write_errors": self._write_errors,
                "broken": self._broken,
            }

    def close(self) -> None:
        with self.mu:
            try:
                self._fh.close()
            except OSError:
                pass
