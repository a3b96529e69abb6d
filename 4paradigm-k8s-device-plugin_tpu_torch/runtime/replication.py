"""Streaming journal replication and the hot standby's takeover.

The port of ``vtpu.runtime.replication``: the same stream, frames and
rules, so a port standby follows a ``vtpu`` primary and a ``vtpu`` standby
a port primary.  A broker's crash otherwise ends in a respawn: a new
process imports torch, claims the card, re-reads and replays the whole
journal, and only then binds the socket.  This module takes the process
start and the replay out of the blackout:

  - **Streaming** (the primary's ``ReplicationHub``): a standby
    subscribes over the admin socket (REPL_SYNC).  The bootstrap reply
    carries the journal's snapshot and log cut consistently under
    ``journal.mu``, then the blob store; from then on every durable
    append fans its raw CRC-framed bytes into the follower's bounded
    queue (``Journal.repl_tap``), every new blob its name
    (``feed_blob``), and the admin session streams them, reading each
    blob back from the journal's store as it sends it.  Backpressure
    fails fast: a follower whose queue of records overflows is dropped
    and must bootstrap again; the primary's write path never blocks on
    one.  A blob is already on the primary's disk when it is fed, so the
    queue holds its name, not a copy: a blob larger than the cap (a
    Llama-3-8B embedding is 1.05 GB against the default 64 MB) streams
    without dropping the follower.  The frames on the wire are
    ``vtpu``'s.
  - **The standby** (``Standby``) applies the bootstrap through the
    journal's own ``_parse_lines`` and ``_apply_record``, mirrors every
    record and blob into its own journal directory (always a valid
    journal) and keeps the applied state in memory.  A torn or damaged
    frame is never applied: the chunk is refused whole and the standby
    bootstraps again.
  - **Takeover**: when the stream ends, the standby probes the primary
    for ``VTPU_REPL_CONFIRM_S``; if it stays dead (kill -9) or drained,
    the standby bumps the epoch fence beside the socket (the old
    journal's pre-write check then refuses every append, so a stale
    primary never acks again) and starts the broker through
    ``server.make_server`` seeded with the state it applied: no journal
    re-read, no replay.  Clients reattach through their reconnect and
    ``resume_epoch``; lanes are swept and built afresh as on any epoch
    change.

What is CUDA's: the standby imports torch and the broker's modules when it
starts and claims no card until the takeover: ``make_server`` claims it
(``torch.cuda.init()`` and the card's first context under the claim
watchdog, ``VTPU_CLAIM_WATCHDOG_S``, the lease sidecar written as at any
boot).  A resumed tenant's PUT arrays go back to the card from the
mirrored blob store, and its programs are vetted and loaded, by the
respawn's own resume (``RuntimeState.try_resume``).  The takeover's split
(confirm, fence, the claim and boot) is in the new primary's STATS
(``replication.takeover``), beside the stream's bytes.

Run a standby:  python -m vtpu_torch.runtime.replication \\
                    --socket /run/vtpu/rt.sock --journal-dir /run/vtpu/standby
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import socket as socketmod
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils import logging as log
from . import journal as journal_mod
from . import protocol as P

# Follower stream-queue cap: past this many buffered bytes of records (and
# blob names) the follower is dropped (it bootstraps again); the primary
# never blocks.
REPL_BUFFER_BYTES = int(float(os.environ.get(
    "VTPU_REPL_BUFFER_MB", "64")) * (1 << 20))
# Idle heartbeat period on the stream: a silent but live primary still
# proves liveness.
REPL_HB_S = float(os.environ.get("VTPU_REPL_HB_S", "0.5"))
# How long the standby probes a lost primary before it takes over: long
# enough to ride out an admin-socket hiccup, short enough for the blackout
# (a killed primary's socket refuses at once).
REPL_CONFIRM_S = float(os.environ.get("VTPU_REPL_CONFIRM_S", "0.75"))


class FencedEpoch(OSError):
    """This broker's epoch has been fenced by a standby takeover: it
    may never journal (and therefore never ack) again."""


class Fence:
    """Epoch fence: a tiny generation file next to the listen socket,
    shared by the primary and every standby of that socket.

    The primary ``claim()``s a generation at boot and ``check()``s it
    before every journal write; a standby's takeover ``claim()`` bumps
    the generation, after which the old primary's next check raises
    ``FencedEpoch``: it can no longer journal, so (journal-before-ack)
    it can no longer acknowledge state changes.  ``VTPU_REPL_FENCE=0``
    disables checks (single-broker deployments skip the per-append
    stat)."""

    def __init__(self, path: str, enabled: Optional[bool] = None):
        self.path = path
        if enabled is None:
            enabled = os.environ.get("VTPU_REPL_FENCE", "1") != "0"
        self.enabled = bool(enabled)
        self.generation = 0

    def read(self) -> int:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return int(json.loads(f.read()).get("generation", 0))
        except (OSError, ValueError):
            return 0

    def claim(self, epoch: Optional[str] = None) -> int:
        """Bump + adopt the fence generation (boot or takeover).
        tmp+rename so a racing reader never sees a torn file."""
        gen = self.read() + 1
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"generation": gen, "epoch": epoch,
                                "pid": os.getpid(),
                                "ts": time.time()}))
        os.replace(tmp, self.path)
        self.generation = gen
        return gen

    def check(self) -> None:
        """Raise FencedEpoch when another instance has claimed a newer
        generation.  Called from the journal's pre-write hook."""
        if not self.enabled:
            return
        cur = self.read()
        if cur > self.generation:
            raise FencedEpoch(
                f"epoch fenced: generation {self.generation} was "
                f"superseded by {cur} (standby takeover) — this "
                f"instance may not journal or ack")


# -- applying the stream (pure helpers) ----------------------------------------

class StreamCorrupt(ValueError):
    """The stream carried a damaged record: nothing past the damage may be
    applied; the standby must bootstrap again."""


def split_complete(data: bytes) -> Tuple[List[Dict[str, Any]], bytes,
                                         bytes]:
    """(records, complete bytes, leftover) of a stream chunk: only
    complete, CRC-good framed lines are decoded; a trailing partial line
    is the leftover the next chunk extends.  Damage in a complete line
    raises StreamCorrupt: a torn record is never applied, nor anything
    after it."""
    end = data.rfind(b"\n")
    if end < 0:
        return [], b"", data
    complete, leftover = data[:end + 1], data[end + 1:]
    try:
        recs = journal_mod.Journal._parse_lines(complete,
                                                tail_tolerant=False)
    except journal_mod.JournalCorrupt as e:
        raise StreamCorrupt(str(e)) from e
    return recs, complete, leftover


def apply_stream(state: Dict[str, Any], data: bytes,
                 leftover: bytes = b"") -> Tuple[int, bytes]:
    """Apply one stream chunk onto a snapshot-shaped state dict through
    the journal's ``_apply_record``.  Returns (records applied, new
    leftover).  Raises StreamCorrupt on damage, with ``state`` untouched
    by the damaged chunk."""
    recs, _complete, rest = split_complete(leftover + data)
    for rec in recs:
        journal_mod._apply_record(state, rec)
    return len(recs), rest


def bootstrap_state(snapshot: bytes, logdata: bytes) -> Dict[str, Any]:
    """The snapshot-shaped state dict of a REPL_SYNC bootstrap: recovery's
    snapshot and replay, without the disk.  A torn final log line is
    dropped as recovery drops a kill -9's."""
    state: Dict[str, Any] = {}
    if snapshot:
        try:
            state = json.loads(snapshot)
            if not isinstance(state, dict):
                raise ValueError("snapshot is not a map")
        except (ValueError, json.JSONDecodeError) as e:
            raise StreamCorrupt(f"unreadable bootstrap snapshot: {e}") \
                from e
    state.setdefault("tenants", {})
    state.setdefault("chips", {})
    if logdata:
        recs = journal_mod.Journal._parse_lines(logdata,
                                                tail_tolerant=True)
        for rec in recs:
            journal_mod._apply_record(state, rec)
    return state


# -- the primary's side --------------------------------------------------------

class _Follower:
    """One subscribed standby: a bounded tagged queue (("rec", bytes)
    journal frames, ("blob", sha, size) names of new blobs in the store)
    fed under journal.mu and drained by the admin session serving it.
    ``queued_bytes`` counts what the queue holds (a blob's name, not its
    size); ``blob_bytes`` the queued blobs' sizes, for the lag."""

    __slots__ = ("queue", "queued_bytes", "blob_bytes", "seq", "dropped",
                 "wake", "since")

    def __init__(self, seq: int):
        self.queue: "collections.deque[tuple]" = collections.deque()
        self.queued_bytes = 0
        self.blob_bytes = 0
        self.seq = seq          # records streamed (or queued) so far
        self.dropped = False    # overflow: must bootstrap again
        self.wake = threading.Event()
        self.since = time.time()

    def push(self, item: tuple, nbytes: int, n_records: int) -> None:
        if self.dropped:
            return
        if self.queued_bytes + nbytes > REPL_BUFFER_BYTES:
            # Fail fast, never block the write path.
            self.dropped = True
            self.queue.clear()
            self.queued_bytes = 0
            self.blob_bytes = 0
        else:
            self.queue.append(item)
            self.queued_bytes += nbytes
            if item[0] == "blob":
                self.blob_bytes += item[2]
            self.seq += n_records
        self.wake.set()


class ReplicationHub:
    """The primary's replication state: the followers and the journal's
    tap.  One None check per append while no follower is subscribed."""

    def __init__(self, state: Any):
        self.state = state
        self.followers: List[_Follower] = []
        self.fence: Optional[Fence] = None
        self.role = "primary"
        self.takeovers = 0
        # The split of the takeover that started this broker, if any.
        self.takeover: Optional[Dict[str, Any]] = None
        # Records ever fanned out (lag arithmetic).
        self.fed_records = 0

    # -- the journal's tap (under journal.mu; queues only, no I/O) --

    def feed(self, data: bytes, n: int) -> None:
        self.fed_records += n
        for f in self.followers:
            f.push(("rec", data), len(data), n)

    def feed_blob(self, sha: str, data: bytes) -> None:
        """A new blob, written to the store before its record (which
        carries only its sha); queued by name, not sequence-counted:
        blobs are unordered content-addressed data."""
        for f in self.followers:
            f.push(("blob", sha, len(data)), len(sha), 0)

    # -- the REPL_SYNC arm --

    def serve_follower(self, sock, msg: Dict[str, Any]) -> None:
        """Serve one standby on its own admin connection: bootstrap, then
        stream until the connection dies or the follower overflows."""
        journal = self.state.journal
        if journal is None:
            P.reply_err(sock, "NO_JOURNAL",
                        "replication needs a journaled broker "
                        "(VTPU_JOURNAL_DIR)")
            return
        follower = None

        def attach() -> None:
            # Inside journal.mu (bootstrap_payload): the sequence read here
            # is the bootstrap's cut, so no append lands between the
            # payload and the first streamed record.
            nonlocal follower
            follower = _Follower(journal._appended_total)  # noqa: SLF001
            self.followers.append(follower)
            journal.repl_tap = self

        snap, logdata, seq = journal.bootstrap_payload(attach=attach)
        try:
            P.send_msg(sock, {"ok": True, "epoch": self.state.epoch,
                              "seq": seq, "snapshot": snap,
                              "log": logdata,
                              "fence_generation":
                                  (self.fence.generation
                                   if self.fence else 0)})
            # The blob store too: records carry only shas, and the
            # takeover's restore needs the bytes.  Read outside journal.mu
            # (blobs are immutable; one collected meanwhile is skipped and
            # its array drops at the restore).
            for name in journal.blob_names():
                data = journal.get_blob(name)
                if data is not None:
                    P.send_msg_tail(sock, {"blob": name}, "data", data)
            while True:
                if follower.dropped:
                    P.send_msg(sock, {"ok": False, "code": "REPL_LAG",
                                      "error": "stream buffer overflowed; "
                                               "re-bootstrap"})
                    return
                recs: List[bytes] = []
                blobs: List[tuple] = []
                while follower.queue:
                    item = follower.queue.popleft()
                    if item[0] == "rec":
                        follower.queued_bytes -= len(item[1])
                        recs.append(item[1])
                    else:
                        follower.queued_bytes -= len(item[1])
                        blobs.append(item)
                for _kind, sha, size in blobs:
                    # From the store, as the bootstrap sends it (a blob
                    # collected meanwhile is skipped; its array is gone
                    # from the records too).
                    data = journal.get_blob(sha)
                    if data is not None:
                        P.send_msg_tail(sock, {"blob": sha}, "data", data)
                    follower.blob_bytes -= size
                if recs:
                    P.send_msg(sock, {"records": b"".join(recs),
                                      "seq": follower.seq})
                else:
                    P.send_msg(sock, {"hb": True, "seq": follower.seq})
                follower.wake.clear()
                follower.wake.wait(REPL_HB_S)
        except OSError:
            pass  # the follower went away
        finally:
            try:
                self.followers.remove(follower)
            except ValueError:
                pass

    def status(self) -> Dict[str, Any]:
        """The STATS and ``vtpu-smi --repl-status`` block: a stalled
        standby shows before it matters."""
        jr = getattr(self.state, "journal", None)
        seq = jr.appended_total() if jr is not None else 0
        out = {
            "role": self.role,
            "followers": [
                {"lag_records": max(seq - f.seq, 0),
                 "lag_bytes": f.queued_bytes + f.blob_bytes,
                 "dropped": f.dropped,
                 "since": round(f.since, 3)}
                for f in list(self.followers)],
            "seq": seq,
            "fence_generation": (self.fence.generation
                                 if self.fence else 0),
            "takeovers": self.takeovers,
        }
        if self.takeover is not None:
            out["takeover"] = dict(self.takeover)
        return out


# -- the standby's side --------------------------------------------------------

class Standby:
    """A hot-standby broker process: follows the primary's journal into an
    in-memory state dict and a local journal copy, and takes over when
    the primary dies or drains away."""

    def __init__(self, socket_path: str, journal_dir: str,
                 hbm_limit: int = 0, core_limit: int = 0,
                 confirm_s: Optional[float] = None, device: str = "cuda"):
        self.socket_path = socket_path
        self.admin_path = socket_path + ".admin"
        self.journal_dir = journal_dir
        self.hbm_limit = hbm_limit
        self.core_limit = core_limit
        self.device = device
        self.confirm_s = (REPL_CONFIRM_S if confirm_s is None
                          else confirm_s)
        self.state: Dict[str, Any] = {"tenants": {}, "chips": {}}
        self.seq = 0
        self.applied_records = 0
        self.resyncs = 0
        self.stream_bytes = 0
        self.blob_bytes = 0
        self.last_hb = 0.0
        self.confirm_s_last = 0.0
        self.primary_epoch: Optional[str] = None
        self._leftover = b""
        self._stop = threading.Event()
        self._srv = None  # the broker after the takeover

    # -- wire --

    def _dial(self, timeout: float = 5.0) -> socketmod.socket:
        s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(self.admin_path)
        return s

    def _bootstrap(self, sock) -> None:
        P.send_msg(sock, {"kind": P.REPL_SYNC})
        rep = P.recv_msg(sock)
        if not rep.get("ok"):
            raise ConnectionError(
                f"bootstrap refused: {rep.get('code')} "
                f"{rep.get('error')}")
        self.primary_epoch = rep.get("epoch")
        snap = bytes(rep.get("snapshot") or b"")
        logdata = bytes(rep.get("log") or b"")
        self.state = bootstrap_state(snap, logdata)
        self.seq = int(rep.get("seq", 0))
        self.stream_bytes += len(snap) + len(logdata)
        self._leftover = b""
        # The mirror on disk is always a valid journal: the takeover (or a
        # standby restart) recovers from it.
        os.makedirs(os.path.join(self.journal_dir,
                                 journal_mod.BLOBS_DIR), exist_ok=True)
        snap_path = os.path.join(self.journal_dir, journal_mod.SNAP_NAME)
        tmp = snap_path + ".tmp"
        if snap:
            with open(tmp, "wb") as f:
                f.write(snap)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, snap_path)
        else:
            try:
                os.unlink(snap_path)
            except OSError:
                pass
        with open(os.path.join(self.journal_dir,
                               journal_mod.LOG_NAME), "wb") as f:
            f.write(logdata)
            f.flush()
        try:
            os.unlink(os.path.join(self.journal_dir,
                                   journal_mod.LOG_NAME + ".old"))
        except OSError:
            pass

    def _store_blob(self, sha: str, data: bytes) -> None:
        """Mirror one content-addressed blob, checked against its sha: a
        damaged one is refused, and the restore then drops that array
        with its ledger released."""
        if not sha or "/" in sha:
            return
        self.blob_bytes += len(data)
        if len(sha) == 64 and hashlib.sha256(data).hexdigest() != sha:
            log.warn("replication: blob %s content hash mismatch; "
                     "refusing it", sha[:12])
            return
        path = os.path.join(self.journal_dir, journal_mod.BLOBS_DIR, sha)
        if os.path.exists(path):
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def _apply_chunk(self, data: bytes, seq: int) -> None:
        """Check and apply one streamed chunk; only its complete, CRC-good
        bytes reach the local log (a torn or damaged record lands neither
        on the standby's disk nor in its state)."""
        recs, complete, self._leftover = split_complete(
            self._leftover + data)
        for rec in recs:
            journal_mod._apply_record(self.state, rec)
        self.applied_records += len(recs)
        self.stream_bytes += len(data)
        self.seq = seq
        if complete:
            with open(os.path.join(self.journal_dir,
                                   journal_mod.LOG_NAME), "ab") as f:
                f.write(complete)
                f.flush()

    # -- following --

    def follow_once(self) -> str:
        """One bootstrap and stream session; returns why it ended: 'eof'
        (the primary is gone), 'lag' (dropped), 'corrupt' (damage; both
        bootstrap again), 'stopped'."""
        sock = self._dial()
        try:
            self._bootstrap(sock)
            log.info("replication: bootstrapped from epoch %s at seq %d "
                     "(%d tenants)", self.primary_epoch, self.seq,
                     len(self.state.get("tenants", {})))
            sock.settimeout(max(4.0 * REPL_HB_S, 2.0))
            while not self._stop.is_set():
                try:
                    msg = P.recv_msg(sock)
                except socketmod.timeout:
                    return "eof"  # heartbeats stopped: a wedged primary
                if msg.get("records") is not None:
                    try:
                        self._apply_chunk(bytes(msg["records"]),
                                          int(msg.get("seq", self.seq)))
                    except StreamCorrupt as e:
                        log.warn("replication: corrupt stream chunk (%s); "
                                 "bootstrapping again", e)
                        self.resyncs += 1
                        return "corrupt"
                elif msg.get("blob") is not None:
                    self._store_blob(str(msg["blob"]),
                                     bytes(msg.get("data") or b""))
                elif msg.get("hb"):
                    self.last_hb = time.monotonic()
                elif msg.get("code") == "REPL_LAG":
                    log.warn("replication: dropped for lag; bootstrapping "
                             "again")
                    self.resyncs += 1
                    return "lag"
            return "stopped"
        except (ConnectionError, P.ProtocolError, OSError):
            return "eof"
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def primary_alive(self) -> bool:
        """Probe the primary's admin socket with a status REPL_SYNC."""
        try:
            s = self._dial(timeout=0.5)
        except OSError:
            return False
        try:
            P.send_msg(s, {"kind": P.REPL_SYNC, "status": True})
            rep = P.recv_msg(s)
            return bool(rep.get("ok"))
        except (OSError, P.ProtocolError):
            return False
        finally:
            try:
                s.close()
            except OSError:
                pass

    def confirm_dead(self) -> bool:
        """Probe for confirm_s; True when the primary stayed gone."""
        t0 = time.monotonic()
        deadline = t0 + max(self.confirm_s, 0.0)
        try:
            while True:
                if self.primary_alive():
                    return False
                if time.monotonic() >= deadline:
                    return True
                if self._stop.wait(0.05):
                    return False
        finally:
            self.confirm_s_last = time.monotonic() - t0

    # -- the takeover --

    def takeover(self):
        """Fence the old epoch and become the serving broker: the applied
        state seeds recovery (no journal re-read, no replay), and the
        socket and the cards are claimed through ``make_server``.  Returns
        the broker, not yet serving."""
        from .server import make_server
        t0 = time.monotonic()
        fence = Fence(self.socket_path + ".fence")
        gen = fence.claim()
        t1 = time.monotonic()
        log.info("replication: TAKEOVER: fenced the old epoch at "
                 "generation %d, claiming %s (seq %d, %d tenants)",
                 gen, self.socket_path, self.seq,
                 len(self.state.get("tenants", {})))
        srv = make_server(self.socket_path, self.hbm_limit, self.core_limit,
                          device=self.device, journal_dir=self.journal_dir,
                          preloaded_state=self.state, fence=fence)
        hub = srv.state.replication
        hub.role = "primary(took-over)"
        hub.takeovers += 1
        hub.takeover = {
            "confirm_s": round(self.confirm_s_last, 4),
            "fence_s": round(t1 - t0, 4),
            "claim_s": round(time.monotonic() - t1, 4),
            "stream_bytes": self.stream_bytes,
            "blob_bytes": self.blob_bytes,
            "applied_records": self.applied_records,
            "resyncs": self.resyncs,
            "seq": self.seq,
        }
        log.info("replication: took over: %s", json.dumps(hub.takeover))
        self._srv = srv
        return srv

    def run(self) -> int:
        """Follow until the primary dies (or drains away), then take over
        and serve."""
        backoff = 0.05
        while not self._stop.is_set():
            try:
                why = self.follow_once()
            except OSError:
                why = "eof"
            if self._stop.is_set():
                return 0
            if why in ("lag", "corrupt"):
                time.sleep(backoff)
                continue
            if self.confirm_dead():
                srv = self.takeover()
                try:
                    srv.serve_forever()
                except KeyboardInterrupt:
                    pass
                finally:
                    srv.server_close()
                return 0
            time.sleep(backoff)
        return 0

    def stop(self) -> None:
        self._stop.set()
        if self._srv is not None:
            self._srv.shutdown()

    def status(self) -> Dict[str, Any]:
        return {
            "role": "standby",
            "seq": self.seq,
            "applied_records": self.applied_records,
            "resyncs": self.resyncs,
            "stream_bytes": self.stream_bytes,
            "blob_bytes": self.blob_bytes,
            "tenants": len(self.state.get("tenants", {})),
            "primary_epoch": self.primary_epoch,
        }


# -- the smoke and the command line --------------------------------------------

def _smoke() -> List[str]:
    """A wiring check without a broker: stream framing and the torn
    record's refusal, the bootstrap against recovery, the fence."""
    import tempfile
    errs: List[str] = []
    frames = [journal_mod.Journal._frame(r) for r in (
        {"op": "epoch", "epoch": "e1"},
        {"op": "bind", "name": "t", "devices": [0], "slots": [2],
         "priority": 1, "over": False, "hbm": [1024], "core": 50},
        {"op": "put", "name": "t", "id": "x", "sha": "s", "shape": [4],
         "dtype": "float32", "nbytes": 16, "charges": [[0, 16]],
         "spilled": False},
        {"op": "migrate", "name": "t", "devices": [1], "slots": [5],
         "hbm": [1024]},
        {"op": "del", "name": "t", "id": "x"},
    )]
    blob = b"".join(frames)
    st: Dict[str, Any] = {"tenants": {}, "chips": {}}
    n, left = apply_stream(st, blob)
    if n != 5 or left:
        errs.append(f"apply_stream applied {n} records, {len(left)}B "
                    f"leftover (want 5, 0)")
    t = st["tenants"].get("t", {})
    if t.get("devices") != [1] or t.get("slots") != [5]:
        errs.append(f"migrate arm not applied: {t.get('devices')}/"
                    f"{t.get('slots')}")
    if "x" in t.get("arrays", {}):
        errs.append("del arm not applied through the stream")
    st2: Dict[str, Any] = {"tenants": {}, "chips": {}}
    cut = len(frames[0]) + len(frames[1]) // 2
    n1, left1 = apply_stream(st2, blob[:cut])
    if n1 != 1 or "t" in st2["tenants"]:
        errs.append(f"mid-record cut applied a torn record "
                    f"(n={n1}, tenants={sorted(st2['tenants'])})")
    n2, left2 = apply_stream(st2, blob[cut:], left1)
    if n2 != 4 or left2 or "t" not in st2["tenants"]:
        errs.append(f"continuation did not complete the deferred "
                    f"record (n={n2})")
    dmg = bytearray(blob)
    dmg[len(frames[0]) + 10] ^= 0x5A
    st3: Dict[str, Any] = {"tenants": {}, "chips": {}}
    try:
        apply_stream(st3, bytes(dmg))
        errs.append("flipped byte in a complete record was applied "
                    "instead of refused")
    except StreamCorrupt:
        pass
    if st3["tenants"]:
        errs.append("damaged stream still mutated standby state")
    bs = bootstrap_state(b"", blob + b"deadbeef {torn")
    if "t" not in bs["tenants"]:
        errs.append("bootstrap_state lost the replayed tenant")
    with tempfile.TemporaryDirectory() as tmp:
        fpath = os.path.join(tmp, "sock.fence")
        primary = Fence(fpath, enabled=True)
        primary.claim("e1")
        try:
            primary.check()
        except FencedEpoch:
            errs.append("fresh fence claim refused its own generation")
        standby = Fence(fpath, enabled=True)
        standby.claim("e2")
        try:
            primary.check()
            errs.append("stale primary passed the fence check after a "
                        "takeover claim")
        except FencedEpoch:
            pass
        try:
            standby.check()
        except FencedEpoch:
            errs.append("the taking-over standby fenced itself")
    return errs


def main(argv: Optional[List[str]] = None) -> int:
    from ..utils import envspec
    ap = argparse.ArgumentParser(
        prog="vtpu-replication",
        description="hot-standby broker: follow a primary's journal "
                    "stream and take over when it dies")
    ap.add_argument("--socket", default=os.environ.get(
        envspec.ENV_RUNTIME_SOCKET, "/usr/local/vtpu/vtpu-runtime.sock"),
        help="the PRIMARY's main socket (admin: <socket>.admin); the "
             "takeover claims this path")
    ap.add_argument("--journal-dir", default=None,
                    help="the standby's own journal directory (the "
                         "stream's mirror; not the primary's)")
    ap.add_argument("--hbm-limit", default="0",
                    help="the default per-tenant HBM cap after the takeover")
    ap.add_argument("--core-limit", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="what the broker serves after the takeover: cuda "
                         "(every card), cuda:<i> or cpu")
    ap.add_argument("--confirm-s", type=float, default=None,
                    help="how long to probe a lost primary before taking "
                         "over (VTPU_REPL_CONFIRM_S)")
    ap.add_argument("--smoke", action="store_true",
                    help="a wiring check without a broker")
    ns = ap.parse_args(argv)
    if ns.smoke:
        errs = _smoke()
        print(json.dumps({"smoke": "vtpu-replication", "ok": not errs,
                          "errors": errs}, indent=2))
        return 0 if not errs else 1
    if not ns.journal_dir:
        ap.error("--journal-dir is required (the standby's own journal "
                 "mirror)")
    hbm = envspec.parse_quantity(ns.hbm_limit) if ns.hbm_limit != "0" else 0
    # Warm the imports while the primary is healthy (torch and the broker
    # dominate a cold start); CUDA stays uninitialised, the card the
    # primary's until the takeover claims it.
    t0 = time.monotonic()
    import torch

    from . import server  # noqa: F401
    log.info("vtpu-replication: torch %s and the broker imported in %.2f s; "
             "CUDA initialised: %s", torch.__version__,
             time.monotonic() - t0, torch.cuda.is_initialized())
    sb = Standby(ns.socket, ns.journal_dir, hbm_limit=hbm,
                 core_limit=ns.core_limit, confirm_s=ns.confirm_s,
                 device=ns.device)
    log.info("vtpu-replication: standby following %s -> %s", ns.socket,
             ns.journal_dir)
    rc = sb.run()
    if sb._srv is not None:
        # K1's launches in the broker this standby became, as the broker's
        # own main writes them at its exit.
        from ..ops import flash_attention as fa
        print("vtpu-replication: K1 launches " + json.dumps(
            fa.flash_attention.route_launches), file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
