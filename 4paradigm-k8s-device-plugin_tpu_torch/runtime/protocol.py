"""Wire protocol of the port's broker: ``vtpu``'s, byte for byte.

The port of ``vtpu.runtime.protocol``.  Length-prefixed msgpack frames
over a unix stream socket.  Binary tensor payloads ride either as
msgpack bin fields (the legacy framing) or as RAW FRAMES: a
length-prefixed run of naked tensor bytes following a msgpack header that
announced them (``raw_parts``/``nbytes``).  Raw frames are only ever read
when the header said they are coming, so the stream stays
self-describing; the sender pushes them straight out of the tensor's
buffer with one ``sendmsg`` gather write and the receiver ``recv_into``s
a pooled buffer.

The verbs, their tables and the header fields are ``vtpu``'s, so a
``vtpu`` client talks to the port's broker and the port's client to
``vtpu``'s, the fastlane's too: the HELLO's ``fastlane`` and its reply's
lane, FASTBIND, a PUT's ``arena_off``, a GET's ``arena`` and the feeds of
an execute; the arena fds follow the HELLO reply as SCM_RIGHTS on a
one-byte message.  The verbs whose modules are not ported yet (MIGRATE,
MIGRATE_OUT and MIGRATE_IN refuse) keep their names here: they are part of
the wire.  A dtype
crosses as its name (``utils.dtypes``), bf16 as ``"bfloat16"``.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Any, Dict, Optional

import msgpack

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 30
# Tensor-payload segmentation threshold (bytes): well under MAX_FRAME so
# msgpack overhead can never push a frame over the limit.  Env-tunable
# for tests.
CHUNK_BYTES = int(os.environ.get("VTPU_PUT_CHUNK_BYTES", str(256 << 20)))

# message kinds (client -> server)
#
# Tracing (vtpu's docs/TRACING.md): with VTPU_TRACE=1 the client stamps every
# request with an optional "trace" field {id: <16-hex>, ts: <epoch s>}
# — the broker threads it through the scheduler into the flight
# recorder, so one id follows a request client -> queue -> bucket ->
# device -> reply.  With tracing off the field is ABSENT (zero protocol
# overhead), and servers ignore it when unexpected (fwd compat).
#
# HELLO optional fields: device (chip index on the node, default 0 — the
# broker serves EVERY chip, each with its own scheduler + accounting
# region); hbm_limit (bytes) / core_limit (pct): this tenant's own
# Allocate-time grant, seeded into its slot (first HELLO wins; absent ->
# broker spawn defaults); pid/pidns (client pid + pid-namespace inode:
# journal recovery re-validates recovered tenants against them);
# resume_epoch (a reconnecting client's previous broker epoch: when the
# new broker recovered this tenant from its journal, the reply carries
# resumed=true and the tenant's quotas/ledger/EMAs/arrays are intact —
# vtpu's docs/BROKER_RECOVERY.md).
HELLO = "hello"          # {tenant, priority, device?, hbm_limit?,
                         #  core_limit?, oversubscribe?, pid?, pidns?,
                         #  resume_epoch?}
                         # -> {ok, tenant_index, chip, epoch, created,
                         #     resumed}
# Large tensors (> CHUNK_BYTES) do not fit one frame (MAX_FRAME):
# the client streams PUT_PART frames {id, data} (each acked {ok}) and
# finishes with PUT {id, shape, dtype, staged: true}; the server joins
# the staged parts.  GET replies larger than CHUNK_BYTES come back as
# {ok, shape, dtype, parts: N} followed by N frames {data} (FIFO on the
# same connection).
#
# Zero-copy framing (vtpu's docs/PERF.md): a PUT header may instead carry
# {raw_parts: K, nbytes: N} and be FOLLOWED by K raw frames (<=
# CHUNK_BYTES each, N bytes total) — one ack for the whole upload, no
# PUT_PART round trips, no msgpack bin copies; the server recv_into's a
# pooled per-connection buffer.  A GET sent with {raw: true} replies
# {ok, shape, dtype, nbytes, raw_parts: K} followed by K raw frames
# gathered straight from the device array's host view.  Old clients
# never set these fields and keep the legacy framing bit-for-bit.
PUT_PART = "put_part"    # {id, data} -> {ok, staged_bytes}
PUT = "put"              # {id, shape, dtype, data | staged |
                         #  raw_parts+nbytes (+K raw frames)}
                         # -> {ok, nbytes}
GET = "get"              # {id, raw?} -> {ok, shape, dtype,
                         #  data | parts: N | raw_parts: K}
DELETE = "delete"        # {id} -> {ok, freed}
COMPILE = "compile"      # {id, exported} -> {ok}
# EXECUTE optional fields: repeats (int, default 1) runs the program as a
# server-side chain of K steps in ONE device program; carry
# ([[out_idx, arg_idx], ...], default [[0, 0]]) maps each iteration's
# outputs back into the next iteration's arguments.  The reply carries
# the LAST step's outputs.  Replies are sent at dispatch (shapes are
# static); completion-time failures surface on the next sync request.
# EXECUTE optional field: free ([ids]) drops those arrays at THIS item's
# dispatch (zero-round-trip GC for pipelined/bridged callers; safe
# because a tenant queue dispatches FIFO).
EXECUTE = "execute"      # {exe, args: [ids], outs: [ids], repeats?,
                         #  carry?, free?}
# Pipelined batch execute (vtpu's docs/PERF.md): N executes — each item the
# same shape as an EXECUTE body ({exe, args, outs, repeats?, carry?,
# free?}) — ride ONE frame, are enqueued under one scheduler-lock
# acquisition, and are answered with ONE reply whose ``results`` list
# is positional (results[i] is item i's {ok, outs, device_time_us} or
# {ok: false, code, error} — errors are isolated per item; a failed
# item never poisons its batch-mates).  The reply goes out when the
# LAST item of the batch has dispatched, so a client pipelines batches
# the way it pipelined single executes.  Replies may piggyback a
# ``lease`` grant (client-side rate leases, vtpu's docs/PERF.md).
EXEC_BATCH = "exec_batch"  # {items: [{exe, args, outs, ...}, ...]}
                           # -> {ok, results: [...], lease?}
# STATS is a BIND-FREE verb: it may be sent before (or without)
# HELLO — no tenant slot is claimed and no chip is lazily bound, so a
# read-only probe (vtpu-smi) can never wedge a chip claim.  On a bound connection it additionally quiesces the tenant's
# dispatched work so counters are fresh.
STATS = "stats"          # {} -> {ok, tenants: {...}, journal: {...}}
# TRACE is bind-free too (same rationale): the flight-recorder read
# path for vtpu-smi / operators.  Optional fields: tenant (one tenant's
# rings only), limit (newest N spans).  Replies with the per-tenant
# span rings + slow-op captures (runtime/trace.py).  Requests MAY carry
# a "trace" stamp like any other verb; with VTPU_TRACE off the verb
# still answers (enabled=false, empty rings) so probes need no
# env-coupling.
TRACE = "trace"          # {tenant?, limit?} -> {ok, enabled, tenants}
# SLO is the always-on telemetry plane's read verb (runtime/slo.py,
# vtpu's docs/OBSERVABILITY.md): per-tenant x per-phase quantile sketches,
# burn rates, noisy-neighbor blame, fairness.  Bind-free (no tenant
# slot, no chip claim) with SCOPED replies: a BOUND tenant connection
# always gets exactly its own row (the requested ``tenant`` field is
# ignored — a tenant cannot widen its view by naming a neighbour); an
# unbound probe gets the row it names explicitly (the bind-free path
# metricsd's virtualized scrape uses — same disclosure level as the
# bind-free STATS matrix) or, with no name, just the enabled flag; the
# admin socket gets every row plus the full blame matrix and the
# fairness report.
SLO = "slo"              # {tenant?} -> {ok, enabled, tenants,
                         #  fairness?, matrix? (admin only)}
# vtpu-fastlane (vtpu's docs/PERF.md): prepare one execute ROUTE — a
# (program, arg ids, out ids) triple resolved broker-side once — so
# ring descriptors carry a single integer instead of id strings.  The
# reply echoes the route index, the program's static output metadata
# (shapes are static, so the client fabricates completion replies
# locally) and a device-time cost hint for the client's region-atomics
# rate burn.  ``route: -1`` means the program has not executed yet
# (out_meta unknown): the client primes it with one brokered execute
# and re-binds.  Only meaningful on a connection whose HELLO
# negotiated a fastlane lane.
FASTBIND = "fastbind"    # {exe, args, outs?} -> {ok, route, cost_us,
                         #  outs?}

# Admin verbs — served ONLY on the host-side admin socket
# (<socket>.admin, never mounted into tenant containers: the tenant
# socket rejecting these is what keeps one tenant from suspending or
# killing its neighbours).  SUSPEND/RESUME are the whole-task
# suspend/resume control the reference's interceptor wields internally
# (suspend_all/resume_all, SURVEY §2.9d), surfaced as an ops verb: a
# suspended tenant's queue stops dispatching (work stays queued), other
# tenants are unaffected.
SUSPEND = "suspend"      # {tenant} -> {ok}
RESUME = "resume"        # {tenant} -> {ok}
SHUTDOWN = "shutdown"    # {} -> {ok}  then the broker exits gracefully
# DRAIN prepares a zero-downtime broker handover: new HELLOs are
# refused with code DRAINING (clients retry against the successor),
# dispatched work quiesces (bounded by timeout), and a final journal
# snapshot is committed.  HANDOVER = DRAIN + graceful exit; the
# supervisor's respawned broker recovers the snapshot and reconnecting
# clients resume with state intact (vtpu's docs/BROKER_RECOVERY.md).
DRAIN = "drain"          # {timeout?} -> {ok, tenants, snapshotted}
HANDOVER = "handover"    # {timeout?} -> {ok, tenants, snapshotted}
# RESIZE (ROADMAP item 4): live per-tenant quota resize, no tenant
# restart.  ``hbm_limit`` replicates across the grant, ``hbm_limits``
# sets per-ordinal caps, ``core_limit`` re-seeds the device-time share.
# Journaled (op "resize") with a replay arm, so the post-resize grant
# survives a broker crash at ANY journal cut (the vtpu-mc crash engine
# cuts through a canned resize).  Shrinks re-clamp immediately: the
# rate lease is revoked (pre-debited budget priced at the old share
# must not outlive it) and over-limit HBM books simply block new
# admissions until freed.
RESIZE = "resize"        # {tenant, hbm_limit?|hbm_limits?, core_limit?}
                         # -> {ok, tenant, hbm, core}
# MIGRATE (vtpu-failover, vtpu's docs/FAILOVER.md): live tenant migration —
# quiesce the tenant (queue hold + fastlane gate-close + in-flight
# drain), move its device arrays, HBM charges and park/credit state
# onto another chip, and resume, all without the tenant's sessions
# noticing anything but a bounded latency blip (blackout_ms in the
# reply).  Journaled (op "migrate" + replay arm) so the post-migrate
# placement survives a broker crash at ANY journal cut.  Absolute-
# target semantics like RESIZE: re-running a MIGRATE to the same chip
# is a no-op, so the verb classifies idempotent.
MIGRATE = "migrate"      # {tenant, device | devices, timeout?}
                         # -> {ok, tenant, from, to, blackout_ms,
                         #     moved_bytes}
# Cross-NODE migration (vtpu-cluster, vtpu's docs/FEDERATION.md): the
# source-broker half.  ``phase`` selects the step of the two-broker
# dance the cluster coordinator (or vtpu-smi --migrate-to) drives:
# "begin" quiesces the tenant exactly like MIGRATE, host-copies its
# arrays, and answers the serialized tenant state plus its
# content-addressed blobs (sha256-keyed — the transfer channel's
# integrity contract); "commit" tears the source copy down and
# releases its ledger (ONLY after the target acked MIGRATE_IN — the
# cluster never holds less than one full copy); "abort" un-quiesces
# back to serving.  Every phase is safe to re-run (begin re-snapshots
# the held tenant, commit/abort of a gone tenant no-op), so the verb
# classifies idempotent.
MIGRATE_OUT = "migrate_out"  # {tenant, phase?} -> {ok, state, blobs,
                             #     epoch, moved_bytes}
# The target-broker half: verify + store the blobs, rebuild the
# tenant through the journal-recovery machinery and PARK it exactly
# like a crash-recovered tenant — the client's next HELLO with
# resume_epoch = the SOURCE broker's epoch adopts it with arrays,
# programs, grant and credit intact (byte-identical, the shas prove
# it).  Same-topology sharded grants land chip-for-chip on the target
# ``devices``; a mismatched topology refuses typed BEFORE any state
# mutates.  Re-running a lost ack re-parks the same state, and
# {phase: "abort"} (the coordinator's rollback when the dance fails
# after this node accepted) discards the parked copy or no-ops if it
# is absent or already adopted — so the verb classifies idempotent.
MIGRATE_IN = "migrate_in"    # {tenant, state?, blobs?, devices?,
                             #  phase?} -> {ok, tenant, devices, epoch}
# REPL_SYNC (vtpu-failover, vtpu's docs/FAILOVER.md): the hot-standby broker's
# subscription verb.  With {status: true} it answers one frame — the
# replication block (role, followers, lag, fence generation) — and the
# connection stays usable.  Without it the reply is a snapshot
# BOOTSTRAP ({ok, epoch, seq, snapshot, log}) followed by a continuous
# stream of {records, seq} frames (raw CRC-framed journal lines, the
# exact bytes the primary's WAL carries) and {hb} heartbeats until the
# connection dies; the standby applies records through the existing
# _apply_record arms and takes over on primary death.
REPL_SYNC = "repl_sync"  # {status?} -> {ok, ...} (then a stream)

# ---------------------------------------------------------------------------
# Verb registries — the machine-checked protocol contract.
#
# `vtpu-smi analyze` (vtpu.tools.analyze.verbs) proves every constant
# above is registered here, every registered verb has a dispatch arm on
# each socket that serves it plus a sender binding (runtime/client.py
# for tenant verbs, tools/vtpu_smi.py for admin verbs), and that
# BIND_FREE verbs answer before the NO_HELLO guard on the tenant socket
# AND are served on the admin socket (the no-wedge probe contract).
# Adding a verb without completing all three halves fails CI.
# ---------------------------------------------------------------------------

# Served on the tenant socket (mounted into containers).
TENANT_VERBS = (HELLO, PUT_PART, PUT, GET, DELETE, COMPILE, EXECUTE,
                EXEC_BATCH, STATS, TRACE, SLO, FASTBIND)
# Served on the host-side admin socket (<socket>.admin, never mounted).
ADMIN_VERBS = (STATS, TRACE, SLO, SUSPEND, RESUME, RESIZE, MIGRATE,
               MIGRATE_OUT, MIGRATE_IN, REPL_SYNC, SHUTDOWN, DRAIN,
               HANDOVER)
# Answer WITHOUT a HELLO binding — no tenant slot, no lazy chip claim,
# so a read-only probe can never wedge a chip claim.
BIND_FREE_VERBS = (STATS, TRACE, SLO)

# ---------------------------------------------------------------------------
# Retry-safety registry — the machine-checked idempotency contract
# (vtpu's docs/CHAOS.md).
#
# The client transparently re-runs an interrupted synchronous request
# against a journal-resumed broker ONLY when its verb is classified
# idempotent here (runtime/client.py derives its retry set from this
# tuple — never from a hand-maintained literal).  Every verb served by
# TENANT_VERBS/ADMIN_VERBS must appear in exactly one of the two
# tuples, and the known-mutating verbs can never be marked idempotent:
# EXECUTE/EXEC_BATCH re-run double-executes, a re-sent PUT_PART stages
# its chunk twice, SHUTDOWN/HANDOVER are one-shot lifecycle.  `vtpu-smi
# analyze` (vtpu.tools.analyze.verbs) enforces all of it.
#
# PUT is idempotent by its replacement semantics (same id, same bytes);
# staged PUT flows are additionally excluded at the retry site (the
# per-connection staging died with the old socket).  RESIZE/SUSPEND/
# RESUME set absolute state; DRAIN re-requested is already draining.
# ---------------------------------------------------------------------------
# FASTBIND is idempotent: re-binding the same (exe, args, outs) triple
# yields a fresh route index with identical behavior — a duplicate
# route entry is benign, a re-run never double-executes anything.
# MIGRATE sets an absolute placement (a re-run toward the same chip is
# a no-op) and REPL_SYNC re-subscribes with a fresh bootstrap — both
# safe to retry.
IDEMPOTENT_VERBS = (HELLO, PUT, GET, DELETE, COMPILE, STATS, TRACE,
                    SLO, SUSPEND, RESUME, RESIZE, MIGRATE, REPL_SYNC,
                    MIGRATE_OUT, MIGRATE_IN, DRAIN, FASTBIND)
NONIDEMPOTENT_VERBS = (PUT_PART, EXECUTE, EXEC_BATCH, SHUTDOWN,
                       HANDOVER)

# ---------------------------------------------------------------------------
# Wire-field registry — the machine-checked request-HEADER contract.
#
# For every verb: ``required`` fields (a missing one is a malformed
# frame, so a serving-side subscript read is correct) and ``optional``
# fields added after the verb first shipped.  Old clients never send
# the optional ones, so the serving side MUST read them with a
# legacy-default branch (``msg.get(...)``) — a subscript read of an
# optional field crashes every pre-upgrade client's session, silently,
# on the first frame.  `vtpu-smi analyze`
# (vtpu.tools.analyze.wirefields) proves both directions: every field
# the broker reads is registered with the matching style, and every
# registered field is actually read.  Adding an optional header field
# without registering it here (and .get-reading it there) fails CI.
#
# EXECUTE item bodies (the per-item dict of EXEC_BATCH ``items`` and
# the EXECUTE frame itself) share one shape, registered under EXECUTE.
# ---------------------------------------------------------------------------

WIRE_FIELDS: Dict[str, Dict[str, tuple]] = {
    HELLO: {
        "required": ("tenant",),
        "optional": ("priority", "device", "devices", "hbm_limit",
                     "hbm_limits", "core_limit", "oversubscribe",
                     "spill_overshoot", "pid", "pidns", "resume_epoch",
                     "slo_target_us", "slo_floor_steps", "fastlane",
                     "trace"),
    },
    PUT_PART: {"required": ("id", "data"), "optional": ("trace",)},
    PUT: {
        # ``data`` is required by the LEGACY framing (its branch may
        # subscript); ``nbytes`` is required whenever ``raw_parts``
        # announced raw frames OR ``arena_off`` named a fastlane
        # shm-arena payload (no payload bytes on the socket at all).
        "required": ("id", "shape", "dtype", "data", "nbytes"),
        "optional": ("staged", "raw_parts", "arena_off", "trace"),
    },
    GET: {"required": ("id",), "optional": ("raw", "arena", "trace")},
    FASTBIND: {"required": ("exe", "args"),
               "optional": ("outs", "trace")},
    DELETE: {"required": ("id",), "optional": ("ids", "trace")},
    COMPILE: {"required": ("id", "exported"), "optional": ("trace",)},
    EXECUTE: {
        # ``feeds``: arena arg-blob descriptors ([fid, argpos, off,
        # nbytes, shape, dtype] each) — per-step host batches read
        # from the fastlane tx arena at dispatch instead of riding a
        # socket PUT; chained (repeats>1) items carry one entry per
        # step (vtpu's docs/PERF.md, vtpu-fastlane-everywhere).
        "required": ("exe", "args"),
        "optional": ("outs", "repeats", "carry", "free", "feeds",
                     "trace"),
    },
    EXEC_BATCH: {"required": (), "optional": ("items", "trace")},
    STATS: {"required": (), "optional": ("trace",)},
    TRACE: {"required": (), "optional": ("tenant", "limit", "trace")},
    # ``tenant`` scopes an UNBOUND probe's reply (metricsd's bind-free
    # scrape); a bound connection's own identity always wins over it.
    SLO: {"required": (), "optional": ("tenant", "trace")},
    SUSPEND: {"required": ("tenant",), "optional": ()},
    RESUME: {"required": ("tenant",), "optional": ()},
    RESIZE: {"required": ("tenant",),
             "optional": ("hbm_limit", "hbm_limits", "core_limit")},
    MIGRATE: {"required": ("tenant",),
              "optional": ("device", "devices", "timeout")},
    MIGRATE_OUT: {"required": ("tenant",),
                  "optional": ("phase", "timeout")},
    MIGRATE_IN: {"required": ("tenant",),
                 "optional": ("state", "blobs", "devices", "phase")},
    REPL_SYNC: {"required": (), "optional": ("status",)},
    SHUTDOWN: {"required": (), "optional": ()},
    DRAIN: {"required": (), "optional": ("timeout",)},
    HANDOVER: {"required": (), "optional": ("timeout",)},
}

# ---------------------------------------------------------------------------
# Overload shedding (vtpu's docs/SCHEDULING.md): under backlog pressure the
# broker answers an execute / EXEC_BATCH / HELLO with the typed error
# code ``"OVERLOAD"`` (an error code like RESOURCE_EXHAUSTED, not a
# verb) instead of queueing unboundedly — lowest priority sheds first,
# and the reply carries a ``retry_ms`` hint the client jitters its
# bounded backoff around (runtime/client.py VtpuOverload; never a
# silent hang).  Shed EXEC_BATCH replies keep the positional
# ``results`` frame shape (every slot carries the OVERLOAD result), so
# pipelined reply accounting never desyncs.
# ---------------------------------------------------------------------------

# Optional REPLY fields newer brokers piggyback on existing replies
# (the client side of the same contract): each must be absorbed with a
# legacy-default ``.get`` in runtime/client.py — an old broker's reply
# simply lacks them.  ``lease``: the client-side rate-lease grant/
# revoke rider on execute/EXEC_BATCH replies (vtpu's docs/PERF.md);
# ``retry_ms``: the backoff hint on OVERLOAD shed replies
# (vtpu's docs/SCHEDULING.md); ``fastlane``: the HELLO reply's negotiated
# lane descriptor (ring/arena paths + slot; vtpu's docs/PERF.md) — absent
# from pre-fastlane brokers and from refusals; ``arena_off``: a GET
# reply whose payload was written into the fastlane rx arena instead
# of the socket.
REPLY_OPTIONAL_FIELDS = ("lease", "retry_ms", "fastlane", "arena_off")


class ProtocolError(RuntimeError):
    pass


def send_msg(sock: socket.socket, msg: Dict[str, Any]) -> None:
    payload = msgpack.packb(msg, use_bin_type=True)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def send_msg_tail(sock: socket.socket, msg: Dict[str, Any], key: str,
                  data) -> None:
    """``send_msg(sock, {**msg, key: data})``, the same bytes on the wire,
    without copying ``data``: the map is packed with ``key`` last and
    empty, that empty bin's header is swapped for ``data``'s, and
    ``data`` goes out as its own iovec.  A gigabyte blob then costs the
    sender no packing under the GIL."""
    head = msgpack.packb({**msg, key: b""}, use_bin_type=True)
    n = len(data)
    if n < 1 << 8:
        bin_hdr = b"\xc4" + n.to_bytes(1, "big")
    elif n < 1 << 16:
        bin_hdr = b"\xc5" + n.to_bytes(2, "big")
    else:
        bin_hdr = b"\xc6" + n.to_bytes(4, "big")
    body = head[:-2] + bin_hdr  # the empty bin packs as c4 00
    send_frames(sock, [_LEN.pack(len(body) + n) + body, data])


# Gather writes batch at most this many iovecs per sendmsg (IOV_MAX is
# 1024 on Linux; staying well under leaves headroom for the kernel).
_IOV_BATCH = 256


def send_frames(sock: socket.socket, bufs) -> None:
    """Vectored send of pre-framed buffers: ONE syscall (sendmsg with
    an iovec per buffer) pushes a header frame plus its raw payload
    segments, instead of a send per frame — and the payload iovecs
    point straight into the caller's numpy/bytes memory (no join, no
    copy).  Falls back to sendall when the platform lacks sendmsg."""
    views = [v if isinstance(v, memoryview) else memoryview(v)
             for v in bufs]
    views = [v.cast("B") if v.format != "B" or v.ndim != 1 else v
             for v in views]
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return
    while views:
        batch = views[:_IOV_BATCH]
        total = sum(len(v) for v in batch)
        sent = sock.sendmsg(batch)
        while sent < total:
            # Partial write: drop fully-sent iovecs, trim the boundary
            # one, and re-enter sendmsg with the remainder.
            rest = []
            for v in batch:
                if sent >= len(v):
                    sent -= len(v)
                elif sent:
                    rest.append(v[sent:])
                    sent = 0
                else:
                    rest.append(v)
            batch = rest
            total = sum(len(v) for v in batch)
            sent = sock.sendmsg(batch)
        views = views[_IOV_BATCH:]


def frame_header(msg: Dict[str, Any]) -> bytes:
    """One length-prefixed msgpack frame as bytes (for send_frames)."""
    payload = msgpack.packb(msg, use_bin_type=True)
    return _LEN.pack(len(payload)) + payload


def raw_frames(payload) -> list:
    """Length-prefix + segment views for one raw payload, split at
    CHUNK_BYTES — ready to append to a send_frames buffer list.  The
    segments are memoryviews into the caller's buffer: nothing is
    copied until the kernel reads the iovecs."""
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    out = []
    n = len(mv)
    off = 0
    while True:
        seg = mv[off:off + CHUNK_BYTES]
        out.append(_LEN.pack(len(seg)))
        out.append(seg)
        off += len(seg)
        if off >= n:
            break
    return out


def raw_part_count(nbytes: int) -> int:
    """How many raw frames ``raw_frames`` will emit for a payload (a
    zero-byte payload still sends one empty frame)."""
    return max(-(-nbytes // CHUNK_BYTES), 1)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(min(n - got, 1 << 20))
        if not b:
            raise ConnectionError("peer closed")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def recv_exact_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket with recv_into — no intermediate
    chunk list, no join."""
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed")
        got += r


def recv_raw_into(sock: socket.socket, view: memoryview) -> int:
    """Read ONE raw frame into ``view`` (which must be large enough);
    returns the frame's byte count.  Only called when a header
    announced the frame, so the stream stays unambiguous."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise ProtocolError(f"raw frame too large: {n}")
    if n > len(view):
        raise ProtocolError(
            f"raw frame ({n} bytes) exceeds announced size {len(view)}")
    recv_exact_into(sock, view[:n])
    return n


class RecvPool:
    """Per-connection receive-buffer pool for raw tensor frames: one
    reusable bytearray, grown on demand and retained up to a byte cap
    (VTPU_RECV_POOL_MB) so steady-state PUT traffic allocates nothing.
    Counters land in an optional shared stats dict (exposed via the
    broker's STATS verb)."""

    def __init__(self, cap_bytes: Optional[int] = None,
                 stats: Optional[Dict[str, int]] = None):
        if cap_bytes is None:
            cap_bytes = int(float(os.environ.get(
                "VTPU_RECV_POOL_MB", "256")) * (1 << 20))
        self.cap = max(int(cap_bytes), 0)
        self._buf: Optional[bytearray] = None
        self.stats = stats if stats is not None else {}
        for k in ("hits", "misses", "bytes_reused", "bytes_alloc",
                  "drops"):
            self.stats.setdefault(k, 0)

    def take(self, n: int) -> bytearray:
        """A buffer of at least ``n`` bytes (detached from the pool
        until ``give``)."""
        buf = self._buf
        self._buf = None
        if buf is not None and len(buf) >= n:
            self.stats["hits"] += 1
            self.stats["bytes_reused"] += n
            return buf
        self.stats["misses"] += 1
        self.stats["bytes_alloc"] += n
        return bytearray(n)

    def give(self, buf: bytearray) -> None:
        """Return a buffer for reuse; oversized buffers are dropped so
        one huge upload cannot pin the cap forever."""
        if len(buf) <= self.cap and (self._buf is None
                                     or len(buf) > len(self._buf)):
            self._buf = buf
        else:
            self.stats["drops"] += 1


def recv_msg(sock: socket.socket) -> Dict[str, Any]:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise ProtocolError(f"frame too large: {n}")
    payload = _recv_exact(sock, n)
    try:
        msg = msgpack.unpackb(payload, raw=False)
    except Exception as e:  # noqa: BLE001 - anything undecodable
        # Surface as ProtocolError so receivers' connection-teardown
        # paths run (an escaped msgpack exception would skip tenant
        # cleanup in the broker — slot/HBM leak).
        raise ProtocolError(f"undecodable frame: {e}") from e
    if not isinstance(msg, dict):
        raise ProtocolError(f"frame is not a map: {type(msg).__name__}")
    return msg


def reply_err(sock: socket.socket, code: str, msg: str) -> None:
    send_msg(sock, {"ok": False, "code": code, "error": msg})
