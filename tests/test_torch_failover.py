"""Streaming replication and the hot standby's takeover of the port
(vtpu_torch.runtime.replication) against vtpu's.

- The epoch fence: claim and check; a fenced journal never appends, so a
  stale primary never acks.
- The stream's framing, cut at every record boundary, mid-record and
  with a flipped byte (the port's helpers and vtpu's give the same
  state): a torn record is never applied, damage refuses the chunk.
- A follower's overflow drops it (fail-fast backpressure); a blob is
  queued by name and streamed from the store, so one larger than the cap
  keeps the follower.
- In-process primary and standby: the state and blobs stream, STATS and
  the status probe show the follower; the takeover seeds the broker from
  the applied state (no journal re-read, no replay) and the tenant
  resumes with its data, the old epoch fenced; a tenant suspended on the
  primary comes back suspended.
- The fastlane's gate-close resubmit stays inside the client.
- A kill -9 of a primary process under a standby process: the standby
  takes over and the tenant reads its data back; the takeover's split is
  in STATS.
- Wire parity: a port standby follows a vtpu primary's REPL_SYNC stream
  and a vtpu standby a port primary's, each ending with the state the
  other package's standby applied and the primary's journal holds.

vtpu's migration tests (tests/test_failover.py's four MIGRATE ones) wait
for ROADMAP Queue 1 item 6(d)(ii)."""

import copy
import os
import signal
import socket as socketmod
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vtpu.runtime import client as jclient
from vtpu.runtime import journal as jjournal
from vtpu.runtime import replication as JR
from vtpu.runtime import server as jserver
from vtpu.shim import core as jcore
from vtpu_torch.ops import _build
from vtpu_torch.runtime import journal as tjournal
from vtpu_torch.runtime import protocol as P
from vtpu_torch.runtime import replication as R
from vtpu_torch.runtime import server as tserver
from vtpu_torch.runtime.client import RuntimeClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 10**6
TIMEOUT_S = 20.0


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """vtpu's brokers load the port's build of libvtpucore when
    native/build has none; lease sidecars under the test's directory; no
    quota env in a HELLO; every client socket has a timeout."""
    if jcore._lib is None:
        monkeypatch.setattr(jcore, "_SEARCH_PATHS", (
            _build.build_all(("vtpucore",))["vtpucore"],
            *jcore._SEARCH_PATHS))
    monkeypatch.setenv("VTPU_LEASE_SIDECAR", str(tmp_path / "lease.json"))
    for k in list(os.environ):
        if k.startswith(("VTPU_DEVICE_", "VTPU_TASK", "VTPU_OVERSUB",
                         "VTPU_FASTLANE")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("VTPU_RPC_TIMEOUT_S", str(TIMEOUT_S))
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "10")


# -- the epoch fence -----------------------------------------------------------

def test_fence_claim_and_stale_check(tmp_path):
    path = str(tmp_path / "s.fence")
    primary = R.Fence(path, enabled=True)
    assert primary.claim("e1") == 1
    primary.check()
    standby = R.Fence(path, enabled=True)
    assert standby.claim("e2") == 2
    with pytest.raises(R.FencedEpoch):
        primary.check()
    standby.check()
    # vtpu's fence reads the port's file and the reverse.
    assert JR.Fence(path).read() == 2
    JR.Fence(path, enabled=True).claim("e3")
    with pytest.raises(R.FencedEpoch):
        standby.check()


def test_fence_disabled_never_trips(tmp_path):
    path = str(tmp_path / "s.fence")
    a = R.Fence(path, enabled=False)
    a.claim("e1")
    R.Fence(path, enabled=True).claim("e2")
    a.check()


def test_fenced_journal_never_appends(tmp_path):
    """A journal that refuses appends is a broker that never acks."""
    fence_path = str(tmp_path / "s.fence")
    stale = R.Fence(fence_path, enabled=True)
    stale.claim("old")
    j = tjournal.Journal(str(tmp_path / "j"))
    j.fence = stale.check
    j.append({"op": "epoch", "epoch": "old"})
    R.Fence(fence_path, enabled=True).claim("new")
    with pytest.raises(OSError):
        j.append({"op": "chip", "index": 0, "lat_us": 1.0})
    j.close()


# -- the stream's framing --------------------------------------------------------

_CANNED = [
    {"op": "epoch", "epoch": "e1"},
    {"op": "bind", "name": "t", "devices": [0], "slots": [2],
     "priority": 1, "over": False, "hbm": [4096], "core": 50},
    {"op": "put", "name": "t", "id": "x", "sha": "s1", "shape": [4],
     "dtype": "float32", "nbytes": 16, "charges": [[0, 16]],
     "spilled": False},
    {"op": "ema", "name": "t", "key": "k", "ema": 123.0, "execs": 3},
    {"op": "migrate", "name": "t", "devices": [1], "slots": [5],
     "hbm": [4096]},
    {"op": "del", "name": "t", "id": "x"},
    {"op": "close", "name": "t"},
]
_FRAMES = [tjournal.Journal._frame(r) for r in _CANNED]
_BLOB = b"".join(_FRAMES)


def _expect_state(n):
    st = {"tenants": {}, "chips": {}}
    for rec in _CANNED[:n]:
        jjournal._apply_record(st, rec)
    return st


def _both(fn, *args):
    """``fn`` over the port's module and vtpu's; their results."""
    return fn(R, *args), fn(JR, *args)


@pytest.mark.parametrize("cut_index", range(len(_CANNED) + 1))
def test_stream_boundary_cut(cut_index):
    """A boundary-aligned prefix applies exactly its records, as vtpu's."""
    off = sum(len(f) for f in _FRAMES[:cut_index])

    def run(mod):
        st = {"tenants": {}, "chips": {}}
        n, left = mod.apply_stream(st, _BLOB[:off])
        return n, left, st

    got, want = _both(run)
    assert got == want == (cut_index, b"", _expect_state(cut_index))


@pytest.mark.parametrize("torn_index", range(len(_CANNED)))
def test_stream_torn_cut_defers_and_completes(torn_index):
    """A mid-record chunk boundary defers the fragment (the torn record is
    never applied) and the continuation completes it."""
    start = sum(len(f) for f in _FRAMES[:torn_index])
    end = start + len(_FRAMES[torn_index])
    frag = start + max(len(_FRAMES[torn_index]) // 2, 1)

    def run(mod):
        st = {"tenants": {}, "chips": {}}
        n, left = mod.apply_stream(st, _BLOB[:frag])
        mid = (n, copy.deepcopy(st))
        n2, left2 = mod.apply_stream(st, _BLOB[frag:end], left)
        return mid, n2, left2, st

    got, want = _both(run)
    assert got == want
    (n, st_mid), n2, left2, st = got
    assert n == torn_index and st_mid == _expect_state(torn_index)
    assert n2 == 1 and left2 == b"" and st == _expect_state(torn_index + 1)


@pytest.mark.parametrize("torn_index", range(len(_CANNED)))
def test_stream_flipped_byte_refused_whole(torn_index):
    """A flipped byte anywhere refuses the chunk and applies nothing."""
    pos = sum(len(f) for f in _FRAMES[:torn_index]) \
        + len(_FRAMES[torn_index]) // 2
    dmg = bytearray(_BLOB)
    dmg[pos] ^= 0x5A
    st = {"tenants": {}, "chips": {}}
    with pytest.raises(R.StreamCorrupt):
        R.apply_stream(st, bytes(dmg))
    with pytest.raises(JR.StreamCorrupt):
        JR.apply_stream({"tenants": {}, "chips": {}}, bytes(dmg))
    assert st == {"tenants": {}, "chips": {}}


def test_bootstrap_state_tolerates_torn_tail():
    data = _BLOB[:sum(len(f) for f in _FRAMES[:3])] + b"deadbeef {torn"
    got, want = _both(lambda mod: mod.bootstrap_state(b"", data))
    assert got == want == _expect_state(3)


def test_follower_overflow_drops(monkeypatch):
    monkeypatch.setattr(R, "REPL_BUFFER_BYTES", 64)
    f = R._Follower(0)
    f.push(("rec", b"x" * 40), 40, 1)
    assert not f.dropped and f.seq == 1
    f.push(("rec", b"y" * 40), 40, 1)
    assert f.dropped and not f.queue and f.queued_bytes == 0
    f.push(("rec", b"z"), 1, 1)
    assert f.dropped and f.seq == 1  # a dropped follower takes nothing


def test_follower_queues_a_blob_by_name(monkeypatch):
    """A blob is on the primary's disk before it is fed: the queue holds
    its name, so one larger than the cap does not drop the follower."""
    monkeypatch.setattr(R, "REPL_BUFFER_BYTES", 256)
    hub = R.ReplicationHub(None)
    f = R._Follower(0)
    hub.followers.append(f)
    hub.feed_blob("a" * 64, b"\0" * 4096)
    assert not f.dropped and f.queue[0] == ("blob", "a" * 64, 4096)
    assert (f.queued_bytes, f.blob_bytes) == (64, 4096)
    hub.feed(b"r" * 200, 1)
    assert f.dropped and (f.queued_bytes, f.blob_bytes) == (0, 0)


def test_blob_larger_than_the_cap_streams(primary, monkeypatch):
    """A PUT whose blob exceeds the follower's cap streams from the
    primary's store to the standby's mirror, the follower kept."""
    monkeypatch.setattr(R, "REPL_BUFFER_BYTES", 4096)
    sock, srv, sdir = primary
    c = RuntimeClient(sock, tenant="big-t", hbm_limit=8 * MB)
    try:
        c.put(torch.zeros(4), aid="w0")
        sb = R.Standby(sock, sdir, confirm_s=0.2, device="cpu")
        _follow(sb)
        seq0 = sb.seq
        x = torch.arange(16384, dtype=torch.float32)  # a 64 KiB blob
        c.put(x, aid="big")
        _wait_seq(sb, seq0 + 1)
        sha = sb.state["tenants"]["big-t"]["arrays"]["big"]["sha"]
        with open(os.path.join(srv.state.journal.dir, "blobs", sha),
                  "rb") as f:
            want = f.read()
        assert len(want) > R.REPL_BUFFER_BYTES
        bpath = os.path.join(sdir, "blobs", sha)
        deadline = time.monotonic() + 5.0
        while not os.path.exists(bpath):
            assert time.monotonic() < deadline, "blob never mirrored"
            time.sleep(0.02)
        with open(bpath, "rb") as f:
            assert f.read() == want
        fl = _admin(sock, {"kind": P.REPL_SYNC, "status": True}
                    )["replication"]["followers"]
        assert len(fl) == 1 and not fl[0]["dropped"]
        assert sb.blob_bytes >= len(want)
        sb.stop()
    finally:
        c.close()


# -- in-process primary, standby and takeover --------------------------------------

def _serve(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.05})
    th.start()
    return th


@pytest.fixture()
def primary(tmp_path):
    sock = str(tmp_path / "rt.sock")
    srv = tserver.make_server(sock, 64 * MB, 0, device="cpu",
                              journal_dir=str(tmp_path / "jp"))
    th = _serve(srv)
    yield sock, srv, str(tmp_path / "js")
    try:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    except Exception:  # noqa: BLE001 - some tests stop it themselves
        pass


def _follow(standby):
    th = threading.Thread(target=standby.follow_once, daemon=True)
    th.start()
    deadline = time.monotonic() + 10.0
    while standby.primary_epoch is None:
        assert time.monotonic() < deadline, "standby never bootstrapped"
        time.sleep(0.02)
    return th


def _wait_seq(standby, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while standby.seq < want:
        assert time.monotonic() < deadline, \
            f"standby lag never caught up ({standby.seq} < {want})"
        time.sleep(0.02)


def _admin(sock, msg):
    s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
    s.settimeout(TIMEOUT_S)
    s.connect(sock + ".admin")
    try:
        P.send_msg(s, msg)
        return P.recv_msg(s)
    finally:
        s.close()


def _crash(srv, standby, client):
    """A kill -9 of an in-process primary: its journal freezes first (a
    dead process appends nothing, not even the teardown's close), it
    stops serving, and the client's connection breaks."""
    old = srv.state.journal
    srv.state.journal = None
    standby._stop.set()
    srv.shutdown()
    srv.server_close()
    client.sock.close()
    return old


def test_streaming_state_and_visibility(primary):
    sock, srv, sdir = primary
    c = RuntimeClient(sock, tenant="repl-t", hbm_limit=8 * MB)
    try:
        c.put(torch.arange(64, dtype=torch.float32), aid="w")
        sb = R.Standby(sock, sdir, confirm_s=0.2, device="cpu")
        _follow(sb)
        assert sb.primary_epoch == srv.state.epoch
        assert "repl-t" in sb.state["tenants"]
        seq0 = sb.seq
        c.put(torch.ones(32), aid="w2")
        _wait_seq(sb, seq0 + 1)
        assert "w2" in sb.state["tenants"]["repl-t"]["arrays"]
        sha = sb.state["tenants"]["repl-t"]["arrays"]["w"]["sha"]
        bpath = os.path.join(sdir, "blobs", sha)
        deadline = time.monotonic() + 5.0
        while not os.path.exists(bpath):
            assert time.monotonic() < deadline, "blob never mirrored"
            time.sleep(0.02)
        rep = _admin(sock, {"kind": P.REPL_SYNC, "status": True})
        assert rep["ok"] and rep["replication"]["role"] == "primary"
        assert len(rep["replication"]["followers"]) == 1
        assert rep["replication"]["followers"][0]["lag_records"] == 0
        assert c.stats()  # STATS carries the block too
        st = tserver._stats_reply(srv.state)["replication"]
        assert len(st["followers"]) == 1 and st["fence_generation"] >= 1
        # The mirror on disk is a journal that loads to the applied state.
        assert sb.status()["stream_bytes"] > 0
        sb.stop()
    finally:
        c.close()


def test_takeover_resume_with_state_intact(primary, monkeypatch):
    """The takeover seeds the broker from the applied state (the journal
    is never re-read), claims through make_server, fences the old epoch;
    the tenant's GET after the reconnect reads its data."""
    sock, srv, sdir = primary
    c = RuntimeClient(sock, tenant="fo-t", hbm_limit=8 * MB)
    data = torch.arange(256, dtype=torch.float32) * 1.5
    c.put(data, aid="w")
    old_epoch = c.epoch
    sb = R.Standby(sock, sdir, confirm_s=0.2, device="cpu")
    _follow(sb)
    _wait_seq(sb, 1)
    old_journal = _crash(srv, sb, c)

    def no_reread(self):
        raise AssertionError("the takeover re-read the journal")

    monkeypatch.setattr(tjournal.Journal, "load_state", no_reread)
    srv2 = sb.takeover()
    monkeypatch.undo()
    th2 = _serve(srv2)
    try:
        assert torch.equal(c.get("w"), data)
        assert c.epoch == srv2.state.epoch != old_epoch
        assert srv2.state.prev_epoch == old_epoch
        repl = srv2.state.replication.status()
        assert repl["takeovers"] == 1 and "took-over" in repl["role"]
        split = repl["takeover"]
        assert set(split) >= {"confirm_s", "fence_s", "claim_s",
                              "stream_bytes", "blob_bytes"}
        assert split["blob_bytes"] >= data.numel() * 4
        assert srv2.state.recovery["tenants_readopted"] == 1
        with pytest.raises(OSError):
            old_journal.append({"op": "chip", "index": 0, "lat_us": 1.0})
    finally:
        c.close()
        srv2.shutdown()
        srv2.server_close()
        th2.join(timeout=10)


def test_failover_mid_park(primary):
    """A tenant admin-suspended on the primary comes back suspended on
    the standby (the suspend record replays through the stream)."""
    sock, srv, sdir = primary
    c = RuntimeClient(sock, tenant="park-t", hbm_limit=8 * MB)
    c.put(torch.ones(16), aid="w")
    assert _admin(sock, {"kind": P.SUSPEND, "tenant": "park-t"})["ok"]
    sb = R.Standby(sock, sdir, confirm_s=0.2, device="cpu")
    _follow(sb)
    _wait_seq(sb, 1)
    assert sb.state["tenants"]["park-t"]["suspended"] == {
        "auto": False, "by": None}
    _crash(srv, sb, c)
    srv2 = sb.takeover()
    th2 = _serve(srv2)
    try:
        assert c.get("w").shape == (16,)
        assert "park-t" in srv2.state.suspended
    finally:
        c.close()
        srv2.shutdown()
        srv2.server_close()
        th2.join(timeout=10)


def test_slo_history_rides_the_takeover(primary, monkeypatch):
    """The SLO plane's journaled rows stream to the standby and the new
    primary resumes the tenant's attainment history."""
    monkeypatch.setenv("VTPU_SLO_JOURNAL_S", "0.01")
    sock, srv, sdir = primary
    c = RuntimeClient(sock, tenant="hist")
    x = torch.rand(32)
    c.put(x, "x0")
    exe = c.compile(lambda a: a + 1.0, [x])
    for i in range(12):
        c.execute_send_ids(exe.id, ["x0"], [f"y{i % 2}"])
    for _ in range(12):
        c.recv_reply()
    c.stats()
    sb = R.Standby(sock, sdir, confirm_s=0.2, device="cpu")
    _follow(sb)
    time.sleep(0.02)
    srv.state.journal_tick()
    deadline = time.monotonic() + 10.0
    while "slo" not in sb.state["tenants"]["hist"]:
        assert time.monotonic() < deadline, "slo record never streamed"
        time.sleep(0.02)
    _crash(srv, sb, c)
    srv2 = sb.takeover()
    th2 = _serve(srv2)
    try:
        row = srv2.state.slo_report(admin=True)["tenants"]["hist"]
        assert row["restored_count"] == row["phases"]["e2e"]["count"] == 12
    finally:
        c.close()
        srv2.shutdown()
        srv2.server_close()
        th2.join(timeout=10)


# -- the fastlane's resubmit ---------------------------------------------------------

def test_gate_close_resubmit_invisible(tmp_path, monkeypatch):
    """A second connection of a laned tenant closes the lane's gate while
    a burst is in the ring: every cancelled descriptor is sent again over
    the socket inside the client, and the caller sees only oks."""
    monkeypatch.setenv("VTPU_FASTLANE", "1")
    sock = str(tmp_path / "fl.sock")
    srv = tserver.make_server(sock, 64 * MB, 0, device="cpu",
                              region_path=str(tmp_path / "fl.shr"))
    th = _serve(srv)
    c = RuntimeClient(sock, tenant="fl-resub", hbm_limit=16 * MB)
    c2 = None
    try:
        assert c._lane is not None, "lane not negotiated"
        data = torch.ones(256)
        c.put(data, aid="x0")
        exe = c.compile(lambda a: a * 2.0, [data])
        for _ in range(2):  # the first run primes over the socket
            c.execute_send_ids(exe.id, ["x0"], ["o"])
            assert c.recv_reply()["ok"]
        # Park the lane so the burst waits in the ring, then close it.
        hub = srv.state.fastlane
        lane = hub.lanes["fl-resub"]
        srv.state.suspended.add("fl-resub")
        deadline = time.monotonic() + 10.0
        while lane.ring.gate() != 1:
            assert time.monotonic() < deadline, "never parked"
            time.sleep(0.01)
        n = 24
        for _ in range(n):
            c.execute_send_ids(exe.id, ["x0"], ["o"])
        c._lane.flush()
        assert c._tok_ring > 0, "the burst never reached the ring"
        c2 = RuntimeClient(sock, tenant="fl-resub", hbm_limit=16 * MB)
        srv.state.suspended.discard("fl-resub")
        for _ in range(n):
            rep = c.recv_reply()
            assert rep["ok"], f"the caller saw the gate close: {rep}"
        assert c.fl_resubmits > 0, "the gate close cancelled nothing"
        assert lane.cancelled > 0
        assert torch.equal(c.get("o"), data * 2.0)
    finally:
        if c2 is not None:
            c2.close()
        c.close()
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


# -- kill -9 of a primary process --------------------------------------------------

def _spawn(args, env, log):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL, stderr=log)


def test_kill9_standby_takeover_e2e(tmp_path):
    """A primary process killed with SIGKILL mid-session under a standby
    process: the standby takes over, the tenant's GET reads its data
    back, the takeover's split is in STATS; the standby warmed torch and
    the broker without initialising CUDA."""
    sock = str(tmp_path / "rt.sock")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), VTPU_LOG_LEVEL="3")
    plog = open(tmp_path / "primary.err", "w")
    slog = open(tmp_path / "standby.err", "w")
    prim = _spawn(["vtpu_torch.runtime.server", "--socket", sock,
                   "--hbm-limit", "64Mi", "--core-limit", "0", "--device",
                   "cpu", "--journal-dir", str(tmp_path / "jp")], env, plog)
    standby = c = None
    try:
        deadline = time.monotonic() + 60.0
        while not os.path.exists(sock + ".admin"):
            assert prim.poll() is None, "the primary exited"
            assert time.monotonic() < deadline, "the primary never bound"
            time.sleep(0.1)
        standby = _spawn(["vtpu_torch.runtime.replication", "--socket", sock,
                          "--journal-dir", str(tmp_path / "js"),
                          "--hbm-limit", "64Mi", "--core-limit", "0",
                          "--device", "cpu", "--confirm-s", "0.3"], env, slog)
        c = RuntimeClient(sock, tenant="e2e", hbm_limit=8 * MB,
                          reconnect_timeout=60.0)
        data = torch.arange(1024, dtype=torch.float32) * 0.5
        c.put(data, aid="w")
        old_epoch = c.epoch
        deadline = time.monotonic() + 60.0
        while True:
            assert standby.poll() is None, "the standby exited"
            assert time.monotonic() < deadline, "the standby never attached"
            rep = _admin(sock, {"kind": P.REPL_SYNC, "status": True})
            fl = rep["replication"]["followers"]
            if fl and not fl[0]["dropped"] and fl[0]["lag_records"] == 0:
                break
            time.sleep(0.1)
        prim.send_signal(signal.SIGKILL)
        prim.wait(timeout=10)
        back = c.get("w")  # idempotent: retried on the new primary
        assert torch.equal(back, data)
        assert c.epoch != old_epoch
        repl = _admin(sock, {"kind": P.STATS})["replication"]
        assert repl["takeovers"] == 1
        assert repl["takeover"]["blob_bytes"] >= data.numel() * 4
        assert c.stats()["e2e"]["used_bytes"] == data.numel() * 4
        with open(tmp_path / "standby.err") as f:
            assert "CUDA initialised: False" in f.read()
    finally:
        if c is not None:
            c.close()
        for p in (prim, standby):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        plog.close()
        slog.close()


# -- wire parity ------------------------------------------------------------------

def _attach_both(sock, tmp_path):
    sbs = [R.Standby(sock, str(tmp_path / "s-port"), device="cpu"),
           JR.Standby(sock, str(tmp_path / "s-vtpu"))]
    ths = [_follow(sb) for sb in sbs]
    return sbs, ths


def _same_end(sbs, jdir, want_records):
    for sb in sbs:
        _wait_seq(sb, want_records)
    assert sbs[0].state == sbs[1].state
    # Each mirror on disk is a journal: both packages load it to the same
    # state, with the same blobs.  A standby (either package's) counts a
    # chunk before it appends it to its mirror, so the mirrors are read
    # until that append lands.
    a, b = (str(sb.journal_dir) for sb in sbs)
    deadline = time.monotonic() + TIMEOUT_S
    while True:
        got = (tjournal.Journal(a).load_state(),
               jjournal.Journal(b).load_state(),
               sorted(os.listdir(os.path.join(a, "blobs"))),
               sorted(os.listdir(os.path.join(b, "blobs"))))
        if got[0] == got[1] and got[2] == got[3] \
                or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    assert got[0] == got[1]
    assert got[2] == got[3]
    for sb in sbs:
        sb.stop()


def test_port_standby_follows_vtpu_primary(tmp_path):
    """A vtpu primary (JAX on the CPU) and its vtpu client; a port standby
    and a vtpu standby follow its REPL_SYNC stream to the same state."""
    sock = str(tmp_path / "v.sock")
    jdir = str(tmp_path / "vj")
    srv = jserver.make_server(sock, hbm_limit=64 * MB, core_limit=0,
                              region_path=str(tmp_path / "v.shr"),
                              journal_dir=jdir)
    th = _serve(srv)
    c = jclient.RuntimeClient(sock, tenant="vt", hbm_limit=8 * MB)
    try:
        c.put(np.arange(64, dtype=np.float32), aid="w")
        sbs, _ = _attach_both(sock, tmp_path)
        c.put(np.ones(32, dtype=np.float32), aid="w2")
        c.delete("w")
        _same_end(sbs, jdir, srv.state.journal.appended_total())
        st = sbs[0].state["tenants"]["vt"]
        assert set(st["arrays"]) == {"w2"}
    finally:
        c.close()
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_vtpu_standby_follows_port_primary(tmp_path):
    """The port's primary; a vtpu standby and a port standby follow its
    stream to the same state, blobs and all."""
    sock = str(tmp_path / "p.sock")
    jdir = str(tmp_path / "pj")
    srv = tserver.make_server(sock, 64 * MB, 0, device="cpu",
                              region_path=str(tmp_path / "p.shr"),
                              journal_dir=jdir)
    th = _serve(srv)
    c = RuntimeClient(sock, tenant="pt", hbm_limit=8 * MB)
    try:
        x = torch.arange(64, dtype=torch.float32)
        c.put(x, aid="w")
        sbs, _ = _attach_both(sock, tmp_path)
        c.put(torch.ones(32), aid="w2")
        c.compile(lambda a: a * 2.0, [x])
        c.delete("w")
        _same_end(sbs, jdir, srv.state.journal.appended_total())
        st = sbs[1].state["tenants"]["pt"]
        assert set(st["arrays"]) == {"w2"} and len(st["exes"]) == 1
    finally:
        c.close()
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_replication_smoke_matches_vtpu(capsys):
    """``python -m vtpu_torch.runtime.replication --smoke`` passes, as
    vtpu's does."""
    assert R.main(["--smoke"]) == 0
    assert '"ok": true' in capsys.readouterr().out
    assert R._smoke() == JR._smoke() == []
