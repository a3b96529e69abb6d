"""The port's journal, fence, faults and timers (vtpu_torch.runtime.journal,
.replication, .faults, .timers) against vtpu's on the same inputs.

- Frames: the same record frames to the same bytes in both packages, and
  each package's load_state reads the other's log (snapshot and segments
  included) to the same state; _apply_record replays random record runs
  to the same state.
- The corruption contract: a torn tail is dropped, damage mid-log fails
  closed (JournalCorrupt; a broker on such a directory quarantines it and
  boots a fresh epoch), compaction keeps the state, a crash between the
  rotation and the snapshot replays both segments, a failed append leaves
  a clean boundary (the journal/fsync fault sites), the blob store's GC
  spares young blobs, the fence stops a superseded journal.
- FaultPlan fires the same sequence as vtpu's for the same spec and seed.
- TimerWheel keeps its tasks on their grid under a driven clock, as
  vtpu's does.
- The degraded mode's LocalEnforcer decides as vtpu's."""

import json
import os
import random
import time
import zlib

import pytest

from vtpu.runtime import degraded as jdegraded
from vtpu.runtime import faults as jfaults
from vtpu.runtime import journal as jjournal
from vtpu.runtime import replication as jrepl
from vtpu.runtime import timers as jtimers
from vtpu_torch.runtime import degraded as tdegraded
from vtpu_torch.runtime import faults as tfaults
from vtpu_torch.runtime import journal as tjournal
from vtpu_torch.runtime import replication as trepl
from vtpu_torch.runtime import server as tserver
from vtpu_torch.runtime import timers as ttimers


@pytest.fixture(autouse=True)
def _lease(tmp_path, monkeypatch):
    """Brokers made here write their lease sidecar under the test's
    directory."""
    monkeypatch.setenv("VTPU_LEASE_SIDECAR", str(tmp_path / "lease.json"))


# One record of every op vtpu's broker writes.
RECORDS = [
    {"op": "epoch", "epoch": "1a2b-3c4d"},
    {"op": "chip", "index": 0, "lat_us": 61.5},
    {"op": "bind", "name": "t", "devices": [0], "slots": [2], "priority": 1,
     "over": False, "hbm": [1 << 30], "core": 50, "spill": None,
     "pid": 4242, "pidns": 4026531836},
    {"op": "put", "name": "t", "id": "w.0", "sha": "ab" * 32,
     "shape": [4, 8], "dtype": "bfloat16", "nbytes": 64,
     "charges": [[0, 64]], "spilled": False},
    {"op": "compile", "name": "t", "id": "e0", "sha": "cd" * 32},
    {"op": "ema", "name": "t", "key": "e0", "ema": 4123.25, "execs": 12},
    {"op": "resize", "name": "t", "hbm": [1 << 29], "core": 25},
    {"op": "suspend", "name": "t", "auto": False},
    {"op": "resume", "name": "t", "auto": False},
    {"op": "credit", "name": "t", "us": 10.5, "minted": 20.0, "spent": 9.5},
    {"op": "slo", "name": "t", "state": {"n": 3, "p": [1.0, 2.5]}},
    {"op": "migrate", "name": "t", "devices": [1], "slots": [0]},
    {"op": "wedge", "stage": "cuda init", "ts": 1.5, "diagnosis": "x"},
    {"op": "del", "name": "t", "id": "w.0"},
    {"op": "close", "name": "t"},
]


@pytest.mark.parametrize("rec", RECORDS, ids=[r["op"] for r in RECORDS])
def test_frames_byte_identical_to_vtpu(rec):
    frame = tjournal.Journal._frame(rec)
    assert frame == jjournal.Journal._frame(rec)
    assert tjournal.Journal._parse_lines(frame, tail_tolerant=False) == [rec]


def _session(jr, n_tenants=3, seed=0):
    """A plausible broker session's records, appended to ``jr``."""
    rng = random.Random(seed)
    recs = [{"op": "epoch", "epoch": f"e{seed}"},
            {"op": "chip", "index": 0, "lat_us": 50.0 + seed}]
    for i in range(n_tenants):
        name = f"t{i}"
        recs.append({"op": "bind", "name": name, "devices": [0],
                     "slots": [i], "priority": 1, "over": False,
                     "hbm": [1000 * (i + 1)], "core": 10 * i, "spill": None,
                     "pid": 100 + i, "pidns": 7})
        for j in range(rng.randrange(1, 5)):
            nb = rng.randrange(1, 64) * 4
            sha = jr.put_blob(bytes([i, j]) * (nb // 2))
            recs.append({"op": "put", "name": name, "id": f"a{j}",
                         "sha": sha, "shape": [nb // 4], "dtype": "float32",
                         "nbytes": nb, "charges": [[0, nb]],
                         "spilled": False})
        recs.append({"op": "compile", "name": name, "id": "e0",
                     "sha": jr.put_blob(b"graph" + bytes([i]))})
        for _ in range(rng.randrange(0, 4)):
            recs.append({"op": "ema", "name": name, "key": "e0",
                         "ema": rng.uniform(10, 5000), "execs": 4})
        if rng.random() < 0.5:
            recs.append({"op": "del", "name": name, "id": "a0"})
        if rng.random() < 0.3:
            recs.append({"op": "resize", "name": name, "core": 77})
    recs.append({"op": "close", "name": "t0"})
    for rec in recs:
        jr.append(rec)
    return recs


@pytest.mark.parametrize("writer", ["port", "vtpu"])
def test_each_package_reads_the_others_log(tmp_path, writer):
    """A log (with a compaction part-way) written by one package loads to
    the same state in both; the log files are byte-identical to the other
    package's for the same records."""
    mods = {"port": tjournal, "vtpu": jjournal}
    other = "vtpu" if writer == "port" else "port"
    jw = mods[writer].Journal(str(tmp_path / "w"), snapshot_every=10**6)
    recs = _session(jw, seed=3)
    jw.write_snapshot(lambda: mods[writer].Journal(str(tmp_path / "w"))
                      .load_state())
    recs += _session(jw, n_tenants=2, seed=4)
    jw.close()
    want = mods[writer].Journal(str(tmp_path / "w")).load_state()
    got = mods[other].Journal(str(tmp_path / "w")).load_state()
    assert got == want and want["tenants"]
    jo = mods[other].Journal(str(tmp_path / "o"), snapshot_every=10**6)
    for rec in recs[-20:]:
        jo.append(rec)
    jo.close()
    with open(tmp_path / "o" / tjournal.LOG_NAME, "rb") as f:
        theirs = f.read()
    assert theirs == b"".join(tjournal.Journal._frame(r) for r in recs[-20:])


@pytest.mark.parametrize("seed", range(4))
def test_apply_record_matches_vtpu(seed):
    rng = random.Random(seed)
    ts, js = {}, {}
    for _ in range(200):
        rec = dict(rng.choice(RECORDS))
        if "name" in rec:
            rec["name"] = rng.choice("abc")
        if rec["op"] == "bind" and rng.random() < 0.5:
            rec.pop("pid")
        tjournal._apply_record(ts, rec)
        jjournal._apply_record(js, rec)
        assert ts == js


def _write(tmp_path, recs):
    jr = tjournal.Journal(str(tmp_path), snapshot_every=10**6)
    for rec in recs:
        jr.append(rec)
    jr.close()
    return tmp_path / tjournal.LOG_NAME


def test_torn_tail_dropped(tmp_path):
    path = _write(tmp_path, RECORDS[:5])
    with open(path, "ab") as f:
        f.write(tjournal.Journal._frame(RECORDS[5])[:-7])
    got = tjournal.Journal(str(tmp_path)).load_state()
    assert got == jjournal.Journal(str(tmp_path)).load_state()
    assert "e0" not in got["tenants"]["t"]["ema"]
    assert got["tenants"]["t"]["exes"] == {"e0": "cd" * 32}


@pytest.mark.parametrize("damage", ["crc", "json", "not_a_map"])
def test_mid_log_damage_fails_closed(tmp_path, damage):
    path = _write(tmp_path, RECORDS[:6])
    lines = path.read_bytes().split(b"\n")
    if damage == "crc":
        lines[2] = b"00000000" + lines[2][8:]
    elif damage == "json":
        lines[2] = lines[2][:-3]
    else:
        payload = b"[1,2]"
        lines[2] = b"%08x %s" % (zlib.crc32(payload), payload)
    path.write_bytes(b"\n".join(lines))
    for mod in (tjournal, jjournal):
        with pytest.raises(mod.JournalCorrupt):
            mod.Journal(str(tmp_path)).load_state()


def test_broker_on_a_corrupt_journal_boots_a_fresh_epoch(tmp_path):
    """Fail closed: the directory is quarantined, nothing is recovered,
    and the next boot starts from a clean journal."""
    jdir = tmp_path / "j"
    path = _write(jdir, RECORDS[:6])
    lines = path.read_bytes().split(b"\n")
    lines[1] = b"deadbeef" + lines[1][8:]
    path.write_bytes(b"\n".join(lines))
    srv = tserver.make_server(str(tmp_path / "b.sock"), 0, 0, device="cpu",
                              journal_dir=str(jdir))
    try:
        js = srv.state.journal_stats()
        assert js["corrupt_recoveries"] == 1
        assert js["tenants_recovered"] == 0 and not srv.state.recovered
        assert any(n.startswith(tjournal.LOG_NAME + ".corrupt.")
                   for n in os.listdir(jdir))
        assert tjournal.Journal(str(jdir)).load_state()["epoch"] == \
            srv.state.epoch
    finally:
        srv.server_close()


def test_unusable_journal_dir_runs_without(tmp_path):
    """An unusable directory is logged and the broker serves with no
    journal, as vtpu's does."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    srv = tserver.make_server(str(tmp_path / "b.sock"), 0, 0, device="cpu",
                              journal_dir=str(blocker / "j"))
    try:
        assert srv.state.journal is None
        assert srv.state.journal_stats()["enabled"] is False
    finally:
        srv.server_close()


def test_compaction_keeps_state(tmp_path):
    """Snapshot every 7 records: the state equals the plain replay, the
    log restarts, a leftover rotated segment (a crash between rotation
    and snapshot) replays before the live one."""
    plain = tjournal.Journal(str(tmp_path / "plain"), snapshot_every=10**6)
    recs = _session(plain, n_tenants=4, seed=9)
    want = plain.load_state()
    jr = tjournal.Journal(str(tmp_path / "c"), snapshot_every=7)
    for rec in recs:
        for blob in (rec.get("sha"),):
            if blob:
                jr.put_blob(plain.get_blob(blob), sha=blob)
        jr.append(rec)
        if jr.snapshot_due():
            jr.write_snapshot(jr.load_state)
    assert jr.load_state() == want
    assert jr.stats()["records_since_snapshot"] < 7
    jr.close()
    # A crash after the rotation, before the snapshot: .old holds records
    # the snapshot does not.
    c = tmp_path / "c"
    os.replace(c / tjournal.LOG_NAME, c / (tjournal.LOG_NAME + ".old"))
    (c / tjournal.LOG_NAME).write_bytes(b"")
    for mod in (tjournal, jjournal):
        assert mod.Journal(str(c)).load_state() == want


def test_blob_store_and_gc(tmp_path):
    jr = tjournal.Journal(str(tmp_path))
    a = jr.put_blob(b"a" * 100)
    assert jr.put_blob(b"a" * 100) == a == jjournal.Journal(
        str(tmp_path / "v")).put_blob(b"a" * 100)
    b = jr.put_blob(b"b" * 10)
    old = jr.put_blob(b"old")
    past = os.path.getmtime(os.path.join(jr.dir, tjournal.BLOBS_DIR, old)) \
        - 2 * tjournal.BLOB_GC_MIN_AGE_S
    for sha in (old, b):
        os.utime(os.path.join(jr.dir, tjournal.BLOBS_DIR, sha), (past, past))
    jr.append({"op": "bind", "name": "t", "devices": [0], "slots": [0]})
    jr.append({"op": "put", "name": "t", "id": "x", "sha": b, "shape": [10],
               "dtype": "uint8", "nbytes": 10, "charges": [[0, 10]],
               "spilled": False})
    jr.write_snapshot(jr.load_state)
    # b is referenced, a is young, old is neither.
    assert sorted(jr.blob_names()) == sorted([a, b])
    assert jr.get_blob(b) == b"b" * 10 and jr.get_blob("../x") is None


@pytest.mark.parametrize("spec", ["write_short@journal:nth=3",
                                  "enospc@journal:nth=3",
                                  "fsync_eio@fsync:nth=3"])
def test_failed_append_leaves_a_clean_boundary(tmp_path, monkeypatch, spec):
    """The failing append raises; the log is cut back to the record
    before it and later appends replay."""
    monkeypatch.setenv("VTPU_FAULTS", spec)
    tfaults.reload()
    try:
        jr = tjournal.Journal(str(tmp_path), fsync=spec.startswith("fsync"))
        jr.append(RECORDS[0])
        jr.append(RECORDS[2])
        with pytest.raises(OSError):
            jr.append(RECORDS[3])
        jr.append(RECORDS[4])
        assert jr.stats()["write_errors"] == 1 and not jr.journal_broken()
    finally:
        monkeypatch.delenv("VTPU_FAULTS")
        tfaults.reload()
    got = tjournal.Journal(str(tmp_path)).load_state()
    assert got["tenants"]["t"]["arrays"] == {}
    assert got["tenants"]["t"]["exes"] == {"e0": "cd" * 32}


def test_fence_stops_a_superseded_journal(tmp_path):
    """A second claim (a successor's) supersedes the first: the first
    journal can append no more.  vtpu's Fence reads the same file."""
    path = str(tmp_path / "s.fence")
    first = trepl.Fence(path, enabled=True)
    assert first.claim("e1") == 1
    jr = tjournal.Journal(str(tmp_path / "j"))
    jr.fence = first.check
    jr.append(RECORDS[0])
    assert jrepl.Fence(path).read() == 1
    assert jrepl.Fence(path).claim("e2") == 2
    with pytest.raises(trepl.FencedEpoch):
        jr.append(RECORDS[1])
    assert isinstance(trepl.FencedEpoch("x"), OSError)
    trepl.Fence(path, enabled=False).check()


# -- faults --------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "sock_drop@get:p=0.3",
    "reply_delay@put:ms=0;sock_drop@EXEC_BATCH:every=3",
    "enospc@journal:after=4,limit=3",
    "exit3@dispatch:nth=5",
    "sock_drop@recv:p=0.5;sock_drop@recv:p=0.5"])
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_fires_as_vtpus(spec, seed):
    """The same spec, seed and call sequence fire the same points, in
    the same order, with the same hit and fire counts."""
    def run(mod):
        plan = mod.FaultPlan(spec, seed)
        fired = []
        sites = ["get", "put", "exec_batch", "journal", "dispatch", "recv"]
        for i in range(60):
            site = sites[i % len(sites)]
            for pt in plan.by_site.get(site, ()):
                if pt.should_fire():
                    fired.append((i, pt.fault, pt.site))
        return fired, plan.snapshot()
    assert run(tfaults) == run(jfaults)


@pytest.mark.parametrize("bad", ["nope", "sock_drop@", "@get",
                                 "sock_drop@get:x=1", "sock_drop@get:p=a"])
def test_fault_spec_errors_match_vtpus(bad):
    with pytest.raises(tfaults.FaultSpecError):
        tfaults.FaultPlan(bad)
    with pytest.raises(jfaults.FaultSpecError):
        jfaults.FaultPlan(bad)


def test_faults_off_is_a_no_op_and_reload_reads_the_env(monkeypatch):
    monkeypatch.delenv("VTPU_FAULTS", raising=False)
    assert tfaults.reload() is None
    tfaults.fire("dispatch")
    monkeypatch.setenv("VTPU_FAULTS", "sock_drop@get:nth=2")
    monkeypatch.setenv("VTPU_FAULTS_SEED", "5")
    try:
        plan = tfaults.reload()
        assert plan.seed == 5
        tfaults.fire("GET")
        with pytest.raises(ConnectionError):
            tfaults.fire("get")
        assert plan.snapshot() == {"sock_drop@get": {"hits": 2, "fires": 1}}
    finally:
        monkeypatch.delenv("VTPU_FAULTS")
        tfaults.reload()


# -- timers --------------------------------------------------------------------

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("coalesce", [0.0, 0.25])
def test_timer_wheel_keeps_its_grid_as_vtpus(coalesce):
    """Periodic tasks on a driven clock: every fire lands on its own
    period's grid (however late the wakeup), co-periodic tasks coalesce
    within the window, and vtpu's wheel fires the same batches."""
    def run(mod):
        clock = Clock()
        w = mod.TimerWheel(coalesce=coalesce, clock=clock, start=False)
        for name, period in (("journal", 1.0), ("lease", 5.0),
                             ("half", 0.5)):
            w.add_periodic(name, period, lambda: None)
        fired = []
        rng = random.Random(1)
        for _ in range(80):
            clock.t += rng.uniform(0.05, 0.9)
            with w.mu:
                batch = w._due_batch_locked(clock.t)
                dues = {n: t["due"] for n, t in w._tasks.items()}
            fired.append(([n for n, _ in batch], dues))
        return fired, w.epoch
    got, epoch = run(ttimers)
    want, _ = run(jtimers)
    assert [f[0] for f in got] == [f[0] for f in want]
    for _names, dues in got:
        for name, period in (("journal", 1.0), ("lease", 5.0),
                             ("half", 0.5)):
            k = (dues[name] - epoch) / period
            assert abs(k - round(k)) < 1e-6, (name, dues[name])
    assert sum(len(f[0]) for f in got) > 80


def test_timer_wheel_thread_arm_cancel_and_stats():
    import threading
    w = ttimers.TimerWheel(coalesce=0.0)
    try:
        hit = threading.Event()
        w.arm("once", ttimers.time.monotonic() + 0.02, hit.set)
        assert hit.wait(5.0)
        w.add_periodic("p", 0.01, lambda: None)
        w.arm("gone", ttimers.time.monotonic() + 60, lambda: None)
        w.cancel("gone")
        deadline = ttimers.time.monotonic() + 5
        while w.stats()["tasks"]["p"]["fires"] < 3:
            assert ttimers.time.monotonic() < deadline
            ttimers.time.sleep(0.01)
        st = w.stats()
        assert "gone" not in st["tasks"] and st["wakeups"] >= 3
        assert st["coalesce_ms"] == 0
    finally:
        w.stop()


def test_timer_coalesce_env(monkeypatch):
    monkeypatch.setenv("VTPU_TIMER_COALESCE_MS", "40")
    assert ttimers.coalesce_s() == jtimers.coalesce_s() == 0.04
    monkeypatch.setenv("VTPU_TIMER_COALESCE_MS", "junk")
    assert ttimers.coalesce_s() == 0.25


# -- the degraded mode's enforcer ------------------------------------------------

def test_local_enforcer_decides_as_vtpus(monkeypatch):
    """The Python mirror (no region): the same HBM verdicts from the same
    usage, and the same bucket verdicts at the same times."""
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", raising=False)
    clock = Clock(50.0)
    monkeypatch.setattr(tdegraded.time, "monotonic", clock)
    monkeypatch.setattr(jdegraded.time, "monotonic", clock)
    t = tdegraded.LocalEnforcer.from_env(hbm_limit=1000, core_pct=50,
                                         used_bytes=600)
    j = jdegraded.LocalEnforcer.from_env(hbm_limit=1000, core_pct=50,
                                         used_bytes=600)
    rng = random.Random(2)
    for _ in range(100):
        clock.t += rng.uniform(0, 0.05)
        n = rng.randrange(0, 600)
        assert t.admit_bytes(n) == j.admit_bytes(n)
        us = rng.uniform(0, 30000)
        assert t.admit_us(us) == j.admit_us(us)
        d = rng.randrange(-50, 50)
        t.note_bytes(d)
        j.note_bytes(d)
    t.close()
    j.close()


def test_local_enforcer_over_the_region(tmp_path, monkeypatch):
    """With a region mounted, the cap is the region's: a refused
    admission leaves the ledger as it was."""
    from vtpu_torch.shim.core import SharedRegion
    path = str(tmp_path / "r.shr")
    region = SharedRegion(path, limits=[1000], core_pcts=[0])
    assert region.mem_acquire(0, 700, False)
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", path)
    enf = tdegraded.LocalEnforcer.from_env()
    try:
        assert enf.region is not None
        assert enf.admit_bytes(300) and not enf.admit_bytes(301)
        assert int(region.device_stats(0).used_bytes) == 700
        assert enf.admit_us(10**9)  # no share: unmetered
    finally:
        enf.close()
        region.close()


def test_snapshot_of_a_live_broker_is_vtpus_shape(tmp_path):
    """The broker's boot snapshot loads in vtpu's journal and carries the
    epoch, the card's calibration key and no tenant."""
    srv = tserver.make_server(str(tmp_path / "b.sock"), 0, 0, device="cpu",
                              journal_dir=str(tmp_path / "j"))
    try:
        got = jjournal.Journal(str(tmp_path / "j")).load_state()
        assert got["epoch"] == srv.state.epoch and got["tenants"] == {}
        with open(tmp_path / "j" / tjournal.SNAP_NAME) as f:
            assert json.load(f)["version"] == 1
    finally:
        srv.server_close()


def test_restored_programs_are_vetted_and_unpickle_nothing(tmp_path,
                                                           monkeypatch):
    """A successor restores a tenant's arrays and programs from the
    journal with torch.load and pickle's loaders made to raise, and a
    graph blob that was altered on disk into one calling an op off the
    broker's list is refused again at the restore (the program is then
    missing, the arrays are back)."""
    import pickle
    import socket
    import threading

    import numpy as np
    import torch

    from vtpu_torch.runtime import client as tclient

    sock, jdir = str(tmp_path / "b.sock"), str(tmp_path / "j")

    def serve():
        srv = tserver.make_server(sock, 0, 0, device="cpu",
                                  journal_dir=jdir)
        th = threading.Thread(target=srv.serve_forever, daemon=True,
                              kwargs={"poll_interval": 0.05})
        th.start()
        return srv, th

    srv, th = serve()
    c = tclient.RuntimeClient(sock, tenant="u", reconnect_timeout=20)
    x = np.arange(6, dtype=np.float32)
    c.put(x, "x")
    good = c.compile(lambda v: v + 1.0, [x])
    bad = c.compile(lambda v: v * 3.0, [x])
    epoch = c.epoch
    # A crash: the teardown of this process's session must journal
    # nothing a killed broker would not have written.
    srv.state.journal = None
    c.sock.shutdown(socket.SHUT_RDWR)
    srv.shutdown()
    srv.server_close()
    th.join(10)
    state = tjournal.Journal(jdir).load_state()
    unsafe = tclient.export_graph(lambda v: torch.empty_like(v), [x])
    with open(os.path.join(jdir, tjournal.BLOBS_DIR,
                           state["tenants"]["u"]["exes"][bad.id]), "wb") as f:
        f.write(unsafe)

    def refuse(*_a, **_k):
        raise AssertionError("the restore unpickled")
    monkeypatch.setattr(torch, "load", refuse)
    monkeypatch.setattr(pickle, "loads", refuse)
    monkeypatch.setattr(pickle, "load", refuse)
    monkeypatch.setattr(pickle, "Unpickler", refuse)
    srv, th = serve()
    try:
        np.testing.assert_array_equal(c.get("x").numpy(), x)
        assert c.epoch == srv.state.epoch != epoch
        c.execute_send_ids(good.id, ["x"], ["y"])
        c.execute_recv()
        np.testing.assert_array_equal(c.get("y").numpy(), x + 1)
        c.execute_send_ids(bad.id, ["x"], ["z"])
        with pytest.raises(tclient.RuntimeError_, match="NOT_FOUND"):
            c.execute_recv()
        assert srv.state.journal_stats()["tenants_readopted"] == 1
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)


def test_teardown_journals_no_drop_after_the_close(tmp_path):
    """A tenant's last connection closing journals ``close`` and no
    ``del`` after it: a late drop record could land after a new binding
    of the same name and delete that tenant's array at replay (vtpu's
    teardown flushes its drops after the close)."""
    import threading

    import numpy as np

    from vtpu_torch.runtime import client as tclient

    sock, jdir = str(tmp_path / "b.sock"), str(tmp_path / "j")
    srv = tserver.make_server(sock, 0, 0, device="cpu", journal_dir=jdir)
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.05})
    th.start()
    try:
        c = tclient.RuntimeClient(sock, tenant="n", reconnect_timeout=0)
        c.put(np.ones(3, np.float32), "x")
        c.close()
        deadline = time.monotonic() + 10
        while srv.state.tenants:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        c = tclient.RuntimeClient(sock, tenant="n", reconnect_timeout=0)
        c.put(np.ones(2, np.float32), "x")
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)
    with open(os.path.join(jdir, tjournal.LOG_NAME), "rb") as f:
        ops = [r["op"] for r in tjournal.Journal._parse_lines(
            f.read(), tail_tolerant=False) if r.get("name") == "n"]
    assert ops == ["bind", "put", "close", "bind", "put", "close"], ops
