"""The port's flight recorder and claim forensics (vtpu_torch.runtime.trace)
against vtpu's, and tracing through the port's broker.

- FlightRecorder: the same spans (and slow-op contexts) give the same
  snapshot, summary and captures as vtpu's; chrome_trace the same
  document.
- The lease sidecar: written, beaten, judged, taken over and cleared as
  vtpu's judges the same file; the default path is CUDA's.
- Tracing off adds zero wire fields and no CUDA events; on, every request
  carries a stamp, and a broker with VTPU_TRACE=1 records one span per
  execute whose queue, bucket and device phases add up to its total, with
  bucket waits under a throttled share; TRACE answers on both sockets;
  ``vtpu-smi trace --dump`` writes a Chrome trace and ``vtpu-smi leases``
  names the broker.
- The claim watchdog: a wedged claim exits 3 with a ``wedge`` record,
  which the successor reports."""

import json
import os
import random
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from vtpu.runtime import trace as jtrace
from vtpu_torch.runtime import client as tclient
from vtpu_torch.runtime import journal as tjournal
from vtpu_torch.runtime import protocol as TP
from vtpu_torch.runtime import server as tserver
from vtpu_torch.runtime import trace as ttrace
from vtpu_torch.tools import vtpu_smi as tsmi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    monkeypatch.setenv("VTPU_LEASE_SIDECAR", str(tmp_path / "lease.json"))
    monkeypatch.setenv("VTPU_RPC_TIMEOUT_S", "20")
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "0")
    for k in list(os.environ):
        if k.startswith(("VTPU_DEVICE_", "VTPU_TASK", "VTPU_FAULTS")):
            monkeypatch.delenv(k)


def _spans(seed, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        q, b, d = (rng.uniform(0, 900), rng.choice([0.0, rng.uniform(0, 5e4)]),
                   rng.uniform(100, 3e5))
        sp = {"ts": 1000.0 + i, "tenant": rng.choice("ab"), "chip": 0,
              "key": rng.choice(["e0", "e1"]), "steps": rng.choice([1, 4]),
              "queue_us": round(q, 1), "bucket_us": round(b, 1),
              "device_us": round(d, 1), "total_us": round(q + b + d, 1),
              "busy_us": round(d * 0.9, 1), "est_us": rng.uniform(10, 3e4)}
        if rng.random() < 0.3:
            sp["trace"] = f"{i:016x}"
        out.append(sp)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_flight_recorder_matches_vtpu(seed):
    t = ttrace.FlightRecorder(enabled=True, depth=16, slow_factor=8.0)
    j = jtrace.FlightRecorder(enabled=True, depth=16, slow_factor=8.0)
    for sp in _spans(seed):
        est = sp["est_us"]
        ct = t.record(sp["tenant"], dict(sp), est_us=est,
                      context_fn=lambda: {"queue_depth": 2})
        cj = j.record(sp["tenant"], dict(sp), est_us=est,
                      context_fn=lambda: {"queue_depth": 2})
        assert (ct is None) == (cj is None)
        if ct is not None:
            assert {k: v for k, v in ct.items() if k != "ts"} == \
                {k: v for k, v in cj.items() if k != "ts"}
    snap = t.snapshot()
    want = j.snapshot()
    for body in list(snap.values()) + list(want.values()):
        for cap in body["captures"]:
            cap.pop("ts")
    assert snap == want
    assert t.snapshot("a", limit=3)["a"]["spans"] == \
        j.snapshot("a", limit=3)["a"]["spans"]
    assert t.summary("a") == j.summary("a") and t.summary("zz") is None
    assert len(t.snapshot("a")["a"]["spans"]) <= 16
    t.forget("a")
    assert "a" not in t.snapshot() and t.summary("a") is None


def test_flight_recorder_off_records_nothing():
    t = ttrace.FlightRecorder(enabled=False)
    assert t.record("a", _spans(0)[0], est_us=1.0) is None
    assert t.snapshot() == {}


@pytest.mark.parametrize("seed", range(2))
def test_chrome_trace_matches_vtpu(seed):
    rec = jtrace.FlightRecorder(enabled=True, depth=64, slow_factor=2.0)
    for sp in _spans(seed):
        rec.record(sp["tenant"], sp, est_us=sp["est_us"],
                   context_fn=lambda: {"co_tenants": []})
    snap = rec.snapshot()
    doc = ttrace.chrome_trace(snap)
    assert doc == jtrace.chrome_trace(snap)
    assert json.loads(json.dumps(doc))["traceEvents"]
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"].split("/")[1] for e in xs} <= {"queue", "bucket",
                                                      "device"}


def test_env_knobs_match_vtpu(monkeypatch):
    for ring, slow in (("32", "3"), ("2", "0"), ("x", "y")):
        monkeypatch.setenv("VTPU_TRACE_RING", ring)
        monkeypatch.setenv("VTPU_SLOW_OP_FACTOR", slow)
        assert ttrace.ring_spans() == jtrace.ring_spans()
        assert ttrace.slow_op_factor() == jtrace.slow_op_factor()
    for v in ("", "0", "1", " 1 "):
        monkeypatch.setenv("VTPU_TRACE", v)
        assert ttrace.trace_enabled() == jtrace.trace_enabled()
    assert len(ttrace.new_trace_id()) == 16


def test_lease_sidecar_as_vtpu_judges_it(tmp_path, monkeypatch):
    path = str(tmp_path / "lease.json")
    monkeypatch.delenv("VTPU_LEASE_SIDECAR")
    assert ttrace.lease_sidecar_path().endswith("vtpu-cuda.lease.json")
    assert "libtpu" not in ttrace.lease_sidecar_path()
    assert ttrace.write_lease_sidecar("cuda init", path, {"epoch": "e"})
    for mod in (ttrace, jtrace):
        d = mod.diagnose_lease(path)
        assert d["present"] and d["pid"] == os.getpid() and d["alive"]
        assert not d["stale"] and d["stage"] == "cuda init"
        assert mod.diagnose_lease(path, exclude_pid=os.getpid()) == \
            {"present": False}
    assert ttrace.format_lease_diagnosis(ttrace.diagnose_lease(path)) == \
        jtrace.format_lease_diagnosis(jtrace.diagnose_lease(path))
    # A dead holder's record: stale, taken over, and the takeover is
    # recorded; a live foreign holder's record is kept.
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True).stdout.strip()
    with open(path, "w") as f:
        json.dump({"pid": int(dead), "cmdline": "x", "stage": "held"}, f)
    assert ttrace.diagnose_lease(path)["stale"]
    assert ttrace.takeover_lease_sidecar(path)
    rec = ttrace.read_lease_sidecar(path)
    assert rec["pid"] == os.getpid() and rec["took_over_pid"] == int(dead)
    ttrace.heartbeat_lease_sidecar(path)
    ttrace.clear_lease_sidecar(path)
    assert not os.path.exists(path)
    with open(path, "w") as f:
        json.dump({"pid": os.getppid(), "cmdline": "y", "stage": "held"}, f)
    assert not ttrace.write_lease_sidecar("mine", path)
    assert ttrace.read_lease_sidecar(path)["pid"] == os.getppid()
    ttrace.clear_lease_sidecar(path)
    assert os.path.exists(path)


# -- through the broker ------------------------------------------------------

def _start(tmp_path, **kw):
    sock = str(tmp_path / "b.sock")
    srv = tserver.make_server(sock, hbm_limit=kw.pop("hbm_limit", 0),
                              core_limit=kw.pop("core_limit", 0),
                              device="cpu", **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.05})
    th.start()
    return sock, srv, th


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


def _sent_messages(monkeypatch):
    """Every request header framed in this process (the broker's replies,
    which carry no ``kind``, are left out)."""
    sent = []
    real_frame, real_send = TP.frame_header, TP.send_msg

    def frame(msg):
        if "kind" in msg:
            sent.append(dict(msg))
        return real_frame(msg)

    def send(sock, msg):
        if "kind" in msg:
            sent.append(dict(msg))
        return real_send(sock, msg)
    monkeypatch.setattr(TP, "frame_header", frame)
    monkeypatch.setattr(TP, "send_msg", send)
    return sent


@pytest.mark.parametrize("on", [False, True])
def test_tracing_off_adds_zero_wire_fields(tmp_path, monkeypatch, on):
    """The same session framed with tracing off carries exactly the
    fields it carried before tracing existed; on, each request carries
    one ``trace`` stamp and nothing else more."""
    sock, srv, th = _start(tmp_path)
    try:
        sent = _sent_messages(monkeypatch)
        c = tclient.RuntimeClient(sock, tenant="w", trace=on)
        exe = c.compile(lambda a: a + 1.0, [np.ones(4, np.float32)])
        c.put(np.ones(4, np.float32), "x")
        c.execute_send_ids(exe.id, ["x"], ["y"])
        c.execute_recv()
        c.get("y")
        c.stats()
        c.close()
    finally:
        _stop(srv, th)
    requests = [m for m in sent if m.get("kind") != TP.HELLO]
    assert {m["kind"] for m in requests} >= {TP.COMPILE, TP.PUT, TP.EXECUTE,
                                             TP.GET, TP.STATS}
    if on:
        assert all(set(m["trace"]) == {"id", "ts"} for m in requests)
    else:
        assert not any("trace" in m for m in sent)
    assert not any("trace" in m for m in sent if m.get("kind") == TP.HELLO)


def test_spans_partition_their_total_under_a_throttled_share(tmp_path,
                                                              monkeypatch):
    """VTPU_TRACE=1, core 20% with a pinned 20 ms cost, strict shares: a
    span per execute, queue + bucket + device == total in each, bucket
    waits once the burst is spent, the client's trace ids in the spans;
    TRACE on the tenant and admin sockets; vtpu-smi trace --dump writes a
    Chrome trace; vtpu-smi leases names this process."""
    monkeypatch.setenv("VTPU_TRACE", "1")
    sock, srv, th = _start(tmp_path, core_limit=20, min_exec_cost_us=20000,
                           work_conserving=False)
    try:
        c = tclient.RuntimeClient(sock, tenant="tr")
        exe = c.compile(lambda a: a * 2.0, [np.ones(8, np.float32)])
        c.put(np.ones(8, np.float32), "x")
        ids = []
        for _ in range(30):
            c.execute_send_ids(exe.id, ["x"], ["y"])
            c.execute_recv()
            ids.append(c.last_trace_id)
        c.stats()  # waits until every dispatched execute is metered
        got = c.trace(tenant="tr")
        assert got["enabled"]
        spans = got["tenants"]["tr"]["spans"]
        assert len(spans) == 30
        for sp in spans:
            assert abs(sp["queue_us"] + sp["bucket_us"] + sp["device_us"]
                       - sp["total_us"]) <= 0.2, sp
        assert sum(sp["bucket_us"] > 0 for sp in spans) >= 5
        assert {sp.get("trace") for sp in spans} >= set(ids[1:])
        with_admin = _raw(sock + ".admin", {"kind": TP.TRACE,
                                            "tenant": "tr", "limit": 5})
        assert len(with_admin["tenants"]["tr"]["spans"]) == 5
        bind_free = _raw(sock, {"kind": TP.TRACE})
        assert bind_free["enabled"] and "tr" in bind_free["tenants"]
        dump = str(tmp_path / "chrome.json")
        assert tsmi.main(["trace", "tr", "--broker", sock, "--dump",
                          dump]) == 0
        with open(dump) as f:
            doc = json.load(f)
        assert any(e["ph"] == "X" and e["name"].endswith("/bucket")
                   for e in doc["traceEvents"])
        assert tsmi.main(["trace", "--broker", sock]) == 0
        assert tsmi.main(["trace"]) == 2
        assert tsmi.main(["leases", "--json"]) == 0
        assert tsmi.main(["leases"]) == 0
        c.close()
    finally:
        _stop(srv, th)


def test_leases_names_the_holder(tmp_path, capsys):
    sock, srv, th = _start(tmp_path)
    try:
        assert tsmi.main(["leases", "--json"]) == 0
        diag = json.loads(capsys.readouterr().out)[0]
        assert diag["present"] and diag["pid"] == os.getpid()
        assert "held" in diag["stage"]
    finally:
        _stop(srv, th)
    # A clean shutdown takes the sidecar away.
    assert tsmi.main(["leases"]) == 0
    assert "no chip-lease sidecar" in capsys.readouterr().out


def _raw(path, msg):
    import socket
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(20)
    try:
        s.connect(path)
        TP.send_msg(s, msg)
        return TP.recv_msg(s)
    finally:
        s.close()


def test_tracing_off_records_no_span_and_no_event(tmp_path, monkeypatch):
    """With tracing off TRACE answers enabled: false with no tenant, and
    the dispatcher asks the card for no timed event."""
    monkeypatch.delenv("VTPU_TRACE", raising=False)
    sock, srv, th = _start(tmp_path)
    timed = []
    real = tserver.ChipState.record

    def record(self, timing=False):
        timed.append(timing)
        return real(self, timing)
    monkeypatch.setattr(tserver.ChipState, "record", record)
    try:
        c = tclient.RuntimeClient(sock, tenant="off")
        exe = c.compile(lambda a: a - 1.0, [np.ones(2, np.float32)])
        h = c.put(np.ones(2, np.float32), "x")
        for _ in range(3):
            exe(h)
        assert c.trace() == {"enabled": False, "tenants": {}}
        c.close()
    finally:
        _stop(srv, th)
    assert timed and not any(timed)


def test_wedge_report_and_the_successors_record(tmp_path):
    """The watchdog's dying words name the other holder of the cards and
    are journaled; the next broker on that journal reports them."""
    holder = subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"])
    try:
        side = str(tmp_path / "lease.json")
        with open(side, "w") as f:
            json.dump({"pid": holder.pid, "cmdline": "holder",
                       "stage": "held"}, f)
        jr = tjournal.Journal(str(tmp_path / "j"))
        msg = tserver.wedge_report("cuda init (torch.cuda.init)", jr)
        assert f"pid {holder.pid} [LIVE]" in msg
        jr.close()
        state = tjournal.Journal(str(tmp_path / "j")).load_state()
        assert state["last_wedge"]["stage"] == "cuda init (torch.cuda.init)"
        os.unlink(side)
        srv = tserver.make_server(str(tmp_path / "b.sock"), 0, 0,
                                  device="cpu",
                                  journal_dir=str(tmp_path / "j"))
        try:
            assert srv.state.journal_stats()["last_wedge"]["diagnosis"] == \
                msg
        finally:
            srv.server_close()
    finally:
        holder.kill()
        holder.wait()


def test_claim_watchdog_exits_3_on_a_wedged_claim(tmp_path):
    """A claim step that never returns: the process exits 3 within the
    deadline and leaves a wedge record."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        from vtpu_torch.runtime import journal, server
        jr = journal.Journal({str(tmp_path / "j")!r})
        server.claim_watchdog("cuda init (torch.cuda.init)", jr)
        time.sleep(30)
    """)
    env = dict(os.environ, VTPU_CLAIM_WATCHDOG_S="0.5",
               VTPU_LEASE_SIDECAR=str(tmp_path / "lease.json"))
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-c", code], env=env, timeout=60,
                       capture_output=True, text=True)
    assert r.returncode == 3, r.stderr[-2000:]
    assert time.monotonic() - t0 < 25
    assert "wedged" in r.stderr
    st = tjournal.Journal(str(tmp_path / "j")).load_state()
    assert st["last_wedge"]["stage"] == "cuda init (torch.cuda.init)"


@pytest.mark.parametrize("args,want", [
    (["--suspend", "adm"], {"ok": True, "known": True}),
    (["--resume", "adm"], {"ok": True, "known": True}),
    (["--resize", "adm", "--hbm", "2Mi", "--core", "40"],
     {"ok": True, "tenant": "adm", "hbm": [2 << 20], "core": 40}),
    (["--drain"], {"ok": True, "tenants": 1, "snapshotted": False}),
    (["--broker-stats"], None),
    (["--shutdown"], {"ok": True})])
def test_vtpu_smi_admin_verbs(tmp_path, capsys, args, want):
    """Each 6(b) admin flag of vtpu-smi against the port's broker: the
    reply printed, exit 0; a flag without --broker is a usage error."""
    sock, srv, th = _start(tmp_path)
    try:
        c = tclient.RuntimeClient(sock, tenant="adm")
        assert tsmi.main(["--broker", sock, *args]) == 0
        got = json.loads(capsys.readouterr().out)
        if want is None:
            assert got["tenants"]["adm"]["arrays"] == 0
            assert got["journal"]["enabled"] is False
        else:
            assert got == want
        if args[0] == "--resize":
            row = c.stats()["adm"]
            assert (row["limit_bytes"], row["core_limit_pct"]) == \
                (2 << 20, 40)
        c.close()
        with pytest.raises(SystemExit):
            tsmi.main(args)
    finally:
        _stop(srv, th)
