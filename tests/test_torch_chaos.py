"""Crash recovery of the port's broker, with the broker as a real process
(``python -m vtpu_torch.runtime.server --device cpu``) and a journal.

- kill -9 and respawn under a port client: get() and stats() succeed with
  no exception, the ledger, the PUT arrays, the program and the cost EMA
  come back, a deleted id and a PUT id an output replaced stay gone;
- an execute in flight when the broker dies (SIGKILL, or the device-fault
  exit 3, both injected at dispatch with VTPU_FAULTS) surfaces as
  VtpuConnectionLost(resumed=True) and never runs twice;
- HANDOVER (vtpu-smi --handover) is zero-downtime for a serving tenant;
  DRAIN refuses new HELLOs with DRAINING;
- RESIZE is live, shrinks the cap, and survives a restart;
- degraded mode fails closed (a PUT past the last-granted cap raises
  VtpuQuotaError with the broker gone) and reattaches;
- serve_brokered across a kill -9 and an injected exit 3 gives the tokens
  of an uninterrupted run;
- vtpu's RuntimeClient resumes against the port's journaled broker through
  PUT, GET and STATS.

Each test runs under a SIGALRM deadline, and every broker it starts is
killed at its end."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from vtpu.runtime import client as jclient
from vtpu.shim import core as jcore
from vtpu_torch import entry
from vtpu_torch.ops import _build
from vtpu_torch.runtime import client as tclient
from vtpu_torch.runtime import protocol as TP
from vtpu_torch.runtime import server as tserver
from vtpu_torch.tools import vtpu_smi as tsmi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 150


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """A deadline per test; no quota env leaks into the clients' HELLOs;
    clients wait long enough for a broker's restart."""
    if jcore._lib is None:
        monkeypatch.setattr(jcore, "_SEARCH_PATHS", (
            _build.build_all(("vtpucore",))["vtpucore"],
            *jcore._SEARCH_PATHS))
    for k in list(os.environ):
        if k.startswith(("VTPU_DEVICE_", "VTPU_TASK", "VTPU_OVERSUB",
                         "VTPU_FAULTS", "VTPU_TRACE", "VTPU_JOURNAL")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("VTPU_LEASE_SIDECAR", str(tmp_path / "lease.json"))
    monkeypatch.setenv("VTPU_RPC_TIMEOUT_S", "60")
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "90")

    def expired(*_):
        raise TimeoutError(f"test ran past {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class Broker:
    """The port's broker as a process, journaled in ``tmp/j``; each
    ``start`` is a successor on the same socket and journal."""

    def __init__(self, tmp, args=()):
        self.tmp, self.args = tmp, list(args)
        self.sock = str(tmp / "b.sock")
        self.p = None
        self.n = 0
        self.closed = False
        self.watchers = []

    def start(self, faults=None):
        env = dict(os.environ, VTPU_JOURNAL_DIR=str(self.tmp / "j"),
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        if faults:
            env["VTPU_FAULTS"] = faults
        self.n += 1
        with open(self.tmp / f"broker{self.n}.err", "w") as err:
            self.p = subprocess.Popen(
                [sys.executable, "-m", "vtpu_torch.runtime.server",
                 "--socket", self.sock, "--device", "cpu", *self.args],
                env=env, stdout=subprocess.DEVNULL, stderr=err)
        deadline = time.monotonic() + 90
        while True:
            assert self.p.poll() is None, self.log()
            try:
                if raw(self.sock, {"kind": TP.STATS})["ok"]:
                    return self
            except OSError:
                pass
            assert time.monotonic() < deadline, self.log()
            time.sleep(0.02)

    def log(self):
        return (self.tmp / f"broker{self.n}.err").read_text()[-3000:]

    def kill(self):
        self.p.kill()
        self.p.wait()

    def stop(self):
        """Kill the running broker; a watcher's successor is not
        started after this, or is killed as it starts."""
        self.closed = True
        if self.p is not None and self.p.poll() is None:
            self.p.kill()
            self.p.wait()
        for th in self.watchers:
            th.join(60)
        if self.p is not None and self.p.poll() is None:
            self.p.kill()
            self.p.wait()

    def restart_when_dead(self):
        """Start a successor as soon as this one exits (as the daemon
        does); the thread's result is the exit code."""
        out = {}

        def watch():
            out["rc"] = self.p.wait()
            if not self.closed:
                self.start()
        th = threading.Thread(target=watch, daemon=True)
        th.start()
        self.watchers.append(th)
        return th, out


@pytest.fixture()
def broker(tmp_path):
    b = Broker(tmp_path)
    yield b
    b.stop()


def raw(path, msg):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10)
    try:
        s.connect(path)
        TP.send_msg(s, msg)
        return TP.recv_msg(s)
    finally:
        s.close()


def learned(c, name, n=4):
    """Run the program until the broker has learned (and journaled) its
    cost."""
    for _ in range(n):
        c.execute_send_ids("e0", ["x"], ["y"])
        c.execute_recv()
    deadline = time.monotonic() + 10
    while not c.stats()[name]["cost_ema_us"]:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    return c.stats()[name]


def test_kill9_resumes_with_state_intact(broker):
    broker.start()
    c = tclient.RuntimeClient(broker.sock, tenant="t", hbm_limit=10**6)
    x = np.arange(8, dtype=np.float32)
    c.put(x, "x")
    c.put(np.ones(4, np.float32), "gone")
    c.delete("gone")
    c.put(np.ones(8, np.float32), "rep")
    exe = c.compile(lambda v: v * 2.0, [x])
    assert exe.id == "e0"
    before = learned(c, "t")
    c.execute_send_ids(exe.id, ["x"], ["rep"])  # an output replaces a PUT
    c.execute_recv()
    before = c.stats()["t"]
    broker.kill()
    broker.start()
    # Before the tenant returns: parked with its ledger charged (the
    # port's STATS lists a parked tenant; vtpu's lists bound ones only).
    parked = raw(broker.sock, {"kind": TP.STATS})["tenants"]["t"]
    assert parked["recovered"] and parked["used_bytes"] == x.nbytes
    assert parked["cost_ema_us"] == before["cost_ema_us"]
    np.testing.assert_array_equal(c.get("x").numpy(), x)
    after = c.stats()["t"]
    assert after["used_bytes"] == x.nbytes
    assert after["limit_bytes"] == 10**6
    assert after["cost_ema_us"] == before["cost_ema_us"]
    assert after["executions"] == before["executions"]
    for gone in ("gone", "rep", "y"):
        with pytest.raises(tclient.RuntimeError_, match="NOT_FOUND"):
            c.get(gone)
    c.execute_send_ids(exe.id, ["x"], ["y"])
    c.execute_recv()
    np.testing.assert_array_equal(c.get("y").numpy(), x * 2)
    js = raw(broker.sock, {"kind": TP.STATS})["journal"]
    assert js["tenants_readopted"] == 1 and js["recoveries_total"] >= 1
    c.close()


@pytest.mark.parametrize("fault,rc", [("sigkill_broker", -9), ("exit3", 3)])
def test_execute_in_flight_surfaces_resumed(broker, fault, rc):
    """The broker dies while it dispatches the third execute: the client
    sees VtpuConnectionLost(resumed=True) for it, the execute ran once at
    most (never twice), and the successor serves on."""
    broker.start(faults=f"{fault}@dispatch:nth=3")
    c = tclient.RuntimeClient(broker.sock, tenant="f")
    c.put(np.ones(4, np.float32), "x")
    c.compile(lambda v: v + 1.0, [np.ones(4, np.float32)])
    for _ in range(2):
        c.execute_send_ids("e0", ["x"], ["y"])
        c.execute_recv()
    # STATS waits for the metering, which journals the count.
    assert c.stats()["f"]["executions"] == 2
    th, out = broker.restart_when_dead()
    c.execute_send_ids("e0", ["x"], ["y"])
    with pytest.raises(tclient.VtpuConnectionLost) as e:
        c.execute_recv()
    assert e.value.resumed
    th.join(90)
    assert out["rc"] == rc
    assert c.stats()["f"]["executions"] == 2
    c.execute_send_ids("e0", ["x"], ["y"])
    c.execute_recv()
    np.testing.assert_array_equal(c.get("y").numpy(), np.full(4, 2.0))
    c.close()


def test_handover_is_zero_downtime(broker):
    """A tenant serves through vtpu-smi --handover: the broker exits 0,
    the successor recovers the snapshot, and serve_brokered never raises;
    the successor holds the tenant's cost model."""
    broker.start()
    c = tclient.RuntimeClient(broker.sock, tenant="h")
    stop = threading.Event()
    got = {}

    def serve():
        try:
            got["out"] = entry.serve_brokered(
                c, "tiny", 2, 16, init="put", seed=1, chain=2, depth=2,
                seconds=60, on_chain=lambda n: got.__setitem__("n", n)
                or stop.is_set())
        except BaseException as e:  # noqa: BLE001 - reported below
            got["error"] = e
    th = threading.Thread(target=serve, daemon=True)
    th.start()
    while got.get("n", 0) < 4:
        assert th.is_alive(), got
        time.sleep(0.01)
    while not (ema := raw(broker.sock, {"kind": TP.STATS})["tenants"]["h"]
               ["cost_ema_us"]):
        assert th.is_alive(), got
        time.sleep(0.01)
    assert tsmi.main(["--broker", broker.sock, "--handover"]) == 0
    assert broker.p.wait(30) == 0
    broker.start()
    n0 = got["n"]
    while got.get("n", 0) < n0 + 4:
        assert th.is_alive(), got
        time.sleep(0.01)
    row = raw(broker.sock, {"kind": TP.STATS})["tenants"]["h"]
    stop.set()
    th.join(90)
    assert "error" not in got, got["error"]
    assert [r["resumed"] for r in got["out"]["resumes"]] == [True]
    assert set(row["cost_ema_us"]) == set(ema)
    c.close()


def test_drain_refuses_new_hellos(tmp_path):
    """DRAIN: a new HELLO is refused with DRAINING; the bound tenant
    serves on; the reply says the snapshot was committed."""
    sock = str(tmp_path / "d.sock")
    srv = tserver.make_server(sock, 0, 0, device="cpu",
                              journal_dir=str(tmp_path / "j"))
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.05})
    th.start()
    try:
        c = tclient.RuntimeClient(sock, tenant="a")
        c.put(np.ones(2, np.float32), "x")
        rep = raw(sock + ".admin", {"kind": TP.DRAIN})
        assert rep == {"ok": True, "tenants": 1, "snapshotted": True}
        with pytest.raises(tclient.RuntimeError_, match="DRAINING"):
            tclient.RuntimeClient(sock, tenant="b", reconnect_timeout=0)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(sock)
        TP.send_msg(s, {"kind": TP.HELLO, "tenant": "b"})
        assert TP.recv_msg(s)["code"] == "DRAINING"
        s.close()
        exe = c.compile(lambda v: v * 3.0, [np.ones(2, np.float32)])
        np.testing.assert_array_equal(exe(c.put(np.ones(2, np.float32)))[0]
                                      .fetch().numpy(), np.full(2, 3.0))
        assert c.stats()["a"]["arrays"] == 3
        assert srv.state.journal_stats()["draining"]
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(10)


def test_resize_is_live_and_survives_a_restart(broker, capsys):
    broker.start()
    c = tclient.RuntimeClient(broker.sock, tenant="r", hbm_limit=1000,
                              core_limit=0)
    c.put(np.ones(100, np.float32), "a")  # 400 B
    assert tsmi.main(["--broker", broker.sock, "--resize", "r", "--hbm",
                      "600", "--core", "30"]) == 0
    assert '"core": 30' in capsys.readouterr().out
    with pytest.raises(tclient.VtpuQuotaError):
        c.put(np.ones(75, np.float32), "b")  # 700 B > 600
    c.put(np.ones(50, np.float32), "b")  # 600 B
    row = c.stats()["r"]
    assert (row["limit_bytes"], row["core_limit_pct"]) == (600, 30)
    assert tsmi.main(["--broker", broker.sock, "--resize", "nobody",
                      "--core", "5"]) == 1
    broker.kill()
    broker.start()
    row = c.stats()["r"]
    assert (row["limit_bytes"], row["core_limit_pct"], row["used_bytes"]) \
        == (600, 30, 600)
    assert tsmi.main(["--broker", broker.sock, "--broker-stats"]) == 0
    assert '"r"' in capsys.readouterr().out
    c.close()


def test_degraded_mode_is_fail_closed_and_reattaches(broker, monkeypatch):
    """The broker gone past VTPU_BROKER_GRACE_S: calls fail fast with
    VtpuBrokerUnavailable, a PUT past the last-granted cap raises
    VtpuQuotaError, a compile queues; back, the client reattaches with its
    state and the queued compile registered."""
    monkeypatch.setenv("VTPU_BROKER_GRACE_S", "0.5")
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "0.5")
    broker.start()
    c = tclient.RuntimeClient(broker.sock, tenant="g", hbm_limit=1000)
    c.put(np.ones(150, np.float32), "x")  # 600 B of 1000
    broker.kill()
    with pytest.raises(tclient.VtpuBrokerUnavailable):
        c.stats()
    with pytest.raises(tclient.VtpuQuotaError, match="degraded"):
        c.put(np.ones(125, np.float32), "big")  # 500 B: past the cap
    with pytest.raises(tclient.VtpuBrokerUnavailable):
        c.put(np.ones(25, np.float32), "small")  # fits; still no broker
    exe = c.compile_blob(tclient.export_graph(lambda v: v.sum(),
                                              [np.ones(150, np.float32)]))
    broker.start()
    deadline = time.monotonic() + 20
    while True:
        try:
            row = c.stats()["g"]
            break
        except tclient.VtpuBrokerUnavailable:
            assert time.monotonic() < deadline
            time.sleep(0.05)
    assert row["used_bytes"] == 600
    assert float(exe(tclient.RemoteArray(c, "x", (150,), "float32"))[0]
                 .fetch()) == 150.0
    c.close()


def test_serve_brokered_across_kill_and_exit3(broker):
    """The tokens after 12 steps equal an uninterrupted run's, through a
    kill -9 after 4 steps and a successor that exits 3 at its second
    dispatch."""
    prompt = np.random.default_rng(0).integers(0, 256, (2, 16),
                                               dtype=np.int32)
    want = entry.serve("tiny", 2, 16, steps=12, device="cpu", seed=3,
                       prompt=prompt)["tokens"]
    broker.start()
    c = tclient.RuntimeClient(broker.sock, tenant="s")
    state = {}

    def on_chain(n):
        if n == 4 and not state:
            broker.kill()
            broker.start(faults="exit3@dispatch:nth=2")
            state["watch"] = broker.restart_when_dead()
    out = entry.serve_brokered(c, "tiny", 2, 16, steps=12, init="put",
                               seed=3, chain=4, depth=2, prompt=prompt,
                               on_chain=on_chain)
    th, res = state["watch"]
    th.join(90)
    assert res["rc"] == 3
    assert [r["at_step"] for r in out["resumes"]] == [4, 4]
    assert all(r["resumed"] for r in out["resumes"])
    assert torch.equal(out["tokens"], want)
    c.close()


def test_vtpu_client_resumes_against_the_port_broker(broker):
    """Wire parity: vtpu's RuntimeClient, journal-resumed by the port's
    broker, through PUT, GET and STATS with no exception."""
    broker.start()
    c = jclient.RuntimeClient(broker.sock, tenant="v", hbm_limit=10**6)
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    c.put(x, "x")
    c.put(np.ones(3, np.int32), "gone")
    c.delete("gone")
    broker.kill()
    broker.start()
    np.testing.assert_array_equal(c.get("x"), x)
    row = c.stats()["v"]
    assert row["used_bytes"] == x.nbytes and row["limit_bytes"] == 10**6
    c.put(np.ones(2, np.float32), "y")
    np.testing.assert_array_equal(c.get("y"), np.ones(2, np.float32))
    with pytest.raises(jclient.RuntimeError_, match="NOT_FOUND"):
        c.get("gone")
    c.close()
