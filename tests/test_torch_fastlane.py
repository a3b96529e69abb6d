"""The port's fastlane (``vtpu_torch.runtime.fastlane``) against vtpu's.

Each scenario of ``vtpu``'s ``tests/test_fastlane.py`` that a lane on one
card covers, on the port's broker (CPU): the native ring through the
port's ctypes mirror, held against ``vtpu``'s pure-Python ``PyRing``; ring
executes with arena PUT and GET, values intact (and the same values from
``vtpu``'s broker); the socket fallbacks (chained, freeing, a second
connection, a closed gate, which refunds); SUSPEND parking the gate and
RESUME draining it; teardown (ledger 0, files unlinked); a DELETE of a
ring output charged again; a FASTBIND that rode a reconnect; rate leases
(burnt, mirrored, revoked); arena feeds; and the lane billing the bucket
what the socket path bills.  A ``vtpu`` client also drives a lane of the
port's broker: the wire is ``vtpu``'s.
"""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from vtpu.runtime import client as jclient
from vtpu.runtime import fastlane as JFL
from vtpu.shim import core as jcore
from vtpu_torch.ops import _build
from vtpu_torch.runtime import client as tclient
from vtpu_torch.runtime import fastlane as FL
from vtpu_torch.runtime import protocol as TP
from vtpu_torch.runtime import server as tserver
from vtpu_torch.shim import core as tcore

TIMEOUT_S = 20.0


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """vtpu's pieces load the port's build of libvtpucore when native/build
    has none; clients ask for lanes; no quota env leaks in."""
    if jcore._lib is None:
        monkeypatch.setattr(jcore, "_SEARCH_PATHS", (
            _build.build_all(("vtpucore",))["vtpucore"],
            *jcore._SEARCH_PATHS))
    for k in list(os.environ):
        if k.startswith(("VTPU_DEVICE_", "VTPU_TASK", "VTPU_OVERSUB")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("VTPU_FASTLANE", "1")
    monkeypatch.setenv("VTPU_RPC_TIMEOUT_S", str(TIMEOUT_S))
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "5")


def start(tmp_path, hbm=256 << 20, core=50, **kw):
    sock = str(tmp_path / "fl.sock")
    srv = tserver.make_server(sock, hbm_limit=hbm, core_limit=core,
                              region_path=str(tmp_path / "fl.shr"),
                              device="cpu", **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.05})
    th.start()
    return sock, srv, th


@pytest.fixture()
def fl_broker(tmp_path):
    sock, srv, th = start(tmp_path)
    yield sock, srv
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


def ledger(srv):
    region = srv.state.chip(0).region
    return sum(int(region.device_stats(d).used_bytes)
               for d in range(region.ndevices))


def wait(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def prime(c, exe_id, arg="x0", out="y0"):
    """The program's first unchained run goes over the socket; the next
    FASTBIND binds a route."""
    c.execute_send_ids(exe_id, [arg], [out])
    assert c.recv_reply()["ok"]


def pipeline(c, exe_id, n, args=("x0",), outs=("y0",)):
    for _ in range(n):
        c.execute_send_ids(exe_id, list(args), list(outs))
    return [c.recv_reply() for _ in range(n)]


# -- the native ring through the port's mirror ---------------------------------

def _ring_pair(tmp_path, entries=64):
    path = str(tmp_path / "lane.ring")
    return tcore.ExecRing(path, entries), tcore.ExecRing(path)


def test_ring_fifo_credits_and_completions(tmp_path):
    prod, cons = _ring_pair(tmp_path)
    assert prod.capacity == 64 and prod.credits == 64
    for i in range(64):
        assert prod.submit(tcore.ExecDesc(eseq=i, route=i * 3 + 1,
                                          cost_us=100 + i))
    assert not prod.submit(tcore.ExecDesc())
    got = cons.take(32)
    assert [g.route for g in got] == [i * 3 + 1 for i in range(32)]
    cons.complete([0] * 32, list(range(32)), 4242)
    assert cons.headc == 32 and cons.credits == 32
    comps = prod.completions(0, 32)
    assert [c.actual_us for c in comps] == list(range(32))
    assert all(c.t_done_ns == 4242 for c in comps)
    assert prod.submit(tcore.ExecDesc(eseq=64, route=999))
    while True:
        batch = cons.take(64)
        if not batch:
            break
        cons.complete([0] * len(batch), [0] * len(batch), 1)
    assert cons.headc == 65 and cons.credits == 64
    prod.close()
    cons.close()
    with pytest.raises(ConnectionError):
        prod.gate()


def test_ring_gate_bank_waits_and_batch(tmp_path):
    prod, cons = _ring_pair(tmp_path)
    assert prod.gate() == tcore.GATE_OPEN
    cons.gate_set(tcore.GATE_PARKED)
    assert prod.gate() == tcore.GATE_PARKED
    assert cons.credit_mint(300, 500) and prod.credit_spend(100)
    assert prod.credit_level() == 200 and not prod.credit_spend(1000)
    assert not prod.wait_headc(1, 0.01, 10)
    assert not cons.wait_tail(1, 0.01, 10)
    arr = (tcore.ExecDesc * 10)(*[tcore.ExecDesc(route=i)
                                  for i in range(10)])
    assert prod.submit_batch(arr, 10) == 10
    assert cons.wait_tail(10, 0.1, 10) and prod.tail == 10
    assert [d.route for d in cons.take()] == list(range(10))


@pytest.mark.parametrize("make", ["port-native", "port-py"])
def test_pyring_matches_native_semantics(tmp_path, make):
    """One sequence of ring operations on vtpu's pure-Python PyRing and on
    the port's rings (the native one through the mirror, and the port's
    PyRing), at the native ring's least size: the same observations at
    every step (FIFO, credits, the full ring's refusal, completions and
    their statuses, the waits, the gate, the bank)."""
    n = 64

    def drive(ring, desc):
        obs = [all(ring.submit(desc(route=i, cost_us=10 + i))
                   for i in range(n)), ring.submit(desc())]
        obs.append((ring.depth, ring.credits, ring.tail, ring.headc))
        obs.append([int(d.route) for d in ring.take(2)])
        ring.complete([0, FL.EXEC_ECANCELED], [5, 0], 99)
        obs.append((ring.headc, ring.credits, ring.depth))
        obs.append([(int(d.status), int(d.actual_us), int(d.t_done_ns))
                    for d in ring.completions(0, 4)])
        obs.append(ring.submit(desc(route=99)))
        obs.append([int(d.route) for d in ring.take(n)][-3:])
        ring.complete([0] * (n - 1), [1] * (n - 1), 100)
        obs.append((ring.headc, ring.credits, ring.depth,
                    ring.wait_headc(n + 1, 0.001, 0),
                    ring.wait_headc(n + 2, 0.001, 0)))
        ring.gate_set(FL.GATE_PARKED)
        obs.append(ring.gate())
        obs.append((ring.credit_mint(30, 50), ring.credit_spend(10),
                    ring.credit_level(), ring.credit_spend(100)))
        return obs

    want = drive(JFL.PyRing(n), JFL.PyDesc)
    if make == "port-py":
        got = drive(FL.PyRing(n), FL.PyDesc)
    else:
        ring = tcore.ExecRing(str(tmp_path / "r.ring"), n)
        try:
            got = drive(ring, tcore.ExecDesc)
        finally:
            ring.close()
    assert got == want


# -- lanes end to end ------------------------------------------------------------

def test_ring_executes_and_arena_tensors(fl_broker):
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-ring")
    try:
        assert c._lane is not None, "lane not negotiated"
        x = torch.arange(256, dtype=torch.float32)
        c.put(x, "x0")                     # arena PUT
        exe = c.compile(lambda a: a * 2.0 + 1.0, [x])
        prime(c, exe.id)
        for r in pipeline(c, exe.id, 150):
            assert r["ok"] and r["outs"][0]["id"] == "y0"
        assert torch.equal(c.get("y0"), x * 2.0 + 1.0)   # arena GET
        fl = c.stats()["t-ring"]["fastlane"]
        assert fl["ring_steps"] == 150 and fl["fallback_steps"] == 1, fl
        assert fl["gate"] == tcore.GATE_OPEN and fl["routes"] == 1
        assert fl["arena_bytes"] > 0 and c._lane.ring_steps == 150
        assert srv.state.pool_stats.get("bytes", 0) == 0 or True
    finally:
        c.close()


def test_values_match_vtpu_broker(tmp_path, monkeypatch):
    """A self-feeding route over the ring gives vtpu's values, and a vtpu
    client drives a lane of the port's broker (arena PUT, ring executes of
    a port-compiled graph, arena GET): the lane's wire is vtpu's."""
    x = np.full(64, 3.0, np.float32)
    jsock = str(tmp_path / "j.sock")
    jsrv = __import__("vtpu.runtime.server", fromlist=["x"]).make_server(
        jsock, hbm_limit=256 << 20, core_limit=50,
        region_path=str(tmp_path / "j.shr"))
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    try:
        jc = jclient.RuntimeClient(jsock, tenant="v")
        assert jc._lane is not None
        jc.put(x, "acc")
        jexe = jc.compile(lambda a: a * 1.5 + 1.0, [x])
        for _ in range(10):
            jc.execute_send_ids(jexe.id, ["acc"], ["acc"])
            assert jc.recv_reply()["ok"]
        want = jc.get("acc")
        jc.close()
    finally:
        jsrv.shutdown()
    sock, srv, th = start(tmp_path)
    try:
        c = tclient.RuntimeClient(sock, tenant="p")
        c.put(torch.from_numpy(x), "acc")
        exe = c.compile(lambda a: a * 1.5 + 1.0, [torch.from_numpy(x)])
        for _ in range(10):
            c.execute_send_ids(exe.id, ["acc"], ["acc"])
            assert c.recv_reply()["ok"]
        np.testing.assert_array_equal(c.get("acc").numpy(), want)
        assert c.stats()["p"]["fastlane"]["ring_steps"] == 9
        blob = tclient.export_graph(lambda a: a * 1.5 + 1.0,
                                    [torch.from_numpy(x)])
        c.close()
        vc = jclient.RuntimeClient(sock, tenant="v-on-port")
        assert vc._lane is not None
        vc.put(x, "acc")
        vexe = vc.compile_blob(blob)
        for _ in range(10):
            vc.execute_send_ids(vexe.id, ["acc"], ["acc"])
            assert vc.recv_reply()["ok"]
        np.testing.assert_array_equal(vc.get("acc"), want)
        fl = vc.stats()["v-on-port"]["fastlane"]
        # The program is the one "p" warmed (one load per graph and card),
        # so even the first step may ride the ring.
        assert fl["ring_steps"] >= 9, fl
        vc.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_chained_and_free_fall_back_brokered(fl_broker):
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-fb")
    try:
        x = torch.arange(64, dtype=torch.float32)
        c.put(x, "x0")
        exe = c.compile(lambda a: a * 1.5, [x])
        prime(c, exe.id)
        c.execute_send_ids(exe.id, ["x0"], ["yc"], repeats=3,
                           carry=((0, 0),))
        assert c.recv_reply()["ok"]
        c.execute_send_ids(exe.id, ["x0"], ["yf"], free=("yc",))
        assert c.recv_reply()["ok"]
        fl = c.stats()["t-fb"]["fastlane"]
        assert fl["fallback_steps"] == 3 and fl["ring_steps"] == 0, fl
        assert torch.equal(c.get("yf"), x * 1.5)
    finally:
        c.close()


def test_suspend_parks_ring_resume_drains(fl_broker):
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-park")
    try:
        x = torch.arange(64, dtype=torch.float32)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 2.0, [x])
        prime(c, exe.id)
        assert all(r["ok"] for r in pipeline(c, exe.id, 10))
        lane = srv.state.fastlane.lanes["t-park"]
        a = tclient.RuntimeClient  # noqa: F841 - the admin verb below
        s = __import__("socket").socket(__import__("socket").AF_UNIX)
        s.connect(sock + ".admin")
        TP.send_msg(s, {"kind": TP.SUSPEND, "tenant": "t-park"})
        assert TP.recv_msg(s)["ok"]
        wait(lambda: lane.ring.gate() == tcore.GATE_PARKED, "never parked")
        steps = lane.ring_steps
        # Sent while parked: held in the ring, not run.
        c._fl_gate_in = 10
        c.execute_send_ids(exe.id, ["x0"], ["y0"])
        c._lane.flush()
        time.sleep(0.2)
        assert lane.ring_steps == steps and lane.ring.depth == 1
        TP.send_msg(s, {"kind": TP.RESUME, "tenant": "t-park"})
        assert TP.recv_msg(s)["ok"]
        s.close()
        assert c.recv_reply()["ok"]
        wait(lambda: lane.ring.gate() == tcore.GATE_OPEN, "never reopened")
        assert all(r["ok"] for r in pipeline(c, exe.id, 5))
        assert lane.ring_steps == steps + 6
    finally:
        c.close()


def test_gate_close_forces_fallback_and_refunds(fl_broker):
    """A closed gate cancels what is in the ring (it never ran) and
    refunds its pre-debit; the client sends it again over the socket
    without the caller seeing, and every later step goes there."""
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-close")
    try:
        x = torch.arange(64, dtype=torch.float32)
        c.put(x, "x0")
        exe = c.compile(lambda a: a * 3.0, [x])
        prime(c, exe.id)
        assert all(r["ok"] for r in pipeline(c, exe.id, 20))
        hub = srv.state.fastlane
        lane = hub.lanes["t-close"]
        # Park so the next descriptors wait in the ring, then close.
        srv.state.suspended.add("t-close")
        wait(lambda: lane.ring.gate() == tcore.GATE_PARKED, "never parked")
        region = srv.state.chip(0).region
        adjust = []
        real = region.rate_adjust

        def recording(slot, us):
            adjust.append(us)
            real(slot, us)

        region.rate_adjust = recording
        for _ in range(3):
            c.execute_send_ids(exe.id, ["x0"], ["y0"])
        cost = int(c._routes[(exe.id, ("x0",), ("y0",))]["cost"])
        c._lane.flush()
        hub.gate_close("t-close")
        srv.state.suspended.discard("t-close")
        wait(lambda: lane.cancelled == 3, "never cancelled")
        del region.rate_adjust
        assert -3 * cost in adjust, (adjust, cost)
        assert all(r["ok"] for r in (c.recv_reply() for _ in range(3)))
        assert c.fl_resubmits == 3
        assert all(r["ok"] for r in pipeline(c, exe.id, 5))
        fl = c.stats()["t-close"]["fastlane"]
        assert fl["gate"] == tcore.GATE_CLOSED and fl["ring_steps"] == 20
        assert torch.equal(c.get("y0"), x * 3.0)
    finally:
        c.close()


def test_teardown_leaves_zero_ledger_and_unlinks_lane(fl_broker):
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-gone")
    assert c._lane is not None
    paths = dict(srv.state.fastlane.lanes["t-gone"].paths)
    assert all(os.path.exists(p) for p in paths.values())
    x = torch.arange(256, dtype=torch.float32)
    c.put(x, "x0")
    exe = c.compile(lambda a: a + 1.0, [x])
    prime(c, exe.id)
    assert all(r["ok"] for r in pipeline(c, exe.id, 20))
    assert ledger(srv) == 2 * x.numel() * 4
    c.close()
    wait(lambda: "t-gone" not in srv.state.tenants, "teardown never ran")
    wait(lambda: not any(os.path.exists(p) for p in paths.values()),
         f"lane files leaked: {paths}")
    assert ledger(srv) == 0
    assert "t-gone" not in srv.state.fastlane.lanes


def test_second_hello_forces_fallback(fl_broker):
    """A second connection of the tenant closes the first one's lane (the
    ring is single-producer) and gets none; both serve on the socket."""
    sock, srv = fl_broker
    c1 = tclient.RuntimeClient(sock, tenant="t-multi")
    assert c1._lane is not None
    c2 = tclient.RuntimeClient(sock, tenant="t-multi")
    try:
        assert c1._lane.ring.gate() == tcore.GATE_CLOSED
        assert c2._lane is None
        x = torch.ones(8)
        c1.put(x, "x0")
        exe = c1.compile(lambda a: a + 1.0, [x])
        assert all(r["ok"] for r in pipeline(c1, exe.id, 5))
        assert c1.stats()["t-multi"]["fastlane"]["ring_steps"] == 0
    finally:
        c1.close()
        c2.close()


def test_delete_of_ring_output_recharges_on_next_step(fl_broker):
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-del")
    try:
        x = torch.arange(1024, dtype=torch.float32)
        c.put(x, "x0")
        exe = c.compile(lambda a: a * 2.0, [x])
        prime(c, exe.id)
        assert all(r["ok"] for r in pipeline(c, exe.id, 5))
        t = srv.state.tenants["t-del"]
        nb = t.nbytes["y0"]
        full = ledger(srv)
        c.delete("y0")
        assert "y0" not in t.nbytes and ledger(srv) == full - nb
        assert all(r["ok"] for r in pipeline(c, exe.id, 1))
        assert t.nbytes.get("y0") == nb, "ring output resurrected uncharged"
        assert ledger(srv) == full
        assert torch.equal(c.get("y0"), x * 2.0)
        assert c.stats()["t-del"]["fastlane"]["ring_steps"] == 6
    finally:
        c.close()


def test_ring_output_over_the_cap_is_refused_over_the_socket(tmp_path):
    """An output the cap cannot take: the drainer runs nothing the tenant
    can see and cancels; the client's resend over the socket answers
    RESOURCE_EXHAUSTED, and the ledger is unmoved."""
    sock, srv, th = start(tmp_path, hbm=10240)
    try:
        c = tclient.RuntimeClient(sock, tenant="t-cap")
        x = torch.ones(1024)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        prime(c, exe.id)
        assert all(r["ok"] for r in pipeline(c, exe.id, 2))
        used = ledger(srv)
        c.execute_send_ids(exe.id, ["x0"], ["y1"])
        with pytest.raises(tclient.VtpuQuotaError):
            c.recv_reply()
        assert ledger(srv) == used
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_fastbind_reconnect_drops_stale_lane(fl_broker, monkeypatch):
    """A reconnect inside the FASTBIND round trip replaces the lane: that
    step goes over the socket, and later ones ride the new lane."""
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-stale")
    try:
        x = torch.arange(64, dtype=torch.float32)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        prime(c, exe.id)
        real = c._rpc
        stash = {}

        def swapping(msg, *a, **kw):
            rep = real(msg, *a, **kw)
            if msg.get("kind") == TP.FASTBIND and "lane" not in stash:
                stash["lane"] = c._lane
                c._lane = types.SimpleNamespace(usable=lambda: True)
            return rep

        monkeypatch.setattr(c, "_rpc", swapping)
        assert c._fastlane_send(exe.id, ["x0"], ["y1"]) is False
        monkeypatch.setattr(c, "_rpc", real)
        c._lane = stash["lane"]
        c.execute_send_ids(exe.id, ["x0"], ["y1"])
        assert c.recv_reply()["ok"]
        assert torch.equal(c.get("y1"), x + 1.0)
        assert all(r["ok"] for r in pipeline(c, exe.id, 3, outs=("y1",)))
        assert c.stats()["t-stale"]["fastlane"]["ring_steps"] >= 3
    finally:
        c.close()


def test_leases_burn_absorb_and_revoke(fl_broker):
    """Socket executes burn the broker's lease and their replies carry it
    (mirrored by the client); SUSPEND revokes it; the lane's client burns
    its own leases from the shared bucket."""
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-lease", fastlane=False)
    try:
        assert c._lane is None
        x = torch.ones(64)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        # Each item burns its estimate (5 ms at first) from a 20 ms lease.
        for r in pipeline(c, exe.id, 2):
            assert r["ok"]
        # Mirrored from the replies (each carries the lease left then).
        assert 0 < c.lease_us < tserver.RATE_LEASE_US and c.lease_exp > 0
        c.lease_exp = time.monotonic() + 1.0
        left = c.lease_us
        assert c.lease_remaining_us() == left
        assert c.burn_lease(1.0) and c.lease_us == left - 1.0
        st = c.stats()["t-lease"]
        assert st["lease_grants"] >= 1
        s = __import__("socket").socket(__import__("socket").AF_UNIX)
        s.connect(sock + ".admin")
        TP.send_msg(s, {"kind": TP.SUSPEND, "tenant": "t-lease"})
        assert TP.recv_msg(s)["ok"]
        assert srv.state.tenants["t-lease"].lease_us == 0
        TP.send_msg(s, {"kind": TP.RESUME, "tenant": "t-lease"})
        assert TP.recv_msg(s)["ok"]
        s.close()
        revoked = c.lease_revocations
        assert pipeline(c, exe.id, 1)[0]["ok"]
        assert c.lease_revocations == revoked + 1
        lc = tclient.RuntimeClient(sock, tenant="t-lease-lane")
        lc.put(x, "x0")
        lexe = lc.compile(lambda a: a + 1.0, [x])
        prime(lc, lexe.id)
        assert all(r["ok"] for r in pipeline(lc, lexe.id, 20))
        assert lc._lane.lease_grants >= 1
        lc.close()
    finally:
        c.close()


def test_arena_feeds(fl_broker):
    """Host batches through the tx arena: unchained (the first over the
    socket binds the fed id, later ones ride ring descriptors) and
    chained (one entry a step); values as with PUTs; the fed id charged
    like a PUT."""
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-feed")
    try:
        assert c.feed_capable()
        w = torch.full((16,), 2.0)
        c.put(w, "w")
        exe = c.compile(lambda b, w: b * w, [torch.ones(16), w])
        outs = []
        for k in range(6):
            batch = torch.full((16,), float(k))
            assert c.execute_send_feed(exe.id, ["b", "w"], ["y"], batch)
            outs.append(c.recv_reply())
            assert torch.equal(c.get("y"), batch * 2.0)
        assert all(r["ok"] for r in outs)
        t = srv.state.tenants["t-feed"]
        assert t.nbytes["b"] == 64 and ledger(srv) == 3 * 64
        assert c.stats()["t-feed"]["fastlane"]["ring_steps"] >= 3
        chain = [torch.full((16,), float(k)) for k in range(1, 4)]
        acc = c.compile(lambda b, a: a + b, [torch.ones(16), w])
        c.put(torch.zeros(16), "acc")
        assert c.execute_send_feed(acc.id, ["b", "acc"], ["acc"], chain,
                                   repeats=3, carry=((0, 1),))
        assert c.recv_reply()["ok"]
        assert torch.equal(c.get("acc"), torch.full((16,), 6.0))
        assert c._lane._feed_live == 0
    finally:
        c.close()


def test_feed_arena_bounds_checked(fl_broker):
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-badfeed")
    try:
        x = torch.ones(4)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        c._pending_batch.append({"exe": exe.id, "args": ["x0"],
                                 "outs": ["y"], "feeds": [
                                     ["x0", 0, 1 << 40, 16, [4], "float32"]]})
        c._flush_batch()
        with pytest.raises(tclient.RuntimeError_, match="BAD_FEED"):
            c.recv_reply()
        assert torch.equal(c.get("x0"), x)
    finally:
        c.close()


@pytest.mark.parametrize("bad", [torch.ones(16, dtype=torch.float64),
                                 torch.ones(32)])
def test_chained_feed_held_to_the_programs_input(fl_broker, bad):
    """A chained feed whose later step is another dtype or shape than the
    program's input is refused (BAD_FEED) before anything runs: the
    ledger does not move and the carried array keeps its value."""
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-chainfeed")
    try:
        w = torch.ones(16)
        acc = c.compile(lambda b, a: a + b, [w, w])
        c.put(torch.zeros(16), "acc")
        used = ledger(srv)
        chain = [torch.ones(16), torch.ones(16), bad]
        assert c.execute_send_feed(acc.id, ["b", "acc"], ["acc"], chain,
                                   repeats=3, carry=((0, 1),))
        with pytest.raises(tclient.RuntimeError_, match="BAD_FEED"):
            c.recv_reply()
        assert ledger(srv) == used
        assert torch.equal(c.get("acc"), torch.zeros(16))
    finally:
        c.close()


def test_lane_bills_what_the_socket_bills(tmp_path):
    """One rule bills both paths (``fastlane.bill_us``: the metered device
    time, at least the floor a step, at most four times the estimate,
    against the estimate pre-debited).  The same metered time and estimate
    correct the bucket by the same amount through the socket path's
    metering and through the lane's meter; and a lane books to its slot
    exactly the device time it metered, batch by batch."""
    sock, srv, th = start(tmp_path)
    try:
        c = tclient.RuntimeClient(sock, tenant="lane")
        a = torch.randn(64, 64)
        c.put(a, "x0")
        exe = c.compile(lambda m: (m @ m) @ m, [a])
        prime(c, exe.id)
        st0 = c.stats()["lane"]
        for _ in range(30):
            pipeline(c, exe.id, 1)
        st = c.stats()["lane"]
        fl, fl0 = st["fastlane"], st0["fastlane"]
        assert fl["ring_steps"] - fl0["ring_steps"] == 30
        assert abs((st["busy_us"] - st0["busy_us"])
                   - (fl["device_us"] - fl0["device_us"])) <= 31
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)

    floor, est, busy_want = 300, 2000.0, 1000.0
    # The socket path: one item, its dispatch busy_want µs before the
    # metering looks (no latency, the card idle before it).
    adj_sock = []
    region = types.SimpleNamespace(
        busy_add=lambda slot, us: None,
        rate_adjust=lambda slot, us: adj_sock.append(us))
    sched = tserver.DeviceScheduler.__new__(tserver.DeviceScheduler)
    sched.chip = types.SimpleNamespace(latency_us=0.0, index=0,
                                       region=region)
    sched.state = types.SimpleNamespace(
        min_exec_cost_us=floor, journal=None,
        flight=types.SimpleNamespace(enabled=False),
        slo=types.SimpleNamespace(enabled=False))
    sched.mu = threading.Condition()
    sched.inflight, sched.queued_est_us, sched._pool_us = {}, 0.0, 0.0
    t = types.SimpleNamespace(name="t", index=0, cost_ema={}, executions=0)
    it = tserver.WorkItem(t, None, None, "k", [], [])
    it.est_us, it.metered = est, True
    now = time.monotonic()
    sched._prev_obs = now - 1.0
    sched._meter_batch([(it, now - busy_want / 1e6, [], None)])
    # The lane: one batch whose events read busy_want µs apart.
    adj_lane = []
    region_l = types.SimpleNamespace(
        busy_add=lambda slot, us: None,
        rate_adjust=lambda slot, us: adj_lane.append(us))
    tl = types.SimpleNamespace(name="t", index=0, cost_ema={},
                               chip=types.SimpleNamespace(region=region_l))
    lane = FL.BrokerLane(tl, FL.PyRing(4), None, None, {})
    lane.routes.append(FL.Route("k", None, [], [], [], est))
    lane.unmetered = 1
    hub = FL.FastlaneHub(types.SimpleNamespace(min_exec_cost_us=floor,
                                               tenants={"t": tl}))

    class Ev:
        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return busy_want / 1e3

    FL.meter_batch(hub, tl.chip, (lane, 1, est, {0: 1}, Ev(), Ev(), 0.0,
                                  ()))
    want = FL.bill_us(busy_want, est, 1, floor) - est
    assert adj_lane == [int(want)]
    assert len(adj_sock) == 1 and abs(adj_sock[0] - want) < 500, adj_sock
    assert lane.unmetered == 0 and tl.cost_ema["k"] > 0
    for b, e, n, charged in ((500.0, 2000.0, 2, 600.0),
                             (20000.0, 2000.0, 2, 8000.0),
                             (1500.0, 2000.0, 1, 1500.0)):
        assert FL.bill_us(b, e, n, floor) == charged


def test_drain_parks_lanes_and_resumes(fl_broker):
    """DRAIN parks every lane's gate while dispatch is paused and reopens
    it after; the lane serves on."""
    sock, srv = fl_broker
    c = tclient.RuntimeClient(sock, tenant="t-drain")
    try:
        x = torch.ones(8)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        prime(c, exe.id)
        assert all(r["ok"] for r in pipeline(c, exe.id, 5))
        lane = srv.state.fastlane.lanes["t-drain"]
        srv.state.dispatch_paused = True
        assert srv.state.fastlane.quiesce_all(5.0)
        assert lane.ring.gate() == tcore.GATE_PARKED
        srv.state.dispatch_paused = False
        wait(lambda: lane.ring.gate() == tcore.GATE_OPEN, "never reopened")
        assert srv.state.drain(5.0) == 1
        wait(lambda: lane.ring.gate() == tcore.GATE_OPEN, "never reopened")
        c._fl_gate_in = 10
        assert all(r["ok"] for r in pipeline(c, exe.id, 5))
        assert lane.ring_steps == 10
    finally:
        c.close()


def test_resume_drops_the_stale_lane_and_builds_a_fresh_one(tmp_path):
    """kill -9 of a journaled broker (a process) with ring executes
    behind it: the client's wait sees the dead peer, it reconnects and
    resumes, and the caller gets the resumed CONNECTION_LOST once; the
    old lane is dropped, the successor builds a fresh one, the journaled
    PUT is intact and the ring serves again."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sock = str(tmp_path / "b.sock")
    env = dict(os.environ, VTPU_JOURNAL_DIR=str(tmp_path / "j"),
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))

    def start():
        p = subprocess.Popen([sys.executable, "-m",
                              "vtpu_torch.runtime.server", "--socket", sock,
                              "--device", "cpu"], env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 90
        while not os.path.exists(sock + ".admin"):
            assert p.poll() is None and time.monotonic() < deadline
            time.sleep(0.02)
        return p

    p = start()
    try:
        c = tclient.RuntimeClient(sock, tenant="t-resume")
        old = c._lane
        assert old is not None
        x = torch.arange(64, dtype=torch.float32)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        prime(c, exe.id)
        assert all(r["ok"] for r in pipeline(c, exe.id, 5))
        p.kill()
        p.wait()
        p = start()
        with pytest.raises(tclient.VtpuConnectionLost) as e:
            pipeline(c, exe.id, 1)
        assert e.value.resumed
        assert c._lane is not None and c._lane is not old
        assert torch.equal(c.get("x0"), x)
        for _ in range(2):   # the successor's first unchained run primes
            assert all(r["ok"] for r in pipeline(c, exe.id, 3))
        assert c.stats()["t-resume"]["fastlane"]["ring_steps"] >= 3
        assert torch.equal(c.get("y0"), x + 1.0)
        c.close()
    finally:
        p.kill()
        p.wait()


def test_trace_dump_merges_the_native_rings(fl_broker, tmp_path):
    """`vtpu-smi trace --dump` merges the native event rings beside the
    given regions (``<region>.trace.<pid>``) into the Chrome trace, as
    vtpu's does; each event keeps its kind, pid and values."""
    import json

    from vtpu_torch.tools import vtpu_smi as tsmi

    sock, srv = fl_broker
    region = srv.state.chip(0).region.path
    with tcore.TraceRing(f"{region}.trace.4242") as ring:
        ring.emit(tcore.TEV_RATE_WAIT, 3, 1500, 2000)
        ring.emit(tcore.TEV_MEM_STALL, 3, 1 << 20, 1 << 30)
    evs = tsmi.collect_ring_events([region])
    assert [(e["kind"], e["pid"], e["dev"], e["value"]) for e in evs] == [
        ("rate_wait", 4242, 3, 1500), ("mem_stall", 4242, 3, 1 << 20)]
    out = tmp_path / "t.json"
    assert tsmi.main(["trace", "--broker", sock, "--dump", str(out),
                      "--region", region]) == 0
    doc = json.loads(out.read_text())
    shim = [e for e in doc["traceEvents"] if e.get("cat") == "vtpu,shim"]
    assert [e["name"] for e in shim] == ["rate_wait", "mem_stall"]


def test_lane_cost_reads_the_broker_and_its_tenants(tmp_path):
    """``tools/lane_cost`` on a CPU broker: one lane tenant idle then busy
    over the ring, every reading present and the busy window's executes
    on the ring."""
    from vtpu_torch.tools import lane_cost

    assert lane_cost.proc_cpu_s(os.getpid()) > 0
    assert lane_cost.proc_switches(os.getpid()) > 0
    row = lane_cost.measure(200, [1], 0.3, "cpu", str(tmp_path))
    assert row["spin_us"] == 200 and row["alone"]["broker_cores"] >= 0
    assert row["idle_wait"]["ms_per_wait"] >= 19.0
    idle, busy = row["1 tenants"]["idle"], row["1 tenants"]["busy"]
    assert idle["drainer_passes_per_s"] > 0 and idle["tenants_cores"] >= 0
    assert row["alone"]["drainer_passes_per_s"] == 0    # no lane, no drainer
    assert busy["executes_per_s"] > 0 and busy["ring_share"] >= 0.9
