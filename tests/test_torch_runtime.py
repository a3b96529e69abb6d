"""The port's broker (vtpu_torch.runtime.server and .client) against
vtpu's, both on the CPU, each in a thread of this process.

- Cross-wire: vtpu's RuntimeClient does HELLO, PUT, GET, DELETE and STATS
  against the port's broker, and the port's client against vtpu's.
- Mirrors of tests/test_runtime.py: each scenario runs on both brokers
  with its own client, the same numpy inputs and a JAX/torch pair of
  functions, and records what it saw: the ledgers (to the byte), the
  error codes, the values.  The two records must be equal.
- COMPILE unpickles nothing: with torch.load and pickle's loaders made to
  raise, a graph still compiles and runs; a torch.export.save archive, a
  pickle, a graph with a lifted constant or a parameter, an op outside the
  aten and vtpu_torch namespaces, and an op that returns unwritten memory,
  writes to an argument, skips bounds checks or places a tensor off the
  card are refused with INVALID_ARGUMENT, and the broker serves on; an
  output that is a view of an argument is copied.
- K1 as the registered op, and the slice as a whole: the tiny transformer
  on the flash path served through the port's broker with vtpu's weights
  (models.convert) against vtpu's greedy forward with the Pallas kernel in
  interpret mode.

vtpu's brokers load the region library from the port's build of the
unchanged source when native/build has none.  Every client has a socket
timeout (VTPU_RPC_TIMEOUT_S)."""

import dataclasses
import io
import os
import pickle
import socket as sk
import stat as statmod
import struct
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vtpu.models import transformer as jtr
from vtpu.runtime import client as jclient
from vtpu.runtime import protocol as JP
from vtpu.runtime import server as jserver
from vtpu.shim import core as jcore
from vtpu_torch import entry
from vtpu_torch.models import transformer as ttr
from vtpu_torch.ops import _build
from vtpu_torch.ops import flash_attention as tfa
from vtpu_torch.runtime import client as tclient
from vtpu_torch.runtime import protocol as TP
from vtpu_torch.runtime import server as tserver
from vtpu_torch.runtime import trace as ttrace

MB = 10**6
TIMEOUT_S = 20.0


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """vtpu's brokers load the port's build of libvtpucore when native/build
    has none; no quota env leaks into the clients' HELLOs; every client
    socket has a timeout."""
    if jcore._lib is None:
        monkeypatch.setattr(jcore, "_SEARCH_PATHS", (
            _build.build_all(("vtpucore",))["vtpucore"],
            *jcore._SEARCH_PATHS))
    for k in list(os.environ):
        if k.startswith(("VTPU_DEVICE_", "VTPU_TASK", "VTPU_OVERSUB")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("VTPU_RPC_TIMEOUT_S", str(TIMEOUT_S))
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "0")


class Side:
    """One broker implementation with its client and its functions."""

    def __init__(self, name):
        self.name = name
        self.server = jserver if name == "vtpu" else tserver
        self.P = JP if name == "vtpu" else TP
        self.client_mod = jclient if name == "vtpu" else tclient
        self.fns = {
            "matmul_add": lambda a, b: a @ b + 1.0,
            "double": lambda a: a * 2.0,
            "inc": lambda a: a + 1.0,
            "add": lambda a, b: a + b,
        }

    def start(self, tmp, hbm_limit=8 * MB, core_limit=0, **kw):
        sock = str(tmp / f"{self.name}.sock")
        extra = {} if self.name == "vtpu" else {"device": "cpu"}
        srv = self.server.make_server(sock, hbm_limit=hbm_limit,
                                      core_limit=core_limit,
                                      region_path=str(tmp / f"{self.name}"
                                                      ".shr"),
                                      **kw, **extra)
        th = threading.Thread(target=srv.serve_forever, daemon=True,
                              kwargs={"poll_interval": 0.05})
        th.start()
        self._running = (srv, th)
        return sock

    def stop(self):
        srv, th = self._running
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)

    def client(self, sock, **kw):
        return self.client_mod.RuntimeClient(sock, **kw)

    @staticmethod
    def np(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


SIDES = ("vtpu", "port")


def run_both(tmp_path, scenario, **server_kw):
    """``scenario(side, sock)`` on a fresh broker of each side; returns
    the two records, which the caller holds equal."""
    recs = {}
    for name in SIDES:
        side = Side(name)
        d = tmp_path / name
        d.mkdir()
        sock = side.start(d, **server_kw)
        try:
            recs[name] = scenario(side, sock)
        finally:
            side.stop()
    return recs["vtpu"], recs["port"]


def error_code(e):
    """The typed code of a refusal, as the clients report it."""
    if isinstance(e, MemoryError):
        return "QUOTA " + str(e).split(":")[0]
    return str(e).split(":")[0]


def admin(side, sock, msg):
    s = sk.socket(sk.AF_UNIX, sk.SOCK_STREAM)
    s.settimeout(TIMEOUT_S)
    try:
        s.connect(sock + ".admin")
        side.P.send_msg(s, msg)
        return side.P.recv_msg(s)
    finally:
        s.close()


def raw_conn(sock):
    s = sk.socket(sk.AF_UNIX, sk.SOCK_STREAM)
    s.settimeout(TIMEOUT_S)
    s.connect(sock)
    return s


def wait_gone(c, name):
    deadline = time.monotonic() + 10
    while name in c.stats():
        assert time.monotonic() < deadline, f"{name} never torn down"
        time.sleep(0.05)


# -- cross-wire ----------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(7)
    return {"f32": rng.standard_normal((3, 5), np.float32),
            "i32": rng.integers(-9, 9, (4, 7), dtype=np.int32),
            "bf16": rng.standard_normal((6, 2), np.float32).astype(
                ml_dtypes.bfloat16)}


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_vtpu_client_against_port_broker(tmp_path):
    side = Side("port")
    sock = side.start(tmp_path)
    try:
        c = jclient.RuntimeClient(sock, tenant="jt", hbm_limit=4 * MB)
        ids = {k: c.put(a, f"x.{k}").id for k, a in _arrays().items()}
        for k, a in _arrays().items():
            got = c.get(ids[k])
            assert got.dtype == a.dtype and got.tobytes() == a.tobytes()
        st = c.stats()["jt"]
        assert st["used_bytes"] == sum(a.nbytes for a in _arrays().values())
        assert st["limit_bytes"] == 4 * MB
        c.delete(ids["f32"])
        c.delete_many([ids["i32"], ids["bf16"]])
        assert c.stats()["jt"]["used_bytes"] == 0
        with pytest.raises(jclient.VtpuQuotaError):
            c.put(np.ones(2 * MB, np.float32))
        c.close()
    finally:
        side.stop()


def test_port_client_against_vtpu_broker(tmp_path):
    side = Side("vtpu")
    sock = side.start(tmp_path)
    try:
        c = tclient.RuntimeClient(sock, tenant="tt", hbm_limit=4 * MB)
        ids = {k: c.put(_as_torch(a), f"x.{k}").id
               for k, a in _arrays().items()}
        for k, a in _arrays().items():
            got = c.get(ids[k])
            assert torch.equal(got, _as_torch(a))
        st = c.stats()["tt"]
        assert st["used_bytes"] == sum(a.nbytes for a in _arrays().values())
        assert st["limit_bytes"] == 4 * MB
        c.delete(ids["f32"])
        c.delete_many([ids["i32"], ids["bf16"]])
        assert c.stats()["tt"]["used_bytes"] == 0
        with pytest.raises(tclient.VtpuQuotaError):
            c.put(torch.ones(2 * MB))
        c.close()
    finally:
        side.stop()


# -- mirrors of tests/test_runtime.py ----------------------------------------

def test_put_get_roundtrip(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="t1")
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        h = c.put(x)
        got = side.np(h.fetch())
        np.testing.assert_array_equal(got, x)
        used = c.stats()["t1"]["used_bytes"]
        h.delete()
        rec = (used, c.stats()["t1"]["used_bytes"], got.tolist())
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t and j[0] == 48


def test_remote_compile_execute(tmp_path):
    a = np.random.default_rng(0).random((8, 16), np.float32)
    b = np.random.default_rng(1).random((16, 4), np.float32)

    def scenario(side, sock):
        c = side.client(sock, tenant="t1")
        got = side.np(c.remote_jit(side.fns["matmul_add"])(a, b))
        np.testing.assert_allclose(got, a @ b + 1.0, rtol=1e-5)
        rec = (got.shape, c.stats()["t1"]["used_bytes"])
        c.close()
        return rec, got

    (jrec, jgot), (trec, tgot) = run_both(tmp_path, scenario)
    assert jrec == trec
    np.testing.assert_allclose(tgot, jgot, rtol=1e-6)


def test_hbm_quota_oom_and_isolation(tmp_path):
    def scenario(side, sock):
        c1 = side.client(sock, tenant="alpha")
        c2 = side.client(sock, tenant="beta")
        h = c1.put(np.ones(6 * MB // 4, np.float32))
        with pytest.raises(MemoryError) as ei:
            c1.put(np.ones(4 * MB // 4, np.float32))
        code = error_code(ei.value)
        h2 = c2.put(np.ones(6 * MB // 4, np.float32))
        head = side.np(h2.fetch())[:3].tolist()
        h.delete()
        c1.put(np.ones(4 * MB // 4, np.float32))
        st = c1.stats()
        rec = (code, head, st["alpha"]["used_bytes"], st["beta"]["used_bytes"],
               st["alpha"]["limit_bytes"])
        c1.close()
        c2.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ("QUOTA RESOURCE_EXHAUSTED", [1, 1, 1], 4 * MB, 6 * MB,
                      8 * MB)


def test_execute_outputs_accounted(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="t1")
        exe = c.compile(side.fns["double"], [np.ones((256, 256), np.float32)])
        h = c.put(np.ones((256, 256), np.float32))
        outs = exe(h)
        used = c.stats()["t1"]["used_bytes"]
        outs[0].delete()
        h.delete()
        rec = (used, c.stats()["t1"]["used_bytes"], len(outs))
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == (2 * 256 * 256 * 4, 0, 1)


def test_disconnect_frees_tenant_memory(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="gone")
        c.put(np.ones(MB // 4, np.float32))
        c.close()
        c2 = side.client(sock, tenant="watcher")
        wait_gone(c2, "gone")
        rec = sorted(c2.stats())
        c2.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ["watcher"]


def test_tenant_slots_recycle(tmp_path):
    def scenario(side, sock):
        watcher = side.client(sock, tenant="watcher")
        for i in range(40):
            c = side.client(sock, tenant=f"ephemeral-{i}")
            c.put(np.ones(4, np.float32))
            c.close()
            wait_gone(watcher, f"ephemeral-{i}")
        c = side.client(sock, tenant="final")
        rec = (c.tenant_index, sorted(c.stats()))
        c.close()
        watcher.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t and j[0] < 16


def test_shared_tenant_survives_one_disconnect(tmp_path):
    def scenario(side, sock):
        a = side.client(sock, tenant="shared")
        b = side.client(sock, tenant="shared")
        h = a.put(np.arange(4, dtype=np.float32))
        a.close()
        time.sleep(0.3)
        rec = (side.np(b.get(h.id)).tolist(),
               b.stats()["shared"]["used_bytes"])
        b.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ([0, 1, 2, 3], 16)


def test_chained_execute(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="chain")
        exe = c.compile(side.fns["add"], [np.zeros(4, np.float32),
                                          np.ones(4, np.float32)])
        c.put(np.zeros(4, np.float32), "acc")
        c.put(np.ones(4, np.float32), "one")
        c.execute_send_ids(exe.id, ["acc", "one"], ["acc"], repeats=7)
        outs = c.execute_recv()
        rec = (side.np(outs[0].fetch()).tolist(),
               c.stats()["chain"]["executions"],
               c.stats()["chain"]["used_bytes"])
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ([7, 7, 7, 7], 7, 32)


def test_chained_execute_pipelined(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="chain2")
        exe = c.compile(side.fns["double"], [np.ones(2, np.float32)])
        c.put(np.ones(2, np.float32), "x0")
        cur, nxt = "x0", "x1"
        for _ in range(4):
            c.execute_send_ids(exe.id, [cur], [nxt], repeats=3)
            cur, nxt = nxt, cur
        for _ in range(4):
            c.execute_recv()
        rec = (side.np(c.get(cur)).tolist(),
               c.stats()["chain2"]["executions"])
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ([4096.0, 4096.0], 12)


def test_bad_carry_rejected(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="badcarry")
        exe = c.compile(side.fns["inc"], [np.ones(2, np.float32)])
        c.put(np.ones(2, np.float32), "x")
        c.execute_send_ids(exe.id, ["x"], ["y"], repeats=3, carry=((0, 5),))
        with pytest.raises(Exception) as ei:
            c.execute_recv()
        code = error_code(ei.value)
        # The session serves on.
        c.execute_send_ids(exe.id, ["x"], ["y"])
        c.execute_recv()
        rec = (code, side.np(c.get("y")).tolist())
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ("BAD_CARRY", [2, 2])


def test_missing_argument_fails_its_execute(tmp_path):
    """test_async_error_surfaces_on_next_sync's dispatch-time half."""
    def scenario(side, sock):
        c = side.client(sock, tenant="poison")
        exe = c.compile(side.fns["inc"], [np.ones(2, np.float32)])
        c.execute_send_ids(exe.id, ["missing"], ["y"])
        with pytest.raises(Exception) as ei:
            c.execute_recv()
        rec = [error_code(ei.value), c.stats()["poison"]["used_bytes"]]
        c.put(np.ones(2, np.float32), "x")
        c.execute_send_ids(exe.id, ["x"], ["y"])
        c.execute_recv()
        rec.append(side.np(c.get("y")).tolist())
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ["NOT_FOUND", 0, [2, 2]]


def test_per_grant_quotas(tmp_path):
    def scenario(side, sock):
        small = side.client(sock, tenant="small", hbm_limit=1 * MB)
        big = side.client(sock, tenant="big", hbm_limit=40 * MB)
        with pytest.raises(MemoryError) as ei:
            small.put(np.ones(2 * MB // 4, np.float32))
        big.put(np.ones(20 * MB // 4, np.float32))
        st = big.stats()
        rec = (error_code(ei.value), st["small"]["limit_bytes"],
               st["big"]["limit_bytes"], st["big"]["used_bytes"],
               st["small"]["used_bytes"])
        small.close()
        big.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ("QUOTA RESOURCE_EXHAUSTED", MB, 40 * MB, 20 * MB, 0)


def test_priority_zero_borrows(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="vip", priority=0)
        exe = c.compile(side.fns["inc"], [np.ones(4, np.float32)])
        h = c.put(np.ones(4, np.float32))
        for _ in range(30):
            exe(h)
        t0 = time.monotonic()
        for _ in range(10):
            exe(h)
        elapsed = time.monotonic() - t0
        assert elapsed < 1.0, f"{side.name}: priority 0 throttled"
        rec = (c.stats()["vip"]["executions"] >= 30,
               c.stats()["vip"]["core_limit_pct"])
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario, hbm_limit=0, core_limit=10,
                    min_exec_cost_us=10_000)
    assert j == t == (True, 10)


def test_execute_throttling(tmp_path):
    def scenario(side, sock):
        c = side.client(sock, tenant="slow")
        exe = c.compile(side.fns["inc"], [np.ones(4, np.float32)])
        h = c.put(np.ones(4, np.float32))
        for _ in range(50):     # drain the 400 ms burst at 10 ms a charge
            exe(h)
        t0 = time.monotonic()
        for _ in range(10):     # 100 ms charged at 25% -> about 0.4 s
            exe(h)
        elapsed = time.monotonic() - t0
        assert elapsed > 0.3, f"{side.name}: no throttle: {elapsed:.3f}"
        rec = c.stats()["slow"]["core_limit_pct"]
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario, hbm_limit=0, core_limit=25,
                    min_exec_cost_us=10_000, work_conserving=False)
    assert j == t == 25


def test_tenant_socket_rejects_admin_verbs(tmp_path):
    def scenario(side, sock):
        s = raw_conn(sock)
        side.P.send_msg(s, {"kind": side.P.HELLO, "tenant": "sneaky",
                            "priority": 1})
        ok = side.P.recv_msg(s)["ok"]
        side.P.send_msg(s, {"kind": side.P.SUSPEND, "tenant": "other"})
        resp = side.P.recv_msg(s)
        s.close()
        return ok, resp["ok"], resp["code"]

    j, t = run_both(tmp_path, scenario)
    assert j == t == (True, False, "BAD_KIND")


def test_admin_suspend_resume(tmp_path):
    def scenario(side, sock):
        P = side.P
        victim = side.client(sock, tenant="victim")
        bystander = side.client(sock, tenant="bystander")
        exe_v = victim.compile(side.fns["inc"], [np.ones(4, np.float32)])
        exe_b = bystander.compile(side.fns["double"],
                                  [np.ones(4, np.float32)])
        hv = victim.put(np.ones(4, np.float32))
        hb = bystander.put(np.ones(4, np.float32))
        exe_v(hv)
        exe_b(hb)
        rec = [admin(side, sock, {"kind": P.SUSPEND, "tenant": "victim"}),
               admin(side, sock, {"kind": P.SUSPEND, "tenant": "victlm"})]
        admin(side, sock, {"kind": P.RESUME, "tenant": "victlm"})
        for _ in range(3):
            victim.execute_send_ids(exe_v.id, [hv.id], ["vs0"])
        time.sleep(0.5)
        st = admin(side, sock, {"kind": P.STATS})
        held = st["tenants"]["victim"]["executions"]
        rec.append(st["tenants"]["victim"]["suspended"])
        rec.append(side.np(exe_b(hb)[0].fetch()).tolist())
        time.sleep(0.3)
        st2 = admin(side, sock, {"kind": P.STATS})
        rec.append(st2["tenants"]["victim"]["executions"] == held)
        rec.append(st2["suspended"])
        rec.append(admin(side, sock, {"kind": P.RESUME,
                                      "tenant": "victim"})["ok"])
        for _ in range(3):
            victim.execute_recv()
        rec.append(side.np(victim.get("vs0")).tolist())
        deadline = time.monotonic() + 10
        while admin(side, sock, {"kind": P.STATS})["tenants"]["victim"][
                "executions"] <= held:
            assert time.monotonic() < deadline, "resumed work never metered"
            time.sleep(0.05)
        rec.append(admin(side, sock, {"kind": P.STATS})["tenants"]["victim"][
            "suspended"])
        victim.close()
        bystander.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t
    assert j[:2] == [{"ok": True, "known": True}, {"ok": True, "known": False}]
    assert j[2:] == [True, [2, 2, 2, 2], True, ["victim"], True, [2, 2, 2, 2],
                     False]


def test_malformed_frames_do_not_kill_broker(tmp_path):
    def scenario(side, sock):
        P = side.P
        good = side.client(sock, tenant="good")
        h = good.put(np.ones(4, np.float32))
        for junk in (struct.pack("<I", 5) + b"\xff\xfe\xfd\xfc\xfb",
                     struct.pack("<I", (1 << 30) + 1),
                     struct.pack("<I", 100) + b"abc"):
            s = raw_conn(sock)
            s.sendall(junk)
            s.close()
        s = raw_conn(sock)
        rec = []
        P.send_msg(s, {"kind": "nope"})
        rec.append(P.recv_msg(s).get("code"))
        P.send_msg(s, {"kind": "hello", "tenant": "fuzz", "priority": "x"})
        rec.append(P.recv_msg(s)["ok"])
        P.send_msg(s, {"kind": "hello", "tenant": "fuzz"})
        rec.append(P.recv_msg(s)["ok"])
        P.send_msg(s, {"kind": "put", "id": "x", "shape": [99999999],
                       "dtype": "float32", "data": b"12"})
        rec.append(P.recv_msg(s)["ok"])
        s.close()
        s = raw_conn(sock)
        P.send_msg(s, {"kind": "hello", "tenant": "fuzz-post"})
        rec.append(P.recv_msg(s)["ok"])
        P.send_msg(s, {"kind": "put", "id": "y", "shape": [4],
                       "dtype": "float32",
                       "data": np.ones(4, np.float32).tobytes()})
        rec.append(P.recv_msg(s)["ok"])
        s.sendall(struct.pack("<I", 5) + b"\xff\xfe\xfd\xfc\xfb")
        s.close()
        wait_gone(good, "fuzz-post")
        wait_gone(good, "fuzz")
        rec.append(side.np(good.get(h.id)).tolist())
        rec.append(sorted(good.stats()))
        good.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ["NO_HELLO", False, True, False, True, True,
                      [1, 1, 1, 1], ["good"]]


def test_second_hello_rejected(tmp_path):
    def scenario(side, sock):
        P = side.P
        s = raw_conn(sock)
        P.send_msg(s, {"kind": P.HELLO, "tenant": "rebind"})
        rec = [P.recv_msg(s)["ok"]]
        P.send_msg(s, {"kind": P.HELLO, "tenant": "rebind-two"})
        resp = P.recv_msg(s)
        rec += [resp["ok"], resp["code"]]
        s.close()
        watcher = side.client(sock, tenant="w")
        wait_gone(watcher, "rebind")
        rec.append(sorted(watcher.stats()))
        watcher.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == [True, False, "ALREADY_BOUND", ["w"]]


def test_chunked_put_get_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(JP, "CHUNK_BYTES", 4096)
    monkeypatch.setattr(TP, "CHUNK_BYTES", 4096)
    x = np.random.default_rng(2).random((300, 300), np.float32)

    def scenario(side, sock):
        c = side.client(sock, tenant="big")
        h = c.put(x)
        np.testing.assert_array_equal(side.np(h.fetch()), x)
        with pytest.raises(MemoryError) as ei:
            c.put(np.ones(4 * MB, np.float32))
        exe = c.compile(side.fns["double"], [x])
        got = side.np(exe(h)[0].fetch())
        np.testing.assert_allclose(got, x * 2.0, rtol=1e-6)
        rec = (error_code(ei.value), c.stats()["big"]["used_bytes"])
        c.close()
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ("QUOTA RESOURCE_EXHAUSTED", 2 * x.nbytes)


def test_admin_socket_hardened(tmp_path):
    def scenario(side, sock):
        P = side.P
        path = sock + ".admin"
        rec = [oct(statmod.S_IMODE(os.stat(path).st_mode))]
        s = raw_conn(path)
        P.send_msg(s, {"kind": P.STATS})
        rec.append(P.recv_msg(s)["ok"])
        s.close()
        cls = side.server.AdminSession
        orig = cls.__dict__["_allowed_uids"]
        cls._allowed_uids = staticmethod(lambda: {2**31 - 5})
        try:
            s2 = raw_conn(path)
            resp = P.recv_msg(s2)
            rec += [resp["ok"], resp["code"]]
            with pytest.raises((ConnectionError, P.ProtocolError, OSError)):
                P.send_msg(s2, {"kind": P.STATS})
                P.recv_msg(s2)
            s2.close()
        finally:
            cls._allowed_uids = orig
        return rec

    j, t = run_both(tmp_path, scenario)
    assert j == t == ["0o700", True, False, "PERMISSION_DENIED"]


# -- the port's own: deferred verbs and knobs, metering, defaults --------------

@pytest.fixture()
def port(tmp_path):
    side = Side("port")
    sock = side.start(tmp_path)
    yield sock
    side.stop()


@pytest.mark.parametrize("verb,item", [
    ("fastbind", "6(c)"), ("migrate_out", "6(d)"), ("migrate_in", "6(d)"),
    ("migrate", "6(d)"), ("repl_sync", "6(d)")])
def test_deferred_verbs_refused_with_their_item(port, verb, item):
    """On the socket that serves the verb in vtpu: a typed refusal that
    names the ROADMAP sub-item (6(d)(ii) for migration); the connection
    serves on.  FASTBIND (6(c)) and REPL_SYNC (6(d)(i)) are served now."""
    on_tenant = verb in TP.TENANT_VERBS
    s = raw_conn(port if on_tenant else port + ".admin")
    try:
        if on_tenant:
            TP.send_msg(s, {"kind": TP.HELLO, "tenant": "d"})
            assert TP.recv_msg(s)["ok"]
        TP.send_msg(s, {"kind": verb, "tenant": "d", "exe": "e", "args": []})
        resp = TP.recv_msg(s)
        if verb == TP.FASTBIND:
            # Ported with 6(c): a tenant without a lane gets vtpu's typed
            # refusal.
            assert resp["code"] == "FASTLANE_OFF"
        elif verb == TP.REPL_SYNC:
            # Ported with 6(d)(i): a broker without a journal has nothing
            # to stream, vtpu's typed answer, and ends the would-be stream
            # as vtpu does; the status probe answers on a new connection.
            assert resp["code"] == "NO_JOURNAL"
            s.close()
            s = raw_conn(port + ".admin")
            TP.send_msg(s, {"kind": verb, "status": True})
            assert TP.recv_msg(s)["replication"]["role"] == "primary"
        else:
            assert resp["code"] == "UNIMPLEMENTED" and \
                f"item {item}(ii)" in resp["error"]
        TP.send_msg(s, {"kind": TP.STATS})
        assert TP.recv_msg(s)["ok"]
    finally:
        s.close()


def test_trace_and_slo_answer_disabled(port, tmp_path, monkeypatch):
    """Bind-free on the tenant socket and on the admin socket: TRACE
    answers disabled with tracing off; SLO answers enabled (the plane's
    default) with no row for an unbound probe that names no tenant, and
    with VTPU_SLO=0 answers disabled, each as vtpu's plane does."""
    from vtpu.runtime import slo as jslo
    for path in (port, port + ".admin"):
        s = raw_conn(path)
        try:
            TP.send_msg(s, {"kind": TP.TRACE})
            assert TP.recv_msg(s) == {"ok": True, "enabled": False,
                                      "tenants": {}}
            TP.send_msg(s, {"kind": TP.SLO})
            resp = TP.recv_msg(s)
            assert resp["ok"] and resp["enabled"] and resp["tenants"] == {}
            if path.endswith(".admin"):
                assert resp["matrix"] == {} and \
                    resp["fairness"]["tenants"] == {}
        finally:
            s.close()
    monkeypatch.setenv("VTPU_SLO", "0")
    srv = tserver.make_server(str(tmp_path / "off.sock"), 0, 0,
                              device="cpu")
    try:
        for admin in (False, True):
            want = jslo.SloPlane(enabled=False).report(admin=admin)
            want["ok"] = True
            assert srv.state.slo_report(admin=admin) == want
            assert want["enabled"] is False and want["tenants"] == {}
    finally:
        srv.server_close()


@pytest.mark.parametrize("key,value,item", [
    ("VTPU_FASTLANE", "1", "6(c)"),
    ("VTPU_SLO", "1", "6(d)")])
def test_deferred_env_refused(tmp_path, monkeypatch, key, value, item):
    monkeypatch.setenv(key, value)
    # Both are ported now (6(c), 6(d)(i)): the broker serves lanes and
    # runs the SLO plane.
    srv = tserver.make_server(str(tmp_path / "x.sock"), 0, 0, device="cpu")
    try:
        if key == "VTPU_FASTLANE":
            assert srv.state.fastlane.serve
        else:
            assert srv.state.slo.enabled
    finally:
        srv.server_close()


def test_cluster_flag_refused(capsys):
    with pytest.raises(SystemExit):
        tserver.main(["--socket", "/nonexistent/x.sock", "--device", "cpu",
                      "--cluster", "/x"])
    assert "6(d)(ii)" in capsys.readouterr().err


def test_defaults_need_a_card(tmp_path):
    """make_server and main run on the card unless asked for the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserver.make_server(str(tmp_path / "a.sock"), 0, 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tserver.main(["--socket", str(tmp_path / "b.sock")])


def test_stats_book_device_time_and_bind_free(port):
    """A bind-free STATS names every tenant; each row books its metered
    device time (busy_us) and counts steps."""
    c = tclient.RuntimeClient(port, tenant="m")
    exe = c.compile(lambda a: a + 1.0, [np.ones(4, np.float32)])
    h = c.put(np.ones(4, np.float32))
    for _ in range(5):
        exe(h)
    row = c.stats()["m"]
    assert row["executions"] == 5 and row["busy_us"] > 0
    s = raw_conn(port)
    try:
        TP.send_msg(s, {"kind": TP.STATS})
        assert "m" in TP.recv_msg(s)["tenants"]
    finally:
        s.close()
    c.close()


def test_admin_shutdown(tmp_path):
    """SHUTDOWN on the admin socket stops the broker gracefully."""
    side = Side("port")
    sock = side.start(tmp_path)
    c = tclient.RuntimeClient(sock, tenant="bye")
    c.put(np.ones(4, np.float32))
    assert admin(side, sock, {"kind": TP.SHUTDOWN}) == {"ok": True}
    srv, th = side._running
    th.join(timeout=10)
    assert not th.is_alive(), "serve_forever did not stop"
    srv.server_close()
    c.close()


def test_pipelined_puts_pair_with_their_acks(port):
    """put_send leaves its ack on the wire (put_parts of them, one on the
    raw framing): a pipelined feed, sends and receives paired FIFO."""
    c = tclient.RuntimeClient(port, tenant="feed")
    exe = c.compile(lambda a: a * 2.0, [np.ones(3, np.float32)])
    acks = 0
    for i in range(3):
        acks += c.put_send(torch.full((3,), float(i)), "x")
        assert acks == (i + 1) * c.put_parts(torch.ones(3))
        c.execute_send_ids(exe.id, ["x"], [f"y{i}"])
    for _ in range(acks):
        assert c.recv_reply()["nbytes"] == 12
        c.execute_recv()
    assert [c.get(f"y{i}").tolist() for i in range(3)] == [
        [0.0] * 3, [2.0] * 3, [4.0] * 3]
    c.close()


def test_outputs_admitted_before_the_run(port):
    """A program whose outputs do not fit the cap is refused before it
    runs: RESOURCE_EXHAUSTED, and the ledger does not move."""
    c = tclient.RuntimeClient(port, tenant="o", hbm_limit=3 * MB)
    exe = c.compile(lambda a: (a * 2.0, a * 3.0),
                    [np.ones(MB // 4, np.float32)])
    h = c.put(np.ones(MB // 4, np.float32))
    exe(h)                       # 2 MB of outputs: the ledger at the cap
    before = c.stats()["o"]["used_bytes"]
    assert before == 3 * MB
    with pytest.raises(tclient.VtpuQuotaError, match="RESOURCE_EXHAUSTED"):
        exe(h)
    assert c.stats()["o"]["used_bytes"] == before
    c.close()


class _Region:
    """What the metering touches of a card's region."""

    def __init__(self):
        self.busy = []
        self.adjust = []

    def busy_add(self, slot, us):
        self.busy.append(us)

    def rate_adjust(self, slot, us):
        self.adjust.append(us)


def _meter(batch_spec, prev_obs_ago, latency_us=1000.0):
    """Run DeviceScheduler._meter_batch over items of the given
    (estimate µs, dispatched s ago) with a stand-in card and tenant;
    returns the µs booked to each item and the tenant."""
    sched = tserver.DeviceScheduler.__new__(tserver.DeviceScheduler)
    region = _Region()
    sched.chip = type("Chip", (), {"latency_us": latency_us, "index": 0,
                                   "region": region})()
    sched.state = type("State", (), {
        "min_exec_cost_us": 0, "journal": None,
        "flight": ttrace.FlightRecorder(enabled=False),
        "slo": type("Slo", (), {"enabled": False})()})()
    sched.mu = threading.Condition()
    sched.inflight, sched.queued_est_us, sched._pool_us = {}, 0.0, 0.0
    tenant = type("T", (), {"name": "t", "index": 0, "cost_ema": {},
                            "executions": 0})()
    now = time.monotonic()
    sched._prev_obs = now - prev_obs_ago
    batch = []
    for est, ago in batch_spec:
        it = tserver.WorkItem(tenant, None, None, "k", [], [])
        it.est_us = est
        batch.append((it, now - ago, [], None))
    sched._meter_batch(batch)
    return region.busy, tenant


def test_meter_batch_rule():
    """busy = min(t_obs - prev_obs, t_obs - t0 - L): after an idle gap a
    singleton books its own dispatch-to-complete window less L (about 9 ms
    here, under its 20 ms estimate); with the card busy since before the
    batch, the completion-to-completion window (about 30 ms) is split over
    the batch from the pool, each item capped at 4x its estimate."""
    busy, t = _meter([(20000.0, 0.010)], prev_obs_ago=0.5)
    assert 8000 < busy[0] <= 10000, busy
    assert t.executions == 1
    busy, t = _meter([(5000.0, 1.0), (5000.0, 1.0)], prev_obs_ago=0.030)
    assert 29000 < sum(busy) <= 40000 and max(busy) <= 20000, busy
    assert t.cost_ema["k"] > 5000.0


# -- COMPILE unpickles nothing --------------------------------------------------

def _graph_of(module, *args):
    from torch._export.serde.serialize import serialize

    return serialize(torch.export.export(module, args, strict=False)
                     ).exported_program


class _Closes(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = torch.ones(4)

    def forward(self, x):
        return x + self.c


class _Param(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def forward(self, x):
        return x * self.w


class _Evil:
    def __reduce__(self):
        return (os.system, ("touch PICKLE_RAN",))


def _bad_blobs():
    ep = torch.export.export(_Param(), (torch.ones(4),), strict=False)
    archive = io.BytesIO()
    torch.export.save(ep, archive)
    good = tclient.export_graph(lambda a: a + 1.0, [np.ones(4, np.float32)])
    foreign = good.replace(b"torch.ops.aten.add.Tensor",
                           b"torch.ops.prims.add.default")
    builtin = good.replace(b"torch.ops.aten.add.Tensor", b"builtins.eval")
    return {"archive": archive.getvalue(),
            "pickle": pickle.dumps(_Evil()),
            "constant": _graph_of(_Closes(), torch.ones(4)),
            "parameter": _graph_of(_Param(), torch.ones(4)),
            "foreign_op": foreign, "builtin_target": builtin,
            "garbage": b"\x00\x01not json"}


def refuse_unpickling(monkeypatch):
    """torch.load and pickle's loaders raise from here on."""
    def refuse(*a, **k):
        raise AssertionError("the broker unpickled tenant bytes")

    for mod, name in ((torch, "load"), (pickle, "loads"), (pickle, "load"),
                      (torch.serialization, "load")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("kind", ["archive", "pickle", "constant",
                                  "parameter", "foreign_op", "builtin_target",
                                  "garbage"])
def test_bad_blob_refused(port, tmp_path, monkeypatch, kind):
    blob = _bad_blobs()[kind]
    monkeypatch.chdir(tmp_path)
    c = tclient.RuntimeClient(port, tenant="b")
    refuse_unpickling(monkeypatch)
    with pytest.raises(tclient.RuntimeError_, match="^INVALID_ARGUMENT"):
        c.compile_blob(blob)
    assert not os.path.exists(tmp_path / "PICKLE_RAN")
    # The broker and the session serve on.
    f = c.remote_jit(lambda a: a * 3.0)
    assert f(torch.ones(2)).tolist() == [3.0, 3.0]
    c.close()


def test_good_graph_compiles_without_unpickling(port, monkeypatch):
    c = tclient.RuntimeClient(port, tenant="g")
    refuse_unpickling(monkeypatch)
    f = c.remote_jit(lambda a, b: a @ b)
    a, b = torch.ones(2, 3), torch.full((3, 2), 2.0)
    assert torch.equal(f(a, b), a @ b)
    c.close()


def test_freed_memory_not_readable_by_another_tenant(port):
    """Tenant a PUTs a pattern and DELETEs it; tenant b's program that
    would return unwritten memory of the same size is refused."""
    a = tclient.RuntimeClient(port, tenant="a")
    pattern = torch.arange(4096, dtype=torch.float32) + 0.5
    a.put(pattern, "secret")
    a.delete("secret")
    b = tclient.RuntimeClient(port, tenant="b")
    with pytest.raises(tclient.RuntimeError_,
                       match="^INVALID_ARGUMENT.*empty_like"):
        b.compile(lambda x: torch.empty_like(x), [pattern])
    assert b.stats()["b"]["used_bytes"] == 0
    a.close()
    b.close()


def _unsafe_blobs():
    good_index = tclient.export_graph(
        lambda x, i: x[i], [torch.ones(4), torch.zeros(3, dtype=torch.int64)])
    to_cpu = tclient.export_graph(lambda x: x.to("cpu") * 2.0, [torch.ones(4)])
    return {
        "empty": tclient.export_graph(
            lambda x: torch.empty(1 << 20, device=x.device) + x.sum(),
            [torch.ones(4)]),
        "empty_strided": tclient.export_graph(
            lambda x: torch.empty_strided((8,), (1,), device=x.device),
            [torch.ones(4)]),
        "new_empty": tclient.export_graph(
            lambda x: x.new_empty((1 << 20,)), [torch.ones(4)]),
        # Grows the tenant's own PUT array past the bytes it was charged.
        "resize_": tclient.export_graph(
            lambda x: torch.ops.aten.resize_(x, [1 << 20]), [torch.ones(4)]),
        "add_": tclient.export_graph(lambda x: x.add_(1.0), [torch.ones(4)]),
        "unsafe_index": good_index.replace(b"torch.ops.aten.index.Tensor",
                                           b"torch.ops.aten._unsafe_index.Tensor"),
        "other_device": to_cpu.replace(
            b'"as_device": {"type": "cpu", "index": null}',
            b'"as_device": {"type": "cuda", "index": 1}'),
    }


@pytest.mark.parametrize("kind", ["empty", "empty_strided", "new_empty",
                                  "resize_", "add_", "unsafe_index",
                                  "other_device"])
def test_unsafe_ops_refused(port, kind):
    """Ops that return unwritten memory, write to an argument, skip bounds
    checks or place a tensor off the card are refused at COMPILE; the
    ledger does not move and the session serves on."""
    c = tclient.RuntimeClient(port, tenant="u")
    x = c.put(torch.ones(4), "x")
    with pytest.raises(tclient.RuntimeError_, match="^INVALID_ARGUMENT"):
        c.compile_blob(_unsafe_blobs()[kind])
    assert c.stats()["u"]["used_bytes"] == 16
    assert c.get(x.id).tolist() == [1.0] * 4
    c.close()


def test_view_outputs_own_their_storage(port):
    """An output that is a view of an argument is copied: the ledger
    charges the output's bytes, and that is all it holds."""
    prog = tserver.load_program(
        tclient.export_graph(lambda x: (x[:1], x.reshape(2, 2)),
                             [torch.ones(4)]), torch.device("cpu"))
    x = torch.arange(4.0)
    first, whole = prog.run([x], 1, ())
    for o in (first, whole):
        assert o.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
        assert o.untyped_storage().nbytes() == o.numel() * o.element_size()
    assert first.tolist() == [0.0] and whole.flatten().tolist() == x.tolist()
    c = tclient.RuntimeClient(port, tenant="v")
    c.put(torch.zeros(1024), "big")
    exe = c.compile(lambda x: x[:1], [torch.zeros(1024)])
    c.execute_send_ids(exe.id, ["big"], ["one"])
    c.execute_recv()
    c.delete("big")
    assert c.stats()["v"]["used_bytes"] == 4
    c.close()


def test_client_refuses_closed_over_tensors():
    w = torch.ones(4)
    with pytest.raises(ValueError, match="pass every tensor as an argument"):
        tclient.export_graph(lambda a: a + w, [np.ones(4, np.float32)])


# -- K1 as the registered op ---------------------------------------------------

def test_op_equals_plain_version_on_cpu():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 32, generator=gen) for _ in range(3))
    for causal in (True, False):
        got = torch.ops.vtpu_torch.flash_attention(q, k, v, causal)
        assert torch.equal(got, tfa.flash_attention_ref(q, k, v, causal))


def test_op_fake_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(3, 40, 64, dtype=torch.bfloat16)
        out = torch.ops.vtpu_torch.flash_attention(q, q, q, True)
    assert out.shape == (3, 40, 64) and out.dtype == torch.bfloat16


def test_op_kept_in_exported_graph():
    """An exported attention_bshd keeps the op as a node (a Python branch
    on the device would have recorded the plain attention instead)."""
    blob = tclient.export_graph(
        lambda q, k, v: tfa.attention_bshd(q, k, v),
        [torch.empty(2, 16, 4, 32, dtype=torch.bfloat16)] * 3)
    assert b"torch.ops.vtpu_torch.flash_attention.default" in blob
    prog = tserver.load_program(blob, torch.device("cpu"))
    targets = [str(n.target) for n in prog.fn.graph.nodes]
    assert "vtpu_torch.flash_attention.default" in targets
    q = torch.randn(2, 16, 4, 32).to(torch.bfloat16)
    got = prog.run([q, q, q], 1, ())[0]
    assert torch.equal(got, tfa.attention_bshd(q, q, q))


# -- the slice as a whole ------------------------------------------------------

def test_tiny_transformer_through_the_port_broker(port):
    """The tiny model in f32 on the flash path, vtpu's weights carried by
    models.convert and PUT to the port's broker, chains of 2 steps: the
    first step's logits agree with vtpu's forward (Pallas kernel in
    interpret mode) to 1e-4 (f32, summation order), and the tokens of 4
    greedy steps are vtpu's exactly."""
    jcfg = dataclasses.replace(jtr.TransformerConfig.tiny(), dtype=jnp.float32,
                               use_flash=True)
    tcfg = dataclasses.replace(ttr.TransformerConfig.tiny(),
                               dtype=torch.float32, use_flash=True)
    params = jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 32),
                                               dtype=np.int32)
    want_logits = np.asarray(jtr.forward(params, jnp.asarray(prompt), jcfg))
    tokens = jnp.asarray(prompt)
    step = jax.jit(lambda p, t: jnp.argmax(jtr.forward(p, t, jcfg), axis=-1)
                   .astype(jnp.int32))
    for _ in range(4):
        tokens = step(params, tokens)

    tenant = tclient.RuntimeClient(port, tenant="tiny")
    out = entry.serve_brokered(tenant, tcfg, batch=2, seq=32, steps=4,
                               weights=params, prompt=prompt, chain=2,
                               depth=2)
    tenant.close()
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(tokens))
    assert out["steps"] == 4 and out["stats"]["executions"] == 4

    c = tclient.RuntimeClient(port, tenant="logits")
    names = [n for n, _, _ in ttr.param_shapes(tcfg)]
    from vtpu_torch.models.convert import _flatten, tensor_from_numpy
    flat = _flatten(params)
    ids = [c.put(tensor_from_numpy(flat[n]), n).id for n in names]
    c.put(torch.from_numpy(prompt), "p")
    meta = [torch.empty(2, 32, dtype=torch.int32)] + [
        torch.empty(s, dtype=d) for _, s, d in ttr.param_shapes(tcfg)]
    exe = c.compile(ttr.functional_forward(tcfg), meta)
    c.execute_send_ids(exe.id, ["p"] + ids, ["logits"])
    c.execute_recv()
    got = c.get("logits").numpy()
    np.testing.assert_allclose(got, want_logits, atol=1e-4, rtol=1e-4)
    c.close()


# -- F1: a tenant's out-of-range indices end nothing but its own results -------

F1_X = np.arange(20, dtype=np.float32).reshape(5, 4)
F1_IDX = np.array([-7, -1, 0, 3, 4, 5, 9], np.int64)


def _f1_cases():
    """(torch program, the JAX program of the same semantics, arguments):
    a gather clamps (``index`` wraps [-n, 0) first, as ``x[i]`` does; the
    others clamp below at 0, as a raw XLA start index does), a scatter
    drops (``index_put`` wraps [-n, 0) first, as ``x.at[i]`` does),
    bernoulli clamps its probabilities (NaN as 0)."""
    F = torch.nn.functional
    col = np.arange(4)
    return {
        "index_select": (lambda a, i: torch.index_select(a, 0, i),
                         lambda a, i: jnp.take(a, i, axis=0, mode="clip"),
                         [F1_X, F1_IDX]),
        # take_along_axis would wrap a negative first: XLA's raw gather
        # clamps it.
        "gather": (lambda a, i: torch.gather(a, 0, i),
                   lambda a, i: jnp.take_along_axis(
                       a, jnp.clip(i, 0, a.shape[0] - 1), 0),
                   [F1_X, np.array([[9, -2, 1, 0], [4, 5, -9, 2]],
                                   np.int64)]),
        "embedding": (lambda w, i: F.embedding(i, w),
                      lambda w, i: jnp.take(w, i, axis=0, mode="clip"),
                      [F1_X, F1_IDX]),
        "index": (lambda a, i: a[i], lambda a, i: a[i], [F1_X, F1_IDX]),
        "index_put": (lambda a, i, v: torch.index_put(a, (i,), v),
                      lambda a, i, v: a.at[i].set(v),
                      [F1_X, np.array([1, 9, -1, -9], np.int64),
                       np.full((4, 4), -1.0, np.float32)]),
        "index_put_accumulate": (
            lambda a, i, v: torch.index_put(a, (i,), v, True),
            lambda a, i, v: a.at[i].add(v),
            [F1_X, np.array([1, 9, -1, -9, 1], np.int64),
             np.full((5, 4), 2.0, np.float32)]),
        # A negative scatter index is out of range (no wrap), as in
        # XLA's raw scatter: dropped.
        "scatter_add": (lambda a, i, v: torch.scatter_add(a, 0, i, v),
                        lambda a, i, v: a.at[
                            jnp.where(i[0] < 0, a.shape[0], i[0]),
                            col].add(v[0]),
                        [F1_X, np.array([[0, 9, -1, 4]], np.int64),
                         np.ones((1, 4), np.float32)]),
        "bernoulli": (lambda p: torch.bernoulli(p),
                      lambda p: jax.random.bernoulli(
                          jax.random.PRNGKey(0), p).astype(jnp.float32),
                      [np.array([-3.0, 0.0, 1.0, 7.0, np.nan], np.float32)]),
    }


@pytest.mark.parametrize("name", list(_f1_cases()))
def test_out_of_range_indices_bounded_as_vtpu(tmp_path, monkeypatch, name):
    """F1: a program with out-of-range indices gives what vtpu's broker
    gives for the JAX program of the same semantics, over the socket and
    (the port) over the fastlane's ring; the broker serves on."""
    tfn, jfn, args = _f1_cases()[name]

    def scenario(side, sock):
        c = side.client(sock, tenant="f1")
        fn = jfn if side.name == "vtpu" else tfn
        ids = [c.put(a if side.name == "vtpu" else torch.from_numpy(a)).id
               for a in args]
        exe = c.compile(fn, args if side.name == "vtpu"
                        else [torch.from_numpy(a) for a in args])
        c.execute_send_ids(exe.id, ids, ["out"])
        c.recv_reply()
        got = side.np(c.get("out"))
        assert "f1" in c.stats()
        c.close()
        return got

    want, got = run_both(tmp_path, scenario)
    np.testing.assert_array_equal(got, want)
    # The ring runs the same bounded program.
    monkeypatch.setenv("VTPU_FASTLANE", "1")
    side = Side("port")
    (tmp_path / "lane").mkdir()
    sock = side.start(tmp_path / "lane")
    try:
        c = tclient.RuntimeClient(sock, tenant="f1")
        assert c._lane is not None
        ids = [c.put(torch.from_numpy(a)).id for a in args]
        exe = c.compile(tfn, [torch.from_numpy(a) for a in args])
        for _ in range(3):  # the first primes over the socket
            c.execute_send_ids(exe.id, ids, ["out"])
            c.recv_reply()
        np.testing.assert_array_equal(c.get("out").numpy(), want)
        assert c.stats()["f1"]["fastlane"]["ring_steps"] >= 2
        c.close()
    finally:
        side.stop()


def test_unboundable_overloads_refused(port):
    """repeat_interleave with a tensor of repeats cannot be bounded (its
    card's check is an assert on the data): COMPILE refuses it."""
    c = tclient.RuntimeClient(port, tenant="ri")
    with pytest.raises(tclient.RuntimeError_, match="INVALID_ARGUMENT"):
        c.compile(lambda x, r: torch.repeat_interleave(x, r, dim=0,
                                                       output_size=6),
                  [torch.ones(3, 2), torch.tensor([1, 2, 3])])
    exe = c.compile(lambda x: torch.repeat_interleave(x, 2, dim=0),
                    [torch.ones(3, 2)])
    assert exe(c.put(torch.ones(3, 2)))[0].fetch().shape == (6, 2)
    c.close()


def test_in_range_indices_unchanged_bit_for_bit():
    """The bounding pass leaves in-range results alone: the bounded
    program and the plain function agree bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    i = torch.from_numpy(rng.integers(0, 6, (9,)))
    v = torch.from_numpy(rng.standard_normal((9, 5)).astype(np.float32))

    def fn(x, i, v):
        return (x[i].sum(0) + torch.index_select(x, 0, i).mean(0),
                torch.index_put(x, (i,), v, True),
                torch.gather(x, 0, i[:5].reshape(1, 5).expand(2, 5)),
                torch.nn.functional.one_hot(i, 6))

    prog = tserver.load_program(
        tclient.export_graph(fn, [x, i, v]), torch.device("cpu"))
    got = prog.run([x, i, v], 1, ())
    for g, w in zip(got, fn(x, i, v)):
        assert torch.equal(g, w)


def _mask_put_ref(x, mask, idx, v, accumulate):
    """numpy's ``x[mask, idx] = v`` (or ``+=``) with the out-of-range
    integer indices dropped, after wrapping [-n, 0)."""
    out = x.copy()
    n = x.shape[mask.ndim]
    for (r, c), i in zip(np.argwhere(mask), idx):
        i = i + n if -n <= i < 0 else i
        if 0 <= i < n:
            out[r, c, i] = out[r, c, i] + v[0] if accumulate else v[0]
    return out


@pytest.mark.parametrize("accumulate", [False, True])
def test_index_put_after_a_mask_bounds_the_dim_it_reads(port, accumulate):
    """A 2-D mask covers two dims: the integer index after it reads the
    third (size 3), not the second (size 6).  Its out-of-range entries
    (4, which the second dim would hold, and -9) are dropped."""
    x = np.arange(36, dtype=np.float32).reshape(2, 6, 3)
    mask = np.zeros((2, 6), bool)
    mask[0, 1] = mask[1, 2] = mask[1, 5] = mask[0, 4] = True
    idx = np.array([1, 4, -1, -9], np.int64)
    v = np.array([-1.0], np.float32)
    ts = [torch.from_numpy(a) for a in (x, mask, idx, v)]
    c = tclient.RuntimeClient(port, tenant="mask")
    exe = c.compile(lambda a, m, i, u: torch.index_put(a, (m, i), u,
                                                       accumulate), ts)
    got = exe(*[c.put(t) for t in ts])[0].fetch().numpy()
    np.testing.assert_array_equal(
        got, _mask_put_ref(x, mask, idx, v, accumulate))
    assert "mask" in c.stats()
    c.close()


@pytest.mark.parametrize("name", ["gather", "index_select", "embedding",
                                  "index", "take_along_dim"])
def test_gather_from_an_empty_dim_refused(port, name):
    """A non-empty index into a dim of size 0 has nothing to clamp to:
    COMPILE refuses it, an empty index into it still runs, and the broker
    serves on."""
    F = torch.nn.functional
    fns = {"gather": lambda a, i: torch.gather(a, 0, i[:, None].expand(-1, 4)),
           "index_select": lambda a, i: torch.index_select(a, 0, i),
           "embedding": lambda a, i: F.embedding(i, a),
           "index": lambda a, i: a[i],
           "take_along_dim": lambda a, i: torch.take_along_dim(
               a, i[:, None].expand(-1, 4), 0)}
    c = tclient.RuntimeClient(port, tenant="empty")
    x = torch.zeros(0, 4)
    with pytest.raises(tclient.RuntimeError_, match="size 0"):
        c.compile(fns[name], [x, torch.tensor([0, 3])])
    none = torch.zeros(0, dtype=torch.int64)
    exe = c.compile(fns[name], [x, none])
    assert exe(c.put(x), c.put(none))[0].fetch().numel() == 0
    c.close()


@pytest.mark.parametrize("op", [torch.scatter, torch.scatter_add])
def test_scatter_into_a_scalar_refused(port, op):
    """A 0-d target has no dim to pad a dropped update into: COMPILE
    refuses the scatter, and the broker serves on."""
    c = tclient.RuntimeClient(port, tenant="scalar")
    with pytest.raises(tclient.RuntimeError_, match="0-d"):
        c.compile(lambda a, i, v: op(a, 0, i, v),
                  [torch.tensor(1.0), torch.tensor(3), torch.tensor(5.0)])
    assert "scalar" in c.stats()
    c.close()


@pytest.mark.parametrize("name", ["index_put_then_index_put",
                                  "scatter_then_gather",
                                  "accumulate_then_index",
                                  "one_hot_then_index_select"])
def test_bounded_ops_read_bounded_outputs(name):
    """A bounded op that reads another's output loads (the pass gives
    every node it makes its fake value) and, in range, gives the plain
    function's bits."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    i = torch.from_numpy(rng.integers(0, 5, (4,)))
    v = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    fns = {
        "index_put_then_index_put": lambda x, i, v: torch.index_put(
            torch.index_put(x, (i,), v), (i[:2],), -v[:2]),
        "scatter_then_gather": lambda x, i, v: torch.gather(
            torch.scatter(x, 0, i[:, None].expand(4, 5), v), 0,
            i[:, None].expand(4, 5)),
        "accumulate_then_index": lambda x, i, v: torch.index_put(
            x, (i,), v, True)[i],
        "one_hot_then_index_select": lambda x, i, v: torch.index_select(
            x, 0, torch.nn.functional.one_hot(i, 6).argmax(1)),
    }
    fn = fns[name]
    prog = tserver.load_program(
        tclient.export_graph(fn, [x, i, v]), torch.device("cpu"))
    assert torch.equal(prog.run([x, i, v], 1, ())[0], fn(x, i, v))


def test_arguments_held_to_the_programs_inputs(port):
    """An argument of another dtype or shape than the graph's input is
    refused before the graph runs (a float64 array through a float32
    graph would make outputs larger than the bytes charged for them), and
    the outputs' admission is handed back."""
    c = tclient.RuntimeClient(port, tenant="args")
    exe = c.compile(lambda a: a * 2.0, [torch.ones(256)])
    used = c.stats()["args"]["used_bytes"]
    for bad in (torch.ones(256, dtype=torch.float64), torch.ones(255)):
        h = c.put(bad)
        with pytest.raises(tclient.RuntimeError_, match="do not match"):
            exe(h)
        c.delete(h.id)
        assert c.stats()["args"]["used_bytes"] == used
    assert torch.equal(exe(c.put(torch.ones(256)))[0].fetch(),
                       torch.full((256,), 2.0))
    c.close()
