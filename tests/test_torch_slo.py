"""The port's SLO plane (vtpu_torch.runtime.slo) against vtpu's, and the
plane in the port's broker and views.

- Sketches: the same numpy-made samples give the same buckets, counts,
  sums and quantiles in both packages; merge, the bucket cap and the JSON
  round trip are equal, and each package's ``from_dict`` reads the
  other's ``to_dict``.
- The plane: blame conservation (a tenant's blame row sums to its
  measured wait), burn rates, throughput floors, objectives, staged
  against direct ingestion, the 64-tenant fairness smoke; the same
  inputs give the same report JSON in both packages, and each package
  ``restore``s the other's ``export_state``.
- The port's split of a batch's device window (``split_batch_window``,
  ``item_phases``, ``stage_row``): every item's phases add up to its
  total, on the plane and from a live broker with tracing off, where each
  batch's window is cut in the shares billing charged its items.
- The broker: the bind-free SLO verb's scoping (a tenant's own row, the
  admin's matrix), the disabled plane, the journal's ``slo`` records
  across a restart without a double count, and across the packages: a
  port broker's records restored by vtpu's ``load_state`` and plane, and
  a vtpu broker's by the port's.
- The views: the exporter's ``--broker`` histograms and exemplars,
  metricsd's SLO metrics, ``vtpu-smi top``.

vtpu's analyzer tests of the SLO verb (tests/test_slo.py's last six) wait
for the analyzers' port (ROADMAP Queue 1 item 7)."""

import json
import math
import os
import socket as socketmod
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from vtpu.runtime import journal as jjournal
from vtpu.runtime import slo as jslo
from vtpu_torch.runtime import journal as tjournal
from vtpu_torch.runtime import protocol as P
from vtpu_torch.runtime import server as tserver
from vtpu_torch.runtime import slo
from vtpu_torch.runtime.client import RuntimeClient
from vtpu_torch.tools import vtpu_smi as tsmi

MB = 2**20
TIMEOUT_S = 20.0


@pytest.fixture(autouse=True)
def _env(tmp_path, monkeypatch):
    """Brokers write their lease sidecar under the test's directory; no
    quota env leaks into a HELLO; every client socket has a timeout."""
    monkeypatch.setenv("VTPU_LEASE_SIDECAR", str(tmp_path / "lease.json"))
    for k in list(os.environ):
        if k.startswith(("VTPU_DEVICE_", "VTPU_TASK", "VTPU_OVERSUB",
                         "VTPU_SLO", "VTPU_TRACE")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("VTPU_RPC_TIMEOUT_S", str(TIMEOUT_S))
    monkeypatch.setenv("VTPU_RECONNECT_TIMEOUT_S", "0")


def samples(seed, n, sigma=1.2):
    return np.random.default_rng(seed).lognormal(7.0, sigma, n).tolist()


def same_sketch(a, b):
    assert a.buckets == b.buckets
    assert (a.count, a.zero, a.min, a.max) == (b.count, b.zero, b.min, b.max)
    assert a.sum == b.sum  # the same additions in the same order
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)


# -- QuantileSketch -------------------------------------------------------------

def test_sketch_rank_error_bound():
    """Any quantile within alpha of the exact one (no collapse), and the
    port's sketch equal to vtpu's bucket for bucket."""
    xs = samples(11, 20_000)
    sk = slo.QuantileSketch(alpha=0.02, max_buckets=4096)
    jk = jslo.QuantileSketch(alpha=0.02, max_buckets=4096)
    for v in xs:
        sk.add(v)
        jk.add(v)
    same_sketch(sk, jk)
    xs.sort()
    for q in (0.5, 0.9, 0.99, 0.999):
        exact = xs[min(int(q * (len(xs) - 1)), len(xs) - 1)]
        assert abs(sk.quantile(q) - exact) / exact <= 0.025, q
    assert sk.count == len(xs)
    assert abs(sk.sum - sum(xs)) < 1e-6 * sum(xs)


def test_sketch_merge_associativity():
    """Merge is associative, and equal to vtpu's on the same sketches."""
    def build(mod, seed):
        sk = mod.QuantileSketch(alpha=0.02, max_buckets=512)
        for v in samples(seed, 3000, 1.0):
            sk.add(v)
        return sk

    for mod in (slo, jslo):
        sks = [build(mod, s) for s in range(3)]

        def clone(s):
            return mod.QuantileSketch.from_dict(s.to_dict(), max_buckets=512)

        left = clone(sks[0]).merge(clone(sks[1])).merge(clone(sks[2]))
        right = clone(sks[0]).merge(clone(sks[1]).merge(clone(sks[2])))
        assert left.buckets == right.buckets
        assert left.count == right.count == sum(s.count for s in sks)
        assert abs(left.sum - right.sum) < 1e-6
        for q in (0.5, 0.99):
            assert left.quantile(q) == right.quantile(q)
        if mod is slo:
            port = left
        else:
            assert port.to_dict() == left.to_dict()


def test_sketch_bucket_cap_collapses_low_end():
    """Past max_buckets the lowest buckets fold: counts stay exact, the
    tail keeps its accuracy, and the fold is vtpu's."""
    vals = (10.0 ** np.random.default_rng(3).uniform(0, 7, 5000)).tolist()
    sk = slo.QuantileSketch(alpha=0.02, max_buckets=32)
    jk = jslo.QuantileSketch(alpha=0.02, max_buckets=32)
    for v in vals:
        sk.add(v)
        jk.add(v)
    same_sketch(sk, jk)
    assert len(sk.buckets) <= 32 and sk.count == 5000
    vals.sort()
    exact99 = vals[int(0.99 * (len(vals) - 1))]
    assert abs(sk.quantile(0.99) - exact99) / exact99 <= 0.05
    qs = [sk.quantile(q) for q in (0.1, 0.5, 0.9, 0.99)]
    assert qs == sorted(qs)


def test_sketch_serialization_roundtrip_json_safe():
    """JSON-safe dicts equal to vtpu's; each package reads the other's."""
    sk = slo.QuantileSketch(alpha=0.02, max_buckets=128)
    jk = jslo.QuantileSketch(alpha=0.02, max_buckets=128)
    for v in (0.0, 1.5, 1000.0, 2.5e6):
        sk.add(v)
        jk.add(v)
    d = json.loads(json.dumps(sk.to_dict()))
    assert d == json.loads(json.dumps(jk.to_dict()))
    for back in (slo.QuantileSketch.from_dict(d),
                 jslo.QuantileSketch.from_dict(d)):
        assert back.count == sk.count and back.zero == sk.zero
        assert back.buckets == sk.buckets
        assert back.quantile(0.5) == sk.quantile(0.5)
    assert slo.QuantileSketch.from_dict(jk.to_dict()).to_dict() == d
    assert sk.bucket_bounds() == jk.bucket_bounds()


# -- the plane -----------------------------------------------------------------

def _plane(mod=slo, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("windows", (30.0, 300.0))
    kw.setdefault("budget", 0.01)
    kw.setdefault("burn_alert", 10.0)
    return mod.SloPlane(**kw)


def test_blame_conservation_and_matrix():
    """Blame splits by the weights and sums to the measured wait; the
    report is vtpu's for the same records."""
    reps = []
    for mod in (slo, jslo):
        plane = _plane(mod)
        plane.ensure_tenant("victim", quota_pct=50)
        fed_wait = 0.0
        for i in range(200):
            q, b = 500.0 + i, 50.0
            fed_wait += q + b
            plane.record("victim", queue_us=q, bucket_us=b,
                         device_us=100.0, total_us=q + b + 100.0,
                         wait_weights={"heavy": 3.0, "light": 1.0},
                         now=1000.0 + i * 0.01)
        rep = plane.report(admin=True, quota_pcts={"victim": 50}, now=1003.0)
        row = rep["tenants"]["victim"]
        blamed = sum(row["blame"].values())
        assert abs(blamed - row["wait_us_total"]) <= 1e-6 * blamed
        assert abs(row["wait_us_total"] - fed_wait) <= 1e-6 * fed_wait
        assert row["blame"]["heavy"] == pytest.approx(
            3 * row["blame"]["light"], rel=1e-9)
        assert row["top_blamer"] == "heavy"
        assert rep["matrix"]["victim"]["heavy"] == row["blame"]["heavy"]
        reps.append(rep)
    assert reps[0] == reps[1]


def test_blame_self_when_no_co_tenant_activity():
    plane = _plane()
    plane.record("solo", queue_us=100.0, bucket_us=0.0, device_us=10.0,
                 total_us=110.0, now=1000.0)
    rep = plane.report(admin=True, quota_pcts={})
    assert rep["tenants"]["solo"]["blame"] == {slo.SELF_BLAME: 100.0}


def test_staged_ingestion_matches_direct_record():
    """The metering thread's bulk path (stage_batch, then ingest) agrees
    with per-item records in count, sum and quantiles."""
    direct, staged = _plane(), _plane()
    flat = []
    for i in range(64):
        dt_enq, bucket_us, dt_disp = 0.010 + i * 1e-4, 20.0, 0.002 + i * 1e-5
        flat.extend((dt_enq, bucket_us, dt_disp, 1))
        direct.record("t", queue_us=(dt_enq - dt_disp) * 1e6 - bucket_us,
                      bucket_us=bucket_us, device_us=dt_disp * 1e6,
                      total_us=dt_enq * 1e6, now=5000.0)
    staged.stage_batch({"t": flat}, None, 64)
    rep_d = direct.report(admin=True, quota_pcts={})["tenants"]["t"]
    rep_s = staged.report(admin=True, quota_pcts={})["tenants"]["t"]
    for phase in slo.PHASES:
        assert rep_s["phases"][phase]["count"] == 64
        assert rep_s["phases"][phase]["sum_us"] == pytest.approx(
            rep_d["phases"][phase]["sum_us"], rel=1e-6)
        assert rep_s["phases"][phase]["p99_us"] == pytest.approx(
            rep_d["phases"][phase]["p99_us"], rel=1e-9)
    assert rep_s["wait_us_total"] == pytest.approx(rep_d["wait_us_total"],
                                                   rel=1e-6)
    blamed = sum(rep_s["blame"].values())
    assert abs(blamed - rep_s["wait_us_total"]) <= 1e-6 * blamed


def test_staged_ingestion_is_lazy_but_read_consistent():
    plane = _plane()
    plane.stage_batch({"t": [0.01, 0.0, 0.001, 1]}, None, 1)
    assert plane._pending_n == 1
    rep = plane.report(admin=True, quota_pcts={})
    assert rep["tenants"]["t"]["phases"]["e2e"]["count"] == 1
    assert plane._pending_n == 0


def test_burn_rate_fires_for_starved_tenant():
    plane = _plane(budget=0.01, burn_alert=10.0)
    plane.ensure_tenant("starved", quota_pct=10, target_us=1000.0)
    for i in range(100):
        plane.record("starved", queue_us=50_000.0, bucket_us=0.0,
                     device_us=10.0, total_us=50_010.0,
                     now=1000.0 + i * 0.1)
    row = plane.report(admin=True, quota_pcts={"starved": 10},
                       now=1011.0)["tenants"]["starved"]
    assert row["burn_alert"] is True
    assert row["windows"]["30"]["burn_rate"] >= 10.0
    assert row["windows"]["30"]["attainment_pct"] == 0.0


def test_throughput_floor_violation_flagged():
    plane = _plane()
    plane.ensure_tenant("slowpoke", quota_pct=50, floor_steps_s=100.0)
    for i in range(30):
        plane.record("slowpoke", queue_us=1.0, bucket_us=0.0,
                     device_us=10.0, total_us=11.0, steps=1, now=1000.0 + i)
    rep = plane.report(admin=True, quota_pcts={}, now=1030.0)
    assert rep["tenants"]["slowpoke"]["windows"]["30"]["floor_ok"] is False


def test_explicit_objective_wins_and_resize_refreshes_default():
    plane = _plane()
    plane.ensure_tenant("a", quota_pct=50, target_us=123.0)
    plane.ensure_tenant("b", quota_pct=50)
    assert plane._tenants["a"].target_us == 123.0
    assert plane._tenants["b"].target_us == slo.default_target_us(50) == \
        jslo.default_target_us(50)
    plane.set_quota_pct("a", 25)
    plane.set_quota_pct("b", 25)
    assert plane._tenants["a"].target_us == 123.0
    assert plane._tenants["b"].target_us == slo.default_target_us(25)


def test_disabled_plane_is_inert():
    plane = slo.SloPlane(enabled=False)
    plane.ensure_tenant("x", quota_pct=50)
    plane.record("x", queue_us=1.0, bucket_us=1.0, device_us=1.0,
                 total_us=3.0)
    plane.stage_batch({"x": [0.1, 0.0, 0.05, 1]}, None, 1)
    rep = plane.report(admin=True, quota_pcts={})
    assert rep["enabled"] is False and rep["tenants"] == {}
    assert plane.export_state("x") is None
    assert plane.journal_due() is False
    assert rep == jslo.SloPlane(enabled=False).report(admin=True,
                                                      quota_pcts={})


def test_fairness_smoke_64_tenants():
    """64 heterogeneous tenants: conservation everywhere, the starved
    tenant's burn fires, Jain's index in (0, 1]; the same report as
    vtpu's smoke."""
    rep = slo.fairness_smoke(n_tenants=64, seed=7)
    assert rep["ok"], rep["failures"]
    assert rep["starved_burn_alert"] is True
    assert 0.0 < rep["jain"] <= 1.0 and rep["starved_ratio"] < 0.5
    assert rep == jslo.fairness_smoke(n_tenants=64, seed=7)


def test_plane_restore_roundtrip():
    """export_state then restore, within the port and across packages in
    both directions: the same report."""
    planes = {}
    for mod in (slo, jslo):
        p = _plane(mod)
        for i in range(50):
            p.record("t", queue_us=100.0, bucket_us=10.0, device_us=50.0,
                     total_us=160.0, wait_weights={"n": 1.0},
                     now=1000.0 + i * 0.01)
        planes[mod] = p
    want = planes[slo].report(admin=True, quota_pcts={})["tenants"]["t"]
    for src, dst in ((slo, slo), (slo, jslo), (jslo, slo)):
        state = json.loads(json.dumps(planes[src].export_state("t")))
        other = _plane(dst)
        other.restore("t", state)
        got = other.report(admin=True, quota_pcts={})["tenants"]["t"]
        assert got["phases"]["e2e"]["count"] == got["restored_count"] == 50
        assert got["phases"] == want["phases"]
        assert got["blame"] == want["blame"]
        assert got["wait_us_total"] == want["wait_us_total"]


def test_same_samples_same_reports():
    """Random records and staged batches (numpy-made, several tenants and
    blame weights) through both planes: the same report JSON and the same
    exported state."""
    rng = np.random.default_rng(21)
    planes = [_plane(slo), _plane(jslo)]
    names = ["a", "b", "c"]
    for p in planes:
        for n in names:
            p.ensure_tenant(n, quota_pct=30)
    for step in range(40):
        name = names[step % 3]
        q, b, d = rng.lognormal(6.0, 1.0, 3).tolist()
        w = {m: float(x) for m, x in zip(names, rng.uniform(0, 5, 3))
             if m != name}
        flat = rng.uniform(0.0005, 0.02, (8, 3))
        flat[:, 2] = np.minimum(flat[:, 2], flat[:, 0])
        rows = np.c_[flat, np.ones(8)].ravel().tolist()
        for p in planes:
            p.record(name, queue_us=q, bucket_us=b, device_us=d,
                     total_us=q + b + d, wait_weights=w, trace_id=f"x{step}",
                     now=1000.0 + step, wall_ts=5.0 + step)
            p.stage_batch({name: list(rows)}, dict(w), 8)
    got = [p.report(admin=True, quota_pcts={n: 30 for n in names},
                    now=1100.0) for p in planes]
    assert json.dumps(got[0], sort_keys=True) == \
        json.dumps(got[1], sort_keys=True)
    for n in names:
        assert planes[0].export_state(n) == planes[1].export_state(n)


def test_split_batch_window_partitions():
    """The port's split of a batch's device window: the ready times follow
    the billed shares and end at the observation; each item's queue,
    bucket and device add up to its total; the staged row reads back the
    same phases through the plane's own arithmetic."""
    assert slo.split_batch_window(1.0, 2.0, [1.0, 1.0, 2.0]) == \
        [1.25, 1.5, 2.0]
    assert slo.split_batch_window(1.0, 2.0, [0.0, 0.0]) == [1.5, 2.0]
    assert slo.split_batch_window(3.0, 2.0, [5.0]) == [2.0]
    rng = np.random.default_rng(5)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        t_enq = np.sort(rng.uniform(0.0, 0.01, n))
        t_disp = t_enq + rng.uniform(0.0, 0.02, n)
        t_obs = float(t_disp.max() + rng.uniform(0.0, 0.05))
        busys = rng.uniform(0.0, 5000.0, n).tolist()
        readies = slo.split_batch_window(float(t_disp[0]), t_obs, busys)
        assert readies[-1] == t_obs and readies == sorted(readies)
        for i in range(n):
            bw = float(rng.uniform(0.0, 3e4))
            ph = slo.item_phases(float(t_enq[i]), float(t_disp[i]),
                                 readies[i], bw)
            assert min(ph) >= 0.0
            assert abs(sum(ph[:3]) - ph[3]) <= 1e-6
            q, b, d, tot, _s = slo.SloPlane._phase_cols(
                list(slo.stage_row(*ph, 1)))
            assert abs(q[0] + b[0] + d[0] - tot[0]) <= 0.5
            assert abs(d[0] - ph[2]) <= 1e-6 and abs(q[0] - ph[0]) <= 1e-6


# -- the plane in the port's broker ------------------------------------------------

def _broker(tmp_path, name="slo", journal_dir=None, core_limit=50):
    sock = str(tmp_path / f"{name}.sock")
    srv = tserver.make_server(sock, 32 * MB, core_limit,
                              region_path=str(tmp_path / f"{name}.shr"),
                              device="cpu", journal_dir=journal_dir)
    th = threading.Thread(target=srv.serve_forever, daemon=True,
                          kwargs={"poll_interval": 0.05})
    th.start()
    return srv, sock, th


def _stop(srv, th, *clients):
    for c in clients:
        if c is not None:
            c.close()
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


def _drive(client, steps=40):
    x = torch.rand(128)
    client.put(x, "x0")
    exe = client.compile(lambda a: a * 1.0001 + 1.0, [x])
    for i in range(steps):
        client.execute_send_ids(exe.id, ["x0"], [f"y{i % 8}"])
    for _ in range(steps):
        client.recv_reply()
    client.stats()  # every dispatched item retires
    return exe


def _admin(sock, msg):
    return tsmi.request(sock + ".admin", msg)


def test_slo_verb_scoping_tenant_vs_admin(tmp_path):
    srv, sock, th = _broker(tmp_path)
    c1 = c2 = None
    try:
        c1 = RuntimeClient(sock, tenant="alice")
        c2 = RuntimeClient(sock, tenant="bob")
        _drive(c1)
        _drive(c2)
        rep = c1.slo()
        assert rep["enabled"] is True and set(rep["tenants"]) == {"alice"}
        row = rep["tenants"]["alice"]
        assert row["phases"]["e2e"]["count"] == 40
        assert row["phases"]["e2e"]["p50_us"] > 0
        assert sum(row["blame"].values()) == pytest.approx(
            row["wait_us_total"], rel=1e-4, abs=1.0)
        # Naming a neighbour does not widen a bound connection's view.
        r = c1._rpc({"kind": P.SLO, "tenant": "bob"})
        assert set(r.get("tenants", {})) == {"alice"} and "matrix" not in r
        arep = _admin(sock, {"kind": P.SLO})
        assert arep["ok"] and set(arep["tenants"]) == {"alice", "bob"}
        assert set(arep["matrix"]) == {"alice", "bob"}
        assert 0.0 < arep["fairness"]["jain"] <= 1.0
        for body in arep["tenants"].values():
            assert sum(body["blame"].values()) == pytest.approx(
                body["wait_us_total"], rel=1e-4, abs=1.0)
    finally:
        _stop(srv, th, c1, c2)


def test_slo_verb_bind_free_probe(tmp_path):
    """SLO answers without a HELLO: a bare probe sees the enabled flag,
    a named probe that row (metricsd's scrape), never the matrix."""
    srv, sock, th = _broker(tmp_path)
    c = None
    try:
        c = RuntimeClient(sock, tenant="carol")
        _drive(c, steps=20)
        s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
        s.settimeout(TIMEOUT_S)
        s.connect(sock)
        P.send_msg(s, {"kind": P.SLO})
        r = P.recv_msg(s)
        assert r["ok"] and r["enabled"] and r["tenants"] == {}
        P.send_msg(s, {"kind": P.SLO, "tenant": "carol"})
        r = P.recv_msg(s)
        assert set(r["tenants"]) == {"carol"} and "matrix" not in r
        assert r["tenants"]["carol"]["phases"]["e2e"]["count"] == 20
        s.close()
        assert set(c.stats()) == {"carol"}  # the probe took no slot
    finally:
        _stop(srv, th, c)


def test_slo_disabled_broker_answers_disabled(tmp_path, monkeypatch):
    monkeypatch.setenv("VTPU_SLO", "0")
    srv, sock, th = _broker(tmp_path, name="off")
    c = None
    try:
        c = RuntimeClient(sock, tenant="dora")
        _drive(c, steps=10)
        rep = c.slo()
        assert rep["enabled"] is False and rep["tenants"] == {}
        assert srv.state.chip(0).scheduler.slo_busy == \
            [0.0] * tserver.MAX_TENANTS
    finally:
        _stop(srv, th, c)


def test_every_retired_item_partitions(tmp_path):
    """Tracing off, two tenants pipelining: every staged row's queue,
    bucket and device add up to its total within 0.5 µs, each tenant
    staged one row per step, and the rows' device phases hold the split
    of each batch's window."""
    srv, sock, th = _broker(tmp_path, core_limit=0)
    rows = []
    plane = srv.state.slo
    orig = plane.stage_batch

    def capture(stage, weights, n):
        rows.append({k: list(v) for k, v in stage.items()})
        return orig(stage, weights, n)

    plane.stage_batch = capture
    cs = []
    try:
        cs = [RuntimeClient(sock, tenant=f"p{i}") for i in range(2)]
        for c in cs:
            _drive(c, steps=30)
        n = {}
        worst = 0.0
        for stage in rows:
            for name, flat in stage.items():
                q, b, d, tot, steps = slo.SloPlane._phase_cols(flat)
                worst = max(worst, float(np.abs(q + b + d - tot).max()))
                n[name] = n.get(name, 0) + len(tot)
        assert worst <= 0.5, worst
        assert n == {"p0": 30, "p1": 30}
        rep = _admin(sock, {"kind": P.SLO})["tenants"]
        for name in n:
            ph = rep[name]["phases"]
            assert abs(ph["queue"]["sum_us"] + ph["bucket"]["sum_us"]
                       + ph["device"]["sum_us"] - ph["e2e"]["sum_us"]) \
                <= 0.5 * 30
    finally:
        _stop(srv, th, *cs)


def test_batch_windows_split_by_billing(tmp_path, monkeypatch):
    """Tracing off: each retired batch's ready times rise within its
    window from its first dispatch to its observation, end at the
    observation, and cut the window in the shares billing charged its
    items; those charges sum to each tenant's booked ``busy_us``."""
    srv, sock, th = _broker(tmp_path, core_limit=0)
    batches = []
    split = slo.split_batch_window
    retire = tserver.DeviceScheduler._retire_phases

    def spy_split(t_first, t_obs, weights):
        out = split(t_first, t_obs, weights)
        batches[-1].update(t_first=t_first, t_obs=t_obs, readies=out)
        return out

    def spy_retire(self, batch, busys, event, t_obs, traced):
        batches.append({"names": [it.tenant.name for it, *_ in batch],
                        "t0s": [t0 for _, t0, _, _ in batch],
                        "busys": list(busys)})
        return retire(self, batch, busys, event, t_obs, traced)

    monkeypatch.setattr(slo, "split_batch_window", spy_split)
    monkeypatch.setattr(tserver.DeviceScheduler, "_retire_phases",
                        spy_retire)
    cs = []
    try:
        cs = [RuntimeClient(sock, tenant=f"p{i}") for i in range(2)]
        for c in cs:
            _drive(c, steps=30)
        billed = {}
        assert sum(len(b["names"]) for b in batches) == 60
        for b in batches:
            r, t_first, t_obs = b["readies"], b["t_first"], b["t_obs"]
            assert t_first == b["t0s"][0] and r[-1] == t_obs
            assert r == sorted(r) and t_first <= r[0]
            span, total = t_obs - t_first, sum(b["busys"])
            assert total > 0.0
            prev = t_first
            for ready, busy in zip(r, b["busys"]):
                assert abs((ready - prev) - span * busy / total) <= 1e-9
                prev = ready
            for name, busy in zip(b["names"], b["busys"]):
                billed[name] = billed.get(name, []) + [busy]
        rows = cs[0].stats()
        for name, bs in billed.items():
            assert abs(sum(bs) - rows[name]["busy_us"]) <= len(bs), name
    finally:
        _stop(srv, th, *cs)


def test_slo_sketches_survive_resume_without_double_count(tmp_path,
                                                          monkeypatch):
    """A kill-style restart: the successor restores the journaled
    sketches before the tenant returns, the resume counts nothing twice,
    and the plane's rows ride the snapshot too."""
    monkeypatch.setenv("VTPU_SLO_JOURNAL_S", "0.01")
    jdir = str(tmp_path / "journal")
    srv1, sock1, th1 = _broker(tmp_path, "b1", journal_dir=jdir)
    c = RuntimeClient(sock1, tenant="phoenix")
    ep1 = c.epoch
    _drive(c, steps=30)
    time.sleep(0.02)
    srv1.state.journal_tick()  # the slo records
    pre_n = srv1.state.slo_report(admin=True)["tenants"]["phoenix"][
        "phases"]["e2e"]["count"]
    assert pre_n == 30
    snap = srv1.state._snapshot_dict()
    assert snap["tenants"]["phoenix"]["slo"]["phases"]["e2e"]["count"] == 30
    # A crash: no graceful close record lands.
    srv1.state.journal.close()
    srv1.state.journal = None
    srv1.shutdown()
    srv1.server_close()
    th1.join(timeout=10)
    c.close()
    srv2, sock2, th2 = _broker(tmp_path, "b2", journal_dir=jdir)
    try:
        rep = srv2.state.slo_report(admin=True)
        assert rep["tenants"]["phoenix"]["phases"]["e2e"]["count"] == pre_n
        assert rep["tenants"]["phoenix"]["restored_count"] == pre_n
        s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
        s.settimeout(TIMEOUT_S)
        s.connect(sock2)
        P.send_msg(s, {"kind": P.HELLO, "tenant": "phoenix",
                       "resume_epoch": ep1})
        r = P.recv_msg(s)
        assert r["ok"] and r["resumed"] is True, r
        P.send_msg(s, {"kind": P.SLO})
        r = P.recv_msg(s)
        assert r["tenants"]["phoenix"]["phases"]["e2e"]["count"] == pre_n
        s.close()
    finally:
        _stop(srv2, th2)


def test_slo_records_cross_both_packages(tmp_path, monkeypatch):
    """A port broker's ``slo`` records are restored by vtpu's load_state
    and plane to the port's report; a vtpu-written journal (vtpu's plane
    exporting, vtpu's Journal framing) is restored by the port's broker at
    recovery to vtpu's report."""
    monkeypatch.setenv("VTPU_SLO_JOURNAL_S", "0.01")
    jdir = str(tmp_path / "pj")
    srv, sock, th = _broker(tmp_path, "pw", journal_dir=jdir)
    c = RuntimeClient(sock, tenant="xp")
    try:
        _drive(c, steps=25)
        time.sleep(0.02)
        srv.state.journal_tick()
        want = srv.state.slo_report(admin=True)["tenants"]["xp"]
        # A crash: the tenant's close is never journaled.
        srv.state.journal.close()
        srv.state.journal = None
    finally:
        _stop(srv, th, c)
    st = jjournal.Journal(jdir).load_state()
    jplane = jslo.SloPlane(enabled=True)
    jplane.restore("xp", st["tenants"]["xp"]["slo"])
    got = jplane.report(admin=True, quota_pcts={})["tenants"]["xp"]
    assert got["phases"] == want["phases"] and got["blame"] == want["blame"]
    assert got["objective"] == want["objective"]

    # The reverse: records as vtpu's broker writes them.
    vdir = str(tmp_path / "vj")
    vplane = _plane(jslo)
    vplane.ensure_tenant("xv", quota_pct=50)
    for i, v in enumerate(samples(9, 60)):
        vplane.record("xv", queue_us=v, bucket_us=v / 4, device_us=v / 2,
                      total_us=1.75 * v, wait_weights={"n": 1.0 + i},
                      now=1000.0 + i)
    vj = jjournal.Journal(vdir)
    vj.append({"op": "epoch", "epoch": "v-1"})
    vj.append({"op": "bind", "name": "xv", "devices": [0], "slots": [0],
               "priority": 1, "over": False, "hbm": [MB], "core": 50,
               "spill": None, "pid": None, "pidns": None})
    vj.append({"op": "slo", "name": "xv", "state": vplane.export_state("xv")})
    vj.close()
    assert tjournal.Journal(vdir).load_state()["tenants"]["xv"]["slo"] == \
        vplane.export_state("xv")
    srv, sock, th = _broker(tmp_path, "pr", journal_dir=vdir)
    try:
        got = srv.state.slo_report(admin=True)["tenants"]["xv"]
        want = vplane.report(admin=True, quota_pcts={})["tenants"]["xv"]
        assert got["phases"] == want["phases"] and \
            got["blame"] == want["blame"]
        assert got["restored_count"] == 60
    finally:
        _stop(srv, th)


# -- the views -------------------------------------------------------------------

def _scrape(sock):
    from vtpu_torch.tools import metrics_server

    msrv = metrics_server.make_server(0, brokers=[sock])
    th = threading.Thread(target=msrv.serve_forever, daemon=True)
    th.start()
    try:
        port = msrv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=TIMEOUT_S) as resp:
            return resp.read().decode()
    finally:
        msrv.shutdown()
        msrv.server_close()


def test_metrics_server_always_emits_slo_histogram(tmp_path):
    """vtpu_tenant_latency_us for every tenant with the sketch's buckets,
    tracing off, with the SLO, blame and fairness gauges; the text is
    vtpu's ``broker_prometheus`` of the same scrape."""
    from vtpu.tools import metrics_server as jms
    from vtpu_torch.tools import metrics_server as tms

    srv, sock, th = _broker(tmp_path)
    c = None
    try:
        c = RuntimeClient(sock, tenant="scraped")
        _drive(c)
        text = _scrape(sock)
        assert 'vtpu_tenant_latency_us_bucket{broker=' in text
        assert 'le="+Inf"} 40' in text
        for name in ("vtpu_tenant_latency_us_count", "vtpu_tenant_slo_phase_us",
                     "vtpu_tenant_slo_burn_rate", "vtpu_tenant_slo_target_us",
                     "vtpu_tenant_blame_us_total", "vtpu_tenant_fairness_ratio",
                     "vtpu_broker_fairness_jain", "vtpu_repl_seq"):
            assert name in text, name
        got = tms.MetricsState(None, [], brokers=[sock]).collect_brokers()
        assert tms.broker_prometheus(got) == jms.broker_prometheus(got)
    finally:
        _stop(srv, th, c)


def test_metrics_server_exemplars_with_trace(tmp_path, monkeypatch):
    """With tracing on, the histogram's buckets carry trace-id exemplars
    that link into the flight recorder."""
    monkeypatch.setenv("VTPU_TRACE", "1")
    srv, sock, th = _broker(tmp_path, name="tr")
    c = None
    try:
        c = RuntimeClient(sock, tenant="traced", trace=True)
        _drive(c, steps=30)
        ex = [ln for ln in _scrape(sock).splitlines()
              if "latency_us_bucket" in ln and "trace_id=" in ln]
        assert ex and ' # {trace_id="' in ex[0]
    finally:
        _stop(srv, th, c)


def test_metricsd_virtualized_slo_scrape():
    """A MetricService client of the port's metricsd sees the tenant's own
    SLO on each granted ordinal, as vtpu's fake tenant gives it."""
    grpc = pytest.importorskip("grpc")
    from vtpu_torch.metricsd import server as msrv_mod
    from vtpu_torch.metricsd.backend import FakeBackend
    from vtpu_torch.proto import tpu_metrics_grpc as mrpc
    from vtpu_torch.proto import tpu_metrics_pb2 as mpb

    backend = FakeBackend()
    server, _, port = msrv_mod.make_server(0, backend)
    try:
        with grpc.insecure_channel(f"localhost:{port}") as ch:
            stub = mrpc.RuntimeMetricServiceStub(ch)
            att = stub.GetRuntimeMetric(mpb.MetricRequest(
                metric_name=msrv_mod.METRIC_SLO_ATTAINMENT), timeout=5)
            p99 = stub.GetRuntimeMetric(mpb.MetricRequest(
                metric_name=msrv_mod.METRIC_SLO_P99), timeout=5)
            listed = stub.ListSupportedMetrics(
                mpb.ListSupportedMetricsRequest(), timeout=5)
        assert len(att.metric.metrics) == backend.n_devices
        assert all(m.gauge.as_double == pytest.approx(95.0)
                   for m in att.metric.metrics)
        assert all(m.gauge.as_double == pytest.approx(42_000.0)
                   for m in p99.metric.metrics)
        assert msrv_mod.METRIC_SLO_ATTAINMENT in {
            sm.metric_name for sm in listed.supported_metric}
    finally:
        server.stop(grace=0.5)


def test_metricsd_region_backend_slo_reads_broker(tmp_path):
    """RegionBackend names its tenant on the main socket (no HELLO) and
    gets its row as a summary that agrees with the SLO verb; the ledger
    comes from STATS."""
    from vtpu_torch.metricsd.backend import RegionBackend
    from vtpu_torch.utils import envspec

    srv, sock, th = _broker(tmp_path, name="mb")
    c = None
    try:
        c = RuntimeClient(sock, tenant="podtenant")
        _drive(c, steps=25)
        be = RegionBackend(region_path=str(tmp_path / "absent"),
                           quota=envspec.quota_from_env({}),
                           broker_socket=sock, tenant="podtenant")
        s = be.slo_summary()
        row = c.slo()["tenants"]["podtenant"]
        assert s["p99_us"] == row["phases"]["e2e"]["p99_us"] > 0.0
        assert s["target_us"] == row["objective"]["target_us"] > 0.0
        assert 0.0 <= s["attainment_pct"] <= 100.0
        used = c.stats()["podtenant"]["used_bytes"]
        assert [v.hbm_used_bytes for v in be.devices()] == [used]
    finally:
        _stop(srv, th, c)


def test_vtpu_smi_top_once_fake(capsys):
    assert tsmi.main(["top", "--once", "--fake"]) == 0
    out = capsys.readouterr().out
    assert "vtpu-smi top" in out and "fake-0" in out
    assert "TENANT" in out and "ATTAIN%" in out and "TOP BLAMER" in out


def test_vtpu_smi_top_once_live_broker(tmp_path, capsys):
    """``top --once`` and ``--json`` against a live broker: the rows agree
    with the admin SLO reply."""
    srv, sock, th = _broker(tmp_path, name="top")
    c = None
    try:
        c = RuntimeClient(sock, tenant="topt")
        _drive(c, steps=15)
        assert tsmi.main(["top", "--once", "--broker", sock]) == 0
        assert "topt" in capsys.readouterr().out
        assert tsmi.main(["top", "--once", "--json", "--broker", sock]) == 0
        rows = json.loads(capsys.readouterr().out)["rows"]
        want = _admin(sock, {"kind": P.SLO})["tenants"]["topt"]["phases"]
        assert [r["tenant"] for r in rows] == ["topt"]
        assert rows[0]["p99_e2e_us"] == want["e2e"]["p99_us"]
        assert rows[0]["hbm_used"] == c.stats()["topt"]["used_bytes"] == \
            9 * 512  # x0 and the eight outputs y0..y7
    finally:
        _stop(srv, th, c)


def test_fastlane_items_reach_the_plane(tmp_path, monkeypatch):
    """A lane tenant's ring steps are harvested by the meter: one row per
    step, each partitioning its total."""
    monkeypatch.setenv("VTPU_FASTLANE", "1")
    srv, sock, th = _broker(tmp_path, name="fl", core_limit=0)
    rows = []
    orig = srv.state.slo.stage_batch

    def capture(stage, weights, n):
        rows.extend(v for vs in stage.values() for v in [list(vs)])
        return orig(stage, weights, n)

    srv.state.slo.stage_batch = capture
    c = None
    try:
        c = RuntimeClient(sock, tenant="lane", fastlane=True)
        assert c._lane is not None
        x = torch.rand(64)
        c.put(x, "x0")
        exe = c.compile(lambda a: a + 1.0, [x])
        for i in range(12):
            c.execute_send_ids(exe.id, ["x0"], ["y"])
            c.recv_reply()
        ring = c.stats()["lane"]["fastlane"]["ring_steps"]
        assert ring >= 10
        rep = c.slo()["tenants"]["lane"]
        assert rep["phases"]["e2e"]["count"] == 12
        flat = [v for r in rows for v in r]
        q, b, d, tot, _s = slo.SloPlane._phase_cols(flat)
        assert len(tot) == 12
        assert float(np.abs(q + b + d - tot).max()) <= 0.5
        assert math.isclose(float(b.sum()), 0.0) or ring < 12
    finally:
        _stop(srv, th, c)
