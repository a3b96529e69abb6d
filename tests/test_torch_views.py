"""The port's views against vtpu's: vtpu-smi (find_regions, read_region,
render, the metricsd sub-command), tpu-info (sample, render) and the
Prometheus exporter (collect, to_prometheus, metricsd_prometheus, the HTTP
server), over one scan tree of regions that vtpu's SharedRegion wrote.
The CLIs run in-process (``main([...])`` with capsys); nothing globs
/tmp.  Every comparison is exact; tpu-info's duty too, where both read
the region over the same (patched) sleep and clock.  The sub-commands and
flags that wait for the broker or the analyzers are refused, each naming
its ROADMAP item."""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

from vtpu.metricsd import backend as jbackend
from vtpu.metricsd import server as jserver
from vtpu.shim import core as jcore
from vtpu.tools import metrics_server as jms
from vtpu.tools import tpu_info as jinfo
from vtpu.tools import vtpu_smi as jsmi
from vtpu_torch.metricsd import backend as tbackend
from vtpu_torch.metricsd import server as tserver
from vtpu_torch.ops import _build
from vtpu_torch.shim.core import SharedRegion
from vtpu_torch.tools import metrics_server as tms
from vtpu_torch.tools import tpu_info as tinfo
from vtpu_torch.tools import vtpu_smi as tsmi

GI = 2**30


@pytest.fixture()
def scan(tmp_path, monkeypatch):
    """A node's shared/ tree written by vtpu's SharedRegion: two pods'
    regions (one with two devices), a broker-style .shr and a .chip
    region, and a directory with no region; each region with this process
    in a slot, a ledger and booked device time."""
    if jcore._lib is None:
        monkeypatch.setattr(jcore, "_SEARCH_PATHS", (
            _build.build_all(("vtpucore",))["vtpucore"],
            *jcore._SEARCH_PATHS))
    root = tmp_path / "shared"
    specs = {"default_pod-a_main_aaaa0000/vtpushr.cache":
             ([6 * GI, 2 * GI], [50, 50], [(0, 1_234_567_890), (1, 5 << 20)],
              [(0, 4_000_000)]),
             "default_pod-b_main_bbbb0000/vtpushr.cache":
             ([3 * GI], [25], [(0, 777 << 20)], [(0, 2_500_000)]),
             "tenant.shr": ([GI], [0], [], []),
             "tenant.shr.chip1": ([2 * GI], [100], [(0, 4096)], [(0, 10)])}
    os.makedirs(root / "empty_pod")
    regions = []
    for rel, (limits, cores, charges, busy) in specs.items():
        path = root / rel
        os.makedirs(path.parent, exist_ok=True)
        reg = jcore.SharedRegion(str(path), limits=limits, core_pcts=cores)
        reg.register()
        for dev, nbytes in charges:
            assert reg.mem_acquire(dev, nbytes)
        for dev, us in busy:
            reg.busy_add(dev, us)
        regions.append(reg)
    yield str(root)
    for reg in regions:
        reg.deregister()
        reg.close()


# -- vtpu-smi ----------------------------------------------------------------

def test_find_regions_matches_vtpu(scan, monkeypatch):
    got = tsmi.find_regions(scan)
    assert got == jsmi.find_regions(scan)
    assert [os.path.relpath(p, scan) for p in got] == [
        "default_pod-a_main_aaaa0000/vtpushr.cache",
        "default_pod-b_main_bbbb0000/vtpushr.cache",
        "tenant.shr", "tenant.shr.chip1"]
    # In a container: the env's region (with its .chip siblings).
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", got[0])
    assert tsmi.find_regions(None) == jsmi.find_regions(None) == [got[0]]


@pytest.mark.parametrize("sweep_host", [False, True])
def test_read_region_and_render_match_vtpu(scan, sweep_host):
    """Every region read as vtpu reads it (the live slot survives the
    host sweep); the table is vtpu's but for its title."""
    paths = tsmi.find_regions(scan)
    got = [tsmi.read_region(p, sweep_host) for p in paths]
    want = [jsmi.read_region(p, sweep_host) for p in paths]
    assert got == want
    assert got[0]["devices"][0]["used_bytes"] == 1_234_567_890
    assert got[0]["procs"][0]["busy_us"] == [4_000_000, 0]
    assert all(len(i["procs"]) == 1 for i in got)
    table, jtable = tsmi.render(got).splitlines(), \
        jsmi.render(want).splitlines()
    assert table[1] != jtable[1] and "vGPU" in table[1]
    assert len(table[1]) == len(jtable[1])
    assert table[:1] + table[2:] == jtable[:1] + jtable[2:]
    assert tsmi.render([]).splitlines()[2:] == jsmi.render([]).splitlines()[2:]


def test_vtpu_smi_main_matches_vtpu(scan, capsys):
    for args in (["--scan", scan, "--json"],
                 ["--region", os.path.join(scan, "tenant.shr"), "--json"]):
        assert tsmi.main(args) == 0
        got = json.loads(capsys.readouterr().out)
        assert jsmi.main(args) == 0
        assert got == json.loads(capsys.readouterr().out)
    assert tsmi.main(["--scan", scan]) == 0
    assert "1,177MiB /   6,144MiB" in capsys.readouterr().out


@pytest.mark.parametrize("cmd,item", sorted(tsmi.REFUSED_COMMANDS.items()))
def test_vtpu_smi_refuses_unported_commands(cmd, item, capsys):
    """Each of vtpu's broker and analyzer sub-commands exits non-zero and
    names its ROADMAP item, whatever options it was given."""
    assert tsmi.main([cmd, "--json", "--dump", "x.json"]) == 2
    err = capsys.readouterr().err
    assert f"vtpu-smi {cmd}" in err and f"item {item}" in err


@pytest.mark.parametrize("args", [
    ["--broker", "/run/vtpu.sock", "--migrate", "tenant-a"],
    ["--migrate", "tenant-a", "--device", "1"],
    ["--broker", "/run/vtpu.sock", "--repl-status", "--device", "1"],
    ["--migrate-to", "/run/other.sock", "--chips", "0"]])
def test_vtpu_smi_refuses_broker_flags(args, capsys):
    """The admin flags of migration wait for ROADMAP Queue 1 item
    6(d)(ii), beside a ported flag too (--repl-status, 6(d)(i); the 6(b)
    ones: tests/test_torch_chaos.py)."""
    assert tsmi.main(args) == 2
    assert "item 6(d)(ii)" in capsys.readouterr().err


def test_vtpu_smi_metricsd_matches_vtpu(capsys):
    """``vtpu-smi metricsd ADDR --json`` against a port's server and
    vtpu's against vtpu's, over the same fake tenant: the same view."""
    kw = dict(n_devices=2, hbm_limit_bytes=10 * GI, hbm_used_bytes=GI,
              duty_cycle_pct=30.0, core_limit_pct=60)
    tsrv, _, tport = tserver.make_server(0, tbackend.FakeBackend(**kw))
    jsrv, _, jport = jserver.make_server(0, jbackend.FakeBackend(**kw))
    try:
        assert tsmi.main(["metricsd", f"127.0.0.1:{tport}", "--json"]) == 0
        got = json.loads(capsys.readouterr().out)
        assert jsmi.main(["metricsd", f"127.0.0.1:{jport}", "--json"]) == 0
        want = json.loads(capsys.readouterr().out)
        assert got.pop("metricsd") != want.pop("metricsd")
        # vtpu's view less its pass-through counter (no pass-through on a
        # CUDA node).
        dropped = "vtpu.metricsd.passthrough.total"
        want["supported"].remove(dropped)
        assert want["metrics"].pop(dropped) == {"-1": 0}
        assert got == want
        assert got["metrics"][tserver.METRIC_DUTY_CYCLE] == \
            {"0": 50.0, "1": 50.0}
        assert tsmi.main(["metricsd", f"127.0.0.1:{tport}"]) == 0
        assert "10,240MiB" in capsys.readouterr().out
    finally:
        tsrv.stop(grace=0)
        jsrv.stop(grace=0)
    assert tsmi.main(["metricsd", f"127.0.0.1:{tport}"]) == 1
    assert "unreachable" in capsys.readouterr().err


# -- tpu-info ------------------------------------------------------------------

@pytest.fixture()
def booked_sleep(scan, monkeypatch):
    """time.sleep books 1.5 s of device time on device 0 of pod A's region
    and advances a patched clock by the interval, for both tools alike."""
    path = tsmi.find_regions(scan)[0]
    clock = [500.0]

    def sleep(interval):
        with SharedRegion(path) as reg:
            reg.busy_add(0, int(interval * 0.375e6))
        clock[0] += interval

    monkeypatch.setattr(time, "sleep", sleep)
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    return path


def test_tpu_info_sample_and_render_match_vtpu(booked_sleep):
    """vtpu's rows over the same window, each also naming its card and
    giving the duty of its share; the table renders vtpu's rows as vtpu
    does under the port's title, and the port's with the share's duty and
    the card."""
    with SharedRegion(booked_sleep) as reg:
        carded = tinfo.sample(reg, 4.0, {0: "GPU-aaaa", 1: "GPU-bbbb"})
        with jcore.SharedRegion(booked_sleep) as jreg:
            want = jinfo.sample(jreg, 4.0)
    got = [{k: v for k, v in d.items()
            if k not in ("card", "share_duty_pct")} for d in carded]
    assert got == want
    assert [d["duty_cycle_pct"] for d in got] == [37.5, 0.0]
    assert [d["procs"][0]["hbm_used_bytes"] for d in got] == \
        [1_234_567_890, 5 << 20]
    assert [(d["card"], d["share_duty_pct"]) for d in carded] == \
        [("GPU-aaaa", 75.0), ("GPU-bbbb", 0.0)]
    table = tinfo.render(got).splitlines()
    assert table[0] == "GPU (vtpu grant view)"
    assert table[1:] == jinfo.render(want).splitlines()[1:]
    rows = tinfo.render(carded).splitlines()
    assert "75.0%" in rows[2] and rows[2].endswith(" GPU-aaaa")
    assert tinfo.render([]).splitlines()[1:] == \
        jinfo.render([]).splitlines()[1:]


def test_tpu_info_main(booked_sleep, monkeypatch, capsys):
    """In a pod's env: its cards by UUID, its cap, ledger and the duty of
    its share, in JSON; no region: exit 1 with a message."""
    monkeypatch.setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", booked_sleep)
    monkeypatch.setenv("VTPU_DEVICE_MAP", "0:GPU-aaaa 1:GPU-bbbb")
    assert tinfo.main(["--json", "--interval", "2"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [(r["card"], r["hbm_limit_bytes"], r["hbm_used_bytes"],
             r["share_duty_pct"]) for r in rows] == \
        [("GPU-aaaa", 6 * GI, 1_234_567_890, 75.0),
         ("GPU-bbbb", 2 * GI, 5 << 20, 0.0)]
    assert tinfo.main([]) == 0
    assert "GPU-bbbb" in capsys.readouterr().out
    monkeypatch.delenv("VTPU_DEVICE_MEMORY_SHARED_CACHE")
    assert tinfo.main([]) == 1
    assert "no vtpu accounting region" in capsys.readouterr().out


# -- the Prometheus exporter ----------------------------------------------------

def by_region(infos):
    return sorted(infos, key=lambda i: i["region"])


def test_collect_and_prometheus_match_vtpu(scan):
    """The same regions collected as vtpu collects them (first scrape:
    duty 0 everywhere), the same Prometheus text for them, and the same
    metricsd block for the same scraped items."""
    got = by_region(tms.MetricsState(scan, []).collect())
    want = by_region(jms.MetricsState(scan, []).collect())
    assert got == want
    assert tms.to_prometheus(got) == jms.to_prometheus(want)
    text = tms.to_prometheus(got)
    assert ('vtpu_hbm_used_bytes{region="default_pod-a_main_aaaa0000",'
            'device="0"} 1234567890') in text
    items = [{"metricsd": "127.0.0.1:1", "up": 0, "self": {},
              "devices": {}},
             {"metricsd": 'pod"b', "up": 1,
              "self": {tserver.METRIC_SELF_REQUESTS: 7,
                       tserver.METRIC_SELF_DENIED: 1},
              "devices": {tserver.METRIC_HBM_TOTAL: {0: 3 * GI},
                          tserver.METRIC_DUTY_CYCLE: {0: 55.5}}}]
    # vtpu's text, less the HELP and TYPE of the pass-through's counter,
    # which the port does not have (no pass-through on a CUDA node).
    want = "".join(ln for ln in jms.metricsd_prometheus(items)
                   .splitlines(keepends=True)
                   if "vtpu_metricsd_passthrough_total" not in ln)
    assert tms.metricsd_prometheus(items) == want
    assert want.count("\n") == \
        jms.metricsd_prometheus(items).count("\n") - 2
    assert tms.metricsd_prometheus([]) == ""


def test_metrics_server_over_http(scan):
    """The exporter's /metrics holds every region's ledger and each pod
    metricsd's gauges (a dead one reads up 0); /json and /healthz
    answer."""
    import threading

    msrv, _, mport = tserver.make_server(0, tbackend.FakeBackend(
        n_devices=1, hbm_limit_bytes=3 * GI, hbm_used_bytes=777 << 20,
        duty_cycle_pct=20.0, core_limit_pct=25))
    dead = "127.0.0.1:1"
    srv = tms.make_server(0, scan=scan,
                          metricsd=[f"127.0.0.1:{mport}", dead])
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        with urllib.request.urlopen(base + "/json", timeout=30) as r:
            doc = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=30)
    finally:
        srv.shutdown()
        srv.server_close()
        msrv.stop(grace=0)
    assert ('vtpu_hbm_used_bytes{region="default_pod-b_main_bbbb0000",'
            f'device="0"}} {777 << 20}') in text
    target = f'target="127.0.0.1:{mport}"'
    assert f"vtpu_metricsd_up{{{target}}} 1" in text
    assert f'vtpu_metricsd_up{{target="{dead}"}} 0' in text
    assert (f'vtpu_metricsd_virtual_value{{{target},metric='
            f'"{tserver.METRIC_HBM_USAGE}",device="0"}} {777 << 20}') in text
    assert (f'vtpu_metricsd_virtual_value{{{target},metric='
            f'"{tserver.METRIC_DUTY_CYCLE}",device="0"}} 80.0') in text
    assert len(doc["regions"]) == 4 and doc["metricsd"][1]["up"] == 0
    assert set(doc) == {"regions", "metricsd"}


@pytest.mark.parametrize("args", [["--broker", "/run/vtpu.sock", "--cluster",
                                   "/run/cluster.sock"],
                                  ["--cluster", "/run/cluster.sock"]])
def test_metrics_server_refuses_broker_flags(args, capsys):
    """--cluster waits for 6(d)(ii), beside --broker (6(d)(i)) too."""
    with pytest.raises(SystemExit) as e:
        tms.main(args)
    assert e.value.code == 2
    assert "item 6" in capsys.readouterr().err


def test_grpc_only_where_the_rule_allows():
    """The port imports grpc and protobuf only in proto/, plugin/server.py
    and the two modules that speak the MetricService wire (the exporter
    reaches it through vtpu_smi): ROADMAP's rule of the port."""
    import ast

    port = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "4paradigm-k8s-device-plugin_tpu_torch")
    allowed = {"plugin/server.py", "metricsd/server.py", "tools/vtpu_smi.py"}
    users = set()
    for root, _, files in os.walk(port):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, port)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                if any(n.split(".")[0] == "grpc"
                       or n.startswith("google.protobuf") for n in names):
                    users.add(rel)
    assert {u for u in users if not u.startswith("proto/")} == allowed
