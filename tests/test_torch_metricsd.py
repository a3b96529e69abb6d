"""The port's metricsd (vtpu_torch.metricsd) against vtpu's: the duty rule
and the deny list over one grid, every RPC over the same fake tenant,
the names it does not model, the region backend over a region vtpu's
SharedRegion wrote and its duty window, the gRPC server and the
in-container port race.  Every comparison is exact: the duty too, where
both backends read the same two samples of the region at the same
(patched) clock."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import grpc
import pytest

import vtpu.metricsd as jmetricsd
from vtpu.metricsd import backend as jbackend
from vtpu.metricsd import server as jserver
from vtpu.proto import tpu_metrics_grpc as jrpc
from vtpu.shim import core as jcore
from vtpu_torch.metricsd import DEFAULT_PORT, METRICSD_RPCS
from vtpu_torch.metricsd import backend as tbackend
from vtpu_torch.metricsd import server as tserver
from vtpu_torch.ops import _build
from vtpu_torch.proto import tpu_metrics_grpc as trpc
from vtpu_torch.proto import tpu_metrics_pb2 as mpb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GI = 2**30


@pytest.fixture()
def jregion_lib(monkeypatch):
    """vtpu's SharedRegion loads the region library from the port's build
    of the same unchanged source when the repo's native/build has none."""
    if jcore._lib is None:
        monkeypatch.setattr(jcore, "_SEARCH_PATHS", (
            _build.build_all(("vtpucore",))["vtpucore"],
            *jcore._SEARCH_PATHS))


# -- the duty rule and the deny list ------------------------------------------

RAW = (-5.0, 0.0, 12.5, 25.0, 40.0, 49.9, 50.0, 99.9, 100.0, 150.0)


@pytest.mark.parametrize("core", [-10, 0, 1, 25, 50, 100, 120])
def test_virtual_duty_pct(core):
    """The same share of the share for every raw duty (exact)."""
    got = [tserver.virtual_duty_pct(r, core) for r in RAW]
    assert got == [jserver.virtual_duty_pct(r, core) for r in RAW]
    assert all(0.0 <= g <= 100.0 for g in got)


@pytest.mark.parametrize("name", [
    "tpu.runtime.hbm.memory.total.bytes", "tpu.runtime.uptime.seconds",
    "HBM_Bandwidth", "gpu.utilization", "tensorcore.count", "duty_cycle",
    "power.draw", "sm.clock", "vtpu.metricsd.requests.total", ""])
def test_is_sensitive(name):
    assert tserver.is_sensitive(name) == jserver.is_sensitive(name)
    assert tserver.SENSITIVE_PATTERNS == jserver.SENSITIVE_PATTERNS


# -- the RPCs over one fake tenant ----------------------------------------------

class Ctx:
    """A servicer's gRPC context: the status it set."""

    def __init__(self):
        self.code, self.details = None, None

    def set_code(self, code):
        self.code = code

    def set_details(self, details):
        self.details = details


def fields(resp):
    """A MetricResponse without its timestamps."""
    return (resp.metric.name, [
        (m.attribute.key, m.attribute.value.int_attr,
         m.gauge.WhichOneof("value"),
         getattr(m.gauge, m.gauge.WhichOneof("value") or "as_int"))
        for m in resp.metric.metrics])


FAKES = {
    "quota": dict(n_devices=3, hbm_limit_bytes=20 * GI,
                  hbm_raw_total_bytes=80 * GI, hbm_used_bytes=3 * GI,
                  duty_cycle_pct=37.5, core_limit_pct=25),
    # An unlimited grant whose ledger is past the raw total: clamped.
    "unlimited": dict(n_devices=1, hbm_limit_bytes=0,
                      hbm_raw_total_bytes=16 * GI, hbm_used_bytes=17 * GI,
                      duty_cycle_pct=120.0, core_limit_pct=0),
}
NAMES = (*tserver.VIRTUALIZED_METRICS, *tserver.SELF_METRICS,
         "tpu.runtime.hbm.raw.bytes", "tpu.runtime.uptime.seconds")


@pytest.mark.parametrize("name", NAMES)
def test_get_runtime_metric_matches_vtpu(name):
    """Every metric name, over the same fake tenants: the same values on
    the same ordinals, the same status code; the self-gauges count
    alike."""
    assert tserver.VIRTUALIZED_METRICS == jserver.VIRTUALIZED_METRICS
    # vtpu's own gauges less its pass-through counter.
    assert tserver.SELF_METRICS == tuple(
        n for n in jserver.SELF_METRICS
        if n != "vtpu.metricsd.passthrough.total")
    for kw in FAKES.values():
        t = tserver.MetricsdServicer(tbackend.FakeBackend(**kw))
        j = jserver.MetricsdServicer(jbackend.FakeBackend(**kw))
        for _ in range(3):                  # the self-gauges move
            tctx, jctx = Ctx(), Ctx()
            got = t.GetRuntimeMetric(mpb.MetricRequest(metric_name=name),
                                     tctx)
            want = j.GetRuntimeMetric(mpb.MetricRequest(metric_name=name),
                                      jctx)
            assert fields(got) == fields(want)
            # The same status; the details name no libtpu on the H100.
            assert tctx.code == jctx.code
            assert (tctx.details is None) == (jctx.details is None)


def test_list_supported_metrics_matches_vtpu():
    t = tserver.MetricsdServicer(tbackend.FakeBackend())
    j = jserver.MetricsdServicer(jbackend.FakeBackend())
    got = t.ListSupportedMetrics(mpb.ListSupportedMetricsRequest(), Ctx())
    want = j.ListSupportedMetrics(mpb.ListSupportedMetricsRequest(), Ctx())
    # vtpu's names (it lists no upstream here), less its pass-through
    # counter.
    assert [m.metric_name for m in got.supported_metric] == \
        [m.metric_name for m in want.supported_metric
         if m.metric_name != "vtpu.metricsd.passthrough.total"]
    assert METRICSD_RPCS == ("GetRuntimeMetric", "ListSupportedMetrics")
    assert DEFAULT_PORT == jmetricsd.DEFAULT_PORT == 8431
    for rpc in METRICSD_RPCS:
        assert callable(getattr(tserver.MetricsdServicer, rpc))
        assert callable(getattr(trpc.RuntimeMetricServiceServicer, rpc))


def test_fake_backend_from_env():
    env = {"VTPU_DEVICE_HBM_LIMIT_0": "10Gi", "VTPU_DEVICE_CORE_LIMIT": "30",
           "VTPU_DEVICE_MAP": "0:GPU-a 1:GPU-b 2:GPU-c"}
    t = tbackend.FakeBackend.from_env(env).devices()
    j = jbackend.FakeBackend.from_env(env).devices()
    strip = [(v.ordinal, v.hbm_limit_bytes, v.hbm_used_bytes,
              v.duty_cycle_pct, v.core_limit_pct) for v in t]
    assert strip == [(v.ordinal, v.hbm_limit_bytes, v.hbm_used_bytes,
                      v.duty_cycle_pct, v.core_limit_pct) for v in j]
    assert len(t) == 3 and t[0].hbm_limit_bytes == 10 * GI


# -- names metricsd does not model --------------------------------------------------

@pytest.mark.parametrize("name", [
    "tpu.runtime.uptime.seconds", "tpu.runtime.other",
    "tpu.runtime.hbm.raw.bytes", "gpu.utilization",
    "vtpu.metricsd.passthrough.total"])
def test_unmodelled_name_not_found(name):
    """A CUDA node runs no metrics service to pass a name on to: every
    name metricsd does not model answers NOT_FOUND with no values, and a
    quota-sensitive one is counted as denied.  vtpu's servicer with no
    upstream answers the same, save for its pass-through counter, which
    the port does not keep."""
    t = tserver.MetricsdServicer(tbackend.FakeBackend())
    j = jserver.MetricsdServicer(jbackend.FakeBackend())
    tctx, jctx = Ctx(), Ctx()
    got = t.GetRuntimeMetric(mpb.MetricRequest(metric_name=name), tctx)
    want = j.GetRuntimeMetric(mpb.MetricRequest(metric_name=name), jctx)
    assert tctx.code == grpc.StatusCode.NOT_FOUND and tctx.details
    assert fields(got) == ("", [])
    assert t.passthrough_denied_total == int(tserver.is_sensitive(name))
    if name in jserver.SELF_METRICS:
        assert name not in tserver.SELF_METRICS and jctx.code is None
    else:
        assert fields(got) == fields(want) and jctx.code == tctx.code
        assert t.passthrough_denied_total == j.passthrough_denied_total
    listed = t.ListSupportedMetrics(mpb.ListSupportedMetricsRequest(), Ctx())
    assert name not in [m.metric_name for m in listed.supported_metric]


# -- the region backend ----------------------------------------------------------

def test_region_backend_matches_vtpu(jregion_lib, tmp_path, monkeypatch):
    """Over a region vtpu's SharedRegion wrote (two devices, one slot,
    a ledger and booked device time): the same views from both backends,
    the duty from the same two samples; probing takes no slot and changes
    nothing in the region."""
    path = str(tmp_path / "vtpushr.cache")
    env = {"VTPU_DEVICE_HBM_LIMIT_0": "6Gi", "VTPU_DEVICE_HBM_LIMIT_1": "3Gi",
           "VTPU_DEVICE_CORE_LIMIT": "40",
           "VTPU_DEVICE_MAP": "0:GPU-aaaa 1:GPU-bbbb",
           "VTPU_DEVICE_MEMORY_SHARED_CACHE": path}
    from vtpu.utils import envspec as jenv
    from vtpu_torch.utils import envspec as tenv
    reg = jcore.SharedRegion(path, limits=[6 * GI, 3 * GI],
                             core_pcts=[40, 40])
    reg.register()
    try:
        assert reg.mem_acquire(0, 1_500_000_000)
        assert reg.mem_acquire(1, 7_000_000)
        reg.busy_add(0, 123_456)
        clock = [1000.0]
        monkeypatch.setattr(time, "monotonic", lambda: clock[0])
        t = tbackend.RegionBackend(quota=tenv.quota_from_env(env))
        j = jbackend.RegionBackend(quota=jenv.quota_from_env(env))
        before = reg.device_stats(0).n_procs, len(reg.proc_stats())

        def views():
            return ([vars(v) for v in t.devices()],
                    [vars(v) for v in j.devices()])

        first = views()
        reg.busy_add(0, 250_000)          # a quarter of the next second
        reg.busy_add(1, 600_000)
        clock[0] += 1.0
        second = views()
        for got, want in (first, second):
            for v in want:       # vtpu's fallback is a v5e's 16 GiB
                v["hbm_raw_total_bytes"] = tbackend._RAW_HBM_FALLBACK
            assert got == want
        got = second[0]
        assert [v["chip_id"] for v in got] == ["GPU-aaaa", "GPU-bbbb"]
        assert [v["hbm_limit_bytes"] for v in got] == [6 * GI, 3 * GI]
        assert [v["hbm_used_bytes"] for v in got] == [1_500_000_000,
                                                      7_000_000]
        assert [v["duty_cycle_pct"] for v in got] == [25.0, 60.0]
        assert (reg.device_stats(0).n_procs, len(reg.proc_stats())) == \
            before == (1, 1)
        # Asked again at once, the port's duty is the window's (25% and
        # 60% of the card at a 40% share: 62.5 and, clamped, 100 of the
        # share); vtpu's restarts its window and reads 0.
        servicer = tserver.MetricsdServicer(t)
        duty = servicer.GetRuntimeMetric(mpb.MetricRequest(
            metric_name=tserver.METRIC_DUTY_CYCLE), Ctx())
        assert [m.gauge.as_double for m in duty.metric.metrics] == \
            [62.5, 100.0]
        assert [v.duty_cycle_pct for v in j.devices()] == [0.0, 0.0]
        assert t.slo_summary() is None is j.slo_summary()
    finally:
        reg.deregister()
        reg.close()


@pytest.mark.parametrize("before", [
    (), (tserver.METRIC_HBM_USAGE,),
    (tserver.METRIC_HBM_TOTAL, tserver.METRIC_HBM_USAGE),
    (tserver.METRIC_DUTY_CYCLE,)])
def test_duty_reads_the_window(jregion_lib, tmp_path, monkeypatch, before):
    """A scrape asks for total, usage and duty one after another, a few
    ms apart: the duty is still the window since the last scrape (a
    quarter of the card at a 50% share reads 50), and so is a second
    scraper's right after.  A window of 1/6 s or more moves the sample."""
    from vtpu_torch.utils import envspec as tenv
    path = str(tmp_path / "vtpushr.cache")
    reg = jcore.SharedRegion(path, limits=[GI], core_pcts=[50])
    reg.register()
    try:
        clock = [1000.0]
        monkeypatch.setattr(time, "monotonic", lambda: clock[0])
        env = {"VTPU_DEVICE_HBM_LIMIT_0": "1Gi",
               "VTPU_DEVICE_CORE_LIMIT": "50",
               "VTPU_DEVICE_MEMORY_SHARED_CACHE": path}
        servicers = [tserver.MetricsdServicer(
            tbackend.RegionBackend(quota=tenv.quota_from_env(env)))
            for _ in range(2)]

        def ask(s, name):
            clock[0] += 0.002
            resp = s.GetRuntimeMetric(mpb.MetricRequest(metric_name=name),
                                      Ctx())
            return [m.gauge.as_double if m.gauge.WhichOneof("value")
                    == "as_double" else m.gauge.as_int
                    for m in resp.metric.metrics]

        starts = []
        for s in servicers:
            assert ask(s, tserver.METRIC_DUTY_CYCLE) == [0.0]  # first sample
            starts.append(clock[0])
        reg.busy_add(0, 500_000)
        clock[0] += 2.0
        for s, t0 in zip(servicers, starts):
            # The window ends at the scrape's first call.
            window = clock[0] + 0.002 - t0
            for name in before:
                ask(s, name)
            assert ask(s, tserver.METRIC_DUTY_CYCLE) == \
                [500_000 / (window * 1e6) * 100.0 * 100.0 / 50]
        reg.busy_add(0, 250_000)           # all of the next 1/4 s
        clock[0] += 0.25
        assert ask(servicers[0], tserver.METRIC_DUTY_CYCLE) == [100.0]
    finally:
        reg.deregister()
        reg.close()


def test_region_backend_refuses_a_broker():
    """A broker socket is taken now (6(d)(i)), from the argument or the
    grant's runtime socket, with the pod's tenant name; a broker that
    does not answer leaves the SLO view empty, as vtpu's does."""
    b = tbackend.RegionBackend(quota=None, broker_socket="/run/broker.sock",
                               tenant="t")
    assert b.broker_socket == "/run/broker.sock" and b.slo_summary() is None
    b = tserver.backend_from_env({"VTPU_RUNTIME_SOCKET": "/run/b.sock",
                                  "VTPU_TENANT": "p"})
    assert (b.broker_socket, b.tenant) == ("/run/b.sock", "p")
    assert isinstance(tserver.backend_from_env({"VTPU_METRICSD_FAKE": "1"}),
                      tbackend.FakeBackend)


def test_region_backend_without_a_region(tmp_path):
    """No region file yet: the grant's caps on its ordinals, nothing
    used, and no file made."""
    from vtpu_torch.utils import envspec as tenv
    env = {"VTPU_DEVICE_HBM_LIMIT_0": "2Gi",
           "VTPU_DEVICE_MEMORY_SHARED_CACHE": str(tmp_path / "none.cache")}
    views = tbackend.RegionBackend(quota=tenv.quota_from_env(env)).devices()
    assert [(v.ordinal, v.hbm_limit_bytes, v.hbm_used_bytes)
            for v in views] == [(0, 2 * GI, 0)]
    assert not os.path.exists(env["VTPU_DEVICE_MEMORY_SHARED_CACHE"])


# -- the server and its CLI ----------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_server_over_grpc_matches_vtpu():
    """The port's server and vtpu's, each over the same fake tenant, give
    a MetricService client the same answers (either side's stub reads
    either server: one wire)."""
    kw = FAKES["quota"]
    tsrv, _, tport = tserver.make_server(0, tbackend.FakeBackend(**kw))
    jsrv, _, jport = jserver.make_server(0, jbackend.FakeBackend(**kw))
    try:
        answers = []
        for port, rpc in ((tport, jrpc), (jport, trpc)):
            with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                stub = rpc.RuntimeMetricServiceStub(ch)
                answers.append([fields(stub.GetRuntimeMetric(
                    mpb.MetricRequest(metric_name=n), timeout=10))
                    for n in (*tserver.VIRTUALIZED_METRICS,
                              *tserver.SELF_METRICS)])
        assert answers[0] == answers[1]
        assert answers[0][0][1][2][3] == 20 * GI
    finally:
        tsrv.stop(grace=0)
        jsrv.stop(grace=0)


def test_selftest_and_cli_refusals(capsys):
    assert tserver.main(["--selftest"]) == 0
    assert "40 GiB total / 1 GiB used / 80%" in capsys.readouterr().out
    # --broker is taken now (6(d)(i)); an unknown flag is still refused.
    assert tserver.main(["--broker", "/run/broker.sock", "--selftest"]) == 0
    with pytest.raises(SystemExit) as e:
        tserver.main(["--cluster", "/run/broker.sock"])
    assert e.value.code == 2


RACE = """
    import json, os, sys, time
    sys.path.insert(0, {repo!r})
    from vtpu_torch.metricsd import server
    got = server.maybe_start_in_container()
    again = server.maybe_start_in_container()
    print(json.dumps({{"won": got is not None, "same": again is got,
                      "port": got[2] if got else None}}), flush=True)
    time.sleep({hold})
"""


def test_maybe_start_in_container_port_race(tmp_path):
    """Three processes of one container start together: one binds the
    port and serves the grant, the others go on without a server; a
    client then reads the winner.  A broker socket in the env is taken
    (6(d)(i)): the server starts with it."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "LD_", "PYTHON"))}
    env.update(VTPU_METRICSD_PORT=str(port), VTPU_METRICSD_FAKE="1",
               VTPU_DEVICE_HBM_LIMIT_0="5Gi", VTPU_DEVICE_CORE_LIMIT="50",
               VTPU_DEVICE_MAP="0:GPU-x", VTPU_LOG_LEVEL="2")
    code = textwrap.dedent(RACE.format(repo=REPO, hold=6))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    try:
        rows = [json.loads(p.stdout.readline()) for p in procs]
        assert sorted(r["won"] for r in rows) == [False, False, True]
        assert all(r["same"] for r in rows)
        assert [r["port"] for r in rows if r["won"]] == [port]
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            resp = trpc.RuntimeMetricServiceStub(ch).GetRuntimeMetric(
                mpb.MetricRequest(metric_name=tserver.METRIC_HBM_TOTAL),
                timeout=10)
        assert [m.gauge.as_int for m in resp.metric.metrics] == [5 * GI]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    code = textwrap.dedent(RACE.format(repo=REPO, hold=0))
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(env, VTPU_METRICSD_BROKER="/run/broker.sock",
                                VTPU_METRICSD_FAKE="0"),
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["won"] is True
    assert "metricsd not started" not in r.stderr
