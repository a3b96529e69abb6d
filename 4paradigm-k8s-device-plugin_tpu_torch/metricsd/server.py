"""The vtpu-metricsd gRPC server: the MetricService wire, answered with the
pod's grant.

``vtpu``'s ``metricsd/server.py`` over the port's region.  It serves
``tpu.monitoring.runtime.v2alpha1.RuntimeMetricService`` with the pod's
view instead of the raw card's:

  =============================  =========================================
  metric                         rule
  =============================  =========================================
  hbm.memory.total.bytes         the HBM cap (the raw card's capacity only
                                 for an unlimited grant)
  hbm.memory.usage.bytes         the pod's ledger, clamped to the total
  tensorcore.dutycycle.percent   the pod's own device time, rescaled by
                                 its compute share so that 100 = all of
                                 the share (a 50% pod running flat out
                                 reads 100, not 50); the interposer's
                                 nvmlDeviceGetUtilizationRates gives
                                 nvidia-smi the same number
  (device enumeration)           the granted ordinals only
  =============================  =========================================

The names are ``vtpu``'s wire contract and stay as they are.  Any other
name is answered NOT_FOUND.  ``vtpu`` passes such names on to the TPU
runtime's own metrics service; a CUDA node runs no such service, so the
port has no pass-through (ROADMAP Queue 1 item 5).  A name that matches
a capacity or utilisation pattern (``SENSITIVE_PATTERNS``) is counted as
denied, as ``vtpu`` counts the names it refuses to forward.

Started in each container by the bootstrap (``maybe_start_in_container``
from sitecustomize: the first process to bind the port serves it) or by
hand::

    python -m vtpu_torch.metricsd --port 8431         # the pod's region
    python -m vtpu_torch.metricsd --fake --port 8431  # a synthetic tenant
    python -m vtpu_torch.metricsd --selftest          # smoke test, exits 0/1
"""

from __future__ import annotations

import argparse
import os
import threading
from concurrent import futures
from typing import Dict, List, Optional

from ..utils import envspec
from ..utils import logging as log
from . import DEFAULT_PORT
from .backend import Backend, DeviceView, FakeBackend, RegionBackend

# Wire metric names (vtpu's).
METRIC_HBM_TOTAL = "tpu.runtime.hbm.memory.total.bytes"
METRIC_HBM_USAGE = "tpu.runtime.hbm.memory.usage.bytes"
METRIC_DUTY_CYCLE = "tpu.runtime.tensorcore.dutycycle.percent"
# The pod's own SLO, rescaled like the duty ("of MY objective"), from the
# broker's SLO plane; no values without a broker (as in ``vtpu``).
METRIC_SLO_ATTAINMENT = "vtpu.slo.attainment.percent"
METRIC_SLO_P99 = "vtpu.slo.e2e.p99.microseconds"
# metricsd's own gauges, on the same wire, so that the node's exporter
# (tools/metrics_server.py --metricsd) needs no side channel.
METRIC_SELF_REQUESTS = "vtpu.metricsd.requests.total"
METRIC_SELF_DENIED = "vtpu.metricsd.passthrough.denied.total"

VIRTUALIZED_METRICS = (METRIC_HBM_TOTAL, METRIC_HBM_USAGE,
                       METRIC_DUTY_CYCLE, METRIC_SLO_ATTAINMENT,
                       METRIC_SLO_P99)
SELF_METRICS = (METRIC_SELF_REQUESTS, METRIC_SELF_DENIED)

# A name holding one of these discloses raw capacity or the neighbours'
# load: a request for one that is not modelled here is counted as denied.
SENSITIVE_PATTERNS = ("hbm", "memory", "dutycycle", "duty_cycle",
                      "utilization", "tensorcore", "bandwidth", "power")


def is_sensitive(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in SENSITIVE_PATTERNS)


def virtual_duty_pct(raw_pct: float, core_limit_pct: int) -> float:
    """The pod's duty of the whole card as a share of its compute share:
    at a 50% share, 40% of the card reads as 80%."""
    if core_limit_pct <= 0:
        return min(max(raw_pct, 0.0), 100.0)
    return min(max(raw_pct, 0.0) * 100.0 / core_limit_pct, 100.0)


class MetricsdServicer:
    """The RuntimeMetricService over a pod's Backend."""

    def __init__(self, backend: Backend):
        from ..proto import tpu_metrics_pb2 as mpb
        self.mpb = mpb
        self.backend = backend
        # metricsd's own gauges (tools/metrics_server.py reads them).
        self.requests_total = 0
        self.passthrough_denied_total = 0
        self.stats_mu = threading.Lock()

    # -- the pod's answers --

    def _gauge_metric(self, name: str, views: List[DeviceView],
                      value_of) -> "object":
        resp = self.mpb.MetricResponse()
        resp.metric.name = name
        for v in views:
            m = resp.metric.metrics.add()
            m.attribute.key = "device-id"
            m.attribute.value.int_attr = v.ordinal
            m.timestamp.GetCurrentTime()
            val = value_of(v)
            if isinstance(val, float):
                m.gauge.as_double = val
            else:
                m.gauge.as_int = int(val)
        return resp

    def _self_metric(self, name: str) -> "object":
        resp = self.mpb.MetricResponse()
        resp.metric.name = name
        m = resp.metric.metrics.add()
        m.timestamp.GetCurrentTime()
        with self.stats_mu:
            vals = {
                METRIC_SELF_REQUESTS: self.requests_total,
                METRIC_SELF_DENIED: self.passthrough_denied_total,
            }
        m.gauge.as_int = int(vals[name])
        return resp

    # -- RPCs (registry: metricsd/__init__.py METRICSD_RPCS) --

    def GetRuntimeMetric(self, request, context):
        with self.stats_mu:
            self.requests_total += 1
        name = request.metric_name
        if name in SELF_METRICS:
            return self._self_metric(name)
        if name == METRIC_HBM_TOTAL:
            return self._gauge_metric(
                name, self.backend.devices(),
                lambda v: v.hbm_limit_bytes or v.hbm_raw_total_bytes)
        if name == METRIC_HBM_USAGE:
            return self._gauge_metric(
                name, self.backend.devices(),
                lambda v: min(v.hbm_used_bytes,
                              v.hbm_limit_bytes or v.hbm_raw_total_bytes))
        if name == METRIC_DUTY_CYCLE:
            return self._gauge_metric(
                name, self.backend.devices(),
                lambda v: float(virtual_duty_pct(v.duty_cycle_pct,
                                                 v.core_limit_pct)))
        if name in (METRIC_SLO_ATTAINMENT, METRIC_SLO_P99):
            # The pod's own attainment or p99, on each granted ordinal; no
            # SLO source: an empty metric, never an error.
            slo = self.backend.slo_summary()
            resp = self.mpb.MetricResponse()
            resp.metric.name = name
            if slo is not None:
                val = (float(slo.get("attainment_pct", 100.0))
                       if name == METRIC_SLO_ATTAINMENT
                       else float(slo.get("p99_us", 0.0)))
                for v in self.backend.devices():
                    m = resp.metric.metrics.add()
                    m.attribute.key = "device-id"
                    m.attribute.value.int_attr = v.ordinal
                    m.timestamp.GetCurrentTime()
                    m.gauge.as_double = val
            return resp
        import grpc
        context.set_code(grpc.StatusCode.NOT_FOUND)
        if is_sensitive(name):
            with self.stats_mu:
                self.passthrough_denied_total += 1
            context.set_details(
                f"metric {name!r} is quota-sensitive and not virtualized")
        else:
            context.set_details(f"unknown metric {name!r}")
        return self.mpb.MetricResponse()

    def ListSupportedMetrics(self, request, context):
        with self.stats_mu:
            self.requests_total += 1
        resp = self.mpb.ListSupportedMetricsResponse()
        for n in (*VIRTUALIZED_METRICS, *SELF_METRICS):
            resp.supported_metric.add().metric_name = n
        return resp


def make_server(port: int, backend: Backend, host: str = "127.0.0.1"):
    """Build and start a metricsd gRPC server; returns (server, servicer,
    bound port).  Port 0 binds an ephemeral port (tests)."""
    import grpc

    from ..proto import tpu_metrics_grpc as mrpc
    servicer = MetricsdServicer(backend)
    # so_reuseport off: the one server per container is decided by a race
    # to bind (maybe_start_in_container); with grpc's default SO_REUSEPORT
    # every process would win it.
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=4,
                                   thread_name_prefix="vtpu-metricsd"),
        options=[("grpc.so_reuseport", 0)])
    mrpc.add_RuntimeMetricServiceServicer_to_server(servicer, server)
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise OSError(f"metricsd cannot bind {host}:{port}")
    server.start()
    return server, servicer, bound


def backend_from_env(env: Optional[Dict[str, str]] = None) -> Backend:
    """The backend the environment names: the fake one under
    ``VTPU_METRICSD_FAKE=1``, else the pod's region, enriched from the
    broker at ``VTPU_METRICSD_BROKER`` (else the grant's runtime socket)
    for the tenant ``VTPU_TENANT``."""
    env = dict(os.environ if env is None else env)
    if env.get("VTPU_METRICSD_FAKE") == "1":
        return FakeBackend.from_env(env)
    return RegionBackend(quota=envspec.quota_from_env(env),
                         broker_socket=env.get("VTPU_METRICSD_BROKER")
                         or env.get(envspec.ENV_RUNTIME_SOCKET),
                         tenant=env.get("VTPU_TENANT"))


_started = None
_started_mu = threading.Lock()


def maybe_start_in_container():
    """The bootstrap's entry (sitecustomize): serve the pod's metricsd
    when Allocate asked for one (``VTPU_METRICSD_PORT``).  One server per
    container, by a race to bind: every process tries, the first bind
    wins, the others go on silently.  Never raises: a broken metricsd must
    not stop the container's program; a grant it cannot serve is said on
    stderr."""
    global _started
    port_s = os.environ.get("VTPU_METRICSD_PORT", "")
    if not port_s:
        return None
    with _started_mu:
        if _started is not None:
            return _started
        try:
            port = int(port_s)
            backend = backend_from_env()
        except ValueError as exc:
            log.warn("metricsd not started: %s", exc)
            return None
        try:
            server, servicer, bound = make_server(port, backend)
        except (OSError, RuntimeError):
            # The port is taken (grpc reports a failed bind as
            # RuntimeError): another process of the container serves it.
            return None
        except Exception as exc:  # noqa: BLE001 - never break the start
            log.warn("metricsd bootstrap failed: %s", exc)
            return None
        _started = (server, servicer, bound)
        log.info("vtpu-metricsd serving MetricService on 127.0.0.1:%d",
                 bound)
        return _started


def selftest() -> int:
    """The CPU smoke test: a MetricService client against a fake tenant
    granted 40 GiB and a 50% share; checks the clamp end to end."""
    import grpc

    from ..proto import tpu_metrics_grpc as mrpc
    from ..proto import tpu_metrics_pb2 as mpb
    backend = FakeBackend()  # 40 GiB / 50% grants, 1 GiB used, duty 40%
    server, _, port = make_server(0, backend)
    try:
        ch = grpc.insecure_channel(f"localhost:{port}")
        stub = mrpc.RuntimeMetricServiceStub(ch)
        total = stub.GetRuntimeMetric(
            mpb.MetricRequest(metric_name=METRIC_HBM_TOTAL), timeout=5)
        usage = stub.GetRuntimeMetric(
            mpb.MetricRequest(metric_name=METRIC_HBM_USAGE), timeout=5)
        duty = stub.GetRuntimeMetric(
            mpb.MetricRequest(metric_name=METRIC_DUTY_CYCLE), timeout=5)
        listed = stub.ListSupportedMetrics(
            mpb.ListSupportedMetricsRequest(), timeout=5)
        ch.close()
        ok = (
            len(total.metric.metrics) == backend.n_devices
            and all(m.gauge.as_int == backend.hbm_limit_bytes
                    for m in total.metric.metrics)
            and all(m.gauge.as_int == backend.hbm_used_bytes
                    for m in usage.metric.metrics)
            and all(abs(m.gauge.as_double - 80.0) < 1e-6
                    for m in duty.metric.metrics)
            and {METRIC_HBM_TOTAL, METRIC_HBM_USAGE, METRIC_DUTY_CYCLE}
            <= {sm.metric_name for sm in listed.supported_metric}
        )
        print("metricsd selftest:",
              "ok: a client sees 40 GiB total / 1 GiB used / 80% of the "
              "share on 2 granted devices" if ok else "FAILED")
        return 0 if ok else 1
    finally:
        server.stop(grace=0.5)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="vtpu-metricsd",
        description="a pod's grant on the MetricService wire")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("VTPU_METRICSD_PORT",
                                               str(DEFAULT_PORT))))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--region", default=None,
                    help="the accounting region (default: the Allocate "
                         "env contract's)")
    ap.add_argument("--broker", default=None, metavar="SOCKET",
                    help="the broker's MAIN socket: the tenant's ledger and "
                         "SLO from its bind-free STATS and SLO (default "
                         "VTPU_METRICSD_BROKER; the tenant is VTPU_TENANT)")
    ap.add_argument("--fake", action="store_true",
                    help="a synthetic tenant (CPU tests)")
    ap.add_argument("--selftest", action="store_true",
                    help="start a fake tenant's server, query it, check "
                         "the clamp")
    ns = ap.parse_args(argv)
    if ns.selftest:
        return selftest()
    if ns.fake:
        backend: Backend = FakeBackend.from_env()
    else:
        backend = RegionBackend(
            region_path=ns.region,
            broker_socket=ns.broker or os.environ.get("VTPU_METRICSD_BROKER"),
            tenant=os.environ.get("VTPU_TENANT"))
    try:
        server, _, bound = make_server(ns.port, backend, host=ns.host)
    except (OSError, RuntimeError) as e:
        log.error("vtpu-metricsd cannot bind %s:%d: %s",
                  ns.host, ns.port, e)
        return 1
    log.info("vtpu-metricsd serving on %s:%d", ns.host, bound)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
