"""vtpu-metrics: the node's Prometheus exporter over the port's regions.

``vtpu``'s ``tools/metrics_server.py``, with its metric names.  It serves
the regions' view (every pod's, with ``--scan`` over monitor mode's
shared directories) as

  GET /metrics   Prometheus text (vtpu_hbm_used_bytes, vtpu_duty_cycle_pct,
                 ...; with --metricsd, each pod's vtpu_metricsd_* gauges)
  GET /json      the same, machine-readable
  GET /healthz   liveness

  python -m vtpu_torch.tools.metrics_server --port 9431 \\
      --scan /usr/local/vtpu/shared --metricsd localhost:8431

It reads the regions only; it takes no slot.  ``--broker`` and
``--cluster`` (the broker's per-tenant gauges and the federation's) wait
for the broker's SLO plane and federation, ROADMAP Queue 1 item 6(d), and
are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from ..shim.core import SharedRegion
from ..utils import logging as log
from .vtpu_smi import find_regions


class MetricsState:
    def __init__(self, scan: Optional[str], regions: List[str],
                 metricsd: Optional[List[str]] = None):
        self.scan = scan
        self.explicit = regions
        self.metricsd = metricsd or []
        # Duty cycle: previous (busy_us, t) sample per (region, device).
        self._prev: Dict[tuple, tuple] = {}
        self.mu = threading.Lock()

    def paths(self) -> List[str]:
        return self.explicit or find_regions(self.scan)

    def collect_metricsd(self) -> List[Dict]:
        """Each pod's metricsd, over its own wire: its own gauges and what
        it tells the pod of each device.  A metricsd that does not answer
        reads up 0; it never fails the scrape."""
        from ..metricsd import server as metricsd_server
        from .vtpu_smi import metricsd_view

        out = []
        for addr in self.metricsd:
            try:
                got = metricsd_view(addr)["metrics"]
            except Exception as e:  # noqa: BLE001 - the scrape goes on
                log.warn("metricsd %s unreachable: %s", addr, e)
                out.append({"metricsd": addr, "up": 0,
                            "self": {}, "devices": {}})
                continue
            out.append({
                "metricsd": addr, "up": 1,
                "self": {n: int(got[n][-1]) for n in
                         metricsd_server.SELF_METRICS if got.get(n)},
                "devices": {n: got[n] for n in
                            metricsd_server.VIRTUALIZED_METRICS}})
        return out

    def collect(self) -> List[Dict]:
        out = []
        live_paths = set(self.paths())
        # Regions vanish under pod churn: drop their samples, or _prev
        # grows without bound.
        with self.mu:
            for k in [k for k in self._prev if k[0] not in live_paths]:
                del self._prev[k]
        for path in live_paths:
            try:
                region = SharedRegion(path)
            except OSError:
                continue
            try:
                devices = []
                now = time.monotonic()
                for d in range(region.ndevices):
                    st = region.device_stats(d)
                    key = (path, d)
                    with self.mu:
                        prev = self._prev.get(key)
                        self._prev[key] = (st.busy_us, now)
                    duty = 0.0
                    if prev is not None and now > prev[1]:
                        duty = min(
                            (st.busy_us - prev[0])
                            / ((now - prev[1]) * 1e6) * 100.0, 100.0)
                    if st.limit_bytes == 0 and st.used_bytes == 0 \
                            and st.n_procs == 0:
                        continue
                    devices.append({
                        "device": d,
                        "hbm_used_bytes": int(st.used_bytes),
                        "hbm_limit_bytes": int(st.limit_bytes),
                        "hbm_peak_bytes": int(st.peak_bytes),
                        "core_limit_pct": int(st.core_limit_pct),
                        "duty_cycle_pct": round(max(duty, 0.0), 2),
                        "n_procs": int(st.n_procs),
                        "busy_us_total": int(st.busy_us),
                    })
                procs = []
                live_pkeys = set()
                for p in region.proc_stats():
                    pinfo = {
                        "pid": int(p.pid), "host_pid": int(p.host_pid),
                        "used_bytes": [int(b) for b in
                                       p.used_bytes[:region.ndevices]],
                        "busy_us": [int(b) for b in
                                    p.busy_us[:region.ndevices]],
                    }
                    # Each process's duty: the delta of its busy_us between
                    # scrapes, keyed by HOST pid (the pids in containers
                    # collide: every pod's workload is pid 1).
                    duties = []
                    for d in range(region.ndevices):
                        pkey = (path, "proc", int(p.host_pid), d)
                        live_pkeys.add(pkey)
                        with self.mu:
                            pprev = self._prev.get(pkey)
                            self._prev[pkey] = (p.busy_us[d], now)
                        pd = 0.0
                        if pprev is not None and now > pprev[1]:
                            pd = min((p.busy_us[d] - pprev[0])
                                     / ((now - pprev[1]) * 1e6) * 100.0,
                                     100.0)
                        duties.append(round(max(pd, 0.0), 2))
                    pinfo["duty_cycle_pct"] = duties
                    procs.append(pinfo)
                # Drop the samples of exited processes.
                with self.mu:
                    for k in [k for k in self._prev
                              if len(k) == 4 and k[0] == path
                              and k not in live_pkeys]:
                        del self._prev[k]
                out.append({"region": path, "devices": devices,
                            "procs": procs})
            finally:
                region.close()
        return out


def _esc(label: str) -> str:
    """Prometheus label escaping: a quote or newline in a label a pod
    controls would corrupt the whole scrape."""
    return (str(label).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def metricsd_prometheus(items: List[Dict]) -> str:
    """Each pod's metricsd: liveness, its request and denial counters,
    and the values it serves the pod per device."""
    if not items:
        return ""
    lines = [
        "# HELP vtpu_metricsd_up 1 when the tenant metricsd answers its "
        "MetricService port.",
        "# TYPE vtpu_metricsd_up gauge",
        "# HELP vtpu_metricsd_requests_total MetricService RPCs served.",
        "# TYPE vtpu_metricsd_requests_total counter",
        "# HELP vtpu_metricsd_passthrough_denied_total Quota-sensitive "
        "metric requests refused instead of proxied.",
        "# TYPE vtpu_metricsd_passthrough_denied_total counter",
        "# HELP vtpu_metricsd_virtual_value The quota-virtualized value "
        "served to the tenant, per metric name and device ordinal.",
        "# TYPE vtpu_metricsd_virtual_value gauge",
    ]
    suffix = {
        "vtpu.metricsd.requests.total": "requests_total",
        "vtpu.metricsd.passthrough.denied.total": "passthrough_denied_total",
    }
    for item in items:
        tgt = _esc(item["metricsd"])
        lines.append(f'vtpu_metricsd_up{{target="{tgt}"}} {item["up"]}')
        for name, val in sorted(item["self"].items()):
            lines.append(
                f'vtpu_metricsd_{suffix[name]}{{target="{tgt}"}} {val}')
        for name, per_dev in sorted(item["devices"].items()):
            for dev, val in sorted(per_dev.items()):
                lines.append(
                    f'vtpu_metricsd_virtual_value{{target="{tgt}",'
                    f'metric="{_esc(name)}",device="{dev}"}} {val}')
    return "\n".join(lines) + "\n"


def to_prometheus(infos: List[Dict]) -> str:
    lines = [
        "# HELP vtpu_hbm_used_bytes Accounted HBM usage per vTPU device.",
        "# TYPE vtpu_hbm_used_bytes gauge",
        "# HELP vtpu_hbm_limit_bytes HBM quota per vTPU device.",
        "# TYPE vtpu_hbm_limit_bytes gauge",
        "# HELP vtpu_duty_cycle_pct Device busy percentage since last "
        "scrape.",
        "# TYPE vtpu_duty_cycle_pct gauge",
        "# HELP vtpu_busy_us_total Cumulative device busy microseconds.",
        "# TYPE vtpu_busy_us_total counter",
        "# HELP vtpu_procs Live processes accounted on the device.",
        "# TYPE vtpu_procs gauge",
        "# HELP vtpu_proc_busy_us_total Cumulative device busy "
        "microseconds per process (tenant attribution).",
        "# TYPE vtpu_proc_busy_us_total counter",
    ]
    for info in infos:
        region = os.path.basename(os.path.dirname(info["region"])) or \
            os.path.basename(info["region"])
        for d in info["devices"]:
            labels = f'{{region="{region}",device="{d["device"]}"}}'
            lines.append(f'vtpu_hbm_used_bytes{labels} '
                         f'{d["hbm_used_bytes"]}')
            lines.append(f'vtpu_hbm_limit_bytes{labels} '
                         f'{d["hbm_limit_bytes"]}')
            lines.append(f'vtpu_duty_cycle_pct{labels} '
                         f'{d["duty_cycle_pct"]}')
            lines.append(f'vtpu_busy_us_total{labels} '
                         f'{d["busy_us_total"]}')
            lines.append(f'vtpu_procs{labels} {d["n_procs"]}')
        for p in info.get("procs", []):
            for d, busy in enumerate(p.get("busy_us", [])):
                if not busy:
                    continue
                # The host pid: unique across containers.
                labels = (f'{{region="{region}",device="{d}",'
                          f'pid="{p["host_pid"]}"}}')
                lines.append(f'vtpu_proc_busy_us_total{labels} {busy}')
    return "\n".join(lines) + "\n"


def make_handler(state: MetricsState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: D401 - quiet
            pass

        def _reply(self, code: int, body: str, ctype: str):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 - stdlib API
            if self.path.startswith("/metrics"):
                body = to_prometheus(state.collect()) + \
                    metricsd_prometheus(state.collect_metricsd())
                self._reply(200, body, "text/plain; version=0.0.4")
            elif self.path.startswith("/json"):
                self._reply(200, json.dumps(
                    {"regions": state.collect(),
                     "metricsd": state.collect_metricsd()}, indent=2),
                    "application/json")
            elif self.path.startswith("/healthz"):
                self._reply(200, "ok\n", "text/plain")
            else:
                self._reply(404, "not found\n", "text/plain")

    return Handler


def make_server(port: int, scan: Optional[str] = None,
                regions: Optional[List[str]] = None,
                host: str = "127.0.0.1",
                metricsd: Optional[List[str]] = None
                ) -> ThreadingHTTPServer:
    state = MetricsState(scan, regions or [], metricsd or [])
    srv = ThreadingHTTPServer((host, port), make_handler(state))
    srv.state = state  # type: ignore[attr-defined]
    return srv


REFUSED = ("is not ported to the H100 yet: the broker's SLO plane and its "
           "federation (ROADMAP.md, Queue 1 item 6(d))")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="vtpu-metrics")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("VTPU_METRICS_PORT", "8431")))
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--scan", default=None,
                    help="directory of per-pod shared regions (node mode)")
    ap.add_argument("--region", action="append", default=[])
    ap.add_argument("--metricsd", action="append", default=[],
                    metavar="HOST:PORT",
                    help="a pod's vtpu-metricsd (repeatable): adds its "
                         "vtpu_metricsd_* gauges")
    ap.add_argument("--broker", action="append", default=[],
                    help=f"refused: {REFUSED}")
    ap.add_argument("--cluster", default=None, metavar="SOCKET",
                    help=f"refused: {REFUSED}")
    ns = ap.parse_args(argv)
    for flag in ("broker", "cluster"):
        if getattr(ns, flag):
            ap.error(f"--{flag} {REFUSED}")
    srv = make_server(ns.port, ns.scan, ns.region, ns.host, ns.metricsd)
    log.info("vtpu-metrics serving on %s:%d (/metrics /json /healthz)",
             ns.host, srv.server_address[1])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
