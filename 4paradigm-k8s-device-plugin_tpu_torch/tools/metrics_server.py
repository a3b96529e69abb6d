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

It reads the regions only; it takes no slot.  ``--broker SOCK``
(repeatable) adds each broker's per-tenant gauges over its admin socket
(STATS and SLO): the SLO plane's latency histogram per tenant, always
emitted, with trace-id exemplars, its phase quantiles, attainment, burn
and blame, the fairness gauges, the journal's, the fastlane's, the
timers' and replication's.  ``--cluster`` (the federation's gauges) waits
for ROADMAP Queue 1 item 6(d)(ii) and is refused.
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
                 metricsd: Optional[List[str]] = None,
                 brokers: Optional[List[str]] = None):
        self.scan = scan
        self.explicit = regions
        self.metricsd = metricsd or []
        self.brokers = brokers or []
        # Duty cycle: previous (busy_us, t) sample per (region, device).
        self._prev: Dict[tuple, tuple] = {}
        self.mu = threading.Lock()

    def paths(self) -> List[str]:
        return self.explicit or find_regions(self.scan)

    def collect_brokers(self) -> List[Dict]:
        """Each broker's STATS and SLO over its admin socket, scraped
        concurrently with a short budget each; a dead or wedged broker is
        skipped and never costs the scrape of the others."""
        from concurrent.futures import ThreadPoolExecutor

        from ..runtime import protocol as P
        from .vtpu_smi import request

        def scrape(sock):
            admin = sock + ".admin"
            try:
                resp = request(admin, {"kind": P.STATS}, timeout=2.0)
            except (OSError, P.ProtocolError) as e:
                log.warn("broker %s unreachable: %s", sock, e)
                return None
            if not resp.get("ok"):
                return None
            slo = None
            try:
                s = request(admin, {"kind": P.SLO}, timeout=2.0)
                if s.get("ok"):
                    slo = s
            except (OSError, P.ProtocolError) as e:
                log.warn("broker %s SLO scrape failed: %s", sock, e)
            return {"broker": sock,
                    "tenants": resp.get("tenants", {}),
                    "suspended": resp.get("suspended", []),
                    "journal": resp.get("journal") or {},
                    "fastlane": resp.get("fastlane") or {},
                    "timers": resp.get("timers") or {},
                    "replication": resp.get("replication") or {},
                    "slo": slo}

        if not self.brokers:
            return []
        with ThreadPoolExecutor(max_workers=min(len(self.brokers), 8)) as ex:
            return [r for r in ex.map(scrape, self.brokers)
                    if r is not None]

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


def broker_prometheus(brokers: List[Dict]) -> str:
    lines = [
        "# HELP vtpu_tenant_hbm_used_bytes Accounted HBM per broker "
        "tenant (incl. overshoot residency).",
        "# TYPE vtpu_tenant_hbm_used_bytes gauge",
        "# HELP vtpu_tenant_hbm_limit_bytes HBM quota per broker tenant.",
        "# TYPE vtpu_tenant_hbm_limit_bytes gauge",
        "# HELP vtpu_tenant_host_spill_bytes Host-RAM spilled bytes per "
        "tenant (oversubscription).",
        "# TYPE vtpu_tenant_host_spill_bytes gauge",
        "# HELP vtpu_tenant_staged_resident_bytes Device-resident spill "
        "copies per tenant.",
        "# TYPE vtpu_tenant_staged_resident_bytes gauge",
        "# HELP vtpu_tenant_suspended 1 when the tenant is "
        "admin-suspended.",
        "# TYPE vtpu_tenant_suspended gauge",
        "# HELP vtpu_tenant_executions_total Steps executed per tenant.",
        "# TYPE vtpu_tenant_executions_total counter",
        # The SLO plane: the end-to-end latency histogram is always
        # emitted for every known tenant, its buckets derived from the
        # broker's own sketch (a stable ~2x log grid) and trace-id
        # exemplars linking into the flight recorder when tracing is on.
        "# HELP vtpu_tenant_latency_us End-to-end broker residency per "
        "execute (enqueue to device-ready), microseconds; buckets "
        "derived from the vtpu-slo sketch.",
        "# TYPE vtpu_tenant_latency_us histogram",
        "# HELP vtpu_tenant_slo_phase_us Phase latency quantiles "
        "(queue/bucket/device/e2e) from the always-on SLO sketches.",
        "# TYPE vtpu_tenant_slo_phase_us gauge",
        "# HELP vtpu_tenant_slo_attainment_ratio Fraction of requests "
        "inside the tenant's latency objective, per burn window.",
        "# TYPE vtpu_tenant_slo_attainment_ratio gauge",
        "# HELP vtpu_tenant_slo_burn_rate SLO burn rate (violation "
        "rate over error budget), per burn window.",
        "# TYPE vtpu_tenant_slo_burn_rate gauge",
        "# HELP vtpu_tenant_slo_burn_alert 1 when the short-window "
        "burn rate crossed the alert threshold.",
        "# TYPE vtpu_tenant_slo_burn_alert gauge",
        "# HELP vtpu_tenant_slo_target_us The tenant's end-to-end "
        "latency objective (explicit grant or quota-share default).",
        "# TYPE vtpu_tenant_slo_target_us gauge",
        "# HELP vtpu_tenant_blame_us_total Noisy-neighbor blame: "
        "cumulative queue+bucket wait of `tenant` attributed to "
        "`culprit` (rows sum to the tenant's measured wait).",
        "# TYPE vtpu_tenant_blame_us_total counter",
        "# HELP vtpu_tenant_fairness_ratio Attained device-time share "
        "over quota share (1.0 = exactly proportional).",
        "# TYPE vtpu_tenant_fairness_ratio gauge",
        "# HELP vtpu_broker_fairness_jain Jain fairness index over "
        "per-tenant attainment ratios (1.0 = perfectly fair).",
        "# TYPE vtpu_broker_fairness_jain gauge",
        # The flight recorder's rollups: where a tenant's request time
        # goes, queue, token bucket or device.  Only with VTPU_TRACE=1.
        "# HELP vtpu_tenant_queue_wait_us_total Cumulative scheduler-"
        "queue wait per tenant (microseconds).",
        "# TYPE vtpu_tenant_queue_wait_us_total counter",
        "# HELP vtpu_tenant_bucket_wait_us_total Cumulative device-time "
        "token-bucket wait per tenant (microseconds).",
        "# TYPE vtpu_tenant_bucket_wait_us_total counter",
        "# HELP vtpu_tenant_device_us_total Cumulative device-phase "
        "wall time per tenant (microseconds).",
        "# TYPE vtpu_tenant_device_us_total counter",
        "# HELP vtpu_tenant_slow_op_captures Slow-op context captures "
        "currently held in the flight recorder.",
        "# TYPE vtpu_tenant_slow_op_captures gauge",
        # Journal health: a growing journal with an aging snapshot means
        # compaction stalled; recoveries, readopted and dropped tell
        # whether broker restarts are transparent to tenants.
        "# HELP vtpu_broker_journal_enabled 1 when the broker journals "
        "its state (crash-safe recovery).",
        "# TYPE vtpu_broker_journal_enabled gauge",
        "# HELP vtpu_broker_journal_size_bytes Journal log+snapshot "
        "bytes on disk.",
        "# TYPE vtpu_broker_journal_size_bytes gauge",
        "# HELP vtpu_broker_journal_last_snapshot_age_seconds Seconds "
        "since the last snapshot compaction (-1 = never).",
        "# TYPE vtpu_broker_journal_last_snapshot_age_seconds gauge",
        "# HELP vtpu_broker_recoveries_total Broker restarts that "
        "replayed a journal.",
        "# TYPE vtpu_broker_recoveries_total counter",
        "# HELP vtpu_broker_tenants_readopted_total Recovered tenants "
        "re-adopted by their reconnecting clients.",
        "# TYPE vtpu_broker_tenants_readopted_total counter",
        "# HELP vtpu_broker_tenants_recovery_dropped_total Recovered "
        "tenants dropped (dead pid, grace expiry, replaced).",
        "# TYPE vtpu_broker_tenants_recovery_dropped_total counter",
        "# HELP vtpu_broker_draining 1 while the broker refuses new "
        "tenants for a handover.",
        "# TYPE vtpu_broker_draining gauge",
        # The fastlane: which data plane each tenant is on, how deep its
        # execute ring runs, and the arenas' footprint.
        "# HELP vtpu_fastlane_ring_depth Submitted-but-uncompleted "
        "descriptors in the tenant's fastlane execute ring.",
        "# TYPE vtpu_fastlane_ring_depth gauge",
        "# HELP vtpu_fastlane_ring_steps_total Executes admitted "
        "through the fastlane ring per tenant.",
        "# TYPE vtpu_fastlane_ring_steps_total counter",
        "# HELP vtpu_fastlane_fallback_steps_total Brokered-fallback "
        "executes while a fastlane lane existed, per tenant.",
        "# TYPE vtpu_fastlane_fallback_steps_total counter",
        "# HELP vtpu_fastlane_arena_bytes Total shm tensor-arena "
        "bytes (tx+rx) mapped for the tenant's lane.",
        "# TYPE vtpu_fastlane_arena_bytes gauge",
        "# HELP vtpu_fastlane_gate Lane gate word (0 open, 1 parked, "
        "2 closed).",
        "# TYPE vtpu_fastlane_gate gauge",
        "# HELP vtpu_broker_fastlane_lanes Active fastlane lanes on "
        "the broker.",
        "# TYPE vtpu_broker_fastlane_lanes gauge",
        # Sharded lanes (vtpu's, over several cards) expose each
        # ordinal's ring; a lane of the port has one.
        "# HELP vtpu_fastlane_chip_ring_depth Per-chip-ordinal ring "
        "depth of a sharded fastlane lane.",
        "# TYPE vtpu_fastlane_chip_ring_depth gauge",
        "# HELP vtpu_fastlane_chip_ring_steps_total Per-chip-ordinal "
        "ring admissions of a sharded fastlane lane.",
        "# TYPE vtpu_fastlane_chip_ring_steps_total counter",
        "# HELP vtpu_fastlane_chip_gate Per-chip-ordinal lane gate "
        "word (0 open, 1 parked, 2 closed).",
        "# TYPE vtpu_fastlane_chip_gate gauge",
        # The timer thread's coalesced wakeups and the dispatcher's and
        # completer's idle wakeups.
        "# HELP vtpu_broker_timer_wakeups_total Coalesced timer-wheel "
        "wakeups on the broker.",
        "# TYPE vtpu_broker_timer_wakeups_total counter",
        "# HELP vtpu_broker_dispatch_idle_wakeups_total Involuntary "
        "dispatcher idle wakeups summed over chips.",
        "# TYPE vtpu_broker_dispatch_idle_wakeups_total counter",
        "# HELP vtpu_broker_completer_wakeups_total Involuntary "
        "completion-loop idle wakeups summed over chips.",
        "# TYPE vtpu_broker_completer_wakeups_total counter",
        # Replication: a stalled standby shows before the primary dies:
        # followers, the worst lag, the fence generation, takeovers.
        "# HELP vtpu_repl_followers Subscribed replication followers "
        "(hot standbys) on this broker.",
        "# TYPE vtpu_repl_followers gauge",
        "# HELP vtpu_repl_lag_records Worst follower lag in journal "
        "records (0 with no followers).",
        "# TYPE vtpu_repl_lag_records gauge",
        "# HELP vtpu_repl_lag_bytes Worst follower stream-buffer "
        "backlog in bytes.",
        "# TYPE vtpu_repl_lag_bytes gauge",
        "# HELP vtpu_repl_seq Journal records appended by this "
        "instance (the replication stream sequence).",
        "# TYPE vtpu_repl_seq counter",
        "# HELP vtpu_repl_fence_generation Epoch-fence generation this "
        "broker claimed (a bump elsewhere fences it).",
        "# TYPE vtpu_repl_fence_generation gauge",
        "# HELP vtpu_repl_takeovers_total Standby takeovers this "
        "serving instance performed.",
        "# TYPE vtpu_repl_takeovers_total counter",
    ]
    for b in brokers:
        broker = _esc(os.path.basename(b["broker"]))
        j = b.get("journal") or {}
        if j:
            bl = f'{{broker="{broker}"}}'
            dropped = (j.get("tenants_dropped_dead", 0)
                       + j.get("tenants_dropped_expired", 0)
                       + j.get("tenants_dropped_replaced", 0))
            lines.append(f'vtpu_broker_journal_enabled{bl} '
                         f'{1 if j.get("enabled") else 0}')
            lines.append(f'vtpu_broker_journal_size_bytes{bl} '
                         f'{j.get("size_bytes", 0)}')
            lines.append(
                f'vtpu_broker_journal_last_snapshot_age_seconds{bl} '
                f'{j.get("last_snapshot_age_s", -1)}')
            lines.append(f'vtpu_broker_recoveries_total{bl} '
                         f'{j.get("recoveries_total", 0)}')
            lines.append(f'vtpu_broker_tenants_readopted_total{bl} '
                         f'{j.get("tenants_readopted", 0)}')
            lines.append(
                f'vtpu_broker_tenants_recovery_dropped_total{bl} '
                f'{dropped}')
            lines.append(f'vtpu_broker_draining{bl} '
                         f'{1 if j.get("draining") else 0}')
        repl = b.get("replication") or {}
        if repl:
            bl = f'{{broker="{broker}",role="{_esc(str(repl.get("role", "primary")))}"}}'
            followers = repl.get("followers") or []
            lines.append(f'vtpu_repl_followers{bl} {len(followers)}')
            lines.append(
                f'vtpu_repl_lag_records{bl} '
                f'{max((f.get("lag_records", 0) for f in followers), default=0)}')
            lines.append(
                f'vtpu_repl_lag_bytes{bl} '
                f'{max((f.get("lag_bytes", 0) for f in followers), default=0)}')
            lines.append(f'vtpu_repl_seq{bl} {repl.get("seq", 0)}')
            lines.append(f'vtpu_repl_fence_generation{bl} '
                         f'{repl.get("fence_generation", 0)}')
            lines.append(f'vtpu_repl_takeovers_total{bl} '
                         f'{repl.get("takeovers", 0)}')
        for name, t in sorted(b["tenants"].items()):
            labels = (f'{{broker="{broker}",tenant="{_esc(name)}",'
                      f'chip="{t["chip"]}"}}')
            lines.append(f'vtpu_tenant_hbm_used_bytes{labels} '
                         f'{t["used_bytes"]}')
            lines.append(f'vtpu_tenant_hbm_limit_bytes{labels} '
                         f'{t["limit_bytes"]}')
            lines.append(f'vtpu_tenant_host_spill_bytes{labels} '
                         f'{t["host_spill_bytes"]}')
            lines.append(f'vtpu_tenant_staged_resident_bytes{labels} '
                         f'{t["staged_resident_bytes"]}')
            lines.append(f'vtpu_tenant_suspended{labels} '
                         f'{1 if t.get("suspended") else 0}')
            lines.append(f'vtpu_tenant_executions_total{labels} '
                         f'{t["executions"]}')
            # The latency histogram of every known tenant: one with no
            # SLO row yet gets a zero-count series, so dashboards never
            # gap.
            slo_rows = ((b.get("slo") or {}).get("tenants") or {})
            _emit_tenant_slo(lines, labels, name,
                             slo_rows.get(name))
            fl = t.get("fastlane")
            if fl:
                lines.append(f'vtpu_fastlane_ring_depth{labels} '
                             f'{fl.get("ring_depth", 0)}')
                lines.append(f'vtpu_fastlane_ring_steps_total{labels} '
                             f'{fl.get("ring_steps", 0)}')
                lines.append(
                    f'vtpu_fastlane_fallback_steps_total{labels} '
                    f'{fl.get("fallback_steps", 0)}')
                lines.append(f'vtpu_fastlane_arena_bytes{labels} '
                             f'{fl.get("arena_bytes", 0)}')
                lines.append(f'vtpu_fastlane_gate{labels} '
                             f'{fl.get("gate", 0)}')
                for ordv, ch in enumerate(fl.get("chips") or ()):
                    clab = (f'{{broker="{broker}",'
                            f'tenant="{_esc(name)}",'
                            f'chip_ordinal="{ordv}"}}')
                    lines.append(
                        f'vtpu_fastlane_chip_ring_depth{clab} '
                        f'{ch.get("ring_depth", 0)}')
                    lines.append(
                        f'vtpu_fastlane_chip_ring_steps_total{clab} '
                        f'{ch.get("ring_steps", 0)}')
                    lines.append(
                        f'vtpu_fastlane_chip_gate{clab} '
                        f'{ch.get("gate", 0)}')
            tr = t.get("trace")
            if tr:
                lines.append(
                    f'vtpu_tenant_queue_wait_us_total{labels} '
                    f'{tr.get("queue_wait_us_total", 0)}')
                lines.append(
                    f'vtpu_tenant_bucket_wait_us_total{labels} '
                    f'{tr.get("bucket_wait_us_total", 0)}')
                lines.append(
                    f'vtpu_tenant_device_us_total{labels} '
                    f'{tr.get("device_us_total", 0)}')
                lines.append(
                    f'vtpu_tenant_slow_op_captures{labels} '
                    f'{tr.get("slow_captures", 0)}')
        fair = ((b.get("slo") or {}).get("fairness") or {})
        for name, row in sorted((fair.get("tenants") or {}).items()):
            lines.append(
                f'vtpu_tenant_fairness_ratio{{broker="{broker}",'
                f'tenant="{_esc(name)}"}} {row.get("ratio", 0.0)}')
        if fair:
            lines.append(f'vtpu_broker_fairness_jain'
                         f'{{broker="{broker}"}} '
                         f'{fair.get("jain", 1.0)}')
        flb = b.get("fastlane") or {}
        if flb:
            lines.append(f'vtpu_broker_fastlane_lanes'
                         f'{{broker="{broker}"}} '
                         f'{flb.get("lanes", 0)}')
        tm = b.get("timers") or {}
        if tm:
            bl = f'{{broker="{broker}"}}'
            lines.append(f'vtpu_broker_timer_wakeups_total{bl} '
                         f'{(tm.get("wheel") or {}).get("wakeups", 0)}')
            lines.append(
                f'vtpu_broker_dispatch_idle_wakeups_total{bl} '
                f'{tm.get("dispatch_idle_wakeups", 0)}')
            lines.append(
                f'vtpu_broker_completer_wakeups_total{bl} '
                f'{tm.get("completer_wakeups", 0)}')
    return "\n".join(lines) + "\n" if brokers else ""


def _emit_tenant_slo(lines: List[str], labels: str, name: str,
                     row: Optional[Dict]) -> None:
    """One tenant's SLO series: the
    sketch-derived e2e histogram with trace-id exemplars, phase
    quantile gauges, per-window attainment/burn, the objective, and
    the noisy-neighbor blame counters."""
    base = labels[1:-1]  # strip braces; le/extra labels ride alongside
    buckets = (row or {}).get("e2e_buckets") or []
    count = ((row or {}).get("phases") or {}).get("e2e", {}) \
        .get("count", 0)
    sum_us = ((row or {}).get("phases") or {}).get("e2e", {}) \
        .get("sum_us", 0.0)
    # Exemplars: OpenMetrics syntax, attached to the first bucket that
    # covers the exemplar value — scrapers that predate exemplars
    # ignore everything after ' # '.
    exemplars = sorted(
        (v for v in ((row or {}).get("exemplars") or {}).values()
         if isinstance(v, (list, tuple)) and len(v) >= 3),
        key=lambda e: e[0])
    prev_le = 0.0
    for le, cum in buckets:
        line = (f'vtpu_tenant_latency_us_bucket{{{base},'
                f'le="{le}"}} {cum}')
        ex = next((e for e in exemplars
                   if prev_le < float(e[0]) <= float(le)), None)
        if ex is not None:
            line += (f' # {{trace_id="{_esc(ex[1])}"}} '
                     f'{ex[0]} {ex[2]}')
        lines.append(line)
        prev_le = float(le)
    lines.append(f'vtpu_tenant_latency_us_bucket{{{base},'
                 f'le="+Inf"}} {count}')
    lines.append(f'vtpu_tenant_latency_us_sum{{{base}}} {sum_us}')
    lines.append(f'vtpu_tenant_latency_us_count{{{base}}} {count}')
    if row is None:
        return
    for phase, ph in sorted((row.get("phases") or {}).items()):
        for q in ("p50_us", "p99_us"):
            lines.append(
                f'vtpu_tenant_slo_phase_us{{{base},phase="{phase}",'
                f'quantile="{q[:3]}"}} {ph.get(q, 0.0)}')
    for w, win in sorted((row.get("windows") or {}).items()):
        lines.append(
            f'vtpu_tenant_slo_attainment_ratio{{{base},'
            f'window_s="{w}"}} '
            f'{round(win.get("attainment_pct", 100.0) / 100.0, 4)}')
        lines.append(
            f'vtpu_tenant_slo_burn_rate{{{base},window_s="{w}"}} '
            f'{win.get("burn_rate", 0.0)}')
    obj = row.get("objective") or {}
    lines.append(f'vtpu_tenant_slo_target_us{{{base}}} '
                 f'{obj.get("target_us", 0.0)}')
    lines.append(f'vtpu_tenant_slo_burn_alert{{{base}}} '
                 f'{1 if row.get("burn_alert") else 0}')
    for culprit, us in sorted((row.get("blame") or {}).items()):
        lines.append(
            f'vtpu_tenant_blame_us_total{{{base},'
            f'culprit="{_esc(culprit)}"}} {us}')


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
                    broker_prometheus(state.collect_brokers()) + \
                    metricsd_prometheus(state.collect_metricsd())
                self._reply(200, body, "text/plain; version=0.0.4")
            elif self.path.startswith("/json"):
                doc = {"regions": state.collect(),
                       "metricsd": state.collect_metricsd()}
                if state.brokers:
                    doc["brokers"] = state.collect_brokers()
                self._reply(200, json.dumps(doc, indent=2),
                            "application/json")
            elif self.path.startswith("/healthz"):
                self._reply(200, "ok\n", "text/plain")
            else:
                self._reply(404, "not found\n", "text/plain")

    return Handler


def make_server(port: int, scan: Optional[str] = None,
                regions: Optional[List[str]] = None,
                host: str = "127.0.0.1",
                metricsd: Optional[List[str]] = None,
                brokers: Optional[List[str]] = None
                ) -> ThreadingHTTPServer:
    state = MetricsState(scan, regions or [], metricsd or [], brokers or [])
    srv = ThreadingHTTPServer((host, port), make_handler(state))
    srv.state = state  # type: ignore[attr-defined]
    return srv


REFUSED = ("is not ported to the H100 yet: the federation (ROADMAP.md, "
           "Queue 1 item 6(d)(ii))")


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
                    metavar="SOCKET",
                    help="a broker's MAIN socket (repeatable): adds its "
                         "per-tenant gauges and SLO histograms, over the "
                         "host-side admin socket")
    ap.add_argument("--cluster", default=None, metavar="SOCKET",
                    help=f"refused: {REFUSED}")
    ns = ap.parse_args(argv)
    if ns.cluster:
        ap.error(f"--cluster {REFUSED}")
    srv = make_server(ns.port, ns.scan, ns.region, ns.host, ns.metricsd,
                      ns.broker)
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
