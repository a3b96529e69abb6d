"""vtpu-smi: caps, ledgers and processes over the port's accounting regions.

``vtpu``'s ``tools/vtpu_smi.py``, the node's tool (``shim/vtpu_smi_lite.py``
is the pod's, mounted in every granted container).  Run in a container
it finds the region from ``VTPU_DEVICE_MEMORY_SHARED_CACHE``; on the node,
``--scan`` over monitor mode's ``/usr/local/vtpu/shared`` shows every
pod's region.  It never takes a slot in a region.

  vtpu-smi                                   # the container's region
  vtpu-smi --scan /usr/local/vtpu/shared     # every pod on the node
  vtpu-smi --json                            # machine-readable
  vtpu-smi --sweep-host                      # free dead host pids' slots
  vtpu-smi metricsd [HOST:PORT]              # what a pod's metricsd says
  vtpu-smi trace [TENANT] --broker SOCK [--dump chrome.json]
  vtpu-smi leases [--lease-file PATH]        # who holds the node's cards
  vtpu-smi top --broker SOCK [--once]        # the SLO plane, per tenant
  vtpu-smi --broker SOCK --broker-stats      # and --suspend/--resume T,
                                             # --resize T --hbm Q --core P,
                                             # --drain, --handover, --shutdown,
                                             # --repl-status

``trace`` reads the broker's flight recorder over its main socket
(bind-free, like STATS); with ``--dump`` it merges the native event rings
(``<region>.trace.<pid>``, ``collect_ring_events``) of the regions given
by ``--region``/``--scan`` into the Chrome trace.  ``--broker-stats``
prints the STATS reply: a row per tenant, with its fastlane block (ring
and socket steps, depth, gate, arenas, metered device time) when it has a
lane, and the lanes' rollup.  ``top`` joins the admin socket's SLO reply
(every tenant's phases, attainment, burn and top blamer, the fairness
report) with its STATS; ``--repl-status`` prints the replication block
(role, followers and their lag, the fence generation, takeovers).  The
admin verbs go to ``SOCK.admin``.  What waits for its module is refused
with a message that names its ROADMAP Queue 1 item, never silently absent:
``cluster`` and the admin flags ``--migrate``, ``--device``,
``--migrate-to`` and ``--chips`` for 6(d)(ii); the analyzers (``analyze``,
``mc``, ``wmm``, ``dmc``, ``chaos``) for item 7.

Run as: python -m vtpu_torch.tools.vtpu_smi
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from ..shim.core import SharedRegion
from ..utils import envspec

TITLE = "| vtpu-smi — vGPU quota monitor"

# Sub-commands of vtpu's that are not ported yet: name -> ROADMAP Queue 1
# item.
REFUSED_COMMANDS = {"cluster": "6(d)(ii)", "analyze": "7", "mc": "7",
                    "wmm": "7", "dmc": "7", "chaos": "7"}
# The broker's admin flags that wait for migration.
REFUSED_FLAGS = ("--migrate", "--device", "--migrate-to", "--chips")


def refusal(what: str, item: str) -> str:
    return (f"vtpu-smi: {what} is not ported to the H100 yet (ROADMAP.md, "
            f"Queue 1 item {item})")


def find_regions(scan: Optional[str]) -> List[str]:
    if scan:
        pats = [os.path.join(scan, "*", "vtpushr.cache"),
                os.path.join(scan, "*", "vtpushr.cache.chip*"),
                os.path.join(scan, "*.cache"),
                os.path.join(scan, "*.cache.chip*"),
                os.path.join(scan, "*.shr"),
                os.path.join(scan, "*.shr.chip*")]
        out: List[str] = []
        for pat in pats:
            out.extend(sorted(glob.glob(pat)))
        return out
    env_path = os.environ.get(envspec.ENV_SHARED_CACHE)
    if env_path and os.path.exists(env_path):
        return [env_path] + sorted(glob.glob(env_path + ".chip*"))
    return sorted(glob.glob("/tmp/vtpu*.cache")
                  + glob.glob("/tmp/vtpu*.cache.chip*"))


def read_region(path: str, sweep_host: bool = False) -> Dict:
    r = SharedRegion(path)
    try:
        if sweep_host:
            r.sweep_dead_host()
        devices = []
        for d in range(r.ndevices):
            st = r.device_stats(d)
            devices.append({
                "device": d,
                "limit_bytes": int(st.limit_bytes),
                "used_bytes": int(st.used_bytes),
                "peak_bytes": int(st.peak_bytes),
                "core_limit_pct": int(st.core_limit_pct),
                "n_procs": int(st.n_procs),
            })
        procs = []
        for st in r.proc_stats():
            procs.append({
                "pid": int(st.pid),
                "host_pid": int(st.host_pid),
                "used_bytes": [int(b) for b in
                               st.used_bytes[:r.ndevices]],
                # per-device cumulative device time: which process uses
                # the card
                "busy_us": [int(b) for b in st.busy_us[:r.ndevices]],
            })
        return {"region": path, "devices": devices, "procs": procs}
    finally:
        r.close()


def _mb(n: int) -> str:
    return f"{n / 2**20:,.0f}MiB"


def render(infos: List[Dict]) -> str:
    lines = []
    lines.append("+" + "-" * 74 + "+")
    lines.append(TITLE + " " * (75 - len(TITLE)) + "|")
    lines.append("+" + "-" * 74 + "+")
    for info in infos:
        lines.append(f"| region: {info['region'][:64]:<64} |")
        lines.append("| dev |       used /      limit (      peak) "
                     "| core% | procs |" + " " * 12 + "|")
        for d in info["devices"]:
            if d["limit_bytes"] == 0 and d["used_bytes"] == 0 \
                    and d["n_procs"] == 0:
                continue
            lim = _mb(d["limit_bytes"]) if d["limit_bytes"] else "unlimited"
            core = f"{d['core_limit_pct']}%" if d["core_limit_pct"] else "-"
            row = (f"| {d['device']:>3} | {_mb(d['used_bytes']):>10} / "
                   f"{lim:>10} ({_mb(d['peak_bytes']):>10}) "
                   f"| {core:>5} | {d['n_procs']:>5} |")
            lines.append(row + " " * max(0, 76 - len(row)) + "|")
        for p in info["procs"]:
            used = sum(p["used_bytes"])
            busy = sum(p.get("busy_us", []))
            row = (f"|   pid {p['pid']:>7} (host {p['host_pid']:>7}) "
                   f"uses {_mb(used):>10}  busy {busy / 1e6:>8.1f}s")
            lines.append(row + " " * max(0, 75 - len(row)) + "|")
        lines.append("+" + "-" * 74 + "+")
    if not infos:
        lines.append("no vTPU accounting regions found")
    return "\n".join(lines)


def request(path: str, msg: dict, timeout: float = 10.0) -> dict:
    """One request and its reply over a broker socket (bind-free STATS
    and TRACE on the main one, the admin verbs on ``<socket>.admin``)."""
    import socket as socketmod

    from ..runtime import protocol as P
    s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        P.send_msg(s, msg)
        return P.recv_msg(s)
    finally:
        s.close()


def collect_ring_events(paths: List[str]) -> List[dict]:
    """The native ring events (rate waits, refused memory admits) of the
    ``<region>.trace.<pid>`` files beside the given regions, in time
    order, each with its ring's pid and path."""
    from ..shim.core import TraceRing
    out: List[dict] = []
    for rp in paths:
        for ring_path in sorted(glob.glob(rp + ".trace.*")):
            try:
                pid = int(ring_path.rsplit(".", 1)[-1])
            except ValueError:
                pid = 0
            try:
                with TraceRing(ring_path) as ring:
                    evs, _ = ring.read(0, 4096)
            except OSError as e:
                print(f"skipping ring {ring_path}: {e}", file=sys.stderr)
                continue
            for ev in evs:
                ev["pid"] = pid
                ev["ring"] = ring_path
            out.extend(evs)
    out.sort(key=lambda e: e.get("t_ns", 0))
    return out


def cmd_trace(ns, paths: List[str]) -> int:
    """``vtpu-smi trace [TENANT]``: the flight recorder's spans and
    slow-op captures, as text, ``--json``, or ``--dump FILE`` (Chrome
    trace, for chrome://tracing or Perfetto)."""
    from ..runtime import protocol as P
    from ..runtime import trace as tracing
    if not ns.broker:
        print("trace needs --broker <main socket>", file=sys.stderr)
        return 2
    msg: dict = {"kind": P.TRACE}
    if ns.cmd_arg:
        msg["tenant"] = ns.cmd_arg
    if ns.limit:
        msg["limit"] = ns.limit
    resp = request(ns.broker, msg)
    if not resp.get("ok"):
        print(json.dumps(resp, indent=2))
        return 1
    tenants = resp.get("tenants", {})
    if ns.dump:
        doc = tracing.chrome_trace(tenants, collect_ring_events(paths))
        with open(ns.dump, "w") as f:
            json.dump(doc, f)
        print(f"wrote {len(doc['traceEvents'])} trace events to {ns.dump} "
              "(load in chrome://tracing or Perfetto)")
        return 0
    if ns.json:
        print(json.dumps(resp, indent=2))
        return 0
    if not resp.get("enabled"):
        print("tracing is disabled on this broker (set VTPU_TRACE=1)")
    for name, body in sorted(tenants.items()):
        spans = body.get("spans", [])
        caps = body.get("captures", [])
        print(f"tenant {name}: {len(spans)} spans, {len(caps)} slow-op "
              "captures")
        for sp in spans[-(ns.limit or 10):]:
            print(f"  {sp.get('trace', '-'):>16} {sp.get('key', '?'):<12}"
                  f" queue {sp.get('queue_us', 0):>9.0f}us"
                  f" bucket {sp.get('bucket_us', 0):>9.0f}us"
                  f" device {sp.get('device_us', 0):>9.0f}us"
                  f" total {sp.get('total_us', 0):>9.0f}us"
                  + (" ERROR" if sp.get("error") else ""))
        for cap in caps[-3:]:
            ctx = cap.get("context", {})
            print(f"  SLOW {cap.get('factor')}x est {cap.get('est_us')}us: "
                  f"qdepth={ctx.get('queue_depth')} bucket="
                  f"{ctx.get('bucket_level_us')}us hbm_free="
                  f"{ctx.get('hbm_headroom_bytes')} co="
                  f"{','.join(ctx.get('co_tenants', [])) or '-'}")
    return 0


def cmd_leases(ns) -> int:
    """``vtpu-smi leases``: the lease sidecar's holder of the node's
    cards, its liveness and heartbeat age; exit 1 when one is stale."""
    from ..runtime import trace as tracing
    out = []
    for p in ns.lease_file or [tracing.lease_sidecar_path()]:
        diag = tracing.diagnose_lease(p)
        diag["sidecar"] = p
        out.append(diag)
    if ns.json:
        print(json.dumps(out, indent=2))
    else:
        for diag in out:
            print(f"{diag['sidecar']}: "
                  f"{tracing.format_lease_diagnosis(diag)}")
    return 1 if any(d.get("stale") for d in out) else 0


def _top_rows(slo_resp: dict, stats_resp: dict) -> List[Dict]:
    """One SLO reply joined with one STATS reply into renderable rows."""
    rows = []
    stats = (stats_resp or {}).get("tenants") or {}
    for name, body in sorted((slo_resp.get("tenants") or {}).items()):
        ph = body.get("phases", {})
        wins = body.get("windows", {})
        short = wins[min(wins, key=float)] if wins else {}
        fair = ((slo_resp.get("fairness") or {}).get("tenants")
                or {}).get(name, {})
        st = stats.get(name, {})
        rows.append({
            "tenant": name,
            "steps_per_s": short.get("steps_per_s", 0.0),
            "p50_queue_us": ph.get("queue", {}).get("p50_us", 0.0),
            "p99_queue_us": ph.get("queue", {}).get("p99_us", 0.0),
            "p50_e2e_us": ph.get("e2e", {}).get("p50_us", 0.0),
            "p99_e2e_us": ph.get("e2e", {}).get("p99_us", 0.0),
            "p99_device_us": ph.get("device", {}).get("p99_us", 0.0),
            "attainment_pct": short.get("attainment_pct", 100.0),
            "burn_rate": short.get("burn_rate", 0.0),
            "burn_alert": body.get("burn_alert", False),
            "fair_ratio": fair.get("ratio"),
            "top_blamer": body.get("top_blamer"),
            "hbm_used": st.get("used_bytes", 0),
            "suspended": st.get("suspended", False),
            # vtpu's burst credits, preemption and shedding (6(f)) read 0
            # here until they are ported.
            "credit_ms": round(st.get("credit_us", 0) / 1e3, 1),
            "preempted": st.get("preempted", False),
            "preemptions": st.get("preemptions", 0),
            "shed": st.get("shed_total", 0),
            "fastlane": st.get("fastlane"),
        })
    rows.sort(key=lambda r: -r["steps_per_s"])
    return rows


def render_top(rows: List[Dict], enabled: bool = True,
               jain: Optional[float] = None) -> str:
    """The per-tenant SLO table (``vtpu``'s columns)."""
    hdr = (f"{'TENANT':<18} {'STEPS/S':>8} {'P50 E2E':>9} "
           f"{'P99 E2E':>9} {'P99 QUE':>9} {'P99 DEV':>9} "
           f"{'ATTAIN%':>8} {'BURN':>6} {'FAIR':>5} {'CREDIT':>8} "
           f"{'SHED':>5} {'PLANE':>6} {'TOP BLAMER':<16}")
    lines = ["vtpu-smi top — per-tenant SLO / fairness / blame"
             + (f"  (jain={jain})" if jain is not None else "")
             + ("" if enabled else "  [SLO PLANE DISABLED: VTPU_SLO=0]"),
             hdr, "-" * len(hdr)]
    for r in rows:
        # '!' burn alert, 's' admin-suspended, 'p' preemption-parked.
        flag = "!" if r["burn_alert"] else (
            "s" if r["suspended"] else (
                "p" if r.get("preempted") else " "))
        fair = (f"{r['fair_ratio']:.2f}" if r["fair_ratio"] is not None
                else "-")
        credit = f"{r.get('credit_ms', 0):.0f}ms"
        # The data plane: 'ring' with an open lane, 'held' while its gate
        # is parked, 'sock' with no lane or a closed one.
        fl = r.get("fastlane")
        plane = "sock"
        if fl:
            g = fl.get("gate", 2)
            if g == 0:
                plane = "ring"
            elif g == 1:
                plane = "held"
        lines.append(
            f"{r['tenant'][:17]:<17}{flag} {r['steps_per_s']:>8.1f} "
            f"{r['p50_e2e_us']:>9.0f} {r['p99_e2e_us']:>9.0f} "
            f"{r['p99_queue_us']:>9.0f} {r['p99_device_us']:>9.0f} "
            f"{r['attainment_pct']:>8.2f} {r['burn_rate']:>6.1f} "
            f"{fair:>5} {credit:>8} {r.get('shed', 0):>5} "
            f"{plane:>6} {(r['top_blamer'] or '-')[:16]:<16}")
    if not rows:
        lines.append("(no tenants with SLO history)")
    return "\n".join(lines)


def cmd_top(ns) -> int:
    """``vtpu-smi top``: the per-tenant table (steps/s, p50/p99 by phase,
    attainment, burn rate, the top noisy neighbour) from the broker's SLO
    plane over the admin socket.  ``--once`` prints one snapshot;
    ``--fake`` renders a synthetic plane (no broker)."""
    import time as timemod

    from ..runtime import protocol as P
    from ..runtime import slo as slo_lib
    if ns.fake:
        rep = slo_lib.fairness_smoke(n_tenants=8, seed=3)
        plane = slo_lib.SloPlane(enabled=True, windows=(30.0,),
                                 budget=0.01)
        for i in range(8):
            name = f"fake-{i}"
            plane.ensure_tenant(name, quota_pct=50)
            for _ in range(64):
                plane.record(name, queue_us=100.0 * (i + 1),
                             bucket_us=10.0, device_us=500.0,
                             total_us=110.0 * (i + 1) + 500.0,
                             wait_weights={f"fake-{(i + 1) % 8}": 1.0})
        plane_rep = plane.report(
            admin=True, quota_pcts={f"fake-{i}": 50 for i in range(8)})
        rows = _top_rows(plane_rep, {})
        if ns.json:
            print(json.dumps({"smoke": rep, "rows": rows}, indent=2))
        else:
            print(render_top(rows, jain=plane_rep["fairness"]["jain"]))
        return 0 if rep["ok"] else 1
    if not ns.broker:
        print("top needs --broker <main socket> (or --fake)",
              file=sys.stderr)
        return 2
    path = ns.broker + ".admin"
    while True:
        slo_resp = request(path, {"kind": P.SLO})
        if not slo_resp.get("ok"):
            print(json.dumps(slo_resp, indent=2))
            return 1
        stats_resp = request(path, {"kind": P.STATS})
        rows = _top_rows(slo_resp, stats_resp)
        if ns.json:
            print(json.dumps({"rows": rows,
                              "fairness": slo_resp.get("fairness")},
                             indent=2))
        else:
            if not ns.once:
                print("\033[2J\033[H", end="")
            print(render_top(
                rows, enabled=slo_resp.get("enabled", False),
                jain=(slo_resp.get("fairness") or {}).get("jain")))
        if ns.once:
            return 0
        timemod.sleep(max(ns.interval, 0.2))


def cmd_admin(ns) -> int:
    """The broker's admin verbs over ``<broker>.admin``; prints the
    reply, exit 0 when it is ok."""
    from ..runtime import protocol as P
    path = ns.broker + ".admin"
    if ns.suspend:
        msg = {"kind": P.SUSPEND, "tenant": ns.suspend}
    elif ns.resume:
        msg = {"kind": P.RESUME, "tenant": ns.resume}
    elif ns.resize:
        msg = {"kind": P.RESIZE, "tenant": ns.resize}
        if ns.hbm is not None:
            msg["hbm_limit"] = envspec.parse_quantity(ns.hbm)
        if ns.core is not None:
            msg["core_limit"] = int(ns.core)
    elif ns.repl_status:
        msg = {"kind": P.REPL_SYNC, "status": True}
    elif ns.broker_stats:
        msg = {"kind": P.STATS}
    elif ns.drain or ns.handover:
        msg = {"kind": P.DRAIN if ns.drain else P.HANDOVER}
    elif ns.shutdown:
        msg = {"kind": P.SHUTDOWN}
    else:
        print("--broker needs --suspend/--resume/--resize/--repl-status/"
              "--broker-stats/--drain/--handover/--shutdown",
              file=sys.stderr)
        return 2
    resp = request(path, msg, timeout=90.0)
    print(json.dumps(resp, indent=2))
    return 0 if resp.get("ok") else 1


def metricsd_view(addr: str) -> Dict:
    """Every metric a pod's metricsd at ``addr`` serves, as
    ``{"metricsd", "supported", "metrics": {name: {device: value}}}``
    (device -1 for a metric with no device).  Raises grpc.RpcError when
    it does not answer."""
    import grpc

    from ..metricsd import server as metricsd_server
    from ..proto import tpu_metrics_grpc as mrpc
    from ..proto import tpu_metrics_pb2 as mpb
    ch = grpc.insecure_channel(addr)
    stub = mrpc.RuntimeMetricServiceStub(ch)
    out: Dict = {"metricsd": addr, "metrics": {}}
    try:
        listed = stub.ListSupportedMetrics(
            mpb.ListSupportedMetricsRequest(), timeout=3.0)
        out["supported"] = [sm.metric_name
                            for sm in listed.supported_metric]
        for name in metricsd_server.VIRTUALIZED_METRICS + \
                metricsd_server.SELF_METRICS:
            resp = stub.GetRuntimeMetric(
                mpb.MetricRequest(metric_name=name), timeout=3.0)
            vals = {}
            for m in resp.metric.metrics:
                dev = int(m.attribute.value.int_attr) \
                    if m.attribute.key else -1
                vals[dev] = (m.gauge.as_double
                             if m.gauge.WhichOneof("value") == "as_double"
                             else int(m.gauge.as_int))
            out["metrics"][name] = vals
    finally:
        ch.close()
    return out


def cmd_metricsd(ns) -> int:
    """``vtpu-smi metricsd [ADDR]``: ask a pod's metricsd over its own
    wire and print what it tells the pod (default: localhost at
    ``VTPU_METRICSD_PORT``, the container's own)."""
    import grpc

    from ..metricsd import DEFAULT_PORT
    from ..metricsd import server as metricsd_server
    addr = ns.cmd_arg \
        or f"localhost:{os.environ.get('VTPU_METRICSD_PORT', DEFAULT_PORT)}"
    try:
        out = metricsd_view(addr)
    except grpc.RpcError as e:
        print(f"metricsd {addr} unreachable: {e.code().name}",
              file=sys.stderr)
        return 1
    if ns.json:
        print(json.dumps(out, indent=2))
        return 0
    print(f"vtpu-metricsd @ {addr} (the pod's view of its grant)")
    totals = out["metrics"].get(metricsd_server.METRIC_HBM_TOTAL, {})
    usages = out["metrics"].get(metricsd_server.METRIC_HBM_USAGE, {})
    duties = out["metrics"].get(metricsd_server.METRIC_DUTY_CYCLE, {})
    print(f"{'Dev':<5} {'HBM usage':<26} {'Duty (of share)':<16}")
    for dev in sorted(totals):
        used, total = usages.get(dev, 0), totals[dev]
        print(f"{dev:<5} {_mb(used) + ' / ' + _mb(total):<26} "
              f"{str(duties.get(dev, 0.0)) + '%':<16}")
    reqs = out["metrics"].get(metricsd_server.METRIC_SELF_REQUESTS, {})
    denied = out["metrics"].get(metricsd_server.METRIC_SELF_DENIED, {})
    print(f"requests served: {sum(reqs.values())}, "
          f"quota-sensitive requests denied: {sum(denied.values())}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="vtpu-smi")
    ap.add_argument("cmd", nargs="?", default=None,
                    choices=("metricsd", "trace", "leases", "top",
                             *REFUSED_COMMANDS),
                    help="metricsd: what a pod's metricsd serves it; trace: "
                         "the broker's flight recorder; leases: who holds "
                         "the node's cards; top: the broker's SLO plane, "
                         "per tenant (--broker; --once, --fake); the others "
                         "are vtpu's federation and analyzer commands, not "
                         "ported yet")
    ap.add_argument("cmd_arg", nargs="?", default=None,
                    help="HOST:PORT for `metricsd`, TENANT for `trace`")
    ap.add_argument("--dump", default=None, metavar="FILE",
                    help="with `trace`: write a Chrome trace")
    ap.add_argument("--limit", type=int, default=0,
                    help="with `trace`: newest N spans per tenant")
    ap.add_argument("--lease-file", action="append", default=[],
                    metavar="PATH",
                    help="with `leases`: sidecar path(s); default "
                         "VTPU_LEASE_SIDECAR")
    ap.add_argument("--scan", default=None,
                    help="directory of per-pod shared regions (node mode)")
    ap.add_argument("--region", action="append", default=[],
                    help="explicit region file (repeatable)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--once", action="store_true",
                    help="with `top`: print one snapshot and exit")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="with `top`: the refresh period, seconds")
    ap.add_argument("--fake", action="store_true",
                    help="with `top`: a synthetic SLO plane (no broker)")
    ap.add_argument("--sweep-host", action="store_true",
                    help="reclaim slots of dead host pids (node mode only)")
    ap.add_argument("--broker", default=None, metavar="SOCKET",
                    help="the broker's MAIN socket; enables the admin verbs "
                         "below (over SOCKET.admin, host-only)")
    ap.add_argument("--suspend", default=None, metavar="TENANT",
                    help="hold TENANT's queue")
    ap.add_argument("--resume", default=None, metavar="TENANT")
    ap.add_argument("--resize", default=None, metavar="TENANT",
                    help="resize TENANT's grant live (journaled); with "
                         "--hbm and/or --core")
    ap.add_argument("--hbm", default=None, metavar="QTY",
                    help="with --resize: the new HBM cap (K8s quantity)")
    ap.add_argument("--core", type=int, default=None, metavar="PCT",
                    help="with --resize: the new compute share (0-100; 0 "
                         "unmetered)")
    ap.add_argument("--broker-stats", action="store_true",
                    help="per-tenant broker stats, with the journal's")
    ap.add_argument("--repl-status", action="store_true",
                    help="the replication block: role, followers and their "
                         "lag, the fence generation, takeovers")
    ap.add_argument("--drain", action="store_true",
                    help="refuse new tenants, quiesce and commit a final "
                         "journal snapshot")
    ap.add_argument("--handover", action="store_true",
                    help="--drain, then exit for the successor broker, "
                         "which recovers the journal")
    ap.add_argument("--shutdown", action="store_true",
                    help="stop the broker without the drain")
    for flag in REFUSED_FLAGS:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    # A refused sub-command is refused whatever its own options are.
    ns, rest = ap.parse_known_args(argv)
    if ns.cmd in REFUSED_COMMANDS:
        print(refusal(f"`vtpu-smi {ns.cmd}`", REFUSED_COMMANDS[ns.cmd]),
              file=sys.stderr)
        return 2
    if rest:
        ap.error("unrecognized arguments: " + " ".join(rest))
    given = [f for f in REFUSED_FLAGS
             if getattr(ns, f[2:].replace("-", "_"))]
    if given:
        print(refusal(", ".join(given) + " (migration)", "6(d)(ii)"),
              file=sys.stderr)
        return 2
    if ns.cmd == "metricsd":
        return cmd_metricsd(ns)
    if ns.cmd == "trace":
        return cmd_trace(ns, ns.region or find_regions(ns.scan))
    if ns.cmd == "leases":
        return cmd_leases(ns)
    if ns.cmd == "top":
        return cmd_top(ns)
    admin = (ns.suspend or ns.resume or ns.resize or ns.broker_stats
             or ns.repl_status or ns.drain or ns.handover or ns.shutdown)
    if admin and not ns.broker:
        ap.error("--suspend/--resume/--resize/--repl-status/--broker-stats/"
                 "--drain/--handover/--shutdown need --broker <main socket>")
    if ns.broker:
        return cmd_admin(ns)

    paths = ns.region or find_regions(ns.scan)
    infos = []
    for p in paths:
        try:
            infos.append(read_region(p, ns.sweep_host))
        except OSError as e:
            print(f"skipping {p}: {e}", file=sys.stderr)
    if ns.json:
        print(json.dumps(infos, indent=2))
    else:
        print(render(infos))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
