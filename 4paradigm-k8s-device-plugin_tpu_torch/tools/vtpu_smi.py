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

The broker's sub-commands wait for their modules: ``trace`` and
``leases`` for ROADMAP Queue 1 item 6(b), ``top`` and ``cluster`` for
6(d); so do its admin flags (``--broker`` and its verbs, with DRAIN and
HANDOVER), for 6(b); the analyzers (``analyze``, ``mc``, ``wmm``, ``dmc``,
``chaos``) for item 7.  Each is refused with a message that names its
item, never silently absent.

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
REFUSED_COMMANDS = {"trace": "6(b)", "leases": "6(b)", "top": "6(d)",
                    "cluster": "6(d)", "analyze": "7", "mc": "7", "wmm": "7",
                    "dmc": "7", "chaos": "7"}
# The broker's admin surface: flags with a value, and switches.
BROKER_FLAGS = ("--broker", "--suspend", "--resume", "--resize", "--hbm",
                "--core", "--migrate", "--device", "--migrate-to", "--chips")
BROKER_SWITCHES = ("--repl-status", "--broker-stats", "--drain",
                   "--handover", "--shutdown")


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
                    choices=("metricsd", *REFUSED_COMMANDS),
                    help="metricsd: what a pod's metricsd serves it; the "
                         "others are vtpu's broker and analyzer commands, "
                         "not ported yet")
    ap.add_argument("cmd_arg", nargs="?", default=None,
                    help="HOST:PORT for `metricsd`")
    ap.add_argument("--scan", default=None,
                    help="directory of per-pod shared regions (node mode)")
    ap.add_argument("--region", action="append", default=[],
                    help="explicit region file (repeatable)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--sweep-host", action="store_true",
                    help="reclaim slots of dead host pids (node mode only)")
    for flag in BROKER_FLAGS:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in BROKER_SWITCHES:
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    # A refused sub-command is refused whatever its own options are.
    ns, rest = ap.parse_known_args(argv)
    if ns.cmd in REFUSED_COMMANDS:
        print(refusal(f"`vtpu-smi {ns.cmd}`", REFUSED_COMMANDS[ns.cmd]),
              file=sys.stderr)
        return 2
    if rest:
        ap.error("unrecognized arguments: " + " ".join(rest))
    given = [f for f in BROKER_FLAGS + BROKER_SWITCHES
             if getattr(ns, f[2:].replace("-", "_"))]
    if given:
        print(refusal(", ".join(given) + " (the broker's admin surface)",
                      "6(b)"),
              file=sys.stderr)
        return 2
    if ns.cmd == "metricsd":
        return cmd_metricsd(ns)

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
