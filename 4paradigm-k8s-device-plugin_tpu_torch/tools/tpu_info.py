"""tpu-info, as the port keeps it: the container's cards as its grant gives
them.

``vtpu``'s ``tools/tpu_info.py`` (the name is kept so that a reader finds
its counterpart).  On the H100 it is the grant's view beside
``nvidia-smi``: for each granted card, by its UUID (``VTPU_DEVICE_MAP``),
the HBM cap as the total, the pod's ledger as the usage, and the pod's
own device time over ``--interval`` from the region's ``busy_us``, of the
whole card and rescaled to the pod's compute share (the duty rule of
metricsd, ``metricsd.server.virtual_duty_pct``, and of the interposer's
``nvmlDeviceGetUtilizationRates``, which is what ``nvidia-smi`` in the
container shows).  It reads the region only; it takes no slot.

  python -m vtpu_torch.tools.tpu_info            # the container's region
  python -m vtpu_torch.tools.tpu_info --region /path/to/vtpushr.cache
  python -m vtpu_torch.tools.tpu_info --json
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

from ..metricsd.server import virtual_duty_pct
from ..shim.core import SharedRegion
from ..utils import envspec


def sample(region: SharedRegion, interval: float,
           cards: Dict[int, str]) -> List[Dict]:
    """vtpu's rows of each device with a grant or use, over ``interval``
    seconds, each also naming its card (``cards``: ordinal -> card UUID)
    and giving ``share_duty_pct``, the duty of the compute share."""
    before = [region.device_stats(d) for d in range(region.ndevices)]
    # Keyed by (pid, host_pid): the namespaced pid alone collides across
    # containers (every pod's workload is its namespace's pid 1).
    pbefore = {(p.pid, p.host_pid): list(p.busy_us)
               for p in region.proc_stats()}
    t0 = time.monotonic()
    time.sleep(interval)
    elapsed_us = (time.monotonic() - t0) * 1e6
    out = []
    procs_after = region.proc_stats()
    for d in range(region.ndevices):
        st = region.device_stats(d)
        busy_delta = st.busy_us - before[d].busy_us
        duty = min(busy_delta / elapsed_us * 100.0, 100.0) \
            if elapsed_us > 0 else 0.0
        if st.limit_bytes == 0 and st.used_bytes == 0 and st.n_procs == 0 \
                and busy_delta == 0:
            continue
        # Each process's part of the window: which of the pod's processes
        # uses the card.
        procs = []
        for p in procs_after:
            prev = pbefore.get((p.pid, p.host_pid))
            # max(.., 0): a swept and reused slot can read lower than the
            # snapshot before.
            delta = max(p.busy_us[d] - (prev[d] if prev else 0), 0)
            if delta <= 0 and not p.used_bytes[d]:
                continue
            procs.append({
                "pid": int(p.pid), "host_pid": int(p.host_pid),
                "hbm_used_bytes": int(p.used_bytes[d]),
                "duty_cycle_pct": round(
                    min(delta / elapsed_us * 100.0, 100.0), 1)
                if elapsed_us > 0 else 0.0,
            })
        out.append({
            "device": d,
            "hbm_used_bytes": int(st.used_bytes),
            "hbm_limit_bytes": int(st.limit_bytes),
            "hbm_peak_bytes": int(st.peak_bytes),
            "duty_cycle_pct": round(duty, 1),
            "core_limit_pct": int(st.core_limit_pct),
            "n_procs": int(st.n_procs),
            "procs": procs,
            "card": cards.get(d, ""),
            "share_duty_pct": round(
                virtual_duty_pct(duty, int(st.core_limit_pct)), 1),
        })
    return out


def _gib(n: int) -> str:
    return f"{n / 2**30:.2f} GiB"


def render(devs: List[Dict]) -> str:
    """vtpu's table under the port's title, with the duty of the share
    and the card's UUID at the end of each row (a row of vtpu's own shape
    renders as vtpu renders it)."""
    lines = [
        "GPU (vtpu grant view)",
        f"{'Chip':<6} {'HBM usage':<24} {'Duty cycle':<12} "
        f"{'Core cap':<10} {'Procs':<5}",
    ]
    for d in devs:
        lim = _gib(d["hbm_limit_bytes"]) if d["hbm_limit_bytes"] \
            else "unlimited"
        duty = d.get("share_duty_pct", d["duty_cycle_pct"])
        lines.append(
            f"{d['device']:<6} "
            f"{_gib(d['hbm_used_bytes']) + ' / ' + lim:<24} "
            f"{str(duty) + '%':<12} "
            f"{(str(d['core_limit_pct']) + '%') if d['core_limit_pct'] else '-':<10} "
            f"{d['n_procs']:<5}" + (f" {d['card']}" if "card" in d else ""))
        for p in d.get("procs", []):
            lines.append(
                f"       pid {p['pid']:<8} (host {p['host_pid']:<8}) "
                f"{_gib(p['hbm_used_bytes']):<12} "
                f"{str(p['duty_cycle_pct']) + '%':<8}")
    if len(lines) == 2:
        lines.append("(no active vTPU devices)")
    return "\n".join(lines)


def find_region() -> Optional[str]:
    env_path = os.environ.get(envspec.ENV_SHARED_CACHE)
    if env_path and os.path.exists(env_path):
        return env_path
    return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="tpu-info (vtpu_torch)")
    ap.add_argument("--region", default=None)
    ap.add_argument("--interval", type=float, default=1.0,
                    help="duty-cycle sampling window (s)")
    ap.add_argument("--json", action="store_true")
    ns = ap.parse_args(argv)

    path = ns.region or find_region()
    if not path:
        print("no vtpu accounting region "
              f"(set {envspec.ENV_SHARED_CACHE} or --region)")
        return 1
    cards = {e.ordinal: e.chip_uuid
             for e in envspec.quota_from_env().device_map}
    region = SharedRegion(path)
    try:
        devs = sample(region, ns.interval, cards)
    finally:
        region.close()
    if ns.json:
        print(json.dumps(devs, indent=2))
    else:
        print(render(devs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
