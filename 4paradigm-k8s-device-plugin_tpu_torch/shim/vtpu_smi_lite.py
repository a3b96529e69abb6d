#!/usr/bin/env python3
"""In-container view of the grant: the tenant's half of vtpu-smi.

Allocate mounts this file at /usr/local/vtpu/vtpu-smi in every granted
container (``plugin.grant``; the reference's extra-binary mount,
server.go:518-519), so that someone shelled into a pod can ask what the
pod was granted, what it uses and how busy the card is.  ``vtpu``'s
shim/vtpu_smi_lite.py, for NVIDIA cards:

- the env contract: each granted card by UUID with its HBM cap, the
  compute share, the policy, oversubscription;
- the pod's own region (``VTPU_DEVICE_MEMORY_SHARED_CACHE``): its ledger
  and device time per device, read without taking a slot in it;
- each granted card's busy file (``VTPU_DEVICE_BUSY_DIR``), where the
  interposers of every pod on the card share its time slices: how many
  tenants hold a live slot and how many are busy now, never whose.

``python3 vtpu_smi_lite.py [--json]``.  It finds the package beside it
(the staged shim), in ``shim/`` below it (mounted as
/usr/local/vtpu/vtpu-smi) or two levels up (the source tree), so it runs
from a shell with no PYTHONPATH.  It never writes to the region or a busy
file, and exits 0 with "no vtpu grant" when the environment has none.
"""

import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
for _cand in (_HERE, os.path.join(_HERE, "shim"),
              os.path.dirname(os.path.dirname(_HERE))):
    if os.path.isdir(os.path.join(_cand, "vtpu_torch")):
        if _cand not in sys.path:
            sys.path.insert(0, _cand)
        break

def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024.0
    return f"{n}B"


def view(env=None) -> dict:
    """The grant, the pod's region and the cards' busy files, as
    ``--json`` prints them: ``vtpu``'s fields ("brokered" is false until
    the broker is ported), and "cards" beside them."""
    from vtpu_torch.utils import envspec

    env = os.environ if env is None else env
    spec = envspec.quota_from_env(env)
    has_grant = bool(spec.hbm_limit_bytes or spec.core_limit_pct
                     or spec.visible_devices or spec.device_map)
    out = {"grant": has_grant}
    if not has_grant:
        return out
    entries = spec.device_map or [envspec.DeviceMapEntry(0, "?")]
    out["devices"] = []
    for i, e in enumerate(entries):
        cap = spec.limit_for(i)
        out["devices"].append({"ordinal": e.ordinal, "chip": e.chip_uuid,
                               "hbm_limit": (_fmt_bytes(cap) if cap
                                             else "unlimited")})
    out["core_limit_pct"] = spec.core_limit_pct
    out["policy"] = spec.utilization_policy
    out["oversubscribe"] = bool(spec.oversubscribe)
    out["brokered"] = bool(spec.runtime_socket)

    region_path = spec.shared_cache
    if region_path and os.path.exists(region_path):
        try:
            from vtpu_torch.shim.core import SharedRegion

            with SharedRegion(region_path) as reg:
                out["region"] = []
                for d in range(reg.ndevices):
                    st = reg.device_stats(d)
                    out["region"].append({
                        "device": d, "used": int(st.used_bytes),
                        "limit": int(st.limit_bytes),
                        "peak": int(st.peak_bytes),
                        "core_limit_pct": int(st.core_limit_pct),
                        "busy_us": int(st.busy_us),
                        "procs": int(st.n_procs)})
        except (OSError, RuntimeError) as e:
            out["region_error"] = str(e)

    busy_dir = env.get(envspec.ENV_DEVICE_BUSY_DIR)
    if busy_dir:
        from vtpu_torch.shim.interposer import busy_slots

        now = time.monotonic_ns()
        out["cards"] = []
        for uuid in dict.fromkeys(e.chip_uuid for e in entries):
            try:
                card = busy_slots(os.path.join(busy_dir, f"{uuid}.busy"), now)
            except OSError as e:
                card = {"error": str(e)}
            out["cards"].append(dict(card=uuid, **card))
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        out = view()
    except ValueError as e:   # a malformed grant env: report, never crash
        print(f"vtpu-smi: cannot parse the grant env: {e}", file=sys.stderr)
        return 1
    if "--json" in argv:
        print(json.dumps(out, indent=2))
        return 0
    if not out["grant"]:
        print("no vtpu grant in this container (no VTPU_* env contract)")
        return 0
    print("vtpu grant")
    for d in out["devices"]:
        print(f"  vtpu {d['ordinal']}: card {d['chip']}  hbm {d['hbm_limit']}")
    pct = out["core_limit_pct"]
    print(f"  core limit : {f'{pct}%' if pct else 'unlimited'}   "
          f"policy {out['policy']}   "
          f"oversubscribe {'on' if out['oversubscribe'] else 'off'}")
    for d in out.get("region", []):
        share = 100.0 * d["used"] / d["limit"] if d["limit"] else 0.0
        limit = _fmt_bytes(d["limit"]) if d["limit"] else "unl"
        print(f"  device {d['device']}: used {_fmt_bytes(d['used'])} / "
              f"{limit} ({share:.0f}%)  peak {_fmt_bytes(d['peak'])}  "
              f"busy {d['busy_us'] / 1e6:.1f}s  procs {d['procs']}")
    for c in out.get("cards", []):
        if "error" in c:
            print(f"  card {c['card']}: busy file unavailable ({c['error']})")
        else:
            print(f"  card {c['card']}: {c['live']} tenant(s) live, "
                  f"{c['busy']} busy now")
    if "region_error" in out:
        print(f"  (region unavailable: {out['region_error']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
