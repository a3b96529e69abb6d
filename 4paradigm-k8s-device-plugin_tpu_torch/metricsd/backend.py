"""Metric backends for vtpu-metricsd.

A backend answers one question: what does THIS pod's grant look like
right now: per granted device ordinal, the HBM cap, the ledger, the raw
card's capacity and the pod's own duty cycle.  The server layer
(``metricsd/server.py``) turns that into wire metrics; the rules (clamp,
rescale, filter) live there, so every backend gets them.

- ``RegionBackend``: the pod's shared accounting region, named by the
  Allocate env contract, the region ``vtpu-smi`` and ``tools.tpu_info``
  read.  It never takes a slot in the region (a ``SharedRegion`` opened
  with no limits adopts it as it is), so a probe changes nothing a
  tenant sees.  With a ``broker_socket`` (``VTPU_METRICSD_BROKER`` or the
  grant's runtime socket) and the pod's tenant name, it reads the
  broker's bind-free STATS and SLO verbs on the main socket (no HELLO, no
  slot, no claim of a card), as ``vtpu``'s does: a brokered grant's
  ledger lives in the broker, so its usage stands in for a region the
  interposer never touched, and ``slo_summary`` is the tenant's own row
  (attainment and burn of the short window, e2e p99, the objective).
- ``FakeBackend``: a deterministic synthetic tenant for the CPU tests and
  ``--selftest``: no region, no native library.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..utils import envspec
from ..utils import logging as log

# The raw card's HBM when nothing else says it: an H100 80GB HBM3 as NVML
# reports it (81559 MiB).  Only an unlimited grant shows it; a grant with
# a cap reports the cap.
_RAW_HBM_FALLBACK = 81559 * 2**20

# The shortest duty window: NVML's own shortest sample period (1/6 s).
MIN_WINDOW_S = 1.0 / 6.0

@dataclass
class DeviceView:
    """One granted device ordinal as the pod may see it."""

    ordinal: int
    chip_id: str = ""              # the card's UUID (VTPU_DEVICE_MAP)
    hbm_limit_bytes: int = 0       # 0 = unlimited grant
    hbm_used_bytes: int = 0
    hbm_raw_total_bytes: int = _RAW_HBM_FALLBACK
    duty_cycle_pct: float = 0.0    # the pod's own, of the WHOLE card
    core_limit_pct: int = 0        # 0 = no compute share


class Backend:
    def devices(self) -> List[DeviceView]:
        raise NotImplementedError

    def slo_summary(self) -> Optional[Dict]:
        """The pod's own SLO view (``{"attainment_pct", "p99_us",
        "target_us", "burn_rate"}``), or None when no SLO source exists."""
        return None


class RegionBackend(Backend):
    """The pod's view from its shared region (reads only)."""

    def __init__(self, region_path: Optional[str] = None,
                 quota: Optional[envspec.QuotaSpec] = None,
                 broker_socket: Optional[str] = None,
                 tenant: Optional[str] = None):
        self.quota = quota if quota is not None else envspec.quota_from_env()
        self.region_path = region_path or self.quota.shared_cache
        self.broker_socket = broker_socket
        self.tenant = tenant
        # The duty cycle needs two samples: ordinal -> (busy_us, t, duty).
        self._prev: Dict[int, tuple] = {}

    def _open_region(self):
        """A fresh open per sample: pod churn can recreate the region file,
        and holding no descriptor keeps the probe free of side effects."""
        if not self.region_path or not os.path.exists(self.region_path):
            return None
        from ..shim.core import SharedRegion
        try:
            return SharedRegion(self.region_path)
        except OSError as e:
            log.warn("metricsd: region %s unreadable: %s",
                     self.region_path, e)
            return None

    def _broker(self, msg: Dict) -> Optional[Dict]:
        """One bind-free request on the broker's main socket; None when it
        does not answer ok."""
        from ..runtime import protocol as P
        from ..tools.vtpu_smi import request
        try:
            resp = request(self.broker_socket, msg, timeout=2.0)
        except (OSError, P.ProtocolError) as e:
            log.warn("metricsd: broker %s unreachable: %s",
                     self.broker_socket, e)
            return None
        return resp if resp.get("ok") else None

    def _broker_usage(self) -> Optional[Dict]:
        """The tenant's STATS row (its ledger), by name, or the only row."""
        if not self.broker_socket:
            return None
        resp = self._broker({"kind": "stats"})
        if resp is None:
            return None
        tenants = resp.get("tenants", {})
        if self.tenant:
            return tenants.get(self.tenant)
        if len(tenants) == 1:
            return next(iter(tenants.values()))
        return None

    def _ordinals(self, region) -> List[int]:
        if self.quota.device_map:
            return [e.ordinal for e in self.quota.device_map]
        if region is not None:
            return list(range(region.ndevices))
        ords = sorted(self.quota.hbm_limit_bytes)
        return [o for o in ords if o >= 0] or [0]

    def _duty(self, ordinal: int, busy_us: int, now: float) -> float:
        """The pod's duty of the whole card since the last sample.  A
        sample younger than MIN_WINDOW_S is no window: the last answer
        stands and the sample stays, so total, usage and duty asked for one
        after another read one window, and two scrapers cannot shrink each
        other's below it (the interposer's NVML hook keeps the same rule).
        The first sample answers 0."""
        prev = self._prev.get(ordinal)
        if prev is None:
            self._prev[ordinal] = (busy_us, now, 0.0)
        elif now - prev[1] >= MIN_WINDOW_S:
            duty = (busy_us - prev[0]) / ((now - prev[1]) * 1e6) * 100.0
            self._prev[ordinal] = (busy_us, now, min(max(duty, 0.0), 100.0))
        return self._prev[ordinal][2]

    def devices(self) -> List[DeviceView]:
        region = self._open_region()
        chip_of = {e.ordinal: e.chip_uuid for e in self.quota.device_map}
        broker = self._broker_usage()
        now = time.monotonic()
        out: List[DeviceView] = []
        try:
            for o in self._ordinals(region):
                view = DeviceView(ordinal=o, chip_id=chip_of.get(o, ""))
                view.hbm_limit_bytes = self.quota.limit_for(o)
                view.core_limit_pct = self.quota.core_limit_pct
                if region is not None and o < region.ndevices:
                    st = region.device_stats(o)
                    if st.limit_bytes:
                        view.hbm_limit_bytes = int(st.limit_bytes)
                    view.hbm_used_bytes = int(st.used_bytes)
                    if st.core_limit_pct:
                        view.core_limit_pct = int(st.core_limit_pct)
                    view.duty_cycle_pct = self._duty(o, int(st.busy_us),
                                                     now)
                out.append(view)
        finally:
            if region is not None:
                region.close()
        # A brokered grant: the ledger is the broker's; its usage stands
        # in for a region the interposer never touched (used 0).  The
        # broker's i-th card is the grant's i-th ordinal.
        if broker and out and not any(v.hbm_used_bytes for v in out):
            for view, pc in zip(out, broker.get("per_chip") or ()):
                view.hbm_used_bytes = int(pc.get("used_bytes", 0))
                lim = int(pc.get("limit_bytes", 0))
                if lim and not view.hbm_limit_bytes:
                    view.hbm_limit_bytes = lim
        return out

    def slo_summary(self) -> Optional[Dict]:
        """The tenant's own SLO row, read bind-free by name on the main
        socket; None without a broker, a name or a row."""
        if not self.broker_socket or not self.tenant:
            return None
        resp = self._broker({"kind": "slo", "tenant": self.tenant})
        if resp is None or not resp.get("enabled"):
            return None
        row = (resp.get("tenants") or {}).get(self.tenant)
        if not row:
            return None
        wins = row.get("windows") or {}
        short = wins[min(wins, key=float)] if wins else {}
        return {
            "attainment_pct": float(short.get("attainment_pct", 100.0)),
            "p99_us": float((row.get("phases") or {})
                            .get("e2e", {}).get("p99_us", 0.0)),
            "target_us": float((row.get("objective") or {})
                               .get("target_us", 0.0)),
            "burn_rate": float(short.get("burn_rate", 0.0)),
        }


class FakeBackend(Backend):
    """A deterministic synthetic tenant (CPU tests, ``--selftest``).

    The defaults: two halves of H100s, each granted 40 GiB and a 50% share,
    with 1 GiB in the ledger and the tenant running 40% of the whole card
    (80% of its share)."""

    def __init__(self, n_devices: int = 2,
                 hbm_limit_bytes: int = 40 * 2**30,
                 hbm_raw_total_bytes: int = _RAW_HBM_FALLBACK,
                 hbm_used_bytes: int = 1 * 2**30,
                 duty_cycle_pct: float = 40.0,
                 core_limit_pct: int = 50):
        self.n_devices = n_devices
        self.hbm_limit_bytes = hbm_limit_bytes
        self.hbm_raw_total_bytes = hbm_raw_total_bytes
        self.hbm_used_bytes = hbm_used_bytes
        self.duty_cycle_pct = duty_cycle_pct
        self.core_limit_pct = core_limit_pct

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "FakeBackend":
        """The grant's env where it has one (cards, cap, share); the
        defaults otherwise."""
        env = dict(os.environ if env is None else env)
        spec = envspec.quota_from_env(env)
        n = len(spec.device_map) or int(env.get("VTPU_FAKE_CHIPS", "2"))
        kw = {}
        if spec.limit_for(0):
            kw["hbm_limit_bytes"] = spec.limit_for(0)
        if spec.core_limit_pct:
            kw["core_limit_pct"] = spec.core_limit_pct
        return cls(n_devices=n, **kw)

    def devices(self) -> List[DeviceView]:
        return [
            DeviceView(
                ordinal=i,
                chip_id=f"GPU-fake-h100-{i:02d}",
                hbm_limit_bytes=self.hbm_limit_bytes,
                hbm_used_bytes=self.hbm_used_bytes,
                hbm_raw_total_bytes=self.hbm_raw_total_bytes,
                duty_cycle_pct=self.duty_cycle_pct,
                core_limit_pct=self.core_limit_pct,
            )
            for i in range(self.n_devices)
        ]

    def slo_summary(self) -> Optional[Dict]:
        """vtpu's synthetic SLO: 95% attainment against a 50 ms objective,
        e2e p99 at 42 ms, burn 0.5."""
        return {"attainment_pct": 95.0, "p99_us": 42_000.0,
                "target_us": 50_000.0, "burn_rate": 0.5}
