"""Deterministic fake card backend: the test seam the reference never had.

Configure programmatically or by ``VTPU_FAKE_CHIPS`` (default 8) and
``VTPU_FAKE_MODEL``:

- ``sxm`` (default): H100 SXM5 80 GB cards, 132 SMs, all to all over
  NVSwitch (an HGX board);
- ``pcie``: H100 PCIe cards paired by NVLink bridges (0-1, 2-3, ...), the
  other pairs over PCIe within a NUMA node or across sockets, so the
  allocator has choices to make;
- ``mig``: ``sxm`` cards with MIG on, 7 instances of 1g.10gb each.

Health faults are injected by writing ``<fault_dir>/<card uuid>`` (its
contents are the reason), which the health loop picks up at its next
poll: the stand-in for a critical XID event (reference nvidia.go:166-237).
The numbers are the fake's own, not a measurement.
"""

from __future__ import annotations

import os
from typing import List, Optional

from .base import ChipBackend
from .types import (LINK_NODE, LINK_NVLINK, LINK_SYSTEM, MODELS, GpuChip,
                    GpuTopology, MigInstance, device_paths)

SXM = "NVIDIA H100 80GB HBM3"
PCIE = "NVIDIA H100 PCIe"
FAKE_MODELS = {"sxm": SXM, "pcie": PCIE, "mig": SXM}
MIG_PROFILE = ("1g.10gb", 7, 16, 9856 * 2**20)   # name, count, SMs, bytes


class FakeChipBackend(ChipBackend):
    def __init__(self, num_chips: int = 8, model: str = "sxm",
                 fault_dir: Optional[str] = None):
        if model not in FAKE_MODELS:
            raise ValueError(f"unknown fake model {model!r} "
                             f"(one of {sorted(FAKE_MODELS)})")
        self.num_chips = num_chips
        self.model = model
        self.fault_dir = fault_dir

    @classmethod
    def from_env(cls) -> "FakeChipBackend":
        return cls(num_chips=int(os.environ.get("VTPU_FAKE_CHIPS", "8")),
                   model=os.environ.get("VTPU_FAKE_MODEL", "sxm"),
                   fault_dir=os.environ.get("VTPU_FAKE_FAULT_DIR"))

    def chips(self) -> List[GpuChip]:
        name = FAKE_MODELS[self.model]
        spec = MODELS[name]
        out = []
        for i in range(self.num_chips):
            cores = []
            if self.model == "mig":
                profile, count, sms, hbm = MIG_PROFILE
                cores = [MigInstance(index=j, uuid=f"MIG-fake-h100-{i:02d}-{j}",
                                     hbm_bytes=hbm, sm_count=sms,
                                     profile=profile) for j in range(count)]
            out.append(GpuChip(
                uuid=f"GPU-fake-h100-{i:02d}",
                index=i,
                model=name,
                hbm_bytes=spec.hbm_bytes,
                sm_count=spec.sm_count,
                minor=i,
                pci_bus_id=f"0000:{i:02x}:00.0",
                device_paths=device_paths(i),
                numa_node=0 if i < self.num_chips // 2 or self.num_chips < 2
                else 1,
                mig_enabled=self.model == "mig",
                cores=cores,
            ))
        return out

    def topology(self) -> GpuTopology:
        n = self.num_chips
        if self.model != "pcie":
            return GpuTopology.all_to_all(n)
        half = max(n // 2, 1)
        return GpuTopology.from_levels(
            n, lambda i, j: LINK_NVLINK if i // 2 == j // 2
            else LINK_NODE if i // half == j // half else LINK_SYSTEM)

    def probe(self, chip: GpuChip) -> Optional[str]:
        if not self.fault_dir:
            return None
        path = os.path.join(self.fault_dir, chip.uuid)
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip() or "injected fault"
        return None
