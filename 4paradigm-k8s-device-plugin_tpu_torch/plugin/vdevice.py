"""Virtual device model: split one physical card into K ``vtpu`` resources.

The reference's vdevice.go: ``Device2VDevice`` gives each vdevice
``totalMem * memoryScaling / splitCount`` and the ID ``<uuid>-<i>``
(reference vdevice.go:36-58); ``VDevicesByIDs`` is an order-preserving
lookup (vdevice.go:61-75); ``UniqueDeviceIDs`` dedupes to physical UUIDs
(vdevice.go:78-90).  ``vtpu``'s shape and IDs (``-vtpu-<i>``, ``-core-<c>``),
with one vdevice per MIG instance for the ``core`` split strategy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from ..discovery.types import GpuChip, Health, MigInstance


@dataclass
class VDevice:
    """One schedulable ``4paradigm.com/vtpu`` unit."""

    id: str                      # "<card-uuid>-vtpu-<i>" (or "-core-<c>")
    chip: GpuChip                # back-pointer to the physical card
    hbm_bytes: int               # per-vdevice HBM quota (0 = whole device)
    core_pct: int                # compute quota, % of one card (0 = no cap)
    core_index: Optional[int] = None     # MIG instance (core split only)
    mig: Optional[MigInstance] = None
    health: Health = field(default=Health.HEALTHY)

    @property
    def chip_uuid(self) -> str:
        return self.chip.uuid


def split_chip(
    chip: GpuChip,
    split_count: int,
    memory_scaling: float = 1.0,
    cores_scaling: float = 1.0,
) -> List[VDevice]:
    """Time-share split: K vdevices per card, each with hbm*scaling/K and
    100*coresScaling/K percent of device time (reference vdevice.go:36-58
    and server.go:492 for the SM-limit formula)."""
    if split_count < 1:
        raise ValueError(f"split_count must be >= 1, got {split_count}")
    hbm = int(chip.hbm_bytes * memory_scaling / split_count)
    core_pct = int(100 * cores_scaling / split_count)
    return [VDevice(id=f"{chip.uuid}-vtpu-{i}", chip=chip, hbm_bytes=hbm,
                    core_pct=min(core_pct, 100))
            for i in range(split_count)]


def split_chip_by_core(chip: GpuChip,
                       memory_scaling: float = 1.0) -> List[VDevice]:
    """Hard-partition split: one vdevice per MIG instance, with the
    instance's own memory times the scaling.  Instances are isolated by
    the card, so they take no compute share (reference mig.go /
    mig-strategy.go 'single')."""
    return [VDevice(id=f"{chip.uuid}-core-{c.index}", chip=chip,
                    hbm_bytes=int(c.hbm_bytes * memory_scaling), core_pct=0,
                    core_index=c.index, mig=c)
            for c in chip.cores]


def vdevices_by_ids(vdevices: Sequence[VDevice],
                    ids: Iterable[str]) -> List[VDevice]:
    """Order-preserving ID lookup; raises KeyError on unknown IDs
    (reference vdevice.go:61-75)."""
    index: Dict[str, VDevice] = {v.id: v for v in vdevices}
    out = []
    for i in ids:
        if i not in index:
            raise KeyError(f"unknown vdevice id {i!r}")
        out.append(index[i])
    return out


def unique_chip_uuids(vdevices: Sequence[VDevice]) -> List[str]:
    """Physical cards backing a vdevice set, deduped, order-preserving
    (reference vdevice.go:78-90)."""
    seen = set()
    out = []
    for v in vdevices:
        if v.chip_uuid not in seen:
            seen.add(v.chip_uuid)
            out.append(v.chip_uuid)
    return out
