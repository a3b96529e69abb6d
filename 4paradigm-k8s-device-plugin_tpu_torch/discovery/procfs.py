"""Card discovery from the NVIDIA driver's procfs and sysfs, without the
driver library: the port's counterpart of ``vtpu``'s ``sysfs.py``.

- ``/proc/driver/nvidia/gpus/<bus>/information``: model, UUID, bus
  location and device minor, one directory per card;
- ``/sys/bus/pci/devices/<bus>/numa_node``.

Memory and SM counts come from the model table (``types.MODELS``).
Neither file says which cards NVLink joins, so the topology is PCIe only:
a NUMA node, or across sockets.  Every path is under ``root``, so tests
point the backend at a fake tree.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

from ..utils import logging as log
from .base import ChipBackend
from .types import (LINK_NODE, LINK_SYSTEM, MODELS, GpuChip, GpuTopology,
                    device_paths, normalize_bus_id, sysfs_numa_node)


def parse_information(text: str) -> Dict[str, str]:
    """``Key: value`` lines of an ``information`` file."""
    out = {}
    for line in text.splitlines():
        key, sep, value = line.partition(":")
        if sep:
            out[key.strip()] = value.strip()
    return out


class ProcfsChipBackend(ChipBackend):
    def __init__(self, root: str = "/"):
        self.root = root
        self._chips: Optional[List[GpuChip]] = None

    def _gpus_dir(self) -> str:
        return os.path.join(self.root, "proc", "driver", "nvidia", "gpus")

    def chips(self) -> List[GpuChip]:
        if self._chips is not None:
            return self._chips
        cards = []
        for path in glob.glob(os.path.join(self._gpus_dir(), "*",
                                           "information")):
            try:
                with open(path) as f:
                    info = parse_information(f.read())
            except OSError as e:
                log.warn("cannot read %s: %s", path, e)
                continue
            bus = normalize_bus_id(info.get("Bus Location")
                                   or os.path.basename(os.path.dirname(path)))
            cards.append((bus, info))
        chips = []
        for index, (bus, info) in enumerate(sorted(cards)):
            model = info.get("Model", "unknown")
            spec = MODELS.get(model)
            if spec is None:
                log.warn("%s is not in the model table: memory and SM "
                         "count unknown", model)
            minor_s = info.get("Device Minor", "")
            minor = int(minor_s) if minor_s.isdigit() else None
            chips.append(GpuChip(
                uuid=info.get("GPU UUID", f"GPU-{bus}"), index=index,
                model=model, hbm_bytes=spec.hbm_bytes if spec else 0,
                sm_count=spec.sm_count if spec else 0, minor=minor,
                pci_bus_id=bus, device_paths=device_paths(minor),
                numa_node=sysfs_numa_node(bus, self.root)))
        self._chips = chips
        return chips

    def topology(self) -> GpuTopology:
        chips = self.chips()
        return GpuTopology.from_levels(
            len(chips), lambda i, j: LINK_NODE
            if chips[i].numa_node is not None
            and chips[i].numa_node == chips[j].numa_node else LINK_SYSTEM)

    def probe(self, chip: GpuChip) -> Optional[str]:
        """A card whose procfs entry or device node vanished is unhealthy
        (unbound or surprise-removed: the hard fault a critical XID
        reports)."""
        entry = os.path.join(self._gpus_dir(), chip.pci_bus_id or "")
        if not os.path.isdir(entry):
            return f"{entry} disappeared"
        node = chip.device_paths[0] if chip.minor is not None else None
        if node and not os.path.exists(os.path.join(self.root,
                                                    node.lstrip("/"))):
            return f"device node {node} disappeared"
        return None
