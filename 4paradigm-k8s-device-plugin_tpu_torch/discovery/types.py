"""Core discovery datatypes: cards, their links, health.

``vtpu`` models a TPU chip by its place in a regular ICI torus and derives
distance from coordinates.  GPUs on one node form no such regular shape:
a card reaches another over NVLink (directly, or all to all through
NVSwitch) or over PCIe, through switches, a host bridge, a NUMA node or
the inter-socket link.  So the topology here is a pairwise matrix of link
levels, taken from NVML (P2P status over NVLink, and the common PCIe
ancestor otherwise), and the distance between two cards is their level.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple


class Health(str, Enum):
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"


# Link levels between two cards, nearest first; a level is the distance.
LINK_SELF = 0
LINK_NVLINK = 1        # NVLink, a bridge or through NVSwitch
LINK_BOARD = 2         # PCIe, one board (NVML_TOPOLOGY_INTERNAL)
LINK_SWITCH = 3        # PCIe, one switch (NVML_TOPOLOGY_SINGLE)
LINK_SWITCHES = 4      # PCIe, several switches (NVML_TOPOLOGY_MULTIPLE)
LINK_HOSTBRIDGE = 5    # PCIe, one host bridge (NVML_TOPOLOGY_HOSTBRIDGE)
LINK_NODE = 6          # PCIe, one NUMA node (NVML_TOPOLOGY_NODE)
LINK_SYSTEM = 7        # across sockets (NVML_TOPOLOGY_SYSTEM)

# NVML's nvmlGpuTopologyLevel_t -> link level.
NVML_TOPOLOGY_LEVELS = {0: LINK_BOARD, 10: LINK_SWITCH, 20: LINK_SWITCHES,
                        30: LINK_HOSTBRIDGE, 40: LINK_NODE, 50: LINK_SYSTEM}


@dataclass(frozen=True)
class GpuTopology:
    """Link levels between the node's cards: ``links[i][j]`` for cards of
    index i and j (``LINK_SELF`` on the diagonal)."""

    links: Tuple[Tuple[int, ...], ...]

    @property
    def num_chips(self) -> int:
        return len(self.links)

    def link(self, i: int, j: int) -> int:
        return self.links[i][j]

    def nvlink_peers(self, i: int) -> List[int]:
        return [j for j, level in enumerate(self.links[i])
                if j != i and level == LINK_NVLINK]

    @classmethod
    def from_levels(cls, n: int, level) -> "GpuTopology":
        """A topology whose link between cards i != j is ``level(i, j)``."""
        return cls(tuple(tuple(LINK_SELF if i == j else level(i, j)
                               for j in range(n)) for i in range(n)))

    @classmethod
    def all_to_all(cls, n: int) -> "GpuTopology":
        """Every pair over NVLink, as an HGX board's NVSwitch joins them."""
        return cls.from_levels(n, lambda i, j: LINK_NVLINK)


@dataclass(frozen=True)
class ModelSpec:
    """What NVML does not say about a model: a whole card's SM count, and
    its memory for backends that do not ask the driver."""

    sm_count: int
    hbm_bytes: int


# NVML's name for each model.  Memory is NVML's total (81559 MiB on an
# H100 SXM5 80 GB and on the PCIe card); SM counts are NVIDIA's data
# sheets'.
MODELS: Dict[str, ModelSpec] = {
    "NVIDIA H100 80GB HBM3": ModelSpec(132, 81559 * 2**20),
    "NVIDIA H100 PCIe": ModelSpec(114, 81559 * 2**20),
}


@dataclass
class MigInstance:
    """One MIG instance of a card: the finest hard partition (the
    TensorCore's counterpart in ``vtpu``'s core split)."""

    index: int            # instance index on its card
    uuid: str             # MIG-...
    hbm_bytes: int
    sm_count: int
    profile: str = ""     # e.g. "1g.10gb"


@dataclass
class GpuChip:
    """One physical card on this node."""

    uuid: str                       # GPU-...
    index: int                      # NVML index, node-local
    model: str                      # NVML's name
    hbm_bytes: int
    sm_count: int
    minor: Optional[int] = None     # /dev/nvidia<minor>
    pci_bus_id: Optional[str] = None   # "0000:18:00.0", sysfs's form
    device_paths: List[str] = field(default_factory=list)
    numa_node: Optional[int] = None
    mig_enabled: bool = False
    cores: List[MigInstance] = field(default_factory=list)  # MIG instances
    health: Health = Health.HEALTHY

    def distance(self, other: "GpuChip",
                 topology: Optional[GpuTopology] = None) -> int:
        """The link level between two cards; without a topology, the
        distance of their indices (as ``vtpu`` without coordinates)."""
        if topology is not None and max(self.index, other.index) \
                < topology.num_chips:
            return topology.link(self.index, other.index)
        return abs(self.index - other.index)


def chips_connected(chips: Sequence[GpuChip], topology: GpuTopology) -> bool:
    """True iff every pair of the set reaches the other over NVLink,
    through cards of the set only (NVLink traffic is not routed through a
    card outside it): the admission criterion for a multi-card pod whose
    collectives should not cross PCIe."""
    if len(chips) <= 1:
        return True
    idx = {c.index for c in chips}
    if len(idx) != len(chips):
        return False
    start = chips[0].index
    seen, frontier = {start}, [start]
    while frontier:
        cur = frontier.pop()
        for n in topology.nvlink_peers(cur):
            if n in idx and n not in seen:
                seen.add(n)
                frontier.append(n)
    return len(seen) == len(idx)


def normalize_bus_id(bus: str) -> str:
    """NVML's "00000000:18:00.0" (or any case) as sysfs names it,
    "0000:18:00.0"."""
    bus = bus.strip().lower()
    domain, sep, rest = bus.partition(":")
    if not sep:
        return bus
    return f"{int(domain, 16):04x}:{rest}"


def device_paths(minor: Optional[int]) -> List[str]:
    """The device nodes a container needs for card ``minor``."""
    nodes = [f"/dev/nvidia{minor}"] if minor is not None else []
    return nodes + ["/dev/nvidiactl", "/dev/nvidia-uvm",
                    "/dev/nvidia-uvm-tools"]


def sysfs_numa_node(bus: str, root: str = "/") -> Optional[int]:
    """The NUMA node sysfs gives PCI device ``bus``, or None."""
    try:
        with open(os.path.join(root, "sys", "bus", "pci", "devices", bus,
                               "numa_node")) as f:
            node = int(f.read().strip())
    except (OSError, ValueError):
        return None
    return node if node >= 0 else None
