"""Topology-aware preferred allocation over the cards' link matrix.

The reference delegates GetPreferredAllocation scoring to the vendored
``gpuallocator`` NVLink-affinity policies (reference server.go:271-326,
mig-strategy.go:62-71).  ``vtpu`` scores chip sets by ICI torus distance;
here the distance is the link level between two cards (NVLink, or how far
apart PCIe puts them, ``discovery.types``), and the scoring is ``vtpu``'s:

1. Project the available vdevice IDs onto their distinct physical cards
   (one vdevice per card per request — the reference's "vGPUs per task
   <= physical GPUs per node", README.md:96-98).
2. Choose a card set of the requested size that (a) is connected over
   NVLink when possible, so a multi-card pod's collectives stay off PCIe,
   and (b) minimises the total pairwise distance.
3. Tie-break toward cards that are already fragmented (fewest free
   vdevices), keeping whole cards free for future multi-card pods.
4. Map the chosen cards back to one available vdevice each.

Falls back to first-N available when no set of distinct cards fits
(reference server.go:298-300 falls back the same way).

Two policies (``--allocation-policy``, the reference's gpuallocator
policy choice, server.go:66): ``pack`` (default) is the scoring above;
``spread`` prefers the LARGEST pairwise distance and the cards with the
MOST free vdevices, so co-tenants land far apart, and drops the NVLink
preference (a maximally spread set is by construction not adjacent).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

from ..discovery.types import GpuChip, GpuTopology, chips_connected
from .vdevice import VDevice

# Enumerating subsets is exponential; nodes cap at 16 cards (envspec
# MAX_DEVICES_PER_NODE) so C(16, k) stays small, but guard anyway.
_MAX_ENUMERATION = 20000


def _pairwise_cost(chips: Sequence[GpuChip],
                   topo: Optional[GpuTopology]) -> int:
    return sum(a.distance(b, topo) for a, b in itertools.combinations(chips, 2))


def preferred_allocation(
    available: Sequence[VDevice],
    must_include: Sequence[VDevice],
    size: int,
    topology: Optional[GpuTopology] = None,
    policy: str = "pack",
) -> List[VDevice]:
    """Pick ``size`` vdevices from ``available`` (a superset of
    ``must_include``), at most one per physical card; ``policy`` selects
    pack (NVLink-compact) or spread (farthest apart) scoring."""
    if size <= 0:
        return []
    if size > len(available):
        # The kubelet never asks for more than it was told is available;
        # degrade to everything there is.
        return list(available)

    by_chip: Dict[str, List[VDevice]] = {}
    chip_of: Dict[str, GpuChip] = {}
    for v in available:
        by_chip.setdefault(v.chip_uuid, []).append(v)
        chip_of[v.chip_uuid] = v.chip

    # Every must-include vdevice appears in the answer as it is (the
    # kubelet's contract), even several of one card; the one-per-card
    # preference applies to the free slots only.
    forced_chips = []
    seen = set()
    for v in must_include:
        if v.chip_uuid not in seen:
            seen.add(v.chip_uuid)
            forced_chips.append(v.chip_uuid)

    candidate_uuids = [u for u in by_chip if u not in seen]
    n_free_slots = size - len(must_include)
    if n_free_slots < 0 or len(must_include) + len(candidate_uuids) < size:
        return _first_n(available, must_include, size)

    best: Optional[List[str]] = None
    best_key = None
    for n_combos, combo in enumerate(
            itertools.combinations(candidate_uuids, n_free_slots)):
        if n_combos >= _MAX_ENUMERATION:
            break
        uuids = forced_chips + list(combo)
        chips = [chip_of[u] for u in uuids]
        connected = (topology is None or len(chips) <= 1
                     or chips_connected(chips, topology))
        cost = _pairwise_cost(chips, topology)
        frag = sum(len(by_chip[u]) for u in uuids)
        key = (-cost, -frag) if policy == "spread" else \
            (not connected, cost, frag)
        if best_key is None or key < best_key:
            best_key = key
            best = uuids

    if best is None:
        return _first_n(available, must_include, size)
    out: List[VDevice] = list(must_include)
    for uuid in best:
        if uuid not in seen:
            out.append(by_chip[uuid][0])
    return out


def _first_n(available: Sequence[VDevice], must_include: Sequence[VDevice],
             size: int) -> List[VDevice]:
    out = list(must_include[:size])
    have = {v.id for v in out}
    for v in available:
        if len(out) >= size:
            break
        if v.id not in have:
            out.append(v)
            have.add(v.id)
    return out
