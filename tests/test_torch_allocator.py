"""The port's preferred allocation (vtpu_torch.plugin.allocator) against
vtpu's: given a link matrix equal to vtpu's ICI torus hop counts, the port
must choose the same vdevices as vtpu under pack and spread, for seeded
random availability sets.  Exact: both pick discrete sets."""

import numpy as np
import pytest

from vtpu.discovery.types import TpuChip, TpuCore, default_topology
from vtpu.discovery.types import chips_connected as j_connected
from vtpu.plugin import allocator as jalloc
from vtpu.plugin.vdevice import split_chip as j_split
from vtpu_torch.discovery.fake import FakeChipBackend
from vtpu_torch.discovery.types import GpuChip, GpuTopology
from vtpu_torch.discovery.types import chips_connected as t_connected
from vtpu_torch.plugin import allocator as talloc
from vtpu_torch.plugin.vdevice import split_chip as t_split

SPLIT = 4


def twin_inventory(n):
    """vtpu's fake v5e chips on the default torus for n chips, and GPU
    cards whose link matrix is that torus's hop counts."""
    topo = default_topology("v5e", n)
    coords = topo.coords()
    jchips = [TpuChip(uuid=f"TPU-{i:02d}", index=i, generation="v5e",
                      hbm_bytes=16 * 2**30,
                      cores=[TpuCore(index=0, global_index=i)],
                      coord=coords[i]) for i in range(n)]
    tchips = [GpuChip(uuid=f"GPU-{i:02d}", index=i,
                      model="NVIDIA H100 80GB HBM3", hbm_bytes=16 * 2**30,
                      sm_count=132) for i in range(n)]
    links = GpuTopology.from_levels(
        n, lambda i, j: jchips[i].ici_distance(jchips[j], topo))
    jv = [v for c in jchips for v in j_split(c, SPLIT)]
    tv = [v for c in tchips for v in t_split(c, SPLIT)]
    return topo, links, jv, tv


def as_port_id(vid):
    return vid.replace("TPU-", "GPU-")


@pytest.mark.parametrize("n", [8, 16], ids=["v5e_2x4", "v5e_4x4"])
@pytest.mark.parametrize("policy", ["pack", "spread"])
@pytest.mark.parametrize("seed", range(6))
def test_preferred_allocation_matches_vtpu(n, policy, seed):
    topo, links, jv, tv = twin_inventory(n)
    rng = np.random.default_rng(seed * 97 + n)
    by_id = {v.id: v for v in tv}
    for trial in range(8):
        keep = rng.random(len(jv)) < rng.uniform(0.3, 0.9)
        avail_j = [v for v, k in zip(jv, keep) if k]
        if not avail_j:
            continue
        size = int(rng.integers(1, min(5, len(avail_j)) + 1))
        n_must = int(rng.integers(0, min(2, size) + 1)) if trial % 2 else 0
        must_j = [avail_j[i] for i in sorted(
            rng.choice(len(avail_j), n_must, replace=False))]
        want = jalloc.preferred_allocation(avail_j, must_j, size, topo,
                                           policy=policy)
        got = talloc.preferred_allocation(
            [by_id[as_port_id(v.id)] for v in avail_j],
            [by_id[as_port_id(v.id)] for v in must_j], size, links,
            policy=policy)
        assert [v.id for v in got] == [as_port_id(v.id) for v in want], (
            trial, size, [v.id for v in must_j])


@pytest.mark.parametrize("n", [8, 16])
def test_connected_matches_vtpu_on_the_torus(n):
    """Hop count 1 is a direct link (LINK_NVLINK): a set is connected in
    the port exactly when it is a connected subgraph of vtpu's torus."""
    topo, links, jv, tv = twin_inventory(n)
    jchips = list({v.chip.uuid: v.chip for v in jv}.values())
    tchips = list({v.chip.uuid: v.chip for v in tv}.values())
    rng = np.random.default_rng(n)
    for _ in range(200):
        k = int(rng.integers(1, 6))
        idx = sorted(rng.choice(n, k, replace=False))
        assert t_connected([tchips[i] for i in idx], links) == \
            j_connected([jchips[i] for i in idx], topo)


def test_pack_takes_an_nvlink_pair_on_pcie_cards():
    """H100 PCIe cards bridged in pairs: a 2-card pod gets a bridged pair,
    and spread puts two cards across sockets."""
    backend = FakeChipBackend(8, "pcie")
    topo = backend.topology()
    vdevs = [v for c in backend.chips() for v in t_split(c, 2)]
    # Card 0 is taken: the free cards are 1-7.
    avail = [v for v in vdevs if v.chip.index != 0]
    pack = talloc.preferred_allocation(avail, [], 2, topo, "pack")
    assert [v.chip.index for v in pack] == [2, 3]
    spread = talloc.preferred_allocation(avail, [], 2, topo, "spread")
    a, b = (v.chip.index for v in spread)
    assert a // 4 != b // 4
    # One vdevice of card 1 is in use too: pack fills that fragmented
    # card first and keeps whole cards free.
    one = talloc.preferred_allocation(avail[1:], [], 1, topo, "pack")
    assert one[0].chip.index == 1


def test_allocation_edge_cases():
    backend = FakeChipBackend(4)
    topo = backend.topology()
    vdevs = [v for c in backend.chips() for v in t_split(c, 2)]
    assert talloc.preferred_allocation(vdevs, [], 0, topo) == []
    assert talloc.preferred_allocation(vdevs[:2], [], 3, topo) == vdevs[:2]
    # Two vdevices of one card requested together: first-N.
    got = talloc.preferred_allocation(vdevs[:2], [], 2, topo)
    assert [v.id for v in got] == [v.id for v in vdevs[:2]]
    # must_include appears verbatim even with two of one card.
    got = talloc.preferred_allocation(vdevs, vdevs[:2], 3, topo)
    assert got[:2] == vdevs[:2] and got[2].chip.index != 0
