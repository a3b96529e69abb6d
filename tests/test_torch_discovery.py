"""The port's card discovery (vtpu_torch.discovery): the fake H100
inventories, the health loop against vtpu's on one fault schedule, procfs
on a fake /proc tree, and NVML through ctypes against the mock driver
(native/mock_cuda.cc built as libnvidia-ml.so.1), each in its own process
so no test process keeps a fake NVML loaded."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from vtpu.discovery.fake import FakeChipBackend as JFake
from vtpu_torch.discovery import make_backend
from vtpu_torch.discovery.fake import FakeChipBackend
from vtpu_torch.discovery.procfs import ProcfsChipBackend
from vtpu_torch.discovery.types import (LINK_NODE, LINK_NVLINK, LINK_SYSTEM,
                                        MODELS, GpuTopology, chips_connected,
                                        normalize_bus_id)
from vtpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def test_fake_default_is_eight_sxm_cards_on_nvswitch(monkeypatch):
    for name in ("VTPU_FAKE_CHIPS", "VTPU_FAKE_MODEL"):
        monkeypatch.delenv(name, raising=False)
    b = FakeChipBackend.from_env()
    chips = b.chips()
    assert len(chips) == 8
    assert {c.model for c in chips} == {H100}
    assert all(c.sm_count == 132 and c.hbm_bytes == 81559 * 2**20
               and not c.mig_enabled and not c.cores for c in chips)
    assert [c.device_paths[0] for c in chips] == \
        [f"/dev/nvidia{i}" for i in range(8)]
    assert [c.numa_node for c in chips] == [0] * 4 + [1] * 4
    topo = b.topology()
    assert all(topo.link(i, j) == (0 if i == j else LINK_NVLINK)
               for i in range(8) for j in range(8))
    assert chips_connected(chips, topo)


def test_fake_pcie_pairs_and_mig_instances():
    pcie = FakeChipBackend(8, "pcie")
    topo = pcie.topology()
    chips = pcie.chips()
    assert chips[0].model == "NVIDIA H100 PCIe" and chips[0].sm_count == 114
    assert topo.nvlink_peers(0) == [1] and topo.nvlink_peers(5) == [4]
    assert topo.link(0, 2) == LINK_NODE and topo.link(0, 4) == LINK_SYSTEM
    assert chips_connected(chips[:2], topo)
    assert not chips_connected(chips[1:3], topo)
    assert chips[0].distance(chips[1], topo) < chips[0].distance(chips[2],
                                                                 topo)
    mig = FakeChipBackend(2, "mig").chips()
    assert all(c.mig_enabled and len(c.cores) == 7 for c in mig)
    inst = mig[1].cores[3]
    assert (inst.uuid, inst.profile, inst.sm_count) == \
        ("MIG-fake-h100-01-3", "1g.10gb", 16)
    with pytest.raises(ValueError):
        FakeChipBackend(2, "a100")


def test_bus_ids_and_distance_without_topology():
    assert normalize_bus_id("00000000:1B:00.0") == "0000:1b:00.0"
    assert normalize_bus_id("0000:1b:00.0") == "0000:1b:00.0"
    chips = FakeChipBackend(4).chips()
    assert chips[0].distance(chips[3]) == 3
    topo = GpuTopology.from_levels(3, lambda i, j: LINK_SYSTEM)
    assert topo.nvlink_peers(0) == [] and not chips_connected(chips[:2],
                                                              topo)
    assert not chips_connected([chips[0], chips[0]], topo)


class ScriptedStop:
    """check_health's stop event: before each poll round it writes the
    next fault-dir state; once the script is spent it stops the loop."""

    def __init__(self, fault_dir, names, script):
        self.fault_dir, self.names, self.script = fault_dir, names, script
        self.round = 0

    def wait(self, timeout=None):
        if self.round == len(self.script):
            return True
        for i, name in enumerate(self.names):
            path = os.path.join(self.fault_dir, name)
            if i in self.script[self.round]:
                with open(path, "w") as f:
                    f.write(f"fault in round {self.round}")
            elif os.path.exists(path):
                os.unlink(path)
        self.round += 1
        return False


# Cards faulted in each poll round: card 0 flickers once (debounced),
# then stays down two rounds (flips), then recovers; card 2 goes down and
# stays down.
SCHEDULE = [{0}, set(), {0}, {0, 2}, {2}, {2}, set(), {1}]


def health_events(backend, fault_dir, names):
    events = []
    backend.health_fail_threshold = 2
    chips = backend.chips()
    backend.check_health(
        ScriptedStop(fault_dir, names, SCHEDULE), chips,
        lambda c, reason: events.append(("down", c.index, reason)),
        lambda c: events.append(("up", c.index)))
    return events


def test_health_loop_debounce_and_recovery_match_vtpu(tmp_path, monkeypatch):
    monkeypatch.setenv("VTPU_HEALTH_INTERVAL", "0")
    tdir, jdir = tmp_path / "port", tmp_path / "vtpu"
    tdir.mkdir()
    jdir.mkdir()
    port = FakeChipBackend(4, fault_dir=str(tdir))
    ref = JFake(4, "v5e", fault_dir=str(jdir))
    got = health_events(port, str(tdir), [c.uuid for c in port.chips()])
    want = health_events(ref, str(jdir), [c.uuid for c in ref.chips()])
    assert got == want
    assert [e[:2] for e in got] == [("down", 0), ("up", 0), ("down", 2),
                                    ("up", 2)]


INFO = """Model: \t\t {model}
IRQ:   \t\t 45
GPU UUID: \t {uuid}
Video BIOS: \t 96.00.99.00.01
Bus Type: \t PCIe
DMA Size: \t 52 bits
DMA Mask: \t 0xfffffffffffff
Bus Location: \t {bus}
Device Minor: \t {minor}
GPU Excluded:\t No
"""


def fake_proc_tree(root, cards):
    for uuid, bus, minor, numa, model in cards:
        d = root / "proc" / "driver" / "nvidia" / "gpus" / bus
        d.mkdir(parents=True)
        (d / "information").write_text(INFO.format(model=model, uuid=uuid,
                                                   bus=bus, minor=minor))
        s = root / "sys" / "bus" / "pci" / "devices" / bus
        s.mkdir(parents=True)
        (s / "numa_node").write_text(f"{numa}\n")
        (root / "dev").mkdir(exist_ok=True)
        (root / "dev" / f"nvidia{minor}").write_text("")


def test_procfs_backend_on_a_fake_tree(tmp_path):
    fake_proc_tree(tmp_path, [
        ("GPU-bbbb", "0000:9a:00.0", 5, 1, H100),
        ("GPU-aaaa", "0000:18:00.0", 0, 0, H100),
        ("GPU-cccc", "0000:1b:00.0", 2, 0, "NVIDIA H100 PCIe"),
    ])
    b = ProcfsChipBackend(root=str(tmp_path))
    chips = b.chips()
    assert [(c.index, c.uuid, c.pci_bus_id, c.minor, c.numa_node)
            for c in chips] == [
        (0, "GPU-aaaa", "0000:18:00.0", 0, 0),
        (1, "GPU-cccc", "0000:1b:00.0", 2, 0),
        (2, "GPU-bbbb", "0000:9a:00.0", 5, 1)]
    assert chips[0].hbm_bytes == MODELS[H100].hbm_bytes
    assert [c.sm_count for c in chips] == [132, 114, 132]
    assert chips[2].device_paths[0] == "/dev/nvidia5"
    topo = b.topology()
    assert topo.link(0, 1) == LINK_NODE and topo.link(0, 2) == LINK_SYSTEM
    assert [b.probe(c) for c in chips] == [None] * 3
    os.unlink(tmp_path / "dev" / "nvidia2")
    assert "nvidia2" in b.probe(chips[1])
    (tmp_path / "proc/driver/nvidia/gpus/0000:18:00.0/information").unlink()
    os.rmdir(tmp_path / "proc/driver/nvidia/gpus/0000:18:00.0")
    assert "disappeared" in b.probe(chips[0])


def test_factory_kinds(tmp_path, monkeypatch):
    monkeypatch.setenv("VTPU_FAKE_CHIPS", "3")
    monkeypatch.setenv("VTPU_FAKE_MODEL", "pcie")
    fake = make_backend("fake")
    assert len(fake.chips()) == 3 and fake.chips()[0].sm_count == 114
    with pytest.raises(ValueError):
        make_backend("pjrt")
    # A node with neither NVML nor the driver's procfs: auto finds
    # nothing, unless the fake inventory is allowed.
    from vtpu_torch.discovery import factory
    from vtpu_torch.discovery.nvml import NvmlChipBackend
    monkeypatch.setattr(factory, "NvmlChipBackend", lambda: NvmlChipBackend(
        str(tmp_path / "libnvidia-ml.so.1")))
    monkeypatch.setattr(factory, "ProcfsChipBackend",
                        lambda: ProcfsChipBackend(str(tmp_path)))
    monkeypatch.delenv("VTPU_ALLOW_FAKE", raising=False)
    auto = make_backend("auto")
    assert type(auto).__name__ == "NvmlChipBackend" and auto.chips() == []
    monkeypatch.setenv("VTPU_ALLOW_FAKE", "1")
    assert len(make_backend("auto").chips()) == 3


NVML_SCRIPT = """
    import json, os, sys
    sys.path.insert(0, {repo!r})
    from vtpu_torch.discovery.nvml import NvmlChipBackend
    b = NvmlChipBackend(sys.argv[1])
    chips = b.chips()
    out = {{"sm_source": b.sm_source, "links": b.topology().links,
           "chips": [dict(uuid=c.uuid, model=c.model, hbm=c.hbm_bytes,
                          sm=c.sm_count, minor=c.minor, bus=c.pci_bus_id,
                          numa=c.numa_node, mig=c.mig_enabled,
                          paths=c.device_paths,
                          cores=[[m.uuid, m.profile, m.sm_count, m.hbm_bytes]
                                 for m in c.cores]) for c in chips]}}
    out["probe0"] = [b.probe(c) for c in chips]
    with open(os.environ["MOCK_NVML_XID_FILE"], "a") as f:
        f.write("1 43\\n2 79\\n0 31\\n")
    out["events"] = b.drain_events()
    out["probe1"] = [b.probe(c) for c in chips]
    out["probe2"] = [b.probe(c) for c in chips]
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mock_nvml():
    return _build.build_all(("mocknvml",))["mocknvml"]


def run_nvml(mock_nvml, tmp_path, **env):
    xids = tmp_path / "xids"
    xids.write_text("")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(NVML_SCRIPT.format(repo=REPO)),
         mock_nvml],
        env=dict(os.environ, MOCK_CUDA_DEVICES="4",
                 MOCK_NVML_XID_FILE=str(xids), **env),
        capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_nvml_backend_against_the_mock(mock_nvml, tmp_path):
    got = run_nvml(mock_nvml, tmp_path)
    chips = got["chips"]
    assert [c["uuid"] for c in chips] == [f"GPU-mock-{i:02d}"
                                           for i in range(4)]
    assert all(c["model"] == H100 and c["hbm"] == 80 * 2**30
               and not c["mig"] and c["cores"] == [] for c in chips)
    assert [c["bus"] for c in chips] == [f"0000:{0x18 + i:02x}:00.0"
                                         for i in range(4)]
    assert [c["minor"] for c in chips] == [0, 1, 2, 3]
    assert [c["numa"] for c in chips] == [0, 0, 1, 1]
    assert chips[2]["paths"] == ["/dev/nvidia2", "/dev/nvidiactl",
                                 "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"]
    # No CUDA here: the SM count of a whole card comes from the table.
    assert got["sm_source"] == "table" and all(c["sm"] == 132 for c in chips)
    assert got["links"] == [[0 if i == j else LINK_NVLINK for j in range(4)]
                            for i in range(4)]
    # XID 43 and 31 are the application's; 79 (fallen off the bus) is
    # critical, and stays.
    assert got["probe0"] == [None] * 4
    assert got["events"] == [["GPU-mock-01", 43], ["GPU-mock-02", 79],
                             ["GPU-mock-00", 31]]
    assert got["probe1"] == [None, None, "critical XID 79", None]
    assert got["probe2"] == got["probe1"]


def test_nvml_backend_mig_and_nvlink_pairs(mock_nvml, tmp_path):
    got = run_nvml(mock_nvml, tmp_path, MOCK_NVML_MIG="1",
                   MOCK_NVML_LINKS="pairs")
    chips = got["chips"]
    assert all(c["mig"] and len(c["cores"]) == 7 for c in chips)
    assert chips[3]["cores"][6] == ["MIG-mock-03-6", "1g.10gb", 16,
                                    9856 * 2**20]
    assert got["sm_source"] == "table"
    # Cards 0-1 and 2-3 are bridged; the halves meet across sockets.
    assert got["links"][0] == [0, LINK_NVLINK, LINK_SYSTEM, LINK_SYSTEM]
    assert got["links"][2] == [LINK_SYSTEM, LINK_SYSTEM, 0, LINK_NVLINK]
