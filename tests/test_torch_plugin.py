"""The port's device-plugin daemon (vtpu_torch.plugin) against vtpu's: the
vdevice split, the split strategies, the flags, Allocate's grant, and the
daemon itself driven over its unix socket by the unchanged
tests/kubelet_sim.py, its answers compared with vtpu's plugin on the
matching fake inventory through the substitution table below.  All
comparisons are exact."""

import base64
import json
import os
import re
import shutil
import stat
import subprocess
import sys

import pytest

from kubelet_sim import KubeletSim, collect_stream
from vtpu.discovery.fake import FakeChipBackend as JFake
from vtpu.discovery.types import TpuChip, TpuCore
from vtpu.plugin import config as jconfig
from vtpu.plugin import split as jsplit
from vtpu.plugin import vdevice as jvd
from vtpu.plugin.controller import VDeviceController as JController
from vtpu.plugin.server import VtpuDevicePlugin as JPlugin
from vtpu.proto import pb
from vtpu_torch.discovery.fake import FakeChipBackend
from vtpu_torch.discovery.types import GpuChip, MigInstance
from vtpu_torch.plugin import config as tconfig
from vtpu_torch.plugin import split as tsplit
from vtpu_torch.plugin import vdevice as tvd
from vtpu_torch.plugin.controller import VDeviceController
from vtpu_torch.plugin.grant import (BUSY_FILE_BYTES, grant,
                                     stage_busy_files, stage_shim,
                                     staged_files)
from vtpu_torch.plugin.main import Daemon
from vtpu_torch.plugin.server import VtpuDevicePlugin as TPlugin
from vtpu_torch.proto import pb as tpb
from vtpu_torch.utils import envspec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
GI = 2**30


# -- the vdevice split --------------------------------------------------------

def chip_pair(hbm, ncores=1):
    j = TpuChip(uuid="TPU-x", index=0, generation="v5p", hbm_bytes=hbm,
                cores=[TpuCore(index=c, global_index=c)
                       for c in range(ncores)])
    t = GpuChip(uuid="GPU-x", index=0, model=H100, hbm_bytes=hbm,
                sm_count=132, mig_enabled=ncores > 1,
                cores=[MigInstance(index=c, uuid=f"MIG-x-{c}",
                                   hbm_bytes=hbm // ncores, sm_count=16)
                       for c in range(ncores)] if ncores > 1 else [])
    return j, t


def suffix(vid, uuid):
    assert vid.startswith(uuid)
    return vid[len(uuid):]


@pytest.mark.parametrize("hbm", [16 * GI, 81559 * 2**20, 95 * GI + 1])
@pytest.mark.parametrize("count", [1, 2, 3, 4, 7, 10])
@pytest.mark.parametrize("scaling", [(1.0, 1.0), (1.5, 1.0), (0.5, 2.0),
                                     (2.0, 0.3)])
def test_split_chip_matches_vtpu(hbm, count, scaling):
    j, t = chip_pair(hbm)
    want = jvd.split_chip(j, count, *scaling)
    got = tvd.split_chip(t, count, *scaling)
    assert [(suffix(v.id, t.uuid), v.hbm_bytes, v.core_pct, v.core_index)
            for v in got] == \
        [(suffix(v.id, j.uuid), v.hbm_bytes, v.core_pct, v.core_index)
         for v in want]


@pytest.mark.parametrize("ncores", [2, 7])
@pytest.mark.parametrize("scaling", [1.0, 1.5, 0.5, 2.0])
def test_split_by_core_matches_vtpu(ncores, scaling):
    """One vdevice per MIG instance against one per TensorCore, on the
    same memory split evenly."""
    j, t = chip_pair(ncores * 10 * GI, ncores)
    want = jvd.split_chip_by_core(j, scaling)
    got = tvd.split_chip_by_core(t, scaling)
    assert [(suffix(v.id, t.uuid), v.hbm_bytes, v.core_pct, v.core_index)
            for v in got] == \
        [(suffix(v.id, j.uuid), v.hbm_bytes, v.core_pct, v.core_index)
         for v in want]
    assert [v.mig.uuid for v in got] == [f"MIG-x-{c}" for c in range(ncores)]


def test_lookup_and_unique_cards():
    vd = tvd.split_chip(FakeChipBackend(2).chips()[1], 3)
    ids = [vd[2].id, vd[0].id]
    assert tvd.vdevices_by_ids(vd, ids) == [vd[2], vd[0]]
    with pytest.raises(KeyError):
        tvd.vdevices_by_ids(vd, ["nope"])
    assert tvd.unique_chip_uuids(vd) == ["GPU-fake-h100-01"]


# -- split strategies ---------------------------------------------------------

class HalfMig(FakeChipBackend):
    """The first half of the cards with MIG on."""

    def chips(self):
        mig = FakeChipBackend(self.num_chips, "mig").chips()
        whole = super().chips()
        half = self.num_chips // 2
        return mig[:half] + whole[half:]


def test_strategies():
    cfg = tconfig.Config(device_split_count=2)
    none = tsplit.build_plugin_specs(cfg, FakeChipBackend(4))
    assert [(s.resource_name, s.socket_name, len(s.vdevices), s.time_shared)
            for s in none] == [("4paradigm.com/vtpu",
                                "4paradigm.com.vtpu.sock", 8, True)]
    cfg.split_strategy = "core"
    with pytest.raises(RuntimeError, match="MIG"):
        tsplit.build_plugin_specs(cfg, FakeChipBackend(4))
    with pytest.raises(RuntimeError):   # vtpu refuses single-core chips
        jsplit.build_plugin_specs(jconfig.Config(split_strategy="core"),
                                  JFake(4, "v5e"))
    core = tsplit.build_plugin_specs(cfg, FakeChipBackend(2, "mig"))
    assert [(s.resource_name, len(s.vdevices), s.time_shared)
            for s in core] == [("4paradigm.com/vtpu-core", 14, False)]
    assert core[0].vdevices[8].id == "GPU-fake-h100-01-core-1"
    cfg.split_strategy = "mixed"
    mixed = tsplit.build_plugin_specs(cfg, HalfMig(4))
    assert [(s.resource_name, len(s.vdevices), s.time_shared)
            for s in mixed] == [("4paradigm.com/vtpu", 4, True),
                                ("4paradigm.com/vtpu-core", 14, False)]


# -- flags ----------------------------------------------------------------

def test_flags_match_vtpu():
    """The same flags as vtpu's daemon, with the same env aliases and
    defaults, but for the two subsystems vtpu turns on by default and the
    port does not have."""
    jp, tp = jconfig.build_parser(), tconfig.build_parser()
    assert set(tp._option_string_actions) == set(jp._option_string_actions)
    j, t = vars(jp.parse_args([])), vars(tp.parse_args([]))
    assert {k for k in j if j[k] != t[k]} == {"enable_runtime",
                                              "enable_metricsd"}
    assert not t["enable_runtime"] and not t["enable_metricsd"]


FLAG_ENV = {"--enable-runtime": "VTPU_ENABLE_RUNTIME",
            "--enable-metricsd": "VTPU_METRICSD_ENABLE",
            "--enable-legacy-preferred": "ENABLE_LEGACY_PREFERRED",
            "--monitor-mode": "VTPU_MONITOR_MODE"}


@pytest.mark.parametrize("flag", ["--enable-runtime"])
def test_unported_flags_refuse(flag, monkeypatch):
    with pytest.raises(SystemExit, match="ROADMAP"):
        tconfig.parse_args([flag, "true"])
    monkeypatch.setenv(FLAG_ENV[flag], "true")
    with pytest.raises(SystemExit, match=flag):
        tconfig.parse_args([])


def test_metricsd_flag_grants_its_port(tmp_path, monkeypatch):
    """--enable-metricsd (or its env alias) starts the daemon, and each
    grant carries VTPU_METRICSD_PORT as vtpu's does; vtpu's two libtpu
    variables (the moved metrics service and metricsd's upstream on it)
    are left out.  Without the flag no metricsd env is granted."""
    host = stage(tmp_path)
    jcfg = jconfig.parse_args([
        "--discovery", "fake", "--device-split-count", "2",
        "--metricsd-port", "9123", "--host-lib-dir", str(tmp_path / "jhost"),
        "--runtime-socket", str(tmp_path / "no-broker.sock")])
    backend = JFake(1, "v5e")
    jplug = JPlugin(jsplit.build_plugin_specs(jcfg, backend)[0], jcfg,
                    topology=backend.topology())
    car = pb.ContainerAllocateResponse()
    jplug._fill_allocate_response(car, jplug.spec.vdevices[:1],
                                  [jplug.spec.vdevices[0].id])
    jenv = dict(car.envs)
    flags = ["--discovery", "fake", "--device-split-count", "2",
             "--metricsd-port", "9123", "--host-lib-dir", host]
    monkeypatch.setenv("VTPU_METRICSD_ENABLE", "true")
    for cfg in (tconfig.parse_args(flags),
                tconfig.parse_args(flags + ["--enable-metricsd", "true"])):
        assert cfg.enable_metricsd and cfg.validate() == []
        spec = tsplit.build_plugin_specs(cfg, FakeChipBackend(1))[0]
        g = grant(cfg, spec, spec.vdevices[:1], [spec.vdevices[0].id])
        assert g.envs["VTPU_METRICSD_PORT"] == jenv["VTPU_METRICSD_PORT"] \
            == "9123"
        assert {"TPU_RUNTIME_METRICS_PORTS", "VTPU_METRICSD_UPSTREAM"} \
            <= set(jenv) - set(g.envs)
    monkeypatch.delenv("VTPU_METRICSD_ENABLE")
    cfg = tconfig.parse_args(flags)
    spec = tsplit.build_plugin_specs(cfg, FakeChipBackend(1))[0]
    assert not any("METRICS" in k for k in grant(
        cfg, spec, spec.vdevices[:1], [spec.vdevices[0].id]).envs)


@pytest.mark.parametrize("flag", ["--enable-legacy-preferred",
                                  "--monitor-mode"])
def test_lifted_flags_accepted(flag, monkeypatch):
    """Monitor mode and the legacy controller run, from the flag or its
    env alias, as in vtpu (which also turns both off by default)."""
    attr = flag[2:].replace("-", "_")
    assert getattr(tconfig.parse_args([flag, "true"]), attr) is True
    assert getattr(jconfig.parse_args([flag, "true", "--node-name", "n"]),
                   attr) is True
    monkeypatch.setenv(FLAG_ENV[flag], "true")
    assert getattr(tconfig.parse_args([]), attr) is True
    assert tconfig.Config(**{attr: True}).validate() == []


def test_flags_validate():
    assert tconfig.parse_args(["--split-strategy", "mixed",
                               "--discovery", "nvml"]).split_strategy == \
        "mixed"
    for bad in (["--split-strategy", "single"], ["--discovery", "pjrt"],
                ["--device-split-count", "0"]):
        with pytest.raises(SystemExit):
            tconfig.parse_args(bad)


# -- the grant ------------------------------------------------------------

def stage(tmp_path):
    host = tmp_path / "host"
    lib = tmp_path / "libvtpu_cuda.so"
    lib.write_bytes(b"\x7fELF")
    staged_files(str(host), str(lib))
    stage_busy_files(str(host), [c.uuid for c in FakeChipBackend(8).chips()])
    return str(host)


def one_grant(cfg, backend, n=1, strategy_spec=None, pick=None):
    spec = strategy_spec or tsplit.build_plugin_specs(cfg, backend)[0]
    vdevs = pick(spec.vdevices) if pick else spec.vdevices[:n]
    return grant(cfg, spec, vdevs, [v.id for v in vdevs])


def test_grant_time_share(tmp_path, monkeypatch):
    monkeypatch.delenv(envspec.ENV_MIN_EXEC_COST, raising=False)
    monkeypatch.delenv(envspec.ENV_UTILIZATION_POLICY, raising=False)
    host = stage(tmp_path)
    cfg = tconfig.Config(host_lib_dir=host, device_split_count=2)
    g = one_grant(cfg, FakeChipBackend(2), pick=lambda v: [v[1]])
    assert g.envs == {
        "NVIDIA_VISIBLE_DEVICES": "GPU-fake-h100-00",
        "VTPU_DEVICE_HBM_LIMIT_0": "42760m",
        "VTPU_DEVICE_MAP": "0:GPU-fake-h100-00",
        "VTPU_DEVICE_CORE_LIMIT": "50",
        "VTPU_DEVICE_MEMORY_SHARED_CACHE": g.envs[
            "VTPU_DEVICE_MEMORY_SHARED_CACHE"],
        "VTPU_CORE_UTILIZATION_POLICY": "FORCE",
        "VTPU_DEVICE_BUSY_DIR": "/usr/local/vtpu/busy",
    }
    assert re.fullmatch(r"/tmp/vtpu_[0-9a-f]{12}\.cache",
                        g.envs["VTPU_DEVICE_MEMORY_SHARED_CACHE"])
    assert [(m.container_path, m.host_path, m.read_only) for m in g.mounts] \
        == [("/usr/local/vtpu/libvtpu_cuda.so", f"{host}/libvtpu_cuda.so",
             True), ("/etc/ld.so.preload", f"{host}/ld.so.preload", True),
            ("/usr/local/vtpu/busy/GPU-fake-h100-00.busy",
             f"{host}/busy/GPU-fake-h100-00.busy", False)]
    with open(f"{host}/ld.so.preload") as f:
        assert f.read() == "/usr/local/vtpu/libvtpu_cuda.so\n"
    assert g.devices == [] and g.annotations == {}
    # A second grant of the same card: its own region, the same busy file.
    g2 = one_grant(cfg, FakeChipBackend(2), pick=lambda v: [v[0]])
    assert g2.envs["VTPU_DEVICE_MEMORY_SHARED_CACHE"] != \
        g.envs["VTPU_DEVICE_MEMORY_SHARED_CACHE"]
    assert g2.mounts == g.mounts
    # Operator values on the daemon win; the H100 has no default floor.
    monkeypatch.setenv(envspec.ENV_MIN_EXEC_COST, "300")
    monkeypatch.setenv(envspec.ENV_UTILIZATION_POLICY, "DEFAULT")
    g3 = one_grant(cfg, FakeChipBackend(2))
    assert g3.envs[envspec.ENV_MIN_EXEC_COST] == "300"
    assert g3.envs[envspec.ENV_UTILIZATION_POLICY] == "DEFAULT"
    assert envspec.min_exec_cost_default(H100) is None


def test_grant_refuses_to_mount_an_unstaged_interposer(tmp_path, capfd):
    cfg = tconfig.Config(host_lib_dir=str(tmp_path / "empty"),
                         device_split_count=2)
    g = one_grant(cfg, FakeChipBackend(1))
    assert g.mounts == [] and envspec.ENV_DEVICE_BUSY_DIR not in g.envs
    err = capfd.readouterr().err
    assert "REFUSING to mount the interposer" in err
    assert f"{tmp_path}/empty/busy/GPU-fake-h100-00.busy is not staged; " \
        "REFUSING to mount it" in err


def test_stage_busy_files(tmp_path):
    """The daemon's busy files: full size, writable by every tenant, in a
    directory only the daemon writes; kept across restarts; a planted
    symlink refused and its target untouched."""
    host = tmp_path / "host"
    (host / "busy").mkdir(parents=True)
    os.chmod(host / "busy", 0o1777)
    paths = stage_busy_files(str(host), ["GPU-a", "GPU-b"])
    assert paths == [f"{host}/busy/GPU-a.busy", f"{host}/busy/GPU-b.busy"]
    assert BUSY_FILE_BYTES == 64 * (24 + 8 * 16)
    for p in paths:
        st = os.lstat(p)
        assert stat.S_ISREG(st.st_mode) and st.st_size == BUSY_FILE_BYTES
        assert stat.S_IMODE(st.st_mode) == 0o666
    assert stat.S_IMODE(os.stat(host / "busy").st_mode) == 0o755
    with open(paths[0], "r+b") as f:
        f.write(b"live slot")
    stage_busy_files(str(host), ["GPU-a"])
    with open(paths[0], "rb") as f:
        assert f.read(9) == b"live slot"
    victim = tmp_path / "weights"
    victim.write_bytes(b"precious")
    os.chmod(victim, 0o600)
    os.symlink(victim, host / "busy" / "GPU-c.busy")
    with pytest.raises(OSError):
        stage_busy_files(str(host), ["GPU-c"])
    assert victim.read_bytes() == b"precious"
    assert stat.S_IMODE(os.stat(victim).st_mode) == 0o600
    for bad in ("", "..", "GPU-a/../../x"):
        with pytest.raises(ValueError):
            stage_busy_files(str(host), [bad])


def test_grant_variants(tmp_path):
    host = stage(tmp_path)
    pci = tmp_path / "pciinfo"
    cfg = tconfig.Config(host_lib_dir=host, device_split_count=4,
                         device_id_strategy="index",
                         device_memory_scaling=2.0, pass_device_specs=True,
                         pcibus_file=str(pci))
    g = one_grant(cfg, FakeChipBackend(4), pick=lambda v: [v[4], v[13]])
    assert g.envs["NVIDIA_VISIBLE_DEVICES"] == "1,3"
    assert g.envs["VTPU_DEVICE_MAP"] == "0:GPU-fake-h100-01 1:GPU-fake-h100-03"
    assert g.envs["VTPU_OVERSUBSCRIBE"] == "true"
    assert g.envs["VTPU_DEVICE_HBM_LIMIT_1"] == "42760m"
    assert g.envs["VTPU_PCIINFO_FILE"] == "/usr/local/vtpu/pciinfo.vtpu"
    assert ("/usr/local/vtpu/pciinfo.vtpu", str(pci), True) in [
        (m.container_path, m.host_path, m.read_only) for m in g.mounts]
    assert [d.container_path for d in g.devices] == [
        "/dev/nvidia1", "/dev/nvidiactl", "/dev/nvidia-uvm",
        "/dev/nvidia-uvm-tools", "/dev/nvidia3"]
    cfg = tconfig.Config(host_lib_dir=host, device_list_strategy="device-specs")
    g = one_grant(cfg, FakeChipBackend(2), pick=lambda v: [v[0], v[2]])
    assert g.envs["NVIDIA_VISIBLE_DEVICES"] == \
        "/var/run/nvidia-container-devices"
    assert [(m.container_path, m.host_path) for m in g.mounts[-2:]] == [
        ("/var/run/nvidia-container-devices/GPU-fake-h100-00", "/dev/null"),
        ("/var/run/nvidia-container-devices/GPU-fake-h100-01", "/dev/null")]


def test_grant_of_mig_instances(tmp_path):
    cfg = tconfig.Config(host_lib_dir=stage(tmp_path), split_strategy="core")
    g = one_grant(cfg, FakeChipBackend(2, "mig"), pick=lambda v: [v[2], v[9]])
    assert g.envs["NVIDIA_VISIBLE_DEVICES"] == \
        "MIG-fake-h100-00-2,MIG-fake-h100-01-2"
    assert g.envs["VTPU_DEVICE_MAP"] == "0:GPU-fake-h100-00 1:GPU-fake-h100-01"
    assert g.envs["VTPU_CORE_INDICES"] == "2,2"
    assert g.envs["VTPU_DEVICE_HBM_LIMIT_0"] == \
        envspec.format_quantity_mb(9856 * 2**20)
    assert "VTPU_DEVICE_CORE_LIMIT" not in g.envs
    assert "VTPU_CORE_UTILIZATION_POLICY" not in g.envs
    assert envspec.ENV_DEVICE_BUSY_DIR not in g.envs
    cfg.device_id_strategy = "index"
    g = one_grant(cfg, FakeChipBackend(2, "mig"), pick=lambda v: [v[9]])
    assert g.envs["NVIDIA_VISIBLE_DEVICES"] == "1:2"


def busy_mounts(g):
    return [m.host_path for m in g.mounts
            if m.container_path.startswith("/usr/local/vtpu/busy/")]


def test_mig_grants_share_no_busy_file(tmp_path):
    """MIG instances of one card run side by side, not in turns: two grants
    on one card meet in no busy file (each would read the other's busy
    ticks as a time slice lost), while two halves of a whole card under
    the mixed strategy do."""
    host = stage(tmp_path)
    backend = FakeChipBackend(2, "mig")
    cfg = tconfig.Config(host_lib_dir=host, split_strategy="core")
    spec = tsplit.build_plugin_specs(cfg, backend)[0]
    a, b = (grant(cfg, spec, [v], [v.id]) for v in spec.vdevices[:2])
    assert spec.vdevices[0].chip_uuid == spec.vdevices[1].chip_uuid
    for g in (a, b):
        assert envspec.ENV_DEVICE_BUSY_DIR not in g.envs
        assert busy_mounts(g) == []
    # mixed: cards 0-1 keep MIG, cards 2-3 are split in halves.
    cfg = tconfig.Config(host_lib_dir=host, split_strategy="mixed",
                         device_split_count=2)
    whole, mig = tsplit.build_plugin_specs(cfg, HalfMig(4))
    halves = [grant(cfg, whole, [v], [v.id]) for v in whole.vdevices[:2]]
    assert [busy_mounts(g) for g in halves] == \
        [[f"{host}/busy/GPU-fake-h100-02.busy"]] * 2
    g = grant(cfg, mig, mig.vdevices[:1], [mig.vdevices[0].id])
    assert busy_mounts(g) == [] and envspec.ENV_DEVICE_BUSY_DIR not in g.envs


# -- the daemon, driven by the kubelet simulator, against vtpu's --------------

# vtpu's Allocate env -> the port's: a new name, None (not emitted: a
# libtpu variable, or no H100 default), or the same name.
ENV_SUBSTITUTIONS = {
    "VTPU_VISIBLE_DEVICES": "NVIDIA_VISIBLE_DEVICES",
    "TPU_LIBRARY_PATH": None,            # the ld.so.preload mount instead
    "TPU_RUNTIME_METRICS_PORTS": None,   # libtpu's metrics service moved
    "VTPU_METRICSD_UPSTREAM": None,      # ... and named metricsd's upstream
}
# vtpu's mounts, by container path -> the port's container path or None;
# the others keep theirs.
MOUNT_SUBSTITUTIONS = {
    "/usr/local/vtpu/libvtpu_pjrt.so": None,      # the ld.so.preload mount
    "/usr/local/vtpu/libvtpu_preload.so": "/usr/local/vtpu/libvtpu_cuda.so",
}
# vtpu's staged files -> the port's, relative to the host lib dir.
HOST_NAMES = {"libvtpu_preload.so": "libvtpu_cuda.so"}
# Added by the port: the per-card busy files' directory.
PORT_ONLY_ENV = {"VTPU_DEVICE_BUSY_DIR": "/usr/local/vtpu/busy"}
REGION = re.compile(r"/tmp/vtpu_[0-9a-f]{12}\.cache")
SHARED = "/usr/local/vtpu/shared"


def to_port(text):
    return re.sub(r"TPU-fake-v5e-(\d\d)", r"GPU-fake-h100-\1", text)


def expected_port_answer(jresp, jhost, thost, floor):
    """vtpu's answer through the substitution tables.  Where vtpu mounts
    the whole shared/ (monitor mode), the port mounts the pod's own
    directory alone, at its own path."""
    envs = {}
    for k, v in jresp.envs.items():
        if k == envspec.ENV_MIN_EXEC_COST and floor is None:
            continue    # vtpu's per-generation default; the H100 has none
        name = ENV_SUBSTITUTIONS.get(k, k)
        if name is not None:
            envs[name] = to_port(v)
    envs.update(PORT_ONLY_ENV)
    mounts = []
    for m in jresp.mounts:
        cpath = MOUNT_SUBSTITUTIONS.get(m.container_path, m.container_path)
        if cpath is None:
            continue
        rel = os.path.relpath(m.host_path, jhost)
        assert not rel.startswith(".."), m.host_path
        if cpath == SHARED:
            own = os.path.dirname(envs[envspec.ENV_SHARED_CACHE])
            if os.path.dirname(own) != SHARED:
                continue      # no pod matched: a private region
            cpath, rel = own, os.path.relpath(own, "/usr/local/vtpu")
        mounts.append((cpath, os.path.join(thost, HOST_NAMES.get(rel, rel)),
                       m.read_only))
    # Each granted card's busy file, the daemon's, mounted on its own.
    cards = [e.split(":", 1)[1] for e in envs["VTPU_DEVICE_MAP"].split()]
    for u in dict.fromkeys(cards):
        mounts.append((f"/usr/local/vtpu/busy/{u}.busy",
                       f"{thost}/busy/{u}.busy", False))
    return envs, mounts


def answer(resp):
    return (dict(resp.envs), [(m.container_path, m.host_path, m.read_only)
                              for m in resp.mounts])


@pytest.fixture()
def daemons(tmp_path, request):
    """The port's daemon (a subprocess: --discovery fake, 8 cards, split
    4) and vtpu's plugin on the matching fake inventory (in this process,
    on the interposer-only path: the broker's socket absent), each with
    its own kubelet simulator and staged host files."""
    floor = request.param
    tdir, jdir = tmp_path / "port", tmp_path / "vtpu"
    tdir.mkdir()
    jdir.mkdir()
    thost = stage(tmp_path)
    stage_shim(thost)
    shutil.rmtree(os.path.join(thost, "busy"))   # the daemon makes them
    jhost = str(tmp_path / "jhost")
    os.makedirs(jhost)
    for name in ("libvtpu_preload.so", "ld.so.preload"):
        open(os.path.join(jhost, name), "w").close()
    tsim, jsim = KubeletSim(str(tdir)).start(), KubeletSim(str(jdir)).start()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "NVIDIA_"))}
    env.update(PYTHONPATH=REPO, VTPU_FAKE_CHIPS="8", VTPU_LOG_LEVEL="0")
    if floor is not None:
        env[envspec.ENV_MIN_EXEC_COST] = floor
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtpu_torch.plugin.main", "--discovery",
         "fake", "--device-split-count", "4", "--device-plugin-path",
         f"{tdir}/", "--host-lib-dir", thost, "--enable-metricsd", "true"],
        env=env, stderr=subprocess.PIPE, text=True)
    jcfg = jconfig.parse_args([
        "--discovery", "fake", "--device-split-count", "4",
        "--device-plugin-path", f"{jdir}/", "--host-lib-dir", jhost,
        "--runtime-socket", str(jdir / "no-broker.sock")])
    backend = JFake(8, "v5e", hbm_bytes=FakeChipBackend().chips()[0].hbm_bytes)
    jplug = JPlugin(jsplit.build_plugin_specs(jcfg, backend)[0], jcfg,
                    topology=backend.topology())
    saved = os.environ.get(envspec.ENV_MIN_EXEC_COST)
    if floor is not None:
        os.environ[envspec.ENV_MIN_EXEC_COST] = floor
    else:
        os.environ.pop(envspec.ENV_MIN_EXEC_COST, None)
    try:
        jplug.start(register=True)
        yield tsim, jsim, proc, (jhost, thost, floor)
    finally:
        if saved is None:
            os.environ.pop(envspec.ENV_MIN_EXEC_COST, None)
        else:
            os.environ[envspec.ENV_MIN_EXEC_COST] = saved
        jplug.stop()
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        tsim.stop()
        jsim.stop()


@pytest.mark.parametrize("daemons", [None, "5000"], indirect=True,
                         ids=["no_floor", "operator_floor"])
def test_daemon_answers_as_vtpu_does(daemons):
    tsim, jsim, proc, (jhost, thost, floor) = daemons
    treg = tsim.wait_registration(timeout=30)
    jreg = jsim.wait_registration(timeout=10)
    assert (treg.version, treg.endpoint, treg.resource_name) == \
        (jreg.version, jreg.endpoint, jreg.resource_name)
    assert treg.options.get_preferred_allocation_available
    tstub, tch = tsim.plugin_stub(treg.endpoint)
    jstub, jch = jsim.plugin_stub(jreg.endpoint)
    try:
        assert tstub.GetDevicePluginOptions(pb.Empty()) == \
            jstub.GetDevicePluginOptions(pb.Empty())
        tdev = collect_stream(tstub.ListAndWatch(pb.Empty()), 1)[0].devices
        jdev = collect_stream(jstub.ListAndWatch(pb.Empty()), 1)[0].devices
        assert len(tdev) == 32
        assert sorted(os.listdir(os.path.join(thost, "busy"))) == \
            [f"GPU-fake-h100-{i:02d}.busy" for i in range(8)]
        assert [(d.ID, d.health, [n.ID for n in d.topology.nodes])
                for d in tdev] == \
            [(to_port(d.ID), d.health, [n.ID for n in d.topology.nodes])
             for d in jdev]
        ids = [d.ID for d in tdev]
        pref = tstub.GetPreferredAllocation(pb.PreferredAllocationRequest(
            container_requests=[pb.ContainerPreferredAllocationRequest(
                available_deviceIDs=ids[4:], must_include_deviceIDs=[ids[9]],
                allocation_size=3)]))
        chosen = list(pref.container_responses[0].deviceIDs)
        assert chosen[0] == ids[9] and len(chosen) == 3
        assert len({c.rsplit("-vtpu-", 1)[0] for c in chosen}) == 3
        for request in ([chosen], [[ids[0]], [ids[1], ids[31]]]):
            treq = pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=r) for r in request])
            jreq = pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=[
                    i.replace("GPU-fake-h100", "TPU-fake-v5e") for i in r])
                for r in request])
            tresp = tstub.Allocate(treq).container_responses
            jresp = jstub.Allocate(jreq).container_responses
            assert len(tresp) == len(jresp) == len(request)
            for t, j in zip(tresp, jresp):
                got_env, got_mounts = answer(t)
                want_env, want_mounts = expected_port_answer(j, jhost, thost,
                                                             floor)
                assert REGION.fullmatch(
                    got_env.pop(envspec.ENV_SHARED_CACHE))
                assert REGION.fullmatch(
                    want_env.pop(envspec.ENV_SHARED_CACHE))
                assert got_env == want_env
                assert got_mounts == want_mounts
                assert list(t.devices) == list(j.devices) == []
                assert dict(t.annotations) == dict(j.annotations) == {}
                assert (envspec.ENV_MIN_EXEC_COST in got_env) == \
                    (floor is not None)
        # An unknown id fails the call, as in vtpu.
        import grpc
        with pytest.raises(grpc.RpcError):
            tstub.Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=["GPU-nope-vtpu-0"])]))
    finally:
        tch.close()
        jch.close()
    assert proc.poll() is None, proc.stderr.read()


def test_daemon_health_and_shutdown(tmp_path):
    """A fault written for a card flips its four vdevices unhealthy over
    ListAndWatch, clearing it recovers them, and SIGTERM ends the daemon
    with its socket removed."""
    faults = tmp_path / "faults"
    faults.mkdir()
    sim = KubeletSim(str(tmp_path)).start()
    env = {k: v for k, v in os.environ.items() if not k.startswith("VTPU_")}
    env.update(PYTHONPATH=REPO, VTPU_FAKE_CHIPS="2", VTPU_LOG_LEVEL="0",
               VTPU_FAKE_FAULT_DIR=str(faults), VTPU_HEALTH_INTERVAL="0.2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vtpu_torch.plugin.main", "--discovery",
         "fake", "--device-split-count", "4", "--device-plugin-path",
         f"{tmp_path}/", "--host-lib-dir", str(tmp_path / "host")], env=env)
    try:
        reg = sim.wait_registration(timeout=30)
        stub, ch = sim.plugin_stub(reg.endpoint)
        stream = stub.ListAndWatch(pb.Empty())
        assert all(d.health == "Healthy"
                   for d in collect_stream(stream, 1)[0].devices)
        (faults / "GPU-fake-h100-01").write_text("critical XID 79")
        upd = collect_stream(stream, 1, timeout=10)
        assert [d.ID for d in upd[-1].devices if d.health == "Unhealthy"] \
            == [f"GPU-fake-h100-01-vtpu-{i}" for i in range(4)]
        (faults / "GPU-fake-h100-01").unlink()
        rec = collect_stream(stream, 1, timeout=10)
        assert all(d.health == "Healthy" for d in rec[-1].devices)
        ch.close()
        sock = tmp_path / reg.endpoint
        assert sock.exists()
        proc.terminate()
        assert proc.wait(timeout=10) == 0
        assert not sock.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        sim.stop()


# -- monitor mode and the legacy controller, against vtpu's -------------------

def pending_pod(name, uid, n, env=None):
    """vtpu's tests/test_plugin_server.py pending pod."""
    ctr = {"name": "main",
           "resources": {"limits": {"4paradigm.com/vtpu": str(n)}}}
    if env is not None:
        ctr["env"] = env
    return {"metadata": {"namespace": "default", "name": name, "uid": uid},
            "status": {"phase": "Pending"}, "spec": {"containers": [ctr]}}


def plugin_pair(tmp_path, split, chips, listers, controllers=(None, None)):
    """vtpu's plugin and the port's (not serving: Allocate is called
    directly) on matching fake inventories, each with its own host dir
    and pod lister; the port's host has its interposer, busy files and
    shim staged, vtpu's the files its preload mounts need."""
    thost = stage(tmp_path)
    stage_shim(thost)
    jhost = str(tmp_path / "jhost")
    os.makedirs(jhost)
    for name in ("libvtpu_preload.so", "ld.so.preload"):
        open(os.path.join(jhost, name), "w").close()
    common = ["--discovery", "fake", "--device-split-count", str(split),
              "--monitor-mode", "true", "--node-name", "node1"]
    jcfg = jconfig.parse_args(common + [
        "--device-plugin-path", f"{tmp_path}/jkubelet/", "--host-lib-dir",
        jhost, "--runtime-socket", str(tmp_path / "no-broker.sock")])
    tcfg = tconfig.parse_args(common + [
        "--device-plugin-path", f"{tmp_path}/tkubelet/", "--host-lib-dir",
        thost, "--enable-metricsd", "true"])     # on in vtpu by default
    tback = FakeChipBackend(chips)
    jback = JFake(chips, "v5e", hbm_bytes=tback.chips()[0].hbm_bytes)
    jplug = JPlugin(jsplit.build_plugin_specs(jcfg, jback)[0], jcfg,
                    topology=jback.topology(), controller=controllers[0],
                    pod_lister=listers[0])
    tplug = TPlugin(tsplit.build_plugin_specs(tcfg, tback)[0], tcfg,
                    topology=tback.topology(), controller=controllers[1],
                    pod_lister=listers[1])
    return jplug, tplug, jhost, thost


def allocate_both(jplug, tplug, jhost, thost, i):
    """Allocate vdevice ``i`` of each; the port's answer and vtpu's
    through the substitutions."""
    jresp = jplug.Allocate(pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devicesIDs=[jplug.vdevices[i].id])]),
        None).container_responses[0]
    tresp = tplug.Allocate(tpb.AllocateRequest(container_requests=[
        tpb.ContainerAllocateRequest(devicesIDs=[tplug.vdevices[i].id])]),
        None).container_responses[0]
    got = answer(tresp)
    want = expected_port_answer(jresp, jhost, thost, None)
    for envs, _ in (got, want):   # private regions: a random name each
        if REGION.fullmatch(envs[envspec.ENV_SHARED_CACHE]):
            envs[envspec.ENV_SHARED_CACHE] = "/tmp/<private>"
    return got, want, dict(tresp.annotations), dict(jresp.annotations)


@pytest.fixture()
def no_floor(monkeypatch):
    for k in (envspec.ENV_MIN_EXEC_COST, envspec.ENV_UTILIZATION_POLICY):
        monkeypatch.delenv(k, raising=False)


def test_monitor_mode_distinct_shared_dirs(tmp_path, no_floor):
    """Two same-sized pending pods get two regions, each in its own
    directory made on the host, and each pod mounts only its own
    (vtpu tests/test_plugin_server.py:371)."""
    pods = [pending_pod("job-a", "uid-aaaa0000", 1),
            pending_pod("job-b", "uid-bbbb0000", 1)]
    jplug, tplug, jhost, thost = plugin_pair(
        tmp_path, 2, 2, (lambda node: pods, lambda node: pods))
    regions = []
    for i in (0, 1):
        got, want, _, _ = allocate_both(jplug, tplug, jhost, thost, i)
        assert got == want
        region = got[0][envspec.ENV_SHARED_CACHE]
        regions.append(region)
        name = os.path.basename(os.path.dirname(region))
        assert os.path.isdir(os.path.join(thost, "shared", name))
        assert [m for m in got[1] if "/shared" in m[0]] == [
            (os.path.dirname(region), f"{thost}/shared/{name}", False)]
    assert regions == [
        "/usr/local/vtpu/shared/default_job-a_main_uid-aaaa/vtpushr.cache",
        "/usr/local/vtpu/shared/default_job-b_main_uid-bbbb/vtpushr.cache"]


def test_monitor_mode_pythonpath_merged_not_clobbered(tmp_path, no_floor):
    """A pod-declared PYTHONPATH goes behind the shim's entry, with the
    merge flag; a pod without one gets the shim's entry alone (vtpu
    tests/test_plugin_server.py:414)."""
    pod = pending_pod("job-pp", "uid-pp000000", 1, env=[
        {"name": "PYTHONPATH", "value": "/app/lib:/app/vendor"},
        {"name": "OTHER", "value": "x"},
        {"name": "FROMREF", "valueFrom": {"fieldRef": {}}}])
    pods = [pod, pending_pod("job-plain", "uid-pl000000", 1)]
    jplug, tplug, jhost, thost = plugin_pair(
        tmp_path, 2, 2, (lambda node: pods, lambda node: pods))
    got = {}
    for i in (0, 1):
        (envs, mounts), want, _, _ = allocate_both(jplug, tplug, jhost,
                                                   thost, i)
        assert (envs, mounts) == want
        got["merged" if "job-pp" in envs[envspec.ENV_SHARED_CACHE]
            else "plain"] = envs
    shim = "/usr/local/vtpu/shim"
    assert got["merged"]["PYTHONPATH"] == f"{shim}:/app/lib:/app/vendor"
    assert got["merged"]["VTPU_SHIM_PYTHONPATH"] == shim
    assert got["merged"]["VTPU_PYTHONPATH_MERGED"] == "1"
    assert got["plain"]["PYTHONPATH"] == shim
    assert "VTPU_PYTHONPATH_MERGED" not in got["plain"]


def test_monitor_mode_pod_list_cached_across_allocates(tmp_path, no_floor):
    """Ten Allocates share the TTL-cached pod list (at most two upstream
    LISTs) and resolve ten pods to ten regions, as vtpu's (vtpu
    tests/test_plugin_server.py:468)."""
    pods = [pending_pod(f"job-{i}", f"uid-{i:04d}0000", 1)
            for i in range(10)]
    calls = ([], [])
    listers = tuple(lambda node, c=c: c.append(node) or pods for c in calls)
    jplug, tplug, jhost, thost = plugin_pair(tmp_path, 12, 1, listers)
    regions = []
    for i in range(10):
        got, want, _, _ = allocate_both(jplug, tplug, jhost, thost, i)
        assert got == want
        regions.append(got[0][envspec.ENV_SHARED_CACHE])
    assert len(set(regions)) == 10
    assert len(calls[1]) == len(calls[0]) <= 2


def test_monitor_mode_fresh_retry_on_cache_miss(tmp_path, no_floor):
    """A pod created inside the cache's TTL is still matched: with every
    cached candidate claimed, one fresh LIST (vtpu
    tests/test_plugin_server.py:512); with no match at all the region is
    private and nothing of shared/ is mounted."""
    pods = [pending_pod("early", "uid-ea000000", 1)]
    calls = ([], [])
    listers = tuple(lambda node, c=c: c.append(node) or list(pods)
                    for c in calls)
    jplug, tplug, jhost, thost = plugin_pair(tmp_path, 4, 1, listers)
    got, want, _, _ = allocate_both(jplug, tplug, jhost, thost, 0)
    assert got == want and "early" in got[0][envspec.ENV_SHARED_CACHE]
    pods.append(pending_pod("late", "uid-la000000", 1))
    got, want, _, _ = allocate_both(jplug, tplug, jhost, thost, 1)
    assert got == want and "late" in got[0][envspec.ENV_SHARED_CACHE]
    assert len(calls[0]) == len(calls[1]) == 2
    pods.clear()
    got, want, _, _ = allocate_both(jplug, tplug, jhost, thost, 2)
    assert got == want
    assert got[0][envspec.ENV_SHARED_CACHE] == "/tmp/<private>"
    assert not [m for m in got[1] if "/shared" in m[0]]


def write_checkpoint(path, pb_mod, pod_uid, request, using):
    car = pb_mod.ContainerAllocateResponse()
    car.annotations["4paradigm.com/vtpu-request"] = ",".join(request)
    car.annotations["4paradigm.com/vtpu-using"] = ",".join(using)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"Data": {"PodDeviceEntries": [{
            "PodUID": pod_uid, "ResourceName": "4paradigm.com/vtpu",
            "DeviceIDs": request,
            "AllocResp": base64.b64encode(car.SerializeToString()).decode(),
        }]}, "Checksum": 0}, f)


def test_legacy_allocate_re_picks_with_annotations(tmp_path, no_floor):
    """vtpu tests/test_controller.py:92 on one card split in two: the
    kubelet's checkpoint shows vdevice 0 granted to a live pod (for its
    request of 1), and an Allocate of the stale ID 0 is given vdevice 1,
    by both plugins, with the same env and mounts.  The port's request
    annotation is the kubelet's ID, where vtpu writes the granted one
    under both annotations."""
    pods = [{"metadata": {"uid": "live-pod"}, "status": {"phase": "Running"}}]
    ctls = (JController(jconfig.Config(
                device_plugin_path=f"{tmp_path}/jkubelet/", node_name="n"),
                pod_lister=lambda node: pods),
            VDeviceController(tconfig.Config(
                device_plugin_path=f"{tmp_path}/tkubelet/", node_name="n"),
                pod_lister=lambda node: pods))
    jplug, tplug, jhost, thost = plugin_pair(tmp_path, 2, 1, (None, None),
                                             ctls)
    for ctl, plug, mod in zip(ctls, (jplug, tplug), (pb, tpb)):
        write_checkpoint(ctl.checkpoint_path, mod, "live-pod",
                         [plug.vdevices[1].id], [plug.vdevices[0].id])
    got, want, tann, jann = allocate_both(jplug, tplug, jhost, thost, 0)
    assert got == want
    assert jann == {"4paradigm.com/vtpu-request": jplug.vdevices[1].id,
                    "4paradigm.com/vtpu-using": jplug.vdevices[1].id}
    assert tann == {"4paradigm.com/vtpu-request": tplug.vdevices[0].id,
                    "4paradigm.com/vtpu-using": tplug.vdevices[1].id}
    assert tplug.GetDevicePluginOptions(None, None) == \
        jplug.GetDevicePluginOptions(None, None)
    assert not tplug.GetDevicePluginOptions(
        None, None).get_preferred_allocation_available


def test_daemon_monitor_and_legacy_over_grpc(tmp_path, no_floor):
    """The daemon with both modes on, driven over its socket: it registers
    without preferred allocation, the controller re-picks the stale ID
    from the checkpoint, and the matched pod's region, PYTHONPATH and own
    shared mount come back with the annotations.  vtpu_torch.plugin.main
    builds the controller and the shared pod lister."""
    host = stage(tmp_path)
    stage_shim(host)
    pods = [pending_pod("job-a", "uid-aaaa0000", 1,
                        env=[{"name": "PYTHONPATH", "value": "/app/lib"}]),
            {"metadata": {"uid": "live-pod"},
             "status": {"phase": "Running"}}]
    lists = []
    cfg = tconfig.parse_args([
        "--discovery", "fake", "--device-split-count", "2",
        "--monitor-mode", "true", "--enable-legacy-preferred", "true",
        "--node-name", "node1", "--device-plugin-path", f"{tmp_path}/",
        "--host-lib-dir", host])
    # The live pod asked the kubelet for vdevice 1 and was given 0, so
    # the kubelet takes 0 for free.
    write_checkpoint(str(tmp_path / "kubelet_internal_checkpoint"), tpb,
                     "live-pod", ["GPU-fake-h100-00-vtpu-1"],
                     ["GPU-fake-h100-00-vtpu-0"])
    sim = KubeletSim(str(tmp_path)).start()
    daemon = Daemon(cfg, FakeChipBackend(1), pod_lister=lambda node, **kw:
                    lists.append((node, kw)) or pods)
    try:
        assert daemon.start_plugins()
        plug, = daemon.plugins
        assert plug.controller is not None
        assert plug.pod_lister is daemon.pod_lister
        assert plug.controller.pod_lister is daemon.pod_lister
        reg = sim.wait_registration(timeout=10)
        assert not reg.options.get_preferred_allocation_available
        stub, ch = sim.plugin_stub(reg.endpoint)
        try:
            car = stub.Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(
                    devicesIDs=["GPU-fake-h100-00-vtpu-0"])])
            ).container_responses[0]
        finally:
            ch.close()
    finally:
        daemon.stop_plugins()
        sim.stop()
    envs, mounts = answer(car)
    name = "default_job-a_main_uid-aaaa"
    assert envs["VTPU_DEVICE_MEMORY_SHARED_CACHE"] == \
        f"/usr/local/vtpu/shared/{name}/vtpushr.cache"
    assert envs["PYTHONPATH"] == "/usr/local/vtpu/shim:/app/lib"
    assert envs["VTPU_PYTHONPATH_MERGED"] == "1"
    assert (f"/usr/local/vtpu/shared/{name}", f"{host}/shared/{name}",
            False) in mounts
    assert [m[0] for m in mounts[:3]] == [
        "/usr/local/vtpu/libvtpucore.so", "/usr/local/vtpu/shim",
        "/usr/local/vtpu/vtpu-smi"]
    assert dict(car.annotations) == {
        "4paradigm.com/vtpu-request": "GPU-fake-h100-00-vtpu-0",
        "4paradigm.com/vtpu-using": "GPU-fake-h100-00-vtpu-1"}
    assert lists and all(node == "node1" for node, _ in lists)


def test_stage_shim(tmp_path):
    """The staged shim: the two scripts and a real package copy without
    native tests, mocks or build output, and the region library beside
    it; staging again replaces it whole.  Without it, no PYTHONPATH and
    none of its mounts."""
    host = str(tmp_path / "host")
    got = stage_shim(host)
    shim = got["shim"]
    assert sorted(os.listdir(shim)) == ["sitecustomize.py",
                                        "vtpu_smi_lite.py", "vtpu_torch"]
    pkg = os.path.join(shim, "vtpu_torch")
    assert not os.path.islink(pkg)
    staged = {os.path.relpath(os.path.join(r, f), pkg)
              for r, _, fs in os.walk(pkg) for f in fs}
    assert {"__init__.py", "shim/pyshim.py", "ops/_build.py",
            "native/interposer.cc", "ops/csrc/flash_attention_sm90.cu"} \
        <= staged
    assert not [f for f in staged if f.endswith("_test.cc")
                or "mock_cuda" in f or "__pycache__" in f]
    assert os.path.getsize(got["libvtpucore.so"]) > 0
    open(os.path.join(shim, "stale"), "w").close()
    stage_shim(host)
    assert not os.path.exists(os.path.join(shim, "stale"))
    assert sorted(os.listdir(host)) == ["libvtpucore.so", "shim"]
    cfg = tconfig.Config(host_lib_dir=str(tmp_path / "bare"))
    g = one_grant(cfg, FakeChipBackend(1))
    assert "PYTHONPATH" not in g.envs and g.mounts == []
