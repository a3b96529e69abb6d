"""The port's device-plugin daemon (vtpu_torch.plugin) against vtpu's: the
vdevice split, the split strategies, the flags, Allocate's grant, and the
daemon itself driven over its unix socket by the unchanged
tests/kubelet_sim.py, its answers compared with vtpu's plugin on the
matching fake inventory through the substitution table below.  All
comparisons are exact."""

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
from vtpu.plugin.server import VtpuDevicePlugin as JPlugin
from vtpu.proto import pb
from vtpu_torch.discovery.fake import FakeChipBackend
from vtpu_torch.discovery.types import GpuChip, MigInstance
from vtpu_torch.plugin import config as tconfig
from vtpu_torch.plugin import split as tsplit
from vtpu_torch.plugin import vdevice as tvd
from vtpu_torch.plugin.grant import (BUSY_FILE_BYTES, grant,
                                     stage_busy_files, staged_files)
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


@pytest.mark.parametrize("flag", ["--enable-runtime", "--enable-metricsd",
                                  "--enable-legacy-preferred",
                                  "--monitor-mode"])
def test_unported_flags_refuse(flag, monkeypatch):
    with pytest.raises(SystemExit, match="ROADMAP"):
        tconfig.parse_args([flag, "true"])
    env = {"--enable-runtime": "VTPU_ENABLE_RUNTIME",
           "--enable-metricsd": "VTPU_METRICSD_ENABLE",
           "--enable-legacy-preferred": "ENABLE_LEGACY_PREFERRED",
           "--monitor-mode": "VTPU_MONITOR_MODE"}[flag]
    monkeypatch.setenv(env, "true")
    with pytest.raises(SystemExit, match=flag):
        tconfig.parse_args([])


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


# -- the daemon, driven by the kubelet simulator, against vtpu's ----------------

# vtpu's Allocate env -> the port's: a new name, None (not emitted until
# its subsystem is ported, or no H100 default), or the same name.
ENV_SUBSTITUTIONS = {
    "VTPU_VISIBLE_DEVICES": "NVIDIA_VISIBLE_DEVICES",
    "TPU_LIBRARY_PATH": None,            # the ld.so.preload mount instead
    "VTPU_SHIM_PYTHONPATH": None,        # the shim
    "PYTHONPATH": None,
    "VTPU_METRICSD_PORT": None,          # metricsd
    "TPU_RUNTIME_METRICS_PORTS": None,
    "VTPU_METRICSD_UPSTREAM": None,
}
# vtpu's mounts, by container path -> the port's container path or None.
MOUNT_SUBSTITUTIONS = {
    "/usr/local/vtpu/libvtpu_pjrt.so": None,      # the ld.so.preload mount
    "/usr/local/vtpu/libvtpucore.so": None,       # compiled into the lib
    "/usr/local/vtpu/shim": None,
    "/usr/local/vtpu/vtpu-smi": None,
    "/usr/local/vtpu/libvtpu_preload.so": "/usr/local/vtpu/libvtpu_cuda.so",
    "/etc/ld.so.preload": "/etc/ld.so.preload",
}
HOST_NAMES = {"libvtpu_preload.so": "libvtpu_cuda.so",
              "ld.so.preload": "ld.so.preload"}
# Added by the port: the per-card busy files' directory.
PORT_ONLY_ENV = {"VTPU_DEVICE_BUSY_DIR": "/usr/local/vtpu/busy"}
REGION = re.compile(r"/tmp/vtpu_[0-9a-f]{12}\.cache")


def to_port(text):
    return re.sub(r"TPU-fake-v5e-(\d\d)", r"GPU-fake-h100-\1", text)


def expected_port_answer(jresp, jhost, thost, floor):
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
        cpath = MOUNT_SUBSTITUTIONS[m.container_path]
        if cpath is not None:
            host = os.path.join(thost, HOST_NAMES[os.path.basename(
                m.host_path)])
            assert os.path.dirname(m.host_path) == jhost
            mounts.append((cpath, host, m.read_only))
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
         f"{tdir}/", "--host-lib-dir", thost], env=env,
        stderr=subprocess.PIPE, text=True)
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
