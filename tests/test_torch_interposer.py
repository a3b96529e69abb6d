"""The port's native interposer (libvtpu_cuda.so, native/interposer.cc) on
the CPU: g++ builds it, the mock driver (native/mock_cuda.cc as
libcuda.so.1 and libnvidia-ml.so.1) stands in for the card, and each
scenario of native/interposer_test.cc runs in its own preloaded process.
The quota the interposer parses is held against vtpu's envspec."""

import ctypes
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from vtpu.utils import envspec as jenv
from vtpu_torch.ops import _build
from vtpu_torch.plugin.grant import BUSY_FILE_BYTES
from vtpu_torch.shim import interposer
from vtpu_torch.shim.core import SharedRegion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "4paradigm-k8s-device-plugin_tpu_torch",
                      "native")

# (scenario, exit status): `killer` must die of SIGKILL.
SCENARIOS = [
    ("mem", 0), ("throttle", 0), ("shared_region", 0), ("sole_fast", 0),
    ("floor_zero_latency", 0),
    ("spill", 0), ("killer", -9), ("procaddr", 0), ("meminfo_nvml", 0),
    ("vmm", 0), ("launch_ex", 0), ("graph", 0), ("failclosed", 0),
    ("forward_other", 0),
    # Per-card busy files: two regions on one card, and slot ownership by
    # token and heartbeat rather than pid.
    ("busy_dir_pair", 0), ("slot_fresh_unreachable", 0), ("slot_lapsed", 0),
    # A planted symlink or a short file where a card's busy file goes is
    # neither followed nor written.
    ("busy_symlink", 0), ("busy_short", 0),
    # CUDA arrays and graph memory nodes are charged and released; a memory
    # node's charge outlives its graph while an executable graph made from
    # it, or an allocation one of its launches left, lives.
    ("array", 0), ("graph_node", 0),
    # Launches on a per-thread default stream are metered and throttled;
    # their events stay one per (thread, context) and go with the thread.
    ("ptsz_meter", 0), ("ptsz_threads", 0),
]


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The interposer, the scenario driver and a directory whose
    libcuda.so.1 and libnvidia-ml.so.1 are the mocks."""
    paths = _build.build_all(("vtpu_cuda", "mockcuda", "mocknvml",
                              "interposer_test"))
    mocks = tmp_path_factory.mktemp("mock_driver")
    os.symlink(paths["mockcuda"], mocks / "libcuda.so.1")
    os.symlink(paths["mocknvml"], mocks / "libnvidia-ml.so.1")
    return paths, str(mocks)


def preloaded_env(native, region, quota=None):
    """A clean environment (no VTPU_* of the caller's) under the
    interposer, with the mocks as the driver."""
    paths, mocks = native
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("VTPU_", "MOCK_", "LD_"))}
    env = interposer.tenant_env(dict(quota or {}), base=base)
    assert env["LD_PRELOAD"] == paths["vtpu_cuda"]
    env.update(LD_LIBRARY_PATH=mocks,
               VTPU_DEVICE_MEMORY_SHARED_CACHE=str(region))
    return env


@pytest.mark.parametrize("name,status", SCENARIOS,
                         ids=[s for s, _ in SCENARIOS])
def test_scenario(native, tmp_path, name, status):
    env = preloaded_env(native, tmp_path / "region.cache")
    r = subprocess.run([native[0]["interposer_test"], name], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == status, r.stdout + r.stderr
    if status == 0:
        assert f"scenario {name}: OK" in r.stdout


def test_grant_env_reports_the_grant_cap(native, tmp_path):
    """A tenant started with exactly an Allocate grant's env (vtpu_torch.
    plugin.grant, split 2 of a fake H100; LD_PRELOAD and the busy directory
    at their host paths, as no container mounts them here) sees the
    grant's cap in cuMemGetInfo and meets its card's busy file."""
    from vtpu_torch.discovery.fake import FakeChipBackend
    from vtpu_torch.plugin.config import Config
    from vtpu_torch.plugin.grant import (grant, stage_busy_files,
                                         staged_files)
    from vtpu_torch.plugin.split import build_plugin_specs
    from vtpu_torch.utils.envspec import parse_quantity

    paths, mocks = native
    host = tmp_path / "host"
    staged = staged_files(str(host), paths["vtpu_cuda"])
    backend = FakeChipBackend(1)
    stage_busy_files(str(host), [c.uuid for c in backend.chips()])
    cfg = Config(host_lib_dir=str(host), device_split_count=2)
    spec = build_plugin_specs(cfg, backend)[0]
    g = grant(cfg, spec, spec.vdevices[1:], [spec.vdevices[1].id])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("VTPU_", "MOCK_", "LD_"))}
    env.update(g.envs)
    by_cpath = {m.container_path: m.host_path for m in g.mounts}
    env["LD_PRELOAD"] = by_cpath["/usr/local/vtpu/libvtpu_cuda.so"]
    assert env["LD_PRELOAD"] == staged["libvtpu_cuda.so"]
    card = os.path.join(g.envs["VTPU_DEVICE_BUSY_DIR"],
                        "GPU-fake-h100-00.busy")
    env["VTPU_DEVICE_BUSY_DIR"] = os.path.dirname(by_cpath[card])
    env["VTPU_DEVICE_MEMORY_SHARED_CACHE"] = str(tmp_path / "region.cache")
    cap = parse_quantity(g.envs["VTPU_DEVICE_HBM_LIMIT_0"])
    env.update(LD_LIBRARY_PATH=mocks, VTPU_TEST_EXPECT_TOTAL=str(cap))
    r = subprocess.run([paths["interposer_test"], "grant_env"], env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "scenario grant_env: OK" in r.stdout
    assert cap == 42_760_000_000
    assert (host / "busy" / "GPU-fake-h100-00.busy").stat().st_size == \
        BUSY_FILE_BYTES


# Quota envs for the parity test: quantities, per-device overrides,
# policies, flags, and values envspec rejects.
QUOTAS = [
    {},
    {"VTPU_DEVICE_HBM_LIMIT": "20Gi"},
    {"VTPU_DEVICE_HBM_LIMIT_0": "1.5G", "VTPU_DEVICE_CORE_LIMIT": "50"},
    {"VTPU_DEVICE_HBM_LIMIT": "512Mi", "VTPU_DEVICE_HBM_LIMIT_2": "3000m",
     "VTPU_DEVICE_HBM_LIMIT_1": "0"},
    {"VTPU_DEVICE_HBM_LIMIT_0": " 7 KiB ", "VTPU_DEVICE_HBM_LIMIT_3": "2t"},
    {"VTPU_DEVICE_CORE_LIMIT": "150", "VTPU_CORE_UTILIZATION_POLICY": "force",
     "VTPU_TASK_PRIORITY": "0", "VTPU_OVERSUBSCRIBE": "yes",
     "VTPU_ACTIVE_OOM_KILLER": "on"},
    {"VTPU_DEVICE_CORE_LIMIT": "25", "VTPU_CORE_UTILIZATION_POLICY": "DISABLE",
     "VTPU_OVERSUBSCRIBE": "false"},
    {"VTPU_DEVICE_CORE_LIMIT": "25",
     "VTPU_CORE_UTILIZATION_POLICY": "bogus"},
    {"VTPU_DEVICE_HBM_LIMIT_0": "1Gi", "VTPU_MIN_EXEC_COST_US": "5000"},
    {"VTPU_DEVICE_HBM_LIMIT": "20Gx"},
    {"VTPU_DEVICE_HBM_LIMIT_0": "-1Gi"},
    {"VTPU_DEVICE_HBM_LIMIT_16": "1Gi"},
    {"VTPU_DEVICE_HBM_LIMIT_x": "1Gi"},
    {"VTPU_DEVICE_CORE_LIMIT": "half"},
    {"VTPU_DEVICE_HBM_LIMIT_0": "1Gi", "VTPU_DEVICE_MAP": "0:GPU-a 1:GPU-b",
     "VTPU_DEVICE_BUSY_DIR": "/usr/local/vtpu/busy"},
    {"VTPU_DEVICE_HBM_LIMIT_0": "1Gi", "VTPU_DEVICE_MAP": "0GPU-a"},
    {"VTPU_DEVICE_HBM_LIMIT_0": "1Gi", "VTPU_DEVICE_MAP": "x:GPU-a"},
]
POLICIES = {"DEFAULT": 0, "FORCE": 1, "DISABLE": 2}


def _parsed_by_interposer(native, region, quota):
    """The interposer's stats after one hooked call in a preloaded
    process (which parses the env and opens the region)."""
    code = f"""
        import ctypes, json, sys
        sys.path.insert(0, {REPO!r})
        from vtpu_torch.shim import interposer
        cu = ctypes.CDLL("libcuda.so.1")
        assert cu.cuInit(0) == 0
        free, total = ctypes.c_size_t(), ctypes.c_size_t()
        cu.cuMemGetInfo_v2(ctypes.byref(free), ctypes.byref(total))
        print(json.dumps(interposer.stats()))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=preloaded_env(native, region, quota),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("quota", QUOTAS, ids=[
    ",".join(f"{k[5:]}={v.strip()}" for k, v in q.items()) or "none"
    for q in QUOTAS])
def test_quota_parse_matches_vtpu_envspec(native, tmp_path, quota):
    """The C++ interposer reads the env exactly as vtpu's envspec does:
    the limits and compute share it seeds the region with, and the
    policy, priority and flags it enforces; and where envspec raises, the
    interposer fails closed and opens no region."""
    region = tmp_path / "region.cache"
    got = _parsed_by_interposer(native, region, quota)
    try:
        spec = jenv.quota_from_env(quota)
    except ValueError:
        assert got["state"] == 2
        assert not region.exists()
        return
    if not (spec.hbm_limit_bytes or spec.core_limit_pct):
        assert got["state"] == 0 and not region.exists()
        return
    assert got["state"] == 1
    n = max([o for o in spec.hbm_limit_bytes if o >= 0], default=0) + 1
    with SharedRegion(str(region)) as reg:
        assert reg.ndevices == n == got["ndev"]
        for i in range(n):
            stats = reg.device_stats(i)
            assert stats.limit_bytes == spec.limit_for(i) == got["limits"][i]
            assert stats.core_limit_pct == spec.core_limit_pct
    assert got["core_pct"] == spec.core_limit_pct
    assert got["policy"] == POLICIES[spec.utilization_policy]
    assert got["priority"] == spec.task_priority
    assert bool(got["oversubscribe"]) == spec.oversubscribe
    assert bool(got["oom_killer"]) == spec.active_oom_killer
    # The pyshim's floor: float(VTPU_MIN_EXEC_COST_US), in whole µs.
    assert got["min_cost_us"] == int(float(
        quota.get("VTPU_MIN_EXEC_COST_US", "0")))


def test_busy_file_bytes_match_the_library(native, tmp_path):
    """The size of a card's busy file that the daemon stages
    (plugin.grant.BUSY_FILE_BYTES) and the scenario driver's mirror of the
    slot layout are the size the interposer itself exports: a grown slot
    struct fails here rather than leave the daemon staging files the
    interposer refuses as short."""
    env = preloaded_env(native, tmp_path / "region.cache")
    r = subprocess.run([native[0]["interposer_test"], "busy_file_bytes"],
                       env=env, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    library, mirror = map(int, re.search(
        r"busy_file_bytes: library (\d+) mirror (\d+)", r.stdout).groups())
    assert library == mirror == BUSY_FILE_BYTES


def test_stats_mirror_matches_interposer():
    """shim/interposer.py:Stats has the interposer's struct fields in its
    order (a drifted mirror fails the size check in stats() as well)."""
    with open(os.path.join(NATIVE, "interposer.cc")) as f:
        src = f.read()
    body = re.search(r"struct vtpu_cuda_stats \{(.*?)\n\};", src, re.S)
    fields = re.findall(r"^\s*(?:u?int\d+_t)\s+(\w+)(?:\[\w+\])?;",
                        body.group(1), re.M)
    assert fields == [name for name, _ in interposer.Stats._fields_]
    assert ctypes.sizeof(interposer.Stats) == 14 * 8 + 8 * 4 + 16 * 8


def test_not_loaded_here():
    """This test process was not started under the interposer."""
    assert not interposer.loaded()
    assert interposer.stats() is None
