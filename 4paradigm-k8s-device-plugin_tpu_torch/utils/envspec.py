"""The quota half of the env-var contract between the device-plugin daemon
and the in-container enforcement layer.

The ``ContainerAllocateResponse`` carries only env vars and mounts; this
module parses the part of it a tenant process reads.  The names are
``vtpu``'s own (``VTPU_DEVICE_HBM_LIMIT[_<i>]``, ``VTPU_DEVICE_CORE_LIMIT``,
``VTPU_DEVICE_MEMORY_SHARED_CACHE``, ...), so one environment drives both
packages and both enforce over the same shared region.

Memory limit values accept Kubernetes-style quantities: a bare integer is
bytes; suffixes ``k/m/g/t`` (decimal, case-insensitive) and
``Ki/Mi/Gi/Ti`` (binary).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional

# Per-virtual-device HBM cap, in K8s quantity syntax; ``_<i>`` is the
# container-visible device ordinal.  Unsuffixed form applies to all devices.
ENV_HBM_LIMIT = "VTPU_DEVICE_HBM_LIMIT"
# Compute quota as a percentage of one card's device time (0-100, 0 = no cap).
ENV_CORE_LIMIT = "VTPU_DEVICE_CORE_LIMIT"
# Ordinal→physical mapping: "<i>:<uuid> <j>:<uuid> ...".
ENV_DEVICE_MAP = "VTPU_DEVICE_MAP"
# Path of the cross-process shared accounting region (mmap'd file).
ENV_SHARED_CACHE = "VTPU_DEVICE_MEMORY_SHARED_CACHE"
# "true" → allocations past the HBM cap are admitted instead of refused.
ENV_OVERSUBSCRIBE = "VTPU_OVERSUBSCRIBE"
# Task priority for the compute scheduler (0 = highest).
ENV_TASK_PRIORITY = "VTPU_TASK_PRIORITY"
# Compute-limit policy: DEFAULT (limit iff shared), FORCE, DISABLE.
ENV_UTILIZATION_POLICY = "VTPU_CORE_UTILIZATION_POLICY"
# "true" → kill the offending process on quota violation instead of failing
# the allocation.
ENV_ACTIVE_OOM_KILLER = "VTPU_ACTIVE_OOM_KILLER"
# Which physical devices the container may see (comma-separated ids).
ENV_VISIBLE_DEVICES = "VTPU_VISIBLE_DEVICES"
# Unix socket of the node-level runtime multiplexer.
ENV_RUNTIME_SOCKET = "VTPU_RUNTIME_SOCKET"
# Floor charge per execute step, µs: keeps throttling meaningful when
# measured step times are tiny or optimistic.
ENV_MIN_EXEC_COST = "VTPU_MIN_EXEC_COST_US"
# Floors by card model.  vtpu injects 150-200 µs per TPU generation
# because its broker's cost average drifted toward 0; the port's
# interposer meters each process's real busy time instead, and would
# charge a floor on every launch (a Llama-3-8B serving step makes 1560),
# so no H100 model has a default.  An operator value on the daemon still
# wins.
MIN_EXEC_COST_US_DEFAULTS: Dict[str, int] = {}


def min_exec_cost_default(model: str) -> Optional[str]:
    """Floor value (µs, as env string) for a card model, or None when the
    model has none (every H100)."""
    us = MIN_EXEC_COST_US_DEFAULTS.get(model)
    return None if us is None else str(us)


# Log level: 0=errors .. 4=debug.
ENV_LOG_LEVEL = "VTPU_LOG_LEVEL"
# PCI inventory file the daemon writes and mounts into each container
# (the reference's pciinfo.vgpu).
ENV_PCIBUS_FILE = "VTPU_PCIINFO_FILE"
# Directory of the per-card busy files (``<uuid>.busy``) in which the
# interposers of every pod on a card share its time slices; the daemon
# makes the files and Allocate mounts each granted card's there.
ENV_DEVICE_BUSY_DIR = "VTPU_DEVICE_BUSY_DIR"
# Under the device-specs list strategy the daemon mounts one file per
# visible device into this directory, named `<ordinal>_<id>`.
DEVICE_LIST_DIR = "/var/run/vtpu-devices"
# The container runtime's names: the cards (UUIDs, indices, or MIG UUIDs)
# the container sees, and the directory its volume-mounts strategy lists
# instead of the variable's value (reference server.go:469-471, 565-581).
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
NVIDIA_DEVICE_LIST_DIR = "/var/run/nvidia-container-devices"

# The in-container bootstrap (``shim/sitecustomize.py``): the shim's own
# entry in the PYTHONPATH that Allocate sets, and the flag Allocate sets
# when it merged a pod-declared PYTHONPATH behind that entry.
ENV_SHIM_PYTHONPATH = "VTPU_SHIM_PYTHONPATH"
ENV_PYTHONPATH_MERGED = "VTPU_PYTHONPATH_MERGED"
# Set on the pod spec (Allocate never sets it): entries the bootstrap puts
# on sys.path, for images whose PYTHONPATH lives in the Dockerfile's ENV,
# which Allocate's PYTHONPATH replaces.
ENV_EXTRA_PYTHONPATH = "VTPU_EXTRA_PYTHONPATH"
# vtpu installs its Python enforcement next to the native path under
# this flag; in the port that would charge the quota twice, so it never
# overrides the stand-down under the interposer (``shim/pyshim.py``).
ENV_FORCE_PY_ENFORCEMENT = "VTPU_FORCE_PY_ENFORCEMENT"

ALL_ENV_VARS = [
    ENV_HBM_LIMIT,
    ENV_CORE_LIMIT,
    ENV_DEVICE_MAP,
    ENV_SHARED_CACHE,
    ENV_OVERSUBSCRIBE,
    ENV_TASK_PRIORITY,
    ENV_UTILIZATION_POLICY,
    ENV_ACTIVE_OOM_KILLER,
    ENV_MIN_EXEC_COST,
    ENV_VISIBLE_DEVICES,
    ENV_RUNTIME_SOCKET,
    ENV_LOG_LEVEL,
    ENV_PCIBUS_FILE,
    ENV_NVIDIA_VISIBLE_DEVICES,
    ENV_DEVICE_BUSY_DIR,
]

# The flag registry: every environment variable the port reads, in its
# Python (``os.environ``) and in ``native/interposer.cc`` (``getenv``),
# and every one Allocate sets, by the layer that reads it: "contract"
# (set by Allocate, read in the container), "daemon", "shim" (the
# in-container bootstrap and enforcement, and the broker's client),
# "tools" (metricsd and the views under ``tools/``), "k8s" (the
# in-cluster API client), "broker" (``runtime/``), "chaos" (fault
# injection), "trace" (the flight recorder), "build" (``ops/_build.py``).  ``vtpu``'s registry
# (``utils/envspec.py``) with the port's own keys; no TPU-only key.
# ``tests/test_torch_bootstrap.py`` walks the sources and holds every
# read to it.
ENV_FLAGS = {
    # Allocate contract.
    ENV_HBM_LIMIT: "contract",
    ENV_CORE_LIMIT: "contract",
    ENV_DEVICE_MAP: "contract",
    ENV_SHARED_CACHE: "contract",
    ENV_OVERSUBSCRIBE: "contract",
    ENV_TASK_PRIORITY: "contract",
    ENV_UTILIZATION_POLICY: "contract",
    ENV_ACTIVE_OOM_KILLER: "contract",
    ENV_MIN_EXEC_COST: "contract",
    ENV_VISIBLE_DEVICES: "contract",
    ENV_RUNTIME_SOCKET: "contract",
    ENV_LOG_LEVEL: "contract",
    ENV_PCIBUS_FILE: "contract",
    ENV_NVIDIA_VISIBLE_DEVICES: "contract",
    ENV_DEVICE_BUSY_DIR: "contract",
    ENV_SHIM_PYTHONPATH: "contract",
    ENV_PYTHONPATH_MERGED: "contract",
    "PYTHONPATH": "contract",
    "VTPU_CORE_INDICES": "contract",
    # metricsd's port in the container (with --enable-metricsd; the daemon
    # reads the same name as its --metricsd-port alias).
    "VTPU_METRICSD_PORT": "contract",
    # The daemon (plugin/config.py, discovery, health); the reference's
    # own env aliases of its flags (main.go:55-161) among them.
    "VTPU_DISCOVERY": "daemon",
    "VTPU_ALLOCATION_POLICY": "daemon",
    "VTPU_METRICSD_ENABLE": "daemon",
    "VTPU_ENABLE_RUNTIME": "daemon",
    "VTPU_MONITOR_MODE": "daemon",
    "VTPU_HOST_LIB_DIR": "daemon",
    "VTPU_POD_INFORMER": "daemon",
    "VTPU_DISABLE_HEALTHCHECKS": "daemon",
    "VTPU_HEALTH_INTERVAL": "daemon",
    "VTPU_ALLOW_FAKE": "daemon",
    "VTPU_FAKE_CHIPS": "daemon",
    "VTPU_FAKE_MODEL": "daemon",
    "VTPU_FAKE_FAULT_DIR": "daemon",
    "VTPU_INOTIFY": "daemon",
    "SPLIT_STRATEGY": "daemon",
    "FAIL_ON_INIT_ERROR": "daemon",
    "PASS_DEVICE_SPECS": "daemon",
    "DEVICE_LIST_STRATEGY": "daemon",
    "DEVICE_ID_STRATEGY": "daemon",
    "DEVICE_SPLIT_COUNT": "daemon",
    "DEVICE_MEMORY_SCALING": "daemon",
    "DEVICE_CORES_SCALING": "daemon",
    "ENABLE_LEGACY_PREFERRED": "daemon",
    "VERBOSE": "daemon",
    "PCIBUSFILE": "daemon",
    "DEVICE_PLUGIN_PATH": "daemon",
    "RESOURCE_NAME": "daemon",
    "NODE_NAME": "daemon",
    # The in-container shim.
    ENV_EXTRA_PYTHONPATH: "shim",
    ENV_FORCE_PY_ENFORCEMENT: "shim",
    "VTPU_RATE_LEASE_US": "shim",
    # metricsd and the tools: the fake backend, a broker socket (refused
    # until the broker is ported), the exporter's port.
    "VTPU_METRICSD_FAKE": "tools",
    "VTPU_METRICSD_BROKER": "tools",
    "VTPU_METRICS_PORT": "tools",
    # The interposer's own channel into a tenant (shim/interposer.py's
    # tenant_env; in a container, the ld.so.preload mount).
    "LD_PRELOAD": "shim",
    # The in-cluster API client (k8s/client.py).
    "KUBERNETES_SERVICE_HOST": "k8s",
    "KUBERNETES_SERVICE_PORT": "k8s",
    # The broker (runtime/): its wire, its scheduler and rate leases, its
    # journal (journal.py), replication and the standby (replication.py),
    # its timers, its client, the fastlane (fastlane.py: VTPU_FASTLANE
    # asks a client's lane and, at 0, turns the broker's off) and the SLO
    # plane (slo.py: on unless VTPU_SLO=0).
    "VTPU_PUT_CHUNK_BYTES": "broker",
    "VTPU_RECV_POOL_MB": "broker",
    "VTPU_MAX_QUEUE_US": "broker",
    "VTPU_WAKE_BATCH": "broker",
    "VTPU_WORK_CONSERVING": "broker",
    "VTPU_JOURNAL_DIR": "broker",
    "VTPU_JOURNAL_FSYNC": "broker",
    "VTPU_JOURNAL_SNAPSHOT_EVERY": "broker",
    "VTPU_RESUME_GRACE_S": "broker",
    "VTPU_CLAIM_WATCHDOG_S": "broker",
    "VTPU_REPL_FENCE": "broker",
    "VTPU_REPL_BUFFER_MB": "broker",
    "VTPU_REPL_HB_S": "broker",
    "VTPU_REPL_CONFIRM_S": "broker",
    "VTPU_TIMER_COALESCE_MS": "broker",
    "VTPU_FASTLANE": "broker",
    "VTPU_FASTLANE_RING": "broker",
    "VTPU_FASTLANE_ARENA_MB": "broker",
    "VTPU_FASTLANE_SPIN_US": "broker",
    "VTPU_FASTLANE_BATCH": "broker",
    "VTPU_ARENA_FEED": "broker",
    "VTPU_SLO": "broker",
    "VTPU_SLO_ALPHA": "broker",
    "VTPU_SLO_BUCKETS": "broker",
    "VTPU_SLO_WINDOWS": "broker",
    "VTPU_SLO_BUDGET": "broker",
    "VTPU_SLO_BURN_ALERT": "broker",
    "VTPU_SLO_JOURNAL_S": "broker",
    # The grant's SLO objective, relayed by the client in HELLO.
    "VTPU_SLO_TARGET_US": "contract",
    "VTPU_SLO_FLOOR_STEPS": "contract",
    "VTPU_EXEC_BATCH": "broker",
    "VTPU_TENANT": "broker",
    "VTPU_RPC_TIMEOUT_S": "broker",
    # Deterministic fault injection (runtime/faults.py), the client's
    # reconnect and its degraded mode (runtime/client.py, degraded.py).
    "VTPU_FAULTS": "chaos",
    "VTPU_FAULTS_SEED": "chaos",
    "VTPU_CONNECT_TIMEOUT_S": "shim",
    "VTPU_RECONNECT_TIMEOUT_S": "shim",
    "VTPU_RECONNECT_BACKOFF_MS": "shim",
    "VTPU_RECONNECT_BACKOFF_CAP_MS": "shim",
    "VTPU_RECONNECT_FAST_S": "shim",
    "VTPU_BROKER_GRACE_S": "shim",
    "VTPU_DEGRADED_QUEUE": "shim",
    # The flight recorder and the lease sidecar (runtime/trace.py).
    "VTPU_TRACE": "trace",
    "VTPU_TRACE_RING": "trace",
    "VTPU_SLOW_OP_FACTOR": "trace",
    "VTPU_LEASE_SIDECAR": "trace",
    # The native build.
    "CUDA_HOME": "build",
}

# Per-ordinal forms: VTPU_DEVICE_HBM_LIMIT_<i>.
ENV_FLAG_PREFIXES = (ENV_HBM_LIMIT + "_",)


def flag_declared(name: str) -> bool:
    """True when ``name`` is a registered flag, or a per-ordinal form of a
    registered prefix."""
    if name in ENV_FLAGS:
        return True
    return any(name.startswith(p) and name[len(p):].isdigit()
               for p in ENV_FLAG_PREFIXES)


# Hard cap mirrored in native/vtpucore (VTPU_MAX_DEVICES).
MAX_DEVICES_PER_NODE = 16

_QUANTITY_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgtKMGT]i?|)\s*[bB]?\s*$")

_MULTIPLIERS = {
    "": 1,
    "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12,
    "ki": 2**10, "mi": 2**20, "gi": 2**30, "ti": 2**40,
}


def parse_quantity(value: str) -> int:
    """Parse a K8s-style quantity into bytes. Raises ValueError on junk."""
    m = _QUANTITY_RE.match(value)
    if not m:
        raise ValueError(f"invalid device memory limit {value!r}")
    number, suffix = m.group(1), m.group(2).lower()
    return int(float(number) * _MULTIPLIERS[suffix])


def format_quantity_mb(nbytes: int) -> str:
    """Render bytes as the reference's `<N>m` megabyte convention."""
    return f"{nbytes // 10**6}m"


def _parse_bool(value: Optional[str]) -> bool:
    return (value or "").strip().lower() in ("true", "1", "yes", "on")


@dataclass
class DeviceMapEntry:
    ordinal: int
    chip_uuid: str


@dataclass
class QuotaSpec:
    """Parsed view of the contract as seen inside one container."""

    # ordinal -> HBM cap in bytes (0 = unlimited); -1 = every ordinal
    hbm_limit_bytes: Dict[int, int] = field(default_factory=dict)
    # percentage of one card's device time, 0-100; 0 = no cap
    core_limit_pct: int = 0
    device_map: List[DeviceMapEntry] = field(default_factory=list)
    shared_cache: Optional[str] = None
    oversubscribe: bool = False
    task_priority: int = 1
    utilization_policy: str = "DEFAULT"  # DEFAULT | FORCE | DISABLE
    active_oom_killer: bool = False
    visible_devices: List[str] = field(default_factory=list)
    runtime_socket: Optional[str] = None
    log_level: int = 1

    def limit_for(self, ordinal: int) -> int:
        """HBM cap for a container-visible ordinal (0 = unlimited)."""
        if ordinal in self.hbm_limit_bytes:
            return self.hbm_limit_bytes[ordinal]
        return self.hbm_limit_bytes.get(-1, 0)


def parse_device_map(raw: str) -> List[DeviceMapEntry]:
    entries: List[DeviceMapEntry] = []
    for token in raw.split():
        if ":" not in token:
            raise ValueError(f"invalid {ENV_DEVICE_MAP} entry {token!r}")
        ordinal_s, uuid = token.split(":", 1)
        entries.append(DeviceMapEntry(ordinal=int(ordinal_s), chip_uuid=uuid))
    return entries


def device_list_from_mounts() -> List[str]:
    """Visible-device list under the device-specs strategy: mount names
    are `<NN>_<id>` so allocation order survives the directory listing."""
    if not os.path.isdir(DEVICE_LIST_DIR):
        return []
    entries = []
    for name in os.listdir(DEVICE_LIST_DIR):
        prefix, _, ident = name.partition("_")
        if ident and prefix.isdigit():
            entries.append((int(prefix), ident))
    return [ident for _, ident in sorted(entries)]


def quota_from_env(env: Optional[Mapping[str, str]] = None) -> QuotaSpec:
    """Parse the contract from an environment mapping (defaults to os.environ)."""
    if env is None:
        env = dict(os.environ)
    spec = QuotaSpec()

    if ENV_HBM_LIMIT in env:
        spec.hbm_limit_bytes[-1] = parse_quantity(env[ENV_HBM_LIMIT])
    for key, val in env.items():
        if key.startswith(ENV_HBM_LIMIT + "_"):
            ordinal = int(key[len(ENV_HBM_LIMIT) + 1:])
            if ordinal >= MAX_DEVICES_PER_NODE:
                raise ValueError(
                    f"device ordinal {ordinal} exceeds node cap "
                    f"{MAX_DEVICES_PER_NODE}")
            spec.hbm_limit_bytes[ordinal] = parse_quantity(val)

    if ENV_CORE_LIMIT in env:
        pct = int(env[ENV_CORE_LIMIT])
        spec.core_limit_pct = max(0, min(100, pct))
    if ENV_DEVICE_MAP in env:
        spec.device_map = parse_device_map(env[ENV_DEVICE_MAP])
    spec.shared_cache = env.get(ENV_SHARED_CACHE)
    spec.oversubscribe = _parse_bool(env.get(ENV_OVERSUBSCRIBE))
    if ENV_TASK_PRIORITY in env:
        spec.task_priority = int(env[ENV_TASK_PRIORITY])
    policy = env.get(ENV_UTILIZATION_POLICY, "DEFAULT").strip().upper()
    if policy not in ("DEFAULT", "FORCE", "DISABLE"):
        policy = "DEFAULT"
    spec.utilization_policy = policy
    spec.active_oom_killer = _parse_bool(env.get(ENV_ACTIVE_OOM_KILLER))
    mounted = device_list_from_mounts()
    if mounted:
        # device-specs strategy: the kubelet-controlled mounts win over
        # the env var (a pod spec can set the variable, it cannot
        # fabricate mounts).
        spec.visible_devices = mounted
    elif env.get(ENV_VISIBLE_DEVICES):
        spec.visible_devices = [
            t for t in env[ENV_VISIBLE_DEVICES].replace(",", " ").split() if t
        ]
    spec.runtime_socket = env.get(ENV_RUNTIME_SOCKET)
    if ENV_LOG_LEVEL in env:
        spec.log_level = int(env[ENV_LOG_LEVEL])
    return spec
