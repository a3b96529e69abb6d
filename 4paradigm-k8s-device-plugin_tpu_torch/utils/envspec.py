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
# Log level: 0=errors .. 4=debug.
ENV_LOG_LEVEL = "VTPU_LOG_LEVEL"
# Under the device-specs list strategy the daemon mounts one file per
# visible device into this directory, named `<ordinal>_<id>`.
DEVICE_LIST_DIR = "/var/run/vtpu-devices"

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
