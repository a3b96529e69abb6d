"""Daemon configuration: CLI flags, each mirrored to an env var, validated
up front — the reference's urfave/cli surface (reference main.go:55-161),
with ``vtpu``'s flags and env aliases.

``--enable-runtime`` turns on the broker in every grant (the runtime
socket and the in-container bridge).  The broker's core is ported
(``runtime/``), but a grant waits for the transparent bridge: the flag is
refused with an error when turned on, never ignored (ROADMAP.md, Queue 1
item 6(e)).  ``--enable-metricsd`` gives each grant
metricsd's port (``plugin/grant.py``).  ``vtpu`` turns both on by
default; here they default off (on a CUDA node the stock tool,
nvidia-smi, reads NVML, which the interposer answers; metricsd is for
the node's exporter and vtpu's tools).
``--monitor-mode`` (per-pod regions found through the pod lister) and
``--enable-legacy-preferred`` (the vdevice controller) run as in
``vtpu``; unlike ``vtpu`` the second does not refuse a daemon without
``NODE_NAME``, whose pod lister then lists the whole cluster's pods
(``plugin/main.py`` says so in its log)."""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import List, Optional

from ..discovery.factory import KINDS

DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"
RESOURCE_NAME = "4paradigm.com/vtpu"

# Host staging dir of the interposer and the ld.so.preload list (the
# reference's /usr/local/vgpu, server.go:511-522).
HOST_LIB_DIR = "/usr/local/vtpu"

SPLIT_STRATEGIES = ("none", "core", "mixed")
DEVICE_LIST_STRATEGIES = ("envvar", "device-specs")
DEVICE_ID_STRATEGIES = ("uuid", "index")
# GetPreferredAllocation scoring policy (the reference's gpuallocator
# policy choice, server.go:66): pack = NVLink-compact and fill fragmented
# cards first; spread = farthest apart, emptiest cards first.
ALLOCATION_POLICIES = ("pack", "spread")

# Flags whose subsystem is not ported: attribute -> (flag, what is
# missing, the ROADMAP Queue 1 item that holds it).
UNPORTED = {
    "enable_runtime": ("--enable-runtime", "the runtime broker's grant",
                       "6(e)"),
}


@dataclass
class Config:
    # reference --mig-strategy: how cards are partitioned.
    #   none  = time-share split via --device-split-count
    #   core  = one vdevice per MIG instance (hard partition)
    #   mixed = MIG instances on MIG cards, time-share on the rest
    split_strategy: str = "none"
    fail_on_init_error: bool = True
    pass_device_specs: bool = False
    device_list_strategy: str = "envvar"
    device_id_strategy: str = "uuid"
    device_split_count: int = 2
    device_memory_scaling: float = 1.0
    device_cores_scaling: float = 1.0
    enable_legacy_preferred: bool = False
    verbose: int = 0
    discovery: str = "auto"
    host_lib_dir: str = HOST_LIB_DIR
    pcibus_file: Optional[str] = None
    device_plugin_path: str = DEVICE_PLUGIN_PATH
    resource_name: str = RESOURCE_NAME
    enable_runtime: bool = False
    runtime_socket: str = HOST_LIB_DIR + "/vtpu-runtime.sock"
    monitor_mode: bool = False
    node_name: Optional[str] = None
    allocation_policy: str = "pack"
    enable_metricsd: bool = False
    metricsd_port: int = 8431

    def validate(self) -> List[str]:
        """Up-front validation (reference main.go:143-161)."""
        errors = []
        if self.split_strategy not in SPLIT_STRATEGIES:
            errors.append(f"invalid --split-strategy {self.split_strategy!r}")
        if self.device_list_strategy not in DEVICE_LIST_STRATEGIES:
            errors.append(
                f"invalid --device-list-strategy {self.device_list_strategy!r}")
        if self.device_id_strategy not in DEVICE_ID_STRATEGIES:
            errors.append(
                f"invalid --device-id-strategy {self.device_id_strategy!r}")
        if self.device_split_count < 1:
            errors.append("--device-split-count must be >= 1")
        if self.device_memory_scaling <= 0:
            errors.append("--device-memory-scaling must be > 0")
        if self.device_cores_scaling <= 0:
            errors.append("--device-cores-scaling must be > 0")
        if self.allocation_policy not in ALLOCATION_POLICIES:
            errors.append(
                f"invalid --allocation-policy {self.allocation_policy!r}")
        if self.discovery.lower() not in KINDS:
            errors.append(f"invalid --discovery {self.discovery!r}")
        if not 0 < self.metricsd_port < 65536:
            errors.append("--metricsd-port must be in 1..65535")
        for attr, (flag, what, item) in UNPORTED.items():
            if getattr(self, attr):
                errors.append(f"{flag}: {what} is not ported to the H100 "
                              f"yet (ROADMAP.md, Queue 1 item {item}); turn "
                              "it off")
        return errors

    @property
    def oversubscribe(self) -> bool:
        return self.device_memory_scaling > 1.0


def _env(name: str, default):
    return os.environ.get(name, default)


def _bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vtpu-device-plugin",
        description="GPU-sharing Kubernetes device plugin")
    p.add_argument("--split-strategy", default=_env("SPLIT_STRATEGY", "none"),
                   help="none|core|mixed (card partitioning strategy)")
    p.add_argument("--fail-on-init-error", type=_bool,
                   default=_bool(_env("FAIL_ON_INIT_ERROR", "true")))
    p.add_argument("--pass-device-specs", type=_bool,
                   default=_bool(_env("PASS_DEVICE_SPECS", "false")))
    p.add_argument("--device-list-strategy",
                   default=_env("DEVICE_LIST_STRATEGY", "envvar"))
    p.add_argument("--device-id-strategy",
                   default=_env("DEVICE_ID_STRATEGY", "uuid"))
    p.add_argument("--device-split-count", type=int,
                   default=int(_env("DEVICE_SPLIT_COUNT", "2")))
    p.add_argument("--device-memory-scaling", type=float,
                   default=float(_env("DEVICE_MEMORY_SCALING", "1.0")))
    p.add_argument("--device-cores-scaling", type=float,
                   default=float(_env("DEVICE_CORES_SCALING", "1.0")))
    p.add_argument("--enable-legacy-preferred", type=_bool,
                   default=_bool(_env("ENABLE_LEGACY_PREFERRED", "false")))
    p.add_argument("--verbose", type=int, default=int(_env("VERBOSE", "0")))
    p.add_argument("--discovery", default=_env("VTPU_DISCOVERY", "auto"),
                   help="|".join(KINDS))
    p.add_argument("--host-lib-dir", default=_env("VTPU_HOST_LIB_DIR",
                                                  HOST_LIB_DIR))
    p.add_argument("--pcibus-file", default=_env("PCIBUSFILE", None))
    p.add_argument("--device-plugin-path",
                   default=_env("DEVICE_PLUGIN_PATH", DEVICE_PLUGIN_PATH))
    p.add_argument("--resource-name", default=_env("RESOURCE_NAME",
                                                   RESOURCE_NAME))
    p.add_argument("--enable-runtime", type=_bool,
                   default=_bool(_env("VTPU_ENABLE_RUNTIME", "false")))
    p.add_argument("--runtime-socket",
                   default=_env("VTPU_RUNTIME_SOCKET",
                                HOST_LIB_DIR + "/vtpu-runtime.sock"))
    p.add_argument("--monitor-mode", type=_bool,
                   default=_bool(_env("VTPU_MONITOR_MODE", "false")))
    p.add_argument("--node-name", default=_env("NODE_NAME", None))
    p.add_argument("--allocation-policy",
                   default=_env("VTPU_ALLOCATION_POLICY", "pack"),
                   help="pack|spread (GetPreferredAllocation scoring)")
    p.add_argument("--enable-metricsd", type=_bool,
                   default=_bool(_env("VTPU_METRICSD_ENABLE", "false")))
    p.add_argument("--metricsd-port", type=int,
                   default=int(_env("VTPU_METRICSD_PORT", "8431")))
    return p


def parse_args(argv: Optional[List[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    cfg = Config(**{f: getattr(ns, f) for f in Config.__dataclass_fields__})
    errors = cfg.validate()
    if errors:
        raise SystemExit("invalid flags:\n  " + "\n  ".join(errors))
    return cfg
