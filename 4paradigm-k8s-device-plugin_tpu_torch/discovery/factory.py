"""Backend selection: fake (tests) | nvml | procfs | auto."""

from __future__ import annotations

import os
from typing import Optional

from .base import ChipBackend
from .fake import FakeChipBackend
from .nvml import NvmlChipBackend
from .procfs import ProcfsChipBackend

KINDS = ("auto", "fake", "nvml", "procfs")


def make_backend(kind: Optional[str] = None) -> ChipBackend:
    """``kind`` in KINDS; default from VTPU_DISCOVERY.

    ``auto`` tries NVML first, then procfs, then the fake inventory when
    ``VTPU_ALLOW_FAKE`` is set, and otherwise returns the empty NVML
    backend (the daemon then applies --fail-on-init-error).  ``vtpu``
    tries sysfs before its PJRT backend because opening a TPU through
    libtpu takes the chip's one-process lock and would starve tenants;
    NVML opens no CUDA context and takes no lock, and it alone knows
    memory, MIG and NVLink, so here it comes first."""
    kind = (kind or os.environ.get("VTPU_DISCOVERY", "auto")).lower()
    if kind not in KINDS:
        raise ValueError(f"unknown discovery backend {kind!r} "
                         f"(one of {', '.join(KINDS)})")
    if kind == "fake":
        return FakeChipBackend.from_env()
    if kind == "nvml":
        return NvmlChipBackend()
    if kind == "procfs":
        return ProcfsChipBackend()
    nvml = NvmlChipBackend()
    if nvml.chips():
        return nvml
    procfs = ProcfsChipBackend()
    if procfs.chips():
        return procfs
    if os.environ.get("VTPU_ALLOW_FAKE", "").lower() in ("1", "true"):
        return FakeChipBackend.from_env()
    return nvml
