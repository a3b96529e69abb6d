"""The native interposer, ``libvtpu_cuda.so``, from Python.

The twin of ``vtpu``'s interposer bootstrap (``shim/pyshim.py``'s
``bootstrap`` and ``_default_interposer``), for a library that enforces
inside the CUDA driver API (``native/interposer.cc``).  vtpu points
``TPU_LIBRARY_PATH`` at its interposer inside the running process; an
LD_PRELOAD library has to be in place before the process starts, so here
the counterpart is the environment a child tenant is started with:

    env = interposer.tenant_env({"VTPU_DEVICE_HBM_LIMIT_0": "20Gi", ...})
    subprocess.run([sys.executable, "serve.py"], env=env)

The child then runs unmodified: its allocations are charged to the
region and refused past the cap, its launches pass the compute gate, and
``torch.cuda.mem_get_info()`` and ``nvidia-smi`` report the cap.
Inside such a process ``loaded()`` is true and ``stats()`` reads the
interposer's counters.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, Mapping, Optional

from ..ops import _build
from ..utils.envspec import MAX_DEVICES_PER_NODE

IDENT = "vtpu_cuda_interposer_ident"

# A card's busy file, as native/interposer.cc lays it out: kBusySlots
# (VTPU_MAX_PROCS) slots of BusySlot, each an owner token, a heartbeat
# (CLOCK_MONOTONIC ns), a pid, a pad and a busy-through time per device
# column.  The interposer refuses a shorter file.  A slot is live while
# its heartbeat is younger than kSlotLeaseNs, and busy while its
# column's time is ahead of now.
BUSY_SLOTS = 64
_BUSY_HEAD = struct.Struct("=QQii")
BUSY_SLOT_BYTES = _BUSY_HEAD.size + 8 * MAX_DEVICES_PER_NODE
BUSY_FILE_BYTES = BUSY_SLOTS * BUSY_SLOT_BYTES
BUSY_SLOT_LEASE_NS = 200_000_000


def busy_slots(path: str, now_ns: int) -> Dict[str, int]:
    """How many slots of the busy file at ``path`` are live, and how many
    of those busy (column 0, a card's own file), at CLOCK_MONOTONIC
    ``now_ns``; read as bytes, nothing mapped or written, and nothing of
    whose."""
    with open(path, "rb") as f:
        data = f.read(BUSY_FILE_BYTES)
    live = busy = 0
    for off in range(0, len(data) - BUSY_SLOT_BYTES + 1, BUSY_SLOT_BYTES):
        _owner, beat, _pid, _pad = _BUSY_HEAD.unpack_from(data, off)
        (until,) = struct.unpack_from("=Q", data, off + _BUSY_HEAD.size)
        if beat and beat + BUSY_SLOT_LEASE_NS >= now_ns:
            live += 1
            busy += until > now_ns
    return {"live": live, "busy": busy}


class Stats(ctypes.Structure):
    # Mirror of vtpu_cuda_stats (native/interposer.cc).
    _fields_ = [
        ("launches", ctypes.c_uint64),        # kernel launches through the gate
        ("graph_launches", ctypes.c_uint64),  # ... of which cuGraphLaunch
        ("gate_waits", ctypes.c_uint64),      # launches that waited
        ("gate_ns", ctypes.c_uint64),         # time in the gate, waits included
        ("wait_ns", ctypes.c_uint64),         # ... of which waiting
        ("refused", ctypes.c_uint64),         # allocations refused past the cap
        ("charged_bytes", ctypes.c_uint64),   # bytes charged now
        ("spilled_bytes", ctypes.c_uint64),   # managed bytes past the cap now
        ("booked_us", ctypes.c_uint64),       # device time booked
        ("debited_us", ctypes.c_uint64),      # ... of which from the bucket
        ("busy_ticks", ctypes.c_uint64),      # watcher ticks with work pending
        ("shared_ticks", ctypes.c_uint64),    # ... with a co-tenant busy too
        ("procaddr_hooks", ctypes.c_uint64),  # cuGetProcAddress answers replaced
        ("state", ctypes.c_int32),            # 0 off, 1 enforcing, 2 failed closed
        ("meter", ctypes.c_int32),            # 0 idle, 1 metering, -1 cannot
        ("ndev", ctypes.c_int32),
        ("core_pct", ctypes.c_int32),
        ("policy", ctypes.c_int32),           # 0 DEFAULT, 1 FORCE, 2 DISABLE
        ("priority", ctypes.c_int32),
        ("oversubscribe", ctypes.c_int32),
        ("oom_killer", ctypes.c_int32),
        ("min_cost_us", ctypes.c_uint64),
        ("limits", ctypes.c_uint64 * MAX_DEVICES_PER_NODE),
    ]


def library_path() -> str:
    """The interposer library, built from ``native/`` if needed."""
    return _build.build_all(("vtpu_cuda",))["vtpu_cuda"]


def tenant_env(quota_env: Mapping[str, str],
               base: Optional[Mapping[str, str]] = None) -> Dict[str, str]:
    """The environment of a tenant started under the interposer: ``base``
    (default ``os.environ``), the quota env as given, and the library
    first in ``LD_PRELOAD``."""
    env = dict(os.environ if base is None else base)
    env.update(quota_env)
    preload = [library_path()] + [
        p for p in env.get("LD_PRELOAD", "").replace(":", " ").split() if p]
    env["LD_PRELOAD"] = ":".join(preload)
    return env


def _symbol(name: str):
    """``name`` as this process resolves it, or None."""
    try:
        return getattr(ctypes.CDLL(None), name)
    except AttributeError:
        return None


def loaded() -> bool:
    """True only when the interposer is in this process (its ident symbol
    resolves)."""
    return _symbol(IDENT) is not None


def stats() -> Optional[Dict[str, object]]:
    """The interposer's counters and the quota it parsed; None when it is
    not loaded."""
    fn = _symbol("vtpu_cuda_interposer_stats")
    if fn is None:
        return None
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(Stats), ctypes.c_size_t]
    out = Stats()
    if fn(ctypes.byref(out), ctypes.sizeof(out)) != 0:
        raise RuntimeError("libvtpu_cuda.so's stats layout differs from "
                           "shim/interposer.py:Stats")
    got = {name: getattr(out, name) for name, _ in Stats._fields_}
    got["limits"] = list(out.limits)
    return got
