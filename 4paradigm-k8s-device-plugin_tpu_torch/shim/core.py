"""ctypes bindings for the native vtpucore shared-region library.

The region is the cross-process accounting state every tenant of a
device shares: per-device HBM ledgers, per-process slots with liveness
tracking, and the device-time token bucket.  Its semantics live in
``native/vtpucore/vtpu_core.h``; the library is built from that unchanged
source at first use (``ops/_build.py``), so a region written by this port
is the same region ``vtpu``'s tools read.

This is the subset of ``vtpu.shim.core`` that in-process enforcement,
the views (``metricsd``, ``tools``) and the broker (``runtime``)
need: ``SharedRegion`` and ``RateLease``.  The broker's region is one
card's: its device axis is the card's tenant slots, each seeded with its
tenant's grant (``set_mem_limit``, ``set_core_limit``, ``reset_slot``).
A ``SharedRegion`` opened with no limits adopts the region as it is and
takes no slot in it: every view opens it so.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import List, Optional, Sequence

from ..ops import _build
from ..utils.envspec import MAX_DEVICES_PER_NODE


class DeviceStats(ctypes.Structure):
    # Mirror of native vtpu_device_stats (vtpu_core.h).
    _fields_ = [
        ("limit_bytes", ctypes.c_uint64),
        ("used_bytes", ctypes.c_uint64),
        ("peak_bytes", ctypes.c_uint64),
        ("core_limit_pct", ctypes.c_int32),
        ("n_procs", ctypes.c_int32),
        ("busy_us", ctypes.c_uint64),
    ]


class ProcStats(ctypes.Structure):
    # Mirror of native vtpu_proc_stats (vtpu_core.h).
    _fields_ = [
        ("pid", ctypes.c_int),
        ("host_pid", ctypes.c_int),
        ("used_bytes", ctypes.c_uint64 * MAX_DEVICES_PER_NODE),
        # per-device cumulative device time (us)
        ("busy_us", ctypes.c_uint64 * MAX_DEVICES_PER_NODE),
    ]


# Mirror of VTPU_MAX_PROCS (vtpu_core.h).
MAX_PROCS = 64

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The region library, built from native/vtpucore on first use."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _build.library("vtpucore")
        vp, i, u64, i32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                           ctypes.c_int32)
        lib.vtpu_region_open.restype = vp
        lib.vtpu_region_open.argtypes = [ctypes.c_char_p, i,
                                         ctypes.POINTER(u64),
                                         ctypes.POINTER(i32)]
        lib.vtpu_region_close.argtypes = [vp]
        lib.vtpu_proc_register.restype = i
        lib.vtpu_proc_register.argtypes = [vp, i]
        lib.vtpu_proc_deregister.argtypes = [vp]
        lib.vtpu_sweep_dead_host.restype = i
        lib.vtpu_sweep_dead_host.argtypes = [vp]
        lib.vtpu_mem_acquire.restype = i
        lib.vtpu_mem_acquire.argtypes = [vp, i, u64, i]
        lib.vtpu_mem_release.argtypes = [vp, i, u64]
        lib.vtpu_mem_info.restype = i
        lib.vtpu_mem_info.argtypes = [vp, i, ctypes.POINTER(u64),
                                      ctypes.POINTER(u64)]
        lib.vtpu_device_get_stats.restype = i
        lib.vtpu_device_get_stats.argtypes = [vp, i,
                                              ctypes.POINTER(DeviceStats)]
        lib.vtpu_proc_get_stats.restype = i
        lib.vtpu_proc_get_stats.argtypes = [vp, i, ctypes.POINTER(ProcStats)]
        lib.vtpu_rate_acquire.restype = u64
        lib.vtpu_rate_acquire.argtypes = [vp, i, u64, i]
        lib.vtpu_rate_adjust.argtypes = [vp, i, ctypes.c_int64]
        lib.vtpu_rate_block.argtypes = [vp, i, u64, i]
        lib.vtpu_busy_add.argtypes = [vp, i, u64]
        lib.vtpu_set_core_limit.argtypes = [vp, i, i32]
        lib.vtpu_region_set_wc.argtypes = [vp, i]
        lib.vtpu_set_mem_limit.argtypes = [vp, i, u64]
        lib.vtpu_reset_slot.argtypes = [vp, i]
        lib.vtpu_rate_level.restype = ctypes.c_int64
        lib.vtpu_rate_level.argtypes = [vp, i]
        lib.vtpu_region_ndevices.restype = i
        lib.vtpu_region_ndevices.argtypes = [vp]
        lib.vtpu_region_active_procs.restype = i
        lib.vtpu_region_active_procs.argtypes = [vp]
        _lib = lib
        return lib


class SharedRegion:
    """One mmap'd accounting region shared by all processes of an
    allocation."""

    def __init__(self, path: str, limits: Sequence[int] = (),
                 core_pcts: Sequence[int] = ()):
        self.lib = load()
        n = max(len(limits), len(core_pcts))
        arr_l = (ctypes.c_uint64 * max(n, 1))(*limits) if limits else None
        arr_c = (ctypes.c_int32 * max(n, 1))(*core_pcts) if core_pcts else None
        self.handle = self.lib.vtpu_region_open(
            path.encode(), n, arr_l, arr_c)
        if not self.handle:
            raise OSError(f"vtpu_region_open({path!r}) failed")
        self.path = path

    # -- lifecycle --
    def close(self) -> None:
        if self.handle:
            self.lib.vtpu_region_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def register(self, host_pid: int = 0) -> int:
        return self.lib.vtpu_proc_register(self.handle, host_pid)

    def deregister(self) -> None:
        """Leave the region; the native side drops this process's
        remaining charges from the device ledgers."""
        self.lib.vtpu_proc_deregister(self.handle)

    def sweep_dead_host(self) -> int:
        """Reclaim the slots of processes dead by their host pid: for the
        node's monitor only, which sees every pid.  Returns how many."""
        return self.lib.vtpu_sweep_dead_host(self.handle)

    # -- memory --
    def mem_acquire(self, dev: int, nbytes: int,
                    oversubscribe: bool = False) -> bool:
        return self.lib.vtpu_mem_acquire(self.handle, dev, nbytes,
                                         1 if oversubscribe else 0) == 0

    def mem_release(self, dev: int, nbytes: int) -> None:
        self.lib.vtpu_mem_release(self.handle, dev, nbytes)

    def mem_info(self, dev: int):
        free = ctypes.c_uint64()
        total = ctypes.c_uint64()
        if self.lib.vtpu_mem_info(self.handle, dev, ctypes.byref(free),
                                  ctypes.byref(total)) != 0:
            raise OSError(f"vtpu_mem_info({dev}) failed")
        return free.value, total.value

    def device_stats(self, dev: int) -> DeviceStats:
        out = DeviceStats()
        if self.lib.vtpu_device_get_stats(self.handle, dev,
                                          ctypes.byref(out)) != 0:
            raise OSError(f"vtpu_device_get_stats({dev}) failed")
        return out

    def proc_stats(self) -> List[ProcStats]:
        out = []
        for slot in range(MAX_PROCS):
            st = ProcStats()
            if self.lib.vtpu_proc_get_stats(self.handle, slot,
                                            ctypes.byref(st)) == 0:
                out.append(st)
        return out

    # -- rate limiting --
    def rate_acquire(self, dev: int, cost_us: int, priority: int = 1) -> int:
        """0 = admitted; else nanoseconds to sleep before retry."""
        return self.lib.vtpu_rate_acquire(self.handle, dev, cost_us, priority)

    def rate_block(self, dev: int, cost_us: int, priority: int = 1) -> None:
        self.lib.vtpu_rate_block(self.handle, dev, cost_us, priority)

    def rate_adjust(self, dev: int, delta_us: int) -> None:
        self.lib.vtpu_rate_adjust(self.handle, dev, delta_us)

    def busy_add(self, dev: int, us: int) -> None:
        """Record completed device time (duty-cycle source)."""
        self.lib.vtpu_busy_add(self.handle, dev, int(us))

    def set_core_limit(self, dev: int, pct: int) -> None:
        """Re-seed one slot's compute share (broker per-grant shares)."""
        self.lib.vtpu_set_core_limit(self.handle, dev, int(pct))

    def set_work_conserving(self, on: bool) -> None:
        """Idle-share redistribution across device entries: broker
        regions only, whose entries are the tenant slots of one card
        (vtpu_core.h)."""
        self.lib.vtpu_region_set_wc(self.handle, 1 if on else 0)

    def set_mem_limit(self, dev: int, limit_bytes: int) -> None:
        """Re-seed one slot's HBM cap (broker per-grant quotas)."""
        self.lib.vtpu_set_mem_limit(self.handle, dev, int(limit_bytes))

    def reset_slot(self, dev: int) -> None:
        """Reset a recycled tenant slot's bucket and burst state."""
        self.lib.vtpu_reset_slot(self.handle, dev)

    def rate_level(self, dev: int) -> int:
        """The token bucket's level in µs (negative: borrowed)."""
        return int(self.lib.vtpu_rate_level(self.handle, dev))

    @property
    def ndevices(self) -> int:
        return self.lib.vtpu_region_ndevices(self.handle)

    def active_procs(self) -> int:
        """Live registered processes (sweeps dead ones first)."""
        return self.lib.vtpu_region_active_procs(self.handle)


class RateLease:
    """Client-side rate lease over the shared region's token bucket: one
    ``rate_acquire`` pre-debits a µs quantum through the same native
    atomics every co-tenant reads, and later admissions burn the local
    balance with plain arithmetic instead of a native bucket round trip
    each.  Re-syncs when the balance is exhausted, on expiry (the
    unburned remainder refunds via ``rate_adjust`` so an idling process
    cannot park device time), and on ``revoke``.  A throttled caller
    blocks in the native bucket with the lease lock released."""

    def __init__(self, region: SharedRegion, dev: int = 0,
                 quantum_us: Optional[int] = None,
                 ttl_s: Optional[float] = None):
        self.mu = threading.Lock()
        self.region = region
        self.dev = dev
        if quantum_us is None:
            quantum_us = int(os.environ.get("VTPU_RATE_LEASE_US",
                                            "20000") or 0)
        self.quantum_us = max(int(quantum_us), 0)
        # A few quanta of wall time: long enough to amortize, short
        # enough that a stalled process returns its pre-debit quickly.
        self.ttl_s = (ttl_s if ttl_s is not None
                      else max(4.0 * self.quantum_us / 1e6, 0.05))
        self._us = 0.0
        self._exp = 0.0
        self.grants = 0
        self.refunds = 0
        self.blocks = 0   # admissions that waited in the native bucket

    def acquire(self, cost_us: float, priority: int = 1) -> None:
        """Admit ``cost_us`` of device time, blocking in the native
        bucket only when neither the local balance nor a fresh quantum
        can fund it."""
        cost = max(int(cost_us), 0)
        if self.quantum_us <= 0:
            self.blocks += 1
            self.region.rate_block(self.dev, cost, priority)
            return
        with self.mu:
            now = time.monotonic()
            if self._us > 0.0 and now >= self._exp:
                self._refund_locked()
            if self._us >= cost:
                self._us -= cost
                return
            wait_ns = self.region.rate_acquire(
                self.dev, cost + self.quantum_us, priority)
            if wait_ns == 0:
                self._us += self.quantum_us
                self._exp = now + self.ttl_s
                self.grants += 1
                return
            # The bucket can't fund a whole quantum: block for the exact
            # ask (minus the balance left) outside the lock.
            need = max(cost - int(self._us), 1)
            self._us = 0.0
            self.blocks += 1
        self.region.rate_block(self.dev, need, priority)

    def revoke(self) -> None:
        """Refund the unburned balance to the bucket immediately."""
        with self.mu:
            self._refund_locked()

    def _refund_locked(self) -> None:
        left = int(self._us)
        self._us = 0.0
        self._exp = 0.0
        if left > 0:
            self.refunds += 1
            self.region.rate_adjust(self.dev, -left)
