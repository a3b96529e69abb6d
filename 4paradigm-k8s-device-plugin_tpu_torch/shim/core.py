"""ctypes bindings for the native vtpucore shared-region library.

The region is the cross-process accounting state every tenant of a
device shares: per-device HBM ledgers, per-process slots with liveness
tracking, and the device-time token bucket.  Its semantics live in
``native/vtpucore/vtpu_core.h``; the library is built from that unchanged
source at first use (``ops/_build.py``), so a region written by this port
is the same region ``vtpu``'s tools read.

This is the subset of ``vtpu.shim.core`` that in-process enforcement,
the views (``metricsd``, ``tools``) and the broker (``runtime``)
need: ``SharedRegion``, ``RateLease``, and the fastlane's two shared-memory
rings, ``ExecRing`` (the SPSC execute ring a tenant's client and the
broker's drainer share) and ``TraceRing`` (the per-process event ring the
library writes rate waits and memory stalls into under ``VTPU_TRACE``).
Every call goes through one ``ctypes.CDLL``, which drops the GIL for the
call: the ring's waits spin, then sleep on a futex, in native code, and
a handle that held the GIL (``vtpu``'s ``PyDLL`` twin of its hot
atomics) would stall every other thread of the process for the whole
wait.  The broker's region is one
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


class TraceEvent(ctypes.Structure):
    # Mirror of native vtpu_trace_event (vtpu_core.h).
    _fields_ = [
        ("t_ns", ctypes.c_uint64),
        ("kind", ctypes.c_uint32),
        ("dev", ctypes.c_uint32),
        ("value", ctypes.c_uint64),
        ("arg", ctypes.c_uint64),
    ]


# Event kinds (vtpu_core.h VTPU_TEV_*).
TEV_RATE_WAIT = 1   # token-bucket block: value=waited us, arg=cost us
TEV_MEM_STALL = 2   # mem_acquire refused: value=bytes, arg=limit
TEV_DISPATCH = 3
TEV_USER = 16
TEV_NAMES = {TEV_RATE_WAIT: "rate_wait", TEV_MEM_STALL: "mem_stall",
             TEV_DISPATCH: "dispatch"}


class ExecDesc(ctypes.Structure):
    # Mirror of native ExecDesc (vtpu_core.h): one fastlane execute
    # descriptor.
    _fields_ = [
        ("eseq", ctypes.c_uint64),
        ("route", ctypes.c_uint64),
        ("arg_off", ctypes.c_uint64),
        ("arg_len", ctypes.c_uint64),
        ("cost_us", ctypes.c_uint64),
        ("t_sub_ns", ctypes.c_uint64),
        ("eflags", ctypes.c_uint64),
        ("status", ctypes.c_int64),
        ("actual_us", ctypes.c_uint64),
        ("t_done_ns", ctypes.c_uint64),
    ]


# ExecDesc.status values (vtpu_core.h VTPU_EXEC_*).
EXEC_OK = 0
EXEC_ENOTFOUND = -1
EXEC_EINTERNAL = -2
EXEC_ECANCELED = -3

# The ring's gate word (vtpu_core.h VTPU_EXEC_GATE_*): anything but OPEN
# sends the producer to the broker's socket.
GATE_OPEN = 0
GATE_PARKED = 1
GATE_CLOSED = 2

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
        # The trace ring (vtpu_core.h vtpu_trace_*).
        lib.vtpu_trace_open.restype = vp
        lib.vtpu_trace_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.vtpu_trace_close.argtypes = [vp]
        lib.vtpu_trace_emit.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint32,
                                        u64, u64]
        lib.vtpu_trace_head.restype = u64
        lib.vtpu_trace_head.argtypes = [vp]
        lib.vtpu_trace_capacity.restype = ctypes.c_uint32
        lib.vtpu_trace_capacity.argtypes = [vp]
        lib.vtpu_trace_read.restype = i
        lib.vtpu_trace_read.argtypes = [vp, u64, ctypes.POINTER(TraceEvent),
                                        i, ctypes.POINTER(u64)]
        # The execute ring (vtpu_core.h vtpu_exec_*).  Single-card lanes
        # only: the completion vector (vtpu_exec_cvec_*) of sharded lanes
        # waits for grants over several cards.
        i64, u32 = ctypes.c_int64, ctypes.c_uint32
        desc_p = ctypes.POINTER(ExecDesc)
        lib.vtpu_exec_open.restype = vp
        lib.vtpu_exec_open.argtypes = [ctypes.c_char_p, u32]
        lib.vtpu_exec_close.argtypes = [vp]
        lib.vtpu_exec_submit.restype = i
        lib.vtpu_exec_submit.argtypes = [vp, desc_p]
        lib.vtpu_exec_submit_batch.restype = i
        lib.vtpu_exec_submit_batch.argtypes = [vp, desc_p, i]
        lib.vtpu_exec_take.restype = i
        lib.vtpu_exec_take.argtypes = [vp, desc_p, i]
        lib.vtpu_exec_complete.argtypes = [vp, ctypes.POINTER(i64),
                                           ctypes.POINTER(u64), u64, i]
        lib.vtpu_exec_completions.restype = i
        lib.vtpu_exec_completions.argtypes = [vp, u64, desc_p, i]
        for fn in ("vtpu_exec_tail", "vtpu_exec_headc"):
            getattr(lib, fn).restype = u64
            getattr(lib, fn).argtypes = [vp]
        lib.vtpu_exec_capacity.restype = u32
        lib.vtpu_exec_capacity.argtypes = [vp]
        lib.vtpu_exec_credits.restype = i64
        lib.vtpu_exec_credits.argtypes = [vp]
        for fn in ("vtpu_exec_wait_headc", "vtpu_exec_wait_tail"):
            getattr(lib, fn).restype = i
            getattr(lib, fn).argtypes = [vp, u64, u64, u64]
        lib.vtpu_exec_gate_set.argtypes = [vp, u32]
        lib.vtpu_exec_gate.restype = u32
        lib.vtpu_exec_gate.argtypes = [vp]
        lib.vtpu_exec_credit_mint.restype = i
        lib.vtpu_exec_credit_mint.argtypes = [vp, i64, i64]
        lib.vtpu_exec_credit_spend.restype = i
        lib.vtpu_exec_credit_spend.argtypes = [vp, i64]
        lib.vtpu_exec_credit_level.restype = i64
        lib.vtpu_exec_credit_level.argtypes = [vp]
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


class ExecRing:
    """The fastlane's SPSC execute ring (``native/vtpucore``): one producer
    (the tenant's client), one consumer (the broker's drainer), a credit
    gate, the broker-published fallback gate and the burst-credit bank
    words, with the memory orders ``vtpu_core.h`` declares.  A ring file
    lives next to its card's region (``<region>.lane<slot>.<...>.ring``).
    The waits spin, then sleep on a futex, in native code with the GIL
    dropped."""

    def __init__(self, path: str, entries: int = 0):
        self.lib = load()
        self.handle = self.lib.vtpu_exec_open(path.encode(), int(entries))
        if not self.handle:
            raise OSError(f"vtpu_exec_open({path!r}) failed")
        self.path = path
        # Reused scratch (take and completions are per-batch calls).
        self._buf_n = 256
        self._buf = (ExecDesc * self._buf_n)()
        self._st = (ctypes.c_int64 * self._buf_n)()
        self._ac = (ctypes.c_uint64 * self._buf_n)()

    def close(self) -> None:
        if self.handle:
            self.lib.vtpu_exec_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _h(self):
        """The live handle.  The native calls read a NULL handle as an
        open gate and a refused submit, which would spin a producer on a
        closed lane; a closed ring raises ConnectionError instead."""
        if not self.handle:
            raise ConnectionError("ExecRing is closed")
        return self.handle

    # -- producer --
    def submit(self, desc: ExecDesc) -> bool:
        """Publish one descriptor; False when the credit or slot gate
        refuses (drain completions and retry)."""
        return self.lib.vtpu_exec_submit(self._h(), ctypes.byref(desc)) == 0

    def submit_batch(self, descs, n: int) -> int:
        """Publish up to ``n`` descriptors of a ctypes ExecDesc array in
        one call; the count published (it stops at the first refusal)."""
        return int(self.lib.vtpu_exec_submit_batch(self._h(), descs, int(n)))

    def completions(self, from_seq: int, max_n: int = 0) -> List[ExecDesc]:
        """Completed descriptors [from_seq, headc), copies."""
        n = min(max_n or self._buf_n, self._buf_n)
        got = self.lib.vtpu_exec_completions(self._h(), int(from_seq),
                                             self._buf, n)
        return [ExecDesc.from_buffer_copy(self._buf[i])
                for i in range(max(got, 0))]

    def wait_headc(self, seq: int, timeout_s: float,
                   spin_us: int = 100) -> bool:
        return self.lib.vtpu_exec_wait_headc(
            self._h(), int(seq), int(max(timeout_s, 0.0) * 1e9),
            int(spin_us) * 1000) == 1

    # -- consumer --
    def take(self, max_n: int = 0) -> List[ExecDesc]:
        """Up to ``max_n`` submitted, untaken descriptors (copies); headc
        moves only at ``complete``."""
        n = min(max_n or self._buf_n, self._buf_n)
        got = self.lib.vtpu_exec_take(self._h(), self._buf, n)
        return [ExecDesc.from_buffer_copy(self._buf[i])
                for i in range(max(got, 0))]

    def complete(self, statuses, actuals, t_done_ns: int) -> None:
        """Complete the ``len(statuses)`` oldest taken descriptors: one
        headc publish, one credit RMW."""
        n = min(len(statuses), self._buf_n)
        for i in range(n):
            self._st[i] = int(statuses[i])
            self._ac[i] = int(actuals[i])
        self.lib.vtpu_exec_complete(self._h(), self._st, self._ac,
                                    int(t_done_ns), n)

    def wait_tail(self, seq: int, timeout_s: float,
                  spin_us: int = 100) -> bool:
        return self.lib.vtpu_exec_wait_tail(
            self._h(), int(seq), int(max(timeout_s, 0.0) * 1e9),
            int(spin_us) * 1000) == 1

    # -- shared --
    @property
    def tail(self) -> int:
        return int(self.lib.vtpu_exec_tail(self._h()))

    @property
    def headc(self) -> int:
        return int(self.lib.vtpu_exec_headc(self._h()))

    @property
    def capacity(self) -> int:
        return int(self.lib.vtpu_exec_capacity(self._h()))

    @property
    def credits(self) -> int:
        return int(self.lib.vtpu_exec_credits(self._h()))

    @property
    def depth(self) -> int:
        """Submitted, uncompleted descriptors."""
        return max(self.tail - self.headc, 0)

    def gate(self) -> int:
        return int(self.lib.vtpu_exec_gate(self._h()))

    def gate_set(self, v: int) -> None:
        self.lib.vtpu_exec_gate_set(self._h(), int(v))

    def credit_mint(self, us: int, cap_us: int) -> bool:
        return self.lib.vtpu_exec_credit_mint(self._h(), int(us),
                                              int(cap_us)) == 1

    def credit_spend(self, us: int) -> bool:
        return self.lib.vtpu_exec_credit_spend(self._h(), int(us)) == 1

    def credit_level(self) -> int:
        return int(self.lib.vtpu_exec_credit_level(self._h()))


class TraceRing:
    """A lock-free per-process event ring (``vtpu_trace_*``): one writer,
    the owning process; any number of readers.  Files sit next to the
    region as ``<region>.trace.<pid>``."""

    def __init__(self, path: str, size_kb: int = 0):
        self.lib = load()
        self.handle = self.lib.vtpu_trace_open(path.encode(), int(size_kb))
        if not self.handle:
            raise OSError(f"vtpu_trace_open({path!r}) failed")
        self.path = path

    def close(self) -> None:
        if self.handle:
            self.lib.vtpu_trace_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def emit(self, kind: int, dev: int = 0, value: int = 0,
             arg: int = 0) -> None:
        self.lib.vtpu_trace_emit(self.handle, int(kind), int(dev),
                                 int(value), int(arg))

    @property
    def head(self) -> int:
        return int(self.lib.vtpu_trace_head(self.handle))

    @property
    def capacity(self) -> int:
        return int(self.lib.vtpu_trace_capacity(self.handle))

    def read(self, cursor: int = 0, max_events: int = 1024):
        """(events, next cursor); each event a dict, its kind named."""
        buf = (TraceEvent * max_events)()
        nxt = ctypes.c_uint64(cursor)
        n = self.lib.vtpu_trace_read(self.handle, int(cursor), buf,
                                     max_events, ctypes.byref(nxt))
        out = [{"t_ns": int(ev.t_ns),
                "kind": TEV_NAMES.get(int(ev.kind), str(int(ev.kind))),
                "dev": int(ev.dev), "value": int(ev.value),
                "arg": int(ev.arg)} for ev in buf[:max(n, 0)]]
        return out, int(nxt.value)
