"""The fastlane: the broker's data plane for a tenant on one card.

The port of ``vtpu.runtime.fastlane``, single-card.  Unchained executes
ride a native SPSC descriptor ring in shared memory (``native/vtpucore``
``vtpu_exec_*``, mirrored by ``shim/core.py``'s ``ExecRing``) from the
tenant's client to a drainer thread of the broker, one per card; tensor
payloads move through two mmap'd arenas whose fds cross the unix socket
once, at HELLO.  Enforcement moves to the region the co-tenants share:
the client pre-debits rate leases from the same native token bucket the
broker's dispatcher reads, and HBM charges go through the same ledger.

The broker stays the control plane: HELLO builds the lane, FASTBIND binds
a route (a program with its argument and output ids) to an integer,
SUSPEND parks the ring's gate word, teardown, RESIZE, DRAIN and HANDOVER
close it, and a journaled resume builds a fresh one.  Chained executes
(``repeats``), executes that free ids, a parked or closed gate and a
second connection of the same tenant fall back to the socket; the client
does that without telling the application, and a descriptor the gate
cancelled before it ran is sent again over the socket.

What is CUDA's here:

- **One stream, two producers.**  The drainer queues its batches on the
  card's one stream, like the dispatcher; ``ChipState.launch_mu`` keeps a
  batch's launches together, so its two timing events bracket its own
  work.  Each output's ``_Ready`` is its batch's end event, so a GET of a
  ring output waits for its batch alone.
- **Billing is device time.**  The dispatch is asynchronous, so the
  batch's host wall time is near zero.  ``LaneMeter`` (one thread per
  card) waits on each batch's end event, reads the device time between
  its events and corrects the tenant's bucket by what the socket path
  would bill for that time (``bill_us``).  A failed event is a device
  fault: the broker exits with ``DEVICE_FAULT_EXIT`` as the metering of
  the socket path does.  On the CPU the batch's wall time is its device
  time.
- **Completions publish after the copies.**  An inline argument blob is
  copied out of the tx arena before the batch's completion publishes (the
  client reuses the region after it), and the outputs own their storage
  (``Program.run`` copies a view).

- **The SLO harvest is the meter's.**  ``meter_batch`` feeds the SLO plane
  (``runtime/slo.py``) once a batch's end event is seen: each item's total
  runs from its client's submit stamp to that moment, and its device phase
  is its share of the batch's device time by estimate, the split the
  routes learn by (the client's bucket waits fall in the queue phase, as
  in ``vtpu``).

Left for later slices, as in ``vtpu`` with the matching knobs off: sharded
lanes over several cards (``VTPU_FASTLANE_MULTICHIP``, the completion
vector; a HELLO over several cards is refused, 6(f)); minting burst
credits into the ring's bank words (6(f), so the bank stays 0);
preemption (6(f)): a lane parks only for ``state.suspended``.

Knobs: ``VTPU_FASTLANE`` (client: ``1`` asks for a lane; broker: ``0``
serves none), ``VTPU_FASTLANE_RING`` (entries), ``VTPU_FASTLANE_ARENA_MB``
(each arena), ``VTPU_FASTLANE_SPIN_US`` (spin before the native waits
sleep on the ring's futex word), ``VTPU_FASTLANE_BATCH`` (descriptors a drain takes), and
``VTPU_ARENA_FEED`` (``0``: per-step host batches go as socket PUTs).
"""

from __future__ import annotations

import mmap
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import logging as log

# The ring's status and gate words (shim/core.py, vtpu_core.h); this
# module imports without the native library.
EXEC_OK = 0
EXEC_ENOTFOUND = -1
EXEC_EINTERNAL = -2
EXEC_ECANCELED = -3
GATE_OPEN = 0
GATE_PARKED = 1
GATE_CLOSED = 2


def _as_int(raw: str, default: int, lo: int) -> int:
    """A knob's integer, at least ``lo``; junk reads as the default."""
    try:
        return max(int(raw or default), lo)
    except ValueError:
        return default


def broker_serves() -> bool:
    """Broker: serve lanes to the clients that ask (``VTPU_FASTLANE=0``
    turns the data plane off)."""
    return os.environ.get("VTPU_FASTLANE", "1") != "0"


def client_wants() -> bool:
    """Client: ask for a lane (off by default)."""
    return os.environ.get("VTPU_FASTLANE", "0") == "1"


def arena_feed_enabled() -> bool:
    """Per-step host batches ride the tx arena (``VTPU_ARENA_FEED=0``:
    socket PUTs)."""
    return os.environ.get("VTPU_ARENA_FEED", "1") != "0"


def ring_entries() -> int:
    return _as_int(os.environ.get("VTPU_FASTLANE_RING", ""), 1024, 1)


def arena_bytes() -> int:
    try:
        mb = float(os.environ.get("VTPU_FASTLANE_ARENA_MB", "64"))
    except ValueError:
        mb = 64.0
    return max(int(mb * (1 << 20)), 1 << 20)


def spin_us() -> int:
    """The native waits spin this long (yielding the core) before they
    sleep on the ring's futex word, 2 ms at most a sleep, until woken or
    timed out."""
    return _as_int(os.environ.get("VTPU_FASTLANE_SPIN_US", ""), 200, 0)


def drain_batch() -> int:
    return _as_int(os.environ.get("VTPU_FASTLANE_BATCH", ""), 128, 1)


def bill_us(busy_us: float, est_us: float, steps: int,
            min_cost_us: float) -> float:
    """What a bucket is charged for ``busy_us`` of metered device time
    that was admitted at ``est_us``: the socket path's rule (at least the
    floor a step, at most four times the estimate)."""
    return min(max(busy_us, min_cost_us * steps), est_us * 4.0)


class PyRing:
    """A pure-Python ring with ``ExecRing``'s surface (FIFO, credits,
    completions, gate, bank), for tests that drive the drain logic
    without shared memory."""

    def __init__(self, entries: int = 64):
        self.capacity = entries
        self.slots: List[Any] = [None] * entries
        self.tail = 0
        self.headc = 0
        self.credits = entries
        self._taken = 0
        self._gate = GATE_OPEN
        self._credit_us = 0
        self.path = ""

    def close(self) -> None:
        pass

    def submit(self, desc) -> bool:
        if self.credits <= 0 or self.tail - self.headc >= self.capacity:
            return False
        self.credits -= 1
        self.slots[self.tail % self.capacity] = desc
        self.tail += 1
        return True

    def take(self, max_n: int = 0):
        out = []
        at = self.headc + self._taken
        n = max_n or self.capacity
        while at < self.tail and len(out) < n:
            out.append(self.slots[at % self.capacity])
            at += 1
        self._taken += len(out)
        return out

    def complete(self, statuses, actuals, t_done_ns: int) -> None:
        n = min(len(statuses), self._taken)
        for i in range(n):
            d = self.slots[(self.headc + i) % self.capacity]
            d.status = int(statuses[i])
            d.actual_us = int(actuals[i])
            d.t_done_ns = int(t_done_ns)
        self.headc += n
        self.credits += n
        self._taken -= n

    def completions(self, from_seq: int, max_n: int = 0):
        out = []
        n = max_n or self.capacity
        while from_seq < self.headc and len(out) < n:
            out.append(self.slots[from_seq % self.capacity])
            from_seq += 1
        return out

    @property
    def depth(self) -> int:
        return max(self.tail - self.headc, 0)

    def gate(self) -> int:
        return self._gate

    def gate_set(self, v: int) -> None:
        self._gate = int(v)

    def credit_mint(self, us: int, cap_us: int) -> bool:
        nv = min(self._credit_us + int(us), int(cap_us))
        if nv <= self._credit_us:
            return False
        self._credit_us = nv
        return True

    def credit_spend(self, us: int) -> bool:
        if self._credit_us < us:
            return False
        self._credit_us -= int(us)
        return True

    def credit_level(self) -> int:
        return self._credit_us

    def wait_tail(self, seq: int, timeout_s: float, spin_us_: int = 0) -> bool:
        return self.tail >= seq

    def wait_headc(self, seq: int, timeout_s: float,
                   spin_us_: int = 0) -> bool:
        return self.headc >= seq


class PyDesc:
    """The descriptor ``PyRing`` carries."""

    __slots__ = ("eseq", "route", "arg_off", "arg_len", "cost_us",
                 "t_sub_ns", "eflags", "status", "actual_us", "t_done_ns")

    def __init__(self, **kw):
        for f in self.__slots__:
            setattr(self, f, int(kw.get(f, 0)))


class Route:
    """One FASTBIND route: a program with its argument and output ids, so
    a descriptor carries one integer."""

    __slots__ = ("exe_key", "prog", "arg_ids", "out_ids", "metas", "cost_us",
                 "meas_us", "primed", "primed_ver")

    def __init__(self, exe_key: str, prog, arg_ids, out_ids, metas,
                 cost_us: float):
        self.exe_key = exe_key
        self.prog = prog
        self.arg_ids = list(arg_ids)
        self.out_ids = list(out_ids)
        self.metas = metas
        self.cost_us = cost_us
        # The metered device time of one item, which completions publish
        # (the client's cost estimate learns from it).
        self.meas_us = 0.0
        # The first run binds the outputs through the ledger; later runs
        # swap the tensors only while the tenant's array table is as this
        # route left it (a DELETE of an output released its charge, and a
        # blind swap would bring it back uncharged).
        self.primed = False
        self.primed_ver = -1


class BrokerLane:
    """The broker's side of one tenant's lane: the ring, the arenas, the
    routes, the counters."""

    def __init__(self, tenant, ring, tx_file, rx_file, paths: Dict[str, str]):
        self.tenant = tenant
        self.ring = ring
        self.tx_file = tx_file          # (fd, mmap) or None
        self.rx_file = rx_file
        self.paths = paths
        self.routes: List[Route] = []
        self.closed = False
        self._freed = False
        self.ring_steps = 0
        self.fallback_steps = 0
        self.errors = 0
        self.cancelled = 0
        # Batches queued on the card whose device time is not billed yet
        # (guarded by the hub's lock).
        self.unmetered = 0
        self.device_us = 0.0
        self.billed_us = 0.0
        # The card's per-slot device time at the last harvest: the SLO
        # blame window of the next batch.
        self.busy_snap: Optional[tuple] = None

    def tx_view(self) -> Optional[memoryview]:
        return memoryview(self.tx_file[1]) if self.tx_file else None

    def rx_view(self) -> Optional[memoryview]:
        return memoryview(self.rx_file[1]) if self.rx_file else None

    def gate_set(self, v: int) -> None:
        try:
            self.ring.gate_set(v)
        except (OSError, ValueError, ConnectionError):
            pass

    def close(self, unlink: bool = True) -> None:
        """The native teardown (``closed`` alone only gates the drain)."""
        if self._freed:
            return
        self._freed = True
        self.closed = True
        self.gate_set(GATE_CLOSED)
        for ent in (self.tx_file, self.rx_file):
            if ent:
                try:
                    ent[1].close()
                except (BufferError, OSError, ValueError):
                    # A view still exported over the arena pins the
                    # mapping; the fd close and unlink below still run.
                    pass
                try:
                    os.close(ent[0])
                except OSError:
                    pass
        try:
            self.ring.close()
        except OSError:
            pass
        if unlink:
            for p in self.paths.values():
                try:
                    os.unlink(p)
                except OSError:
                    pass

    def stats(self) -> Dict[str, Any]:
        try:
            depth, gate = self.ring.depth, self.ring.gate()
            credit = self.ring.credit_level()
        except (OSError, ValueError, ConnectionError):
            depth, gate, credit = 0, GATE_CLOSED, 0
        arena = 0
        for ent in (self.tx_file, self.rx_file):
            if ent:
                try:
                    arena += len(ent[1])
                except ValueError:
                    pass
        return {"ring_depth": depth, "ring_steps": self.ring_steps,
                "fallback_steps": self.fallback_steps, "errors": self.errors,
                "cancelled": self.cancelled,
                "gate": gate, "credit_us": credit, "credit_minted_us": 0,
                "arena_bytes": arena, "routes": len(self.routes),
                "device_us": int(self.device_us),
                "billed_us": int(self.billed_us)}


class FastlaneHub:
    """The broker's lanes: their lifecycle, FASTBIND, one drainer and one
    meter per card, the STATS rollup.  ``mu`` guards the registry only
    (never held across execution, journal writes or socket I/O)."""

    def __init__(self, state):
        self.state = state
        self.mu = threading.Condition()
        self.lanes: Dict[str, BrokerLane] = {}
        self.drainers: Dict[int, "Drainer"] = {}
        self.meters: Dict[int, "LaneMeter"] = {}
        # Retired lanes: their cancel and munmap run on the card's drainer
        # (never beside a live drain), inline only where none exists.
        self._dead: Dict[int, List[BrokerLane]] = {}
        self.serve = broker_serves()
        self.ring_steps_total = 0
        self.fallback_total = 0

    # -- lifecycle --

    def create_lane(self, tenant) -> Optional[Tuple[dict, List[int]]]:
        """A lane for ``tenant`` at HELLO: a ring and two arenas next to
        its card's region.  (reply descriptor, [tx fd, rx fd]), or None
        when lanes are off or the tenant is shared by connections."""
        if not self.serve or tenant.connections > 1:
            return None
        from ..shim import core as shim_core
        region_path = tenant.chip.region.path
        base = (f"{region_path}.lane{tenant.index}."
                f"{os.getpid():x}.{time.time_ns() & 0xffffff:x}")
        paths = {"ring": base + ".ring", "tx": base + ".tx",
                 "rx": base + ".rx"}
        # An earlier epoch's files of this slot are dead weight (their
        # descriptors died with that broker).
        lane_dir = os.path.dirname(region_path) or "."
        prefix = os.path.basename(region_path) + f".lane{tenant.index}."
        try:
            for fn in os.listdir(lane_dir):
                if fn.startswith(prefix) \
                        and not fn.startswith(os.path.basename(base)):
                    try:
                        os.unlink(os.path.join(lane_dir, fn))
                    except OSError:
                        pass
        except OSError:
            pass
        ring = None
        files: List[Tuple[int, mmap.mmap]] = []
        nbytes = arena_bytes()
        try:
            ring = shim_core.ExecRing(paths["ring"], ring_entries())
            for p in (paths["tx"], paths["rx"]):
                fd = os.open(p, os.O_RDWR | os.O_CREAT, 0o666)
                os.ftruncate(fd, nbytes)
                files.append((fd, mmap.mmap(fd, nbytes)))
        except OSError as e:
            log.warn("fastlane: lane of %s not built (%s); its executes go "
                     "over the socket", tenant.name, e)
            if ring is not None:
                ring.close()
            for fd, m in files:
                m.close()
                os.close(fd)
            return None
        lane = BrokerLane(tenant, ring, files[0], files[1], paths)
        with self.mu:
            old = self.lanes.pop(tenant.name, None)
            self.lanes[tenant.name] = lane
        if old is not None:
            self._retire_lane(old)
        tenant.fastlane = lane
        self._ensure_threads(tenant.chip)
        reply = {"ring": paths["ring"], "entries": ring.capacity,
                 "arena_tx": paths["tx"], "arena_rx": paths["rx"],
                 "arena_bytes": nbytes, "region": region_path,
                 "slot": tenant.index,
                 "quantum_us": int(self.state.rate_lease_us),
                 "priority": tenant.priority}
        return reply, [files[0][0], files[1][0]]

    def _ensure_threads(self, chip) -> None:
        with self.mu:
            if chip.index not in self.drainers:
                m = LaneMeter(self, chip)
                d = Drainer(self, chip)
                self.meters[chip.index] = m
                self.drainers[chip.index] = d
                m.start()
                d.start()

    def bind_route(self, tenant, exe_key: str, arg_ids, out_ids) -> dict:
        """FASTBIND: a route's index and its outputs' static metadata.
        Route -1 until the program has run unchained once over the socket
        (its first run holds one-time costs, which the socket's metering
        bills at the estimate)."""
        lane = getattr(tenant, "fastlane", None)
        if lane is None or lane.closed:
            return {"ok": False, "code": "FASTLANE_OFF",
                    "error": "no fastlane lane on this tenant"}
        prog = tenant.executables.get(exe_key)
        if prog is None:
            return {"ok": False, "code": "NOT_FOUND", "error": exe_key}
        cost = float(tenant.cost_ema.get(
            exe_key, max(float(self.state.min_exec_cost_us), 5000.0)))
        if not any(steps == 1 for steps, _ in prog.warmed):
            return {"ok": True, "route": -1, "cost_us": cost}
        out_ids = list(out_ids)
        while len(out_ids) < prog.n_outs:
            tenant.anon_seq += 1
            out_ids.append(f"_anon{tenant.anon_seq}")
        metas = [{"id": out_ids[i], "shape": m["shape"], "dtype": m["dtype"]}
                 for i, m in enumerate(prog.out_meta)]
        route = Route(exe_key, prog, arg_ids, out_ids, metas, cost)
        with self.mu:
            lane.routes.append(route)
            idx = len(lane.routes) - 1
        return {"ok": True, "route": idx, "cost_us": cost, "outs": metas}

    def gate_close(self, name: str) -> None:
        """Send the tenant to the socket for good (a second connection
        joined it): the gate closes and what is in the ring cancels, on
        the card's drainer (take and complete are single-consumer)."""
        with self.mu:
            lane = self.lanes.get(name)
            drained = lane is not None and lane.tenant.chip.index \
                in self.drainers
        if lane is None:
            return
        lane.closed = True
        lane.gate_set(GATE_CLOSED)
        if not drained:
            self._cancel_ring(lane)

    def quiesce_lane(self, name: str, timeout_s: float = 2.0) -> None:
        """Teardown's first step: close the gate and wait, bounded, for the
        drainer to cancel what is in the ring (refunding the client's
        pre-debits) and for the meter to bill the batches queued on the
        card, before the slot can recycle: a late refund or bill would
        land on the slot's next tenant."""
        self.gate_close(name)
        with self.mu:
            lane = self.lanes.get(name)
        if lane is None:
            return
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                empty = lane.ring.depth == 0
            except (OSError, ValueError, ConnectionError):
                empty = True
            with self.mu:
                if empty and not lane.unmetered:
                    return
                self.mu.wait(0.002)
        log.warn("fastlane: lane %s did not quiesce in %.1fs", name,
                 timeout_s)

    def repark(self, name: str) -> None:
        """Park the lane's gate until the drainer's next pass reopens it
        (RESIZE): the client sends that step over the socket and gives
        back the lease it holds at the old share."""
        with self.mu:
            lane = self.lanes.get(name)
        if lane is not None and not lane.closed:
            lane.gate_set(GATE_PARKED)

    def quiesce_all(self, timeout_s: float) -> bool:
        """A drain's wait: every lane parked by its drainer (so no batch of
        it is mid-dispatch) or closed, and every lane batch billed.  True
        when quiet."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        with self.mu:
            while True:
                busy = False
                for ln in self.lanes.values():
                    try:
                        parked = ln.closed or ln.ring.gate() != GATE_OPEN
                    except (OSError, ValueError, ConnectionError):
                        parked = True
                    if ln.unmetered or not (
                            parked or ln.tenant.chip.index
                            not in self.drainers):
                        busy = True
                        break
                if not busy:
                    return True
                if time.monotonic() >= deadline:
                    return False
                self.mu.wait(0.005)

    def wait_metered(self, name: str, timeout_s: float = 30.0) -> None:
        """Wait until every batch the tenant's lane queued is billed (what
        STATS waits for, like the socket path's quiesce)."""
        deadline = time.monotonic() + timeout_s
        with self.mu:
            lane = self.lanes.get(name)
            while lane is not None and lane.unmetered \
                    and time.monotonic() < deadline:
                self.mu.wait(0.05)

    def _retire_lane(self, lane: BrokerLane) -> None:
        lane.closed = True
        lane.gate_set(GATE_CLOSED)
        with self.mu:
            idx = lane.tenant.chip.index
            drained = idx in self.drainers
            if drained:
                self._dead.setdefault(idx, []).append(lane)
                self.mu.notify_all()
        if not drained:
            self._cancel_ring(lane)
            lane.close()

    def close_lane(self, name: str) -> None:
        """Teardown: what is left in the ring completes ECANCELED and
        refunds; the files are unlinked (on the drainer)."""
        with self.mu:
            lane = self.lanes.pop(name, None)
        if lane is None:
            return
        lane.tenant.fastlane = None
        self._retire_lane(lane)

    def reap_dead(self, chip_index: int) -> None:
        """Cancel and close the retired lanes of one card: the drainer
        calls it, so no drain runs beside it."""
        with self.mu:
            dead = self._dead.pop(chip_index, None)
        for lane in dead or ():
            self._cancel_ring(lane)
            lane.close()

    def note_fallback(self, tenant, n: int = 1) -> None:
        """A socket execute while the tenant has a lane."""
        lane = getattr(tenant, "fastlane", None)
        if lane is not None:
            lane.fallback_steps += n
            self.fallback_total += n

    def stop(self) -> None:
        with self.mu:
            threads = list(self.drainers.values()) + list(
                self.meters.values())
            lanes = list(self.lanes.values())
            dead = [ln for lst in self._dead.values() for ln in lst]
            self.lanes.clear()
            self.drainers.clear()
            self.meters.clear()
            self._dead.clear()
        for th in threads:
            th.stop()
        for lane in lanes + dead:
            self._cancel_ring(lane)
            lane.close()

    # -- stats --

    def tenant_stats(self, name: str) -> Optional[Dict[str, Any]]:
        with self.mu:
            lane = self.lanes.get(name)
        return lane.stats() if lane is not None else None

    def stats(self) -> Dict[str, Any]:
        with self.mu:
            n = len(self.lanes)
            passes = sum(d.passes for d in self.drainers.values())
        return {"lanes": n, "ring_steps_total": self.ring_steps_total,
                "fallback_steps_total": self.fallback_total,
                "enabled": self.serve, "drainer_passes": passes}

    # -- the drain --

    def drain_once(self, chip) -> int:
        """One pass over the lanes of ``chip``; the items it moved."""
        with self.mu:
            work = [ln for ln in self.lanes.values()
                    if ln.tenant.chip is chip]
        return sum(self._drain_lane(ln) for ln in work)

    def _cancel_ring(self, lane: BrokerLane) -> None:
        """Complete every descriptor still in a closing lane's ring with
        ECANCELED and refund its pre-debit, while the tenant still owns
        its slot (after the release a new tenant may hold it)."""
        ring = lane.ring
        t = lane.tenant
        try:
            while True:
                descs = ring.take(64)
                if not descs:
                    break
                costs = sum(int(d.cost_us) for d in descs)
                ring.complete([EXEC_ECANCELED] * len(descs),
                              [0] * len(descs), time.time_ns())
                lane.cancelled += len(descs)
                reg = getattr(self.state, "tenants", None)
                if costs and (reg is None or reg.get(t.name) is t):
                    t.chip.region.rate_adjust(t.index, -costs)
        except (OSError, ValueError, ConnectionError):
            pass

    def _drain_lane(self, lane: BrokerLane) -> int:
        t = lane.tenant
        if lane.closed:
            self._cancel_ring(lane)
            return 0
        if t.name in self.state.suspended or self.state.dispatch_paused:
            try:
                if lane.ring.gate() != GATE_PARKED:
                    lane.gate_set(GATE_PARKED)
            except (OSError, ConnectionError):
                pass
            return 0
        try:
            if lane.ring.gate() == GATE_PARKED:
                lane.gate_set(GATE_OPEN)
            descs = lane.ring.take(drain_batch())
        except (OSError, ValueError, ConnectionError):
            return 0
        if not descs:
            t.fastlane_depth = 0
            return 0
        return self._execute_batch(lane, descs)

    def _resolve(self, t, route: Route, desc, tx) -> List[torch.Tensor]:
        """A descriptor's arguments (caller holds ``t.mu``); an inline
        blob replaces the argument its flags name, copied out of the
        arena and to the card before the completion publishes."""
        args = []
        for aid in route.arg_ids:
            a = t.arrays.get(aid)
            if a is None:
                raise KeyError(aid)
            args.append(a)
        if desc.arg_len and tx is not None and args:
            ap = int(desc.eflags) & 0xFF
            if ap >= len(args):
                ap = 0
            a0 = args[ap]
            off, n = int(desc.arg_off), int(desc.arg_len)
            want = a0.numel() * a0.element_size()
            if off < 0 or off + n > len(tx) or n != want:
                raise ValueError(f"arena blob [{off}, +{n}) does not hold "
                                 f"argument {ap} ({want} bytes)")
            from .server import to_card
            host = torch.frombuffer(bytearray(tx[off:off + n]),
                                    dtype=a0.dtype).reshape(a0.shape)
            args[ap] = to_card(host, t.chip)
        return args

    def _bind(self, t, route: Route, outs, ready) -> bool:
        """Bind one item's outputs (caller holds ``t.mu``): a tensor swap
        on a primed route whose table is as it left it, else every output
        through the ledger.  False (nothing bound) when the outputs do not
        fit the cap."""
        if route.primed and route.primed_ver == t.arrays_ver:
            for oid, o in zip(route.out_ids, outs):
                t.arrays[oid] = o
                t.ready[oid] = ready
            return True
        need = 0
        for oid, m in zip(route.out_ids, route.prog.out_meta):
            if not (oid in t.arrays and t.nbytes.get(oid) == m["nbytes"]):
                need += m["nbytes"]
        if need and not t.charge_array(need):
            return False
        for oid, o, m in zip(route.out_ids, outs, route.prog.out_meta):
            nb = m["nbytes"]
            if oid in t.arrays and t.nbytes.get(oid) == nb:
                t.arrays[oid] = o
            else:
                t.drop_array(oid)
                t.arrays[oid] = o
                t.nbytes[oid] = nb
            t.ready[oid] = ready
        t.arrays_ver += 1
        route.primed = True
        route.primed_ver = t.arrays_ver
        return True

    def _execute_batch(self, lane: BrokerLane, descs) -> int:
        """Run one drained batch on the card's stream, bind its outputs and
        publish its completions; its device time is billed by the meter."""
        from .server import _Ready, flush_tenant_journal
        t = lane.tenant
        chip = t.chip
        n = len(descs)
        st = [EXEC_OK] * n
        ac = [0] * n
        est = [float(d.cost_us) for d in descs]
        subs = [int(d.t_sub_ns) for d in descs]
        routes = lane.routes
        tx = lane.tx_view() if any(d.arg_len for d in descs) else None
        ready = _Ready()
        counts: Dict[int, int] = {}
        cuda = chip.stream is not None
        with chip.launch_mu, chip.context(), torch.inference_mode():
            ev0 = chip.record(timing=True)
            t0 = time.monotonic()
            for i, d in enumerate(descs):
                ridx = int(d.route)
                if ridx >= len(routes):
                    st[i] = EXEC_ENOTFOUND
                    continue
                route = routes[ridx]
                try:
                    with t.mu:
                        args = self._resolve(t, route, d, tx)
                    outs = route.prog.run(args, 1, ((0, 0),))
                    with t.mu:
                        bound = self._bind(t, route, outs, ready)
                    if not bound:
                        # Over the cap: never ran as far as the tenant can
                        # see; the client sends it again over the socket,
                        # which answers RESOURCE_EXHAUSTED.
                        st[i] = EXEC_ECANCELED
                        continue
                    counts[ridx] = counts.get(ridx, 0) + 1
                    ac[i] = int(route.meas_us or route.cost_us)
                except KeyError:
                    st[i] = EXEC_ENOTFOUND
                except Exception as e:  # noqa: BLE001 - per-item isolation
                    st[i] = EXEC_EINTERNAL
                    log.warn("fastlane: %s route execute failed: %s",
                             t.name, e)
            wall_us = (time.monotonic() - t0) * 1e6
            ev1 = chip.record(timing=True)
            ready.fill(ev1)
        ok_est = sum(e for e, s in zip(est, st) if s == EXEC_OK)
        refund = sum(e for e, s in zip(est, st) if s != EXEC_OK)
        errors = sum(1 for s in st if s not in (EXEC_OK, EXEC_ECANCELED))
        if refund:
            chip.region.rate_adjust(t.index, -int(refund))
        ok = n - st.count(EXEC_ECANCELED) - errors
        if ok:
            with self.mu:
                lane.unmetered += 1
            items = [(e, sub) for e, sub, s_ in zip(est, subs, st)
                     if s_ == EXEC_OK]
            self.meters_put(chip, (lane, ok, ok_est, counts,
                                   ev0 if cuda else None,
                                   ev1 if cuda else None, wall_us, items))
        # The counters move before the completions publish, so a client
        # that has its reply reads them moved.
        lane.errors += errors
        lane.ring_steps += ok
        self.ring_steps_total += ok
        t.executions += ok
        lane.ring.complete(st, [a if s == EXEC_OK else 0
                                for a, s in zip(ac, st)], time.time_ns())
        try:
            t.fastlane_depth = lane.ring.depth
        except (OSError, ValueError, ConnectionError):
            t.fastlane_depth = 0
        if t.pending_journal:
            flush_tenant_journal(self.state, t)
        return n

    def meters_put(self, chip, rec) -> None:
        m = self.meters.get(chip.index)
        if m is None:
            # No meter thread (tests drive the drain by hand): bill now.
            meter_batch(self, chip, rec)
        else:
            m.q.put(rec)


def meter_batch(hub: FastlaneHub, chip, rec) -> None:
    """Bill one lane batch: its device time from its two events (the wall
    time of its dispatch on the CPU), charged to the bucket by
    ``bill_us`` against what the client pre-debited, and learned by its
    routes and the tenant's cost EMA; then the SLO plane's rows (the
    module docstring)."""
    lane, n, est, counts, ev0, ev1, wall_us, items = rec
    t = lane.tenant
    try:
        if ev1 is not None:
            try:
                ev1.synchronize()
            except RuntimeError as e:
                from .server import DEVICE_FAULT_EXIT
                log.error("device fault on card %d (%s): the CUDA context is "
                          "unusable; the broker exits", chip.index, e)
                os._exit(DEVICE_FAULT_EXIT)
            busy = max(ev0.elapsed_time(ev1), 0.0) * 1e3
        else:
            busy = wall_us
        state = hub.state
        charged = bill_us(busy, est, n, float(state.min_exec_cost_us))
        region = chip.region
        reg = getattr(state, "tenants", None)
        if reg is None or reg.get(t.name) is t:
            region.busy_add(t.index, int(busy))
            region.rate_adjust(t.index, int(charged - est))
        lane.device_us += busy
        lane.billed_us += charged
        # Each route learns its share of the batch's time, by estimate.
        per_est = busy / max(est, 1.0)
        for ridx, k in counts.items():
            route = lane.routes[ridx]
            meas = route.cost_us * per_est
            route.meas_us = meas if not route.meas_us else (
                0.7 * route.meas_us + 0.3 * meas)
            prev = t.cost_ema.get(route.exe_key, route.cost_us)
            t.cost_ema[route.exe_key] = 0.7 * prev + 0.3 * min(
                route.meas_us, prev * 4.0)
        plane = getattr(state, "slo", None)
        if plane is not None and plane.enabled and items:
            _harvest_slo(plane, chip, lane, busy, est, items)
    finally:
        with hub.mu:
            lane.unmetered = max(lane.unmetered - 1, 0)
            hub.mu.notify_all()


def _harvest_slo(plane, chip, lane: BrokerLane, busy: float, est: float,
                 items) -> None:
    """One lane batch into the SLO plane, on the meter's thread: a row per
    item (``stage_batch``'s), total from its submit stamp to now, device
    its share of ``busy`` by estimate; blame weights from the co-tenants'
    device time since the lane's last batch."""
    done_ns = time.time_ns()
    sched = getattr(chip, "scheduler", None)
    weights = None
    if sched is not None:
        snap = tuple(sched.slo_busy)
        prev = lane.busy_snap
        if prev is not None:
            weights = {}
            for slot, (b0, b1) in enumerate(zip(prev, snap)):
                name = sched.slo_names[slot]
                if b1 - b0 > 0.0 and name:
                    weights[name] = weights.get(name, 0.0) + (b1 - b0)
        lane.busy_snap = snap
    flat: List[float] = []
    for e, sub in items:
        dt_enq = max((done_ns - sub) * 1e-9, 0.0)
        dt_disp = min(busy * (e / max(est, 1.0)) * 1e-6, dt_enq)
        flat.extend((dt_enq, 0.0, dt_disp, 1))
    plane.stage_batch({lane.tenant.name: flat}, weights, len(items))


class ClientLane:
    """The tenant's side of a lane: the ring's producer, the mapped arenas
    (fds from HELLO, paths as the fallback), and the enforcement the
    client burns itself: a rate-lease quantum pre-debited from the token
    bucket its co-tenants read, or a block in that bucket."""

    def __init__(self, info: Dict[str, Any], fds: Optional[List[int]] = None):
        from ..shim import core as shim_core
        self.ring = shim_core.ExecRing(str(info["ring"]))
        self.info = dict(info)
        self.slot = int(info.get("slot", 0))
        self.priority = int(info.get("priority", 1))
        self.quantum_us = float(info.get("quantum_us", 20000) or 0)
        self.arena_nbytes = int(info.get("arena_bytes", 0) or 0)
        self.tx = self.rx = None
        try:
            if fds and len(fds) >= 2:
                self.tx = mmap.mmap(fds[0], self.arena_nbytes)
                self.rx = mmap.mmap(fds[1], self.arena_nbytes)
                for fd in fds[:2]:
                    os.close(fd)
            else:
                for attr, key in (("tx", "arena_tx"), ("rx", "arena_rx")):
                    fd = os.open(str(info[key]), os.O_RDWR)
                    try:
                        setattr(self, attr, mmap.mmap(fd, self.arena_nbytes))
                    finally:
                        os.close(fd)
        except (OSError, KeyError, ValueError):
            self.tx = self.rx = None  # a lane without arenas: ring only
        self.region = None
        rp = info.get("region")
        if rp and os.path.exists(str(rp)):
            try:
                self.region = shim_core.SharedRegion(str(rp))
            except OSError:
                self.region = None
        self._lease_us = 0.0
        self._lease_exp = 0.0
        self._lease_ttl = max(4.0 * self.quantum_us / 1e6, 0.05)
        self.lease_grants = 0
        # Per-step host batches bump-allocate from the tx arena's upper
        # half (the lower half is the synchronous PUT's), wrap when none
        # is outstanding, and refuse when full.
        self.feed_base = self.arena_nbytes // 2
        self._feed_head = self.feed_base
        self._feed_live = 0
        self.feed_steps = 0
        self.seq = self.ring.tail
        self._done: Dict[int, Tuple[int, int, int]] = {}
        self._done_cursor = self.ring.headc
        self.ring_steps = 0
        self._items: List[Tuple[int, float, int, int, int]] = []
        self._cost = 0.0

    def close(self) -> None:
        for m in (self.tx, self.rx):
            try:
                if m is not None:
                    m.close()
            except (BufferError, OSError, ValueError):
                pass
        if self.region is not None:
            self.region.close()
            self.region = None
        self.ring.close()

    def usable(self) -> bool:
        try:
            return self.ring.gate() == GATE_OPEN
        except (OSError, ValueError, ConnectionError):
            return False

    # -- the feed window --

    def feed_alloc(self, nbytes: int) -> Optional[int]:
        if self.tx is None or nbytes <= 0 \
                or nbytes > self.arena_nbytes - self.feed_base:
            return None
        if self._feed_head + nbytes > self.arena_nbytes:
            if self._feed_live:
                return None
            self._feed_head = self.feed_base
        off = self._feed_head
        self._feed_head += nbytes
        self._feed_live += 1
        self.feed_steps += 1
        return off

    def feed_release(self, n: int = 1) -> None:
        self._feed_live = max(self._feed_live - n, 0)
        if self._feed_live == 0:
            self._feed_head = self.feed_base

    def feed_reset(self) -> None:
        self._feed_live = 0
        self._feed_head = self.feed_base

    # -- enforcement --

    def admit(self, cost_us: float) -> None:
        """Admit ``cost_us`` before the submit: the lease's balance, else a
        fresh pre-debited quantum, else a block in the shared bucket."""
        reg = self.region
        if reg is None:
            return
        cost = max(int(cost_us), 0)
        now = time.monotonic()
        if self._lease_us > 0.0 and now >= self._lease_exp:
            self.release_lease()
        if self._lease_us >= cost:
            self._lease_us -= cost
            return
        q = int(self.quantum_us)
        if q > 0 and reg.rate_acquire(self.slot, cost + q,
                                      self.priority) == 0:
            self._lease_us += q
            self._lease_exp = now + self._lease_ttl
            self.lease_grants += 1
            return
        reg.rate_block(self.slot, max(cost, 1), self.priority)

    def release_lease(self) -> None:
        """Refund the unburned lease (expiry, fallback, teardown)."""
        left = int(self._lease_us)
        self._lease_us = 0.0
        if left > 0 and self.region is not None:
            self.region.rate_adjust(self.slot, -left)

    # -- produce and complete --

    def buffer(self, route_id: int, cost_us: float, arg_off: int = 0,
               arg_len: int = 0, argpos: int = 0) -> int:
        """Stage one descriptor (``flush`` publishes it); its seq."""
        seq = self.seq
        self.seq += 1
        self._items.append((route_id, cost_us, arg_off, arg_len,
                            int(argpos) & 0xFF))
        self._cost += cost_us
        self.ring_steps += 1
        return seq

    @property
    def buffered(self) -> int:
        return len(self._items)

    def flush(self, alive_check=None) -> None:
        """Admit and publish the staged descriptors in order, waiting out
        a full ring with the gate and the broker's pulse checked."""
        items, self._items = self._items, []
        if not items:
            return
        cost, self._cost = self._cost, 0.0
        self.admit(cost)
        from ..shim.core import ExecDesc
        seq0 = self.seq - len(items)
        arr = (ExecDesc * len(items))()
        now = time.time_ns()
        for k, (route, c, off, ln, ap) in enumerate(items):
            arr[k].eseq = seq0 + k
            arr[k].route = int(route)
            arr[k].arg_off = int(off)
            arr[k].arg_len = int(ln)
            arr[k].cost_us = int(c)
            arr[k].t_sub_ns = now
            arr[k].eflags = ap
        import ctypes
        done, stuck = 0, 0
        size = ctypes.sizeof(ExecDesc)
        while done < len(items):
            ptr = ctypes.cast(ctypes.byref(arr, done * size),
                              ctypes.POINTER(ExecDesc))
            done += self.ring.submit_batch(ptr, len(items) - done)
            if done >= len(items):
                break
            if self.ring.gate() == GATE_CLOSED:
                raise ConnectionError("fastlane: lane closed with staged "
                                      "submits")
            if not self.ring.wait_headc(self.ring.headc + 1, 0.05,
                                        spin_us()):
                stuck += 1
                if alive_check is not None and not alive_check():
                    raise ConnectionError("fastlane: broker died with "
                                          "staged submits")
                if stuck > 2400:
                    raise ConnectionError("fastlane: ring wedged (no "
                                          "consumer progress)")

    def poll_completions(self) -> None:
        while self._done_cursor < self.ring.headc:
            got = self.ring.completions(self._done_cursor)
            if not got:
                break
            for c in got:
                self._done[self._done_cursor] = (
                    int(c.status), int(c.actual_us), int(c.t_done_ns))
                self._done_cursor += 1

    def try_result(self, seq: int):
        if seq not in self._done:
            self.poll_completions()
        return self._done.pop(seq, None)

    def wait_result(self, seq: int, timeout_s: float, alive_check=None):
        """(status, actual_us, t_done_ns) of ``seq``, waiting in native
        code with the GIL dropped; ConnectionError on a timeout or a dead
        broker."""
        res = self.try_result(seq)
        if res is not None:
            return res
        if self._items:
            self.flush(alive_check)
        deadline = time.monotonic() + max(timeout_s, 0.05)
        spin = spin_us()
        while True:
            if self.ring.wait_headc(seq + 1, 0.05, spin):
                res = self.try_result(seq)
                if res is not None:
                    return res
                continue
            if alive_check is not None and not alive_check():
                raise ConnectionError("fastlane: broker died with ring "
                                      "submits in flight")
            if time.monotonic() >= deadline:
                raise ConnectionError(f"fastlane: completion of seq {seq} "
                                      f"timed out after {timeout_s:.0f}s")


class Drainer(threading.Thread):
    """The drain loop of one card: it spins while lanes have work and
    waits in the ring's native wait (GIL dropped) when they are idle."""

    def __init__(self, hub: FastlaneHub, chip):
        super().__init__(daemon=True, name=f"vtpu-fastlane-{chip.index}")
        self.hub = hub
        self.chip = chip
        self._halt = threading.Event()
        # Passes of the loop: each is a wakeup of this thread in Python
        # (STATS ``fastlane.drainer_passes``, read by tools/lane_cost).
        self.passes = 0

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=2.0)

    def run(self) -> None:
        spin = spin_us()
        idle = 0
        while not self._halt.is_set():
            self.passes += 1
            self.hub.reap_dead(self.chip.index)
            try:
                done = self.hub.drain_once(self.chip)
            except Exception as e:  # noqa: BLE001 - the drainer must live
                log.warn("fastlane drainer (card %d): %s", self.chip.index, e)
                done = 0
                time.sleep(0.05)
            if done:
                idle = 0
                continue
            idle += 1
            with self.hub.mu:
                lanes = [ln for ln in self.hub.lanes.values()
                         if ln.tenant.chip is self.chip and not ln.closed]
            if not lanes:
                self._halt.wait(0.05)
                continue
            lane = lanes[idle % len(lanes)]
            try:
                lane.ring.wait_tail(lane.ring.headc + 1, 0.02, spin)
            except (OSError, ValueError, ConnectionError):
                self._halt.wait(0.01)
        self.hub.reap_dead(self.chip.index)


class LaneMeter(threading.Thread):
    """Bills the lane batches of one card in device order, off the
    drainer's thread (a wait on the card here never delays a drain)."""

    def __init__(self, hub: FastlaneHub, chip):
        super().__init__(daemon=True, name=f"vtpu-fastlane-meter-{chip.index}")
        self.hub = hub
        self.chip = chip
        self.q: "queue.Queue" = queue.Queue()
        self._halt = threading.Event()

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=2.0)

    def run(self) -> None:
        while not (self._halt.is_set() and self.q.empty()):
            try:
                rec = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                meter_batch(self.hub, self.chip, rec)
            except Exception as e:  # noqa: BLE001 - the meter must live
                log.warn("fastlane meter (card %d): %s", self.chip.index, e)

