"""One deadline-heap timer thread for the broker's housekeeping.

The port of ``vtpu.runtime.timers``, whole.  Periodic keepers register
once with a period instead of each sleeping on a thread of its own (in
the port: the journal tick, 1 s, and the lease-sidecar heartbeat, 5 s);
a single thread sleeps until the EARLIEST deadline and, on each wakeup,
fires every task due within ``VTPU_TIMER_COALESCE_MS`` (default 250 ms)
of that deadline, so tasks whose grids align (all periods are anchored
to the wheel's epoch) share one wakeup.  Cadence is preserved, not
drifted: a task's next deadline advances on its OWN grid
(``due + k*period``), never from "now", so a slow callback or a
coalesced early fire cannot shear the schedule.

One-shot wakes (``arm``) replace a deadline by name; ``vtpu``'s
dispatchers use them, the port's dispatchers keep their own idle
timeouts.

Callbacks run OUTSIDE the wheel lock and must not block; an exception
in one is logged and the wheel goes on.
"""

from __future__ import annotations

import heapq
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import logging as log


def coalesce_s() -> float:
    """Wakeup-coalescing window (seconds).  Tasks due within this
    window of the earliest deadline fire on the SAME wakeup; 0
    disables coalescing (every deadline is its own wakeup)."""
    try:
        ms = float(os.environ.get("VTPU_TIMER_COALESCE_MS", "250"))
    except ValueError:
        ms = 250.0
    return max(ms, 0.0) / 1e3


class TimerWheel:
    """Deadline-heap timer thread with coalesced wakeups and
    grid-anchored periodic cadence."""

    def __init__(self, coalesce: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 start: bool = True):
        self.clock = clock
        self.coalesce = coalesce_s() if coalesce is None \
            else max(float(coalesce), 0.0)
        self.mu = threading.Condition()
        # heap entries: (deadline, tie, name); the live tasks dict is
        # authoritative — stale heap entries (re-armed/cancelled) are
        # skipped by generation check.
        self._heap: List[Tuple[float, int, str]] = []
        self._tie = itertools.count()
        # name -> {fn, period (None = one-shot), due, gen}
        self._tasks: Dict[str, Dict[str, Any]] = {}
        self._stop = False
        self.epoch = self.clock()
        # -- observability (STATS "timers" block) --
        self.wakeups = 0
        self.fires: Dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="vtpu-rt-timers")
            self._thread.start()

    # -- registration ------------------------------------------------------

    def add_periodic(self, name: str, period_s: float,
                     fn: Callable[[], None]) -> None:
        """Register a recurring task.  The deadline grid anchors to
        the wheel's epoch, so co-periodic tasks (and harmonics: 0.5s/
        1s/5s) land on SHARED instants and coalesce into one wakeup —
        the idle broker's ~1 wakeup/s instead of one per keeper."""
        period = max(float(period_s), 1e-3)
        now = self.clock()
        k = int((now - self.epoch) / period) + 1
        due = self.epoch + k * period
        with self.mu:
            gen = self._tasks.get(name, {}).get("gen", 0) + 1
            self._tasks[name] = {"fn": fn, "period": period,
                                 "due": due, "gen": gen}
            heapq.heappush(self._heap, (due, next(self._tie), name))
            self.mu.notify_all()

    def arm(self, name: str, deadline: float,
            fn: Callable[[], None]) -> None:
        """One-shot wake at ``deadline`` (monotonic clock).  Re-arming
        the same name REPLACES the previous deadline — the dispatcher
        re-arms its kick every time its soonest-event estimate
        changes."""
        with self.mu:
            cur = self._tasks.get(name)
            if cur is not None and cur.get("period") is None \
                    and abs(cur["due"] - deadline) < 1e-4:
                return  # unchanged: skip the notify
            gen = (cur or {}).get("gen", 0) + 1
            self._tasks[name] = {"fn": fn, "period": None,
                                 "due": float(deadline), "gen": gen}
            heapq.heappush(self._heap,
                           (float(deadline), next(self._tie), name))
            self.mu.notify_all()

    def cancel(self, name: str) -> None:
        with self.mu:
            self._tasks.pop(name, None)

    def stop(self) -> None:
        with self.mu:
            self._stop = True
            self.mu.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self.mu:
            return {"wakeups": self.wakeups,
                    "coalesce_ms": int(self.coalesce * 1e3),
                    "tasks": {n: {"period_s": t["period"],
                                  "fires": self.fires.get(n, 0)}
                              for n, t in self._tasks.items()}}

    # -- the loop ----------------------------------------------------------

    def _due_batch_locked(self, now: float) -> List[Tuple[str, Any]]:
        """Pop every task due within the coalescing window of the
        earliest deadline (caller holds self.mu).  Periodic tasks
        re-arm on their own grid before release."""
        batch: List[Tuple[str, Any]] = []
        if not self._heap:
            return batch
        horizon = max(self._heap[0][0], now) + self.coalesce
        while self._heap and self._heap[0][0] <= horizon:
            due, _tie, name = heapq.heappop(self._heap)
            task = self._tasks.get(name)
            if task is None or abs(task["due"] - due) > 1e-9:
                continue  # stale entry (cancelled or re-armed)
            batch.append((name, task["fn"]))
            period = task["period"]
            if period is None:
                del self._tasks[name]
            else:
                # Grid-anchored re-arm: however late (or coalesced-
                # early) this fire ran, the next deadline stays on
                # the task's own grid — cadence never drifts.
                nxt = due + period
                if nxt <= now:
                    nxt = due + (int((now - due) / period) + 1) * period
                task["due"] = nxt
                heapq.heappush(self._heap,
                               (nxt, next(self._tie), name))
        return batch

    def _run(self) -> None:
        while True:
            with self.mu:
                if self._stop:
                    return
                now = self.clock()
                if not self._heap:
                    self.mu.wait(timeout=5.0)
                    continue
                delay = self._heap[0][0] - now
                if delay > 0:
                    self.mu.wait(timeout=delay)
                    if self._stop:
                        return
                    now = self.clock()
                    if self._heap and self._heap[0][0] > now:
                        continue  # woken early (re-arm/notify)
                self.wakeups += 1
                batch = self._due_batch_locked(now)
            for name, fn in batch:
                self.fires[name] = self.fires.get(name, 0) + 1
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 - keepers must survive
                    log.warn("timer task %s: %s", name, e)
