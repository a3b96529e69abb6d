"""The ChipBackend seam: the reference's ``ResourceManager`` interface
(reference nvidia.go:43-46: ``Devices()`` and ``CheckHealth(stop, devices,
unhealthy)``), narrow so that a fake backend is first-class for tests.
``vtpu``'s own, over cards."""

from __future__ import annotations

import abc
import os
import threading
from typing import Callable, List, Optional

from .types import GpuChip, GpuTopology


class ChipBackend(abc.ABC):
    """Enumerates physical cards and watches their health."""

    # Health-loop tuning, overridable per backend (and by tests):
    # consecutive probe failures before a card flips unhealthy (debounce
    # for noisy probes), and the poll period (the reference's 5 s
    # event-wait timeout, nvidia.go:180).
    health_fail_threshold = 1
    health_interval = 5.0

    @abc.abstractmethod
    def chips(self) -> List[GpuChip]:
        """Enumerate the node's physical cards."""

    @abc.abstractmethod
    def topology(self) -> GpuTopology:
        """The links between the cards."""

    def check_health(
        self,
        stop: threading.Event,
        chips: List[GpuChip],
        on_unhealthy: Callable[[GpuChip, str], None],
        on_healthy: Optional[Callable[[GpuChip], None]] = None,
    ) -> None:
        """Blocking health loop; invokes ``on_unhealthy(card, reason)``
        after ``health_fail_threshold`` consecutive probe failures and —
        unlike the reference, whose unhealthy is one-way (server.go:262
        FIXME) — ``on_healthy(card)`` when a downed card probes clean
        again.  Returns when ``stop`` is set.  Mirrors the reference's
        XID event loop (nvidia.go:166-237) with polling."""
        try:
            interval = float(os.environ.get("VTPU_HEALTH_INTERVAL",
                                            self.health_interval))
        except ValueError:
            # A malformed tuning knob must not escape into the daemon's
            # catch-all (which marks the whole node unhealthy).
            interval = self.health_interval
        fails = {c.uuid: 0 for c in chips}
        down = set()
        while not stop.wait(interval):
            for chip in chips:
                reason = self.probe(chip)
                if reason is not None:
                    fails[chip.uuid] = fails.get(chip.uuid, 0) + 1
                    if fails[chip.uuid] >= self.health_fail_threshold \
                            and chip.uuid not in down:
                        down.add(chip.uuid)
                        on_unhealthy(chip, reason)
                else:
                    fails[chip.uuid] = 0
                    if chip.uuid in down:
                        down.discard(chip.uuid)
                        if on_healthy is not None:
                            on_healthy(chip)

    def probe(self, chip: GpuChip) -> Optional[str]:
        """Return an unhealth reason for ``chip``, or None if healthy."""
        return None
