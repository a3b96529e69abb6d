"""Broker-loss degraded mode: local fail-closed enforcement.

The port of ``vtpu.runtime.degraded``, whole.  When the broker stays
unreachable past ``VTPU_BROKER_GRACE_S`` the client
(``runtime/client.py``) stops blocking on reconnects and enters DEGRADED
mode: every operation fails fast with a typed error instead of hanging,
and (the fail-closed half) the tenant's LAST-GRANTED quotas keep biting
locally, so killing the broker is never a quota escape.

The backend prefers the shared accounting region (the mmap'd books and
token bucket the interposer and the in-process enforcer drive, the
port's ``shim.core.SharedRegion``), found through
``VTPU_DEVICE_MEMORY_SHARED_CACHE``: where one is mounted, admission
runs through the same atomics.  Without a region (a tenant of the
broker alone, the tests) a Python ledger mirror seeded from the
client's tracked usage enforces the same limits.
"""

from __future__ import annotations

import os
import time
from typing import Any

from ..utils import envspec

# One scheduler quantum of device-time budget (µs): the mirror bucket's
# capacity — matches the broker-side lease ceiling, so degraded pacing
# can never admit more burst than the live scheduler would.
MIRROR_BUCKET_CAP_US = 100_000.0


class LocalEnforcer:
    """Fail-closed local quota enforcement at the last-granted limits."""

    def __init__(self, hbm_limit: int = 0, core_pct: int = 0,
                 region: Any = None, dev: int = 0,
                 used_bytes: int = 0):
        self.region = region
        self.dev = dev
        self.hbm_limit = max(int(hbm_limit or 0), 0)
        self.core_pct = max(int(core_pct or 0), 0)
        self._used = max(int(used_bytes), 0)
        self._level_us = MIRROR_BUCKET_CAP_US
        self._last = time.monotonic()

    @classmethod
    def from_env(cls, hbm_limit: int = 0, core_pct: int = 0,
                 used_bytes: int = 0) -> "LocalEnforcer":
        """Backend selection: native region when the Allocate contract
        mounted one, python mirror otherwise.  The HELLO-granted limits
        win; the env contract fills in whatever the HELLO left unset."""
        spec = envspec.quota_from_env()
        region = None
        path = spec.shared_cache
        if path and os.path.exists(path):
            try:
                from ..shim.core import SharedRegion
                region = SharedRegion(path)
            except (OSError, FileNotFoundError):
                region = None
        if not hbm_limit and spec.hbm_limit_bytes:
            hbm_limit = spec.limit_for(0)
        if not core_pct:
            core_pct = spec.core_limit_pct
        return cls(hbm_limit, core_pct, region=region,
                   used_bytes=used_bytes)

    # -- HBM ---------------------------------------------------------------

    def admit_bytes(self, nbytes: int) -> bool:
        """Would ``nbytes`` more fit under the last-granted quota?  The
        region charge is immediately released — this is an ADMISSION
        check (a refused degraded op stores nothing), the verdict is
        what must stay correct."""
        n = int(nbytes)
        if self.region is not None:
            if not self.region.mem_acquire(self.dev, n, False):
                return False
            self.region.mem_release(self.dev, n)
        if self.hbm_limit and self._used + n > self.hbm_limit:
            return False
        return True

    def note_bytes(self, delta: int) -> None:
        """Track the mirror ledger (the client calls this from its
        connected-path bookkeeping so a later degraded window starts
        from real usage)."""
        self._used = max(self._used + int(delta), 0)

    # -- rate --------------------------------------------------------------

    def admit_us(self, est_us: float, priority: int = 1) -> bool:
        """Non-blocking token-bucket admission at the last-granted core
        share; False = the rate quota is exhausted (fail closed).  The
        debit is real — a tenant hammering ops while the broker is down
        spends its share exactly as a live interposer tenant would."""
        if self.core_pct <= 0:
            return True
        if self.region is not None:
            return self.region.rate_acquire(self.dev, int(est_us),
                                            priority) == 0
        now = time.monotonic()
        self._level_us = min(
            self._level_us
            + (now - self._last) * self.core_pct / 100.0 * 1e6,
            MIRROR_BUCKET_CAP_US)
        self._last = now
        if self._level_us >= est_us:
            self._level_us -= est_us
            return True
        return False

    def close(self) -> None:
        if self.region is not None:
            try:
                self.region.close()
            except OSError:
                pass
            self.region = None
