"""The journal's epoch fence.

The part of ``vtpu.runtime.replication`` that the journal needs: ``Fence``
and ``FencedEpoch`` (``vtpu``'s ``replication.py:80-140``).  ``make_server``
claims a generation at boot and the journal checks it before every
append, so a broker whose generation a successor has superseded can
never journal, and so never acknowledge, a state change.  Streaming
replication, the hot standby and its takeover are ROADMAP Queue 1 item
6(d).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class FencedEpoch(OSError):
    """This broker's epoch has been fenced by a standby takeover: it
    may never journal (and therefore never ack) again."""


class Fence:
    """Epoch fence: a tiny generation file next to the listen socket,
    shared by the primary and every standby of that socket.

    The primary ``claim()``s a generation at boot and ``check()``s it
    before every journal write; a standby's takeover ``claim()`` bumps
    the generation, after which the old primary's next check raises
    ``FencedEpoch``: it can no longer journal, so (journal-before-ack)
    it can no longer acknowledge state changes.  ``VTPU_REPL_FENCE=0``
    disables checks (single-broker deployments skip the per-append
    stat)."""

    def __init__(self, path: str, enabled: Optional[bool] = None):
        self.path = path
        if enabled is None:
            enabled = os.environ.get("VTPU_REPL_FENCE", "1") != "0"
        self.enabled = bool(enabled)
        self.generation = 0

    def read(self) -> int:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return int(json.loads(f.read()).get("generation", 0))
        except (OSError, ValueError):
            return 0

    def claim(self, epoch: Optional[str] = None) -> int:
        """Bump + adopt the fence generation (boot or takeover).
        tmp+rename so a racing reader never sees a torn file."""
        gen = self.read() + 1
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"generation": gen, "epoch": epoch,
                                "pid": os.getpid(),
                                "ts": time.time()}))
        os.replace(tmp, self.path)
        self.generation = gen
        return gen

    def check(self) -> None:
        """Raise FencedEpoch when another instance has claimed a newer
        generation.  Called from the journal's pre-write hook."""
        if not self.enabled:
            return
        cur = self.read()
        if cur > self.generation:
            raise FencedEpoch(
                f"epoch fenced: generation {self.generation} was "
                f"superseded by {cur} (standby takeover) — this "
                f"instance may not journal or ack")
