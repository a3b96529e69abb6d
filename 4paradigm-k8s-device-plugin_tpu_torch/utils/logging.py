"""Leveled stderr logging shared by daemon and runtime.

Mirrors the reference interceptor's ``LIBCUDA_LOG_LEVEL`` semantics
(reference README.md:225-233: 0 errors only, 1 +warnings, 3 +info,
4 +debug) under ``VTPU_LOG_LEVEL``, with the same bracketed prefixes so
node operators can grep either system identically.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from .envspec import ENV_LOG_LEVEL

_LOCK = threading.Lock()

LEVEL_ERROR = 0
LEVEL_WARN = 1
LEVEL_INFO = 3
LEVEL_DEBUG = 4

_NAMES = {LEVEL_ERROR: "ERROR", LEVEL_WARN: "Warn",
          LEVEL_INFO: "Info", LEVEL_DEBUG: "Debug"}


# Cached level: the env read was measurably hot on the broker's
# per-item paths (every filtered-out log.debug re-read the environ).
# Tests that flip VTPU_LOG_LEVEL mid-process call refresh_level().
_cached_level: int = -1


def refresh_level() -> int:
    global _cached_level
    try:
        _cached_level = int(os.environ.get(ENV_LOG_LEVEL, "1"))
    except ValueError:
        _cached_level = 1
    return _cached_level


def current_level() -> int:
    return _cached_level if _cached_level >= 0 else refresh_level()


def log(level: int, msg: str, *args) -> None:
    if level > current_level():
        return
    if args:
        msg = msg % args
    stamp = time.strftime("%H:%M:%S")
    with _LOCK:
        print(f"[vtpu {_NAMES.get(level, 'Info')}] {stamp} {msg}",
              file=sys.stderr, flush=True)


def error(msg: str, *args) -> None:
    log(LEVEL_ERROR, msg, *args)


def warn(msg: str, *args) -> None:
    log(LEVEL_WARN, msg, *args)


def info(msg: str, *args) -> None:
    log(LEVEL_INFO, msg, *args)


def debug(msg: str, *args) -> None:
    log(LEVEL_DEBUG, msg, *args)
