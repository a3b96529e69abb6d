"""Filesystem + signal watchers for the daemon event loop (the port's own
copy of ``vtpu``'s).

The reference uses fsnotify on the kubelet device-plugin dir and a signal
channel (reference watchers.go:9-31).  Python's stdlib has no inotify
binding, but the syscall surface is three libc calls away — so the fs
watcher talks to inotify(7) through ctypes and falls back to the old
1 s polling thread only when inotify is unavailable (non-Linux, watch
budget exhausted, or ``VTPU_INOTIFY=0``).  The event the daemon cares
about is kubelet.sock being recreated on kubelet restart (reference
main.go:253-263); with inotify the re-register now starts the moment
the kubelet drops the socket instead of up to a poll interval later.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import queue
import select
import signal
import struct
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class FsEvent:
    path: str
    op: str          # "create" | "delete"


# inotify(7) masks — from <sys/inotify.h>; stable kernel ABI.
_IN_CREATE = 0x00000100
_IN_DELETE = 0x00000200
_IN_MOVED_FROM = 0x00000040
_IN_MOVED_TO = 0x00000080
_IN_ATTRIB = 0x00000004
_IN_Q_OVERFLOW = 0x00004000
_IN_IGNORED = 0x00008000
_IN_NONBLOCK = 0x00000800
_IN_CLOEXEC = 0x00080000
_WATCH_MASK = (_IN_CREATE | _IN_DELETE | _IN_MOVED_FROM | _IN_MOVED_TO
               | _IN_ATTRIB)
_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


class _Inotify:
    """Minimal ctypes binding: one watch on the target's PARENT
    directory.  Watching the file itself would break on unlink — the
    kubelet.sock lifecycle IS unlink+recreate — so directory events
    filtered to the basename are the correct shape."""

    def __init__(self, path: str):
        libc_name = ctypes.util.find_library("c")
        if libc_name is None:
            raise OSError("no libc")
        libc = ctypes.CDLL(libc_name, use_errno=True)
        for fn in ("inotify_init1", "inotify_add_watch"):
            if not hasattr(libc, fn):
                raise OSError(f"libc lacks {fn}")
        self._libc = libc
        self.dir = os.path.dirname(path) or "."
        self.name = os.path.basename(path)
        self.fd = libc.inotify_init1(_IN_NONBLOCK | _IN_CLOEXEC)
        if self.fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1")
        wd = libc.inotify_add_watch(
            self.fd, os.fsencode(self.dir), _WATCH_MASK)
        if wd < 0:
            err = ctypes.get_errno()
            os.close(self.fd)
            raise OSError(err, f"inotify_add_watch({self.dir})")
        self.wd = wd

    def read_ops(self, timeout_s: float):
        """Block up to ``timeout_s``; return the list of ("create" |
        "delete" | "resync") ops seen for the watched basename."""
        r, _, _ = select.select([self.fd], [], [], timeout_s)
        if not r:
            return []
        try:
            data = os.read(self.fd, 65536)
        except OSError as e:
            if e.errno in (errno.EAGAIN, errno.EINTR):
                return []
            raise
        ops = []
        off = 0
        while off + _EVENT_HDR.size <= len(data):
            _, mask, _, nlen = _EVENT_HDR.unpack_from(data, off)
            name = data[off + _EVENT_HDR.size:
                        off + _EVENT_HDR.size + nlen].split(b"\0", 1)[0]
            off += _EVENT_HDR.size + nlen
            if mask & _IN_Q_OVERFLOW:
                # Kernel dropped events; state is unknown — resync
                # from a stat instead of trusting the stream.
                ops.append("resync")
                continue
            if mask & _IN_IGNORED:
                # Watch died (dir deleted/unmounted) — caller falls
                # back to polling.
                raise OSError(errno.EINVAL, "inotify watch removed")
            if os.fsdecode(name) != self.name:
                continue
            if mask & (_IN_CREATE | _IN_MOVED_TO | _IN_ATTRIB):
                ops.append("create")
            if mask & (_IN_DELETE | _IN_MOVED_FROM):
                ops.append("delete")
        return ops

    def close(self):
        try:
            os.close(self.fd)
        except OSError:
            pass


class FsWatcher:
    """Watches one path; emits FsEvent("create") when it appears (or is
    replaced in place) and FsEvent("delete") when it vanishes.

    inotify on the parent dir when available (events within ms of the
    kubelet touching the socket); degrades to the historical
    ``interval``-second stat poll otherwise.  ``VTPU_INOTIFY=0`` forces
    the poll path (A/B, or paranoid hosts with tiny watch budgets)."""

    def __init__(self, path: str, interval: float = 1.0):
        self.path = path
        self.interval = interval
        self.events: "queue.Queue[FsEvent]" = queue.Queue()
        self.backend = "poll"
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _ino(self):
        # Inode alone is not enough: tmpfs reuses a freed inode number
        # immediately, so an unlink+recreate between two polls can look
        # unchanged.  ctime disambiguates.
        try:
            st = os.stat(self.path)
            return (st.st_dev, st.st_ino, st.st_ctime_ns)
        except OSError:
            return None

    def _make_inotify(self):
        if os.environ.get("VTPU_INOTIFY", "1") == "0":
            return None
        try:
            return _Inotify(self.path)
        except OSError:
            return None

    def start(self) -> "FsWatcher":
        last = self._ino()
        ino = self._make_inotify()
        self.backend = "inotify" if ino is not None else "poll"

        def emit_from_stat():
            # Shared resync: compare the on-disk truth with what we
            # last reported and emit the transition, if any.
            nonlocal last
            cur = self._ino()
            if cur == last:
                return
            self.events.put(FsEvent(
                self.path, "delete" if cur is None else "create"))
            last = cur

        def run_inotify(handle):
            nonlocal last
            while not self._stop.is_set():
                try:
                    ops = handle.read_ops(self.interval)
                except OSError:
                    # Watch torn down under us (dir removed, fd
                    # revoked) — degrade to polling, don't die.
                    handle.close()
                    self.backend = "poll"
                    run_poll()
                    return
                for op in ops:
                    if op == "resync":
                        emit_from_stat()
                        continue
                    cur = self._ino()
                    if op == "create" and cur is not None \
                            and cur != last:
                        self.events.put(FsEvent(self.path, "create"))
                        last = cur
                    elif op == "delete" and cur is None \
                            and last is not None:
                        self.events.put(FsEvent(self.path, "delete"))
                        last = None
            handle.close()

        def run_poll():
            while not self._stop.wait(self.interval):
                emit_from_stat()

        target = (lambda: run_inotify(ino)) if ino is not None \
            else run_poll
        self._thread = threading.Thread(target=target, daemon=True,
                                        name="vtpu-fswatch")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class SignalWatcher:
    """Queues SIGHUP/SIGINT/SIGTERM/SIGQUIT like the reference's
    signal.Notify channel (reference watchers.go:27-31)."""

    SIGNALS = (signal.SIGHUP, signal.SIGINT, signal.SIGTERM, signal.SIGQUIT)

    def __init__(self):
        self.events: "queue.Queue[int]" = queue.Queue()

    def install(self) -> "SignalWatcher":
        for sig in self.SIGNALS:
            signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self.events.put(signum)
