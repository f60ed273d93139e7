"""Minimal Linux inotify wrapper over ctypes.

The reference watches the kubelet socket directory with fsnotify
(dpm/manager.go:53-55) to catch kubelet restarts. Python's stdlib has no
inotify binding and this project adds no third-party runtime deps, so the
three syscalls are bound directly; a polling fallback covers non-Linux or
restricted environments.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import logging
import os
import select
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Optional

log = logging.getLogger(__name__)

IN_CREATE = 0x00000100
IN_DELETE = 0x00000200
IN_MOVED_TO = 0x00000080
IN_NONBLOCK = 0o4000

_EVENT_FMT = "iIII"
_EVENT_SIZE = struct.calcsize(_EVENT_FMT)


@dataclass(frozen=True)
class FileEvent:
    name: str       # basename within the watched directory
    created: bool   # IN_CREATE or IN_MOVED_TO
    deleted: bool   # IN_DELETE


class DirWatcher:
    """Watches one directory; delivers FileEvents to a callback from a
    background thread until stop()."""

    def __init__(self, path: str, callback: Callable[[FileEvent], None]):
        self._path = path
        self._callback = callback
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fd: Optional[int] = None
        self._libc = None

    def start(self) -> None:
        try:
            self._start_inotify()
        except (OSError, AttributeError):
            # AttributeError: libc without the inotify symbols (non-Linux).
            self._start_polling()

    def _start_inotify(self) -> None:
        libc_name = ctypes.util.find_library("c") or "libc.so.6"
        libc = ctypes.CDLL(libc_name, use_errno=True)
        fd = libc.inotify_init1(IN_NONBLOCK)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        wd = libc.inotify_add_watch(
            fd, self._path.encode(), IN_CREATE | IN_DELETE | IN_MOVED_TO
        )
        if wd < 0:
            err = ctypes.get_errno()
            os.close(fd)
            raise OSError(err, f"inotify_add_watch({self._path}) failed")
        self._fd = fd
        self._libc = libc
        self._thread = threading.Thread(
            target=self._inotify_loop, name="dpm-fswatch", daemon=True
        )
        self._thread.start()

    def _inotify_loop(self) -> None:
        assert self._fd is not None
        while not self._stop.is_set():
            r, _, _ = select.select([self._fd], [], [], 0.5)
            if not r:
                continue
            try:
                data = os.read(self._fd, 4096)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EINTR):
                    continue
                break
            offset = 0
            while offset + _EVENT_SIZE <= len(data):
                _wd, mask, _cookie, name_len = struct.unpack_from(
                    _EVENT_FMT, data, offset
                )
                name = data[
                    offset + _EVENT_SIZE : offset + _EVENT_SIZE + name_len
                ].rstrip(b"\0").decode()
                offset += _EVENT_SIZE + name_len
                if name:
                    self._callback(
                        FileEvent(
                            name=name,
                            created=bool(mask & (IN_CREATE | IN_MOVED_TO)),
                            deleted=bool(mask & IN_DELETE),
                        )
                    )

    def _start_polling(self) -> None:
        """Degraded mode: poll directory contents at 1s cadence."""
        self._thread = threading.Thread(
            target=self._poll_loop, name="dpm-fswatch-poll", daemon=True
        )
        self._thread.start()

    def _poll_loop(self) -> None:
        def snapshot():
            try:
                return set(os.listdir(self._path))
            except OSError:
                return set()

        prev = snapshot()
        while not self._stop.wait(1.0):
            cur = snapshot()
            for name in cur - prev:
                self._callback(FileEvent(name=name, created=True, deleted=False))
            for name in prev - cur:
                self._callback(FileEvent(name=name, created=False, deleted=True))
            prev = cur

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread:
            thread.join(timeout=2)
        if thread is not None and thread.is_alive():
            # The loop is wedged past its select timeout (a stuck
            # callback): closing the fd under it would hand a reused
            # descriptor to the select. Leak the fd instead — this
            # process is shutting down anyway.
            log.warning(
                "fs watcher thread did not exit within 2s; "
                "leaving inotify fd open"
            )
            return
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
