"""Leveled logging + timers.

Equivalent of the reference's Debug subsystem
(lib/mmseqs/src/commons/Debug.h:42-220): verbosity levels NOTHING(0) /
ERROR(1) / WARNING(2) / INFO(3).

All output goes to stderr (the reference writes both levels to stderr;
stdout is reserved for data).
"""

from __future__ import annotations

import sys
import time

NOTHING = 0
ERROR = 1
WARNING = 2
INFO = 3

_level = INFO


def set_verbosity(level: int) -> None:
    global _level
    _level = int(level)


def get_verbosity() -> int:
    return _level


def _emit(prefix: str, msg: str) -> None:
    sys.stderr.write(f"{prefix}{msg}\n")
    sys.stderr.flush()


def error(msg: str) -> None:
    if _level >= ERROR:
        _emit("Error: ", msg)


def warning(msg: str) -> None:
    if _level >= WARNING:
        _emit("Warning: ", msg)


def info(msg: str) -> None:
    if _level >= INFO:
        _emit("", msg)


class Timer:
    """Wall-clock timer (commons/Timer.h): Application.cpp:45-60 prints
    'Time for processing: Xh Ym Zs' per command."""

    def __init__(self):
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start

    def format(self) -> str:
        secs = self.elapsed()
        h, rem = divmod(int(secs), 3600)
        m, s = divmod(rem, 60)
        frac = secs - int(secs)
        return f"{h}h {m}m {s}s {int(frac * 1000)}ms"
