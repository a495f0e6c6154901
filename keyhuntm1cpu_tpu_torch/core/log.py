"""Leveled console logger with keyhunt's prefixes (the part of
keyhuntm1cpu_tpu/core/log.py the port uses): ``[+] [W] [E]`` on stderr, a
level filter for ``-q``, and ``result`` lines that always print."""

from __future__ import annotations

import sys
import threading
from typing import Optional

LEVELS = {"plus": 25, "warn": 30, "error": 40}
_PREFIX = {"plus": "[+]", "warn": "[W]", "error": "[E]"}


class Logger:
    def __init__(self, level: str = "plus"):
        self.level = LEVELS[level]
        self._lock = threading.Lock()

    def set_level(self, level: str) -> None:
        self.level = LEVELS[level]

    def _emit(self, level: str, msg: str, force: bool = False) -> None:
        if not force and LEVELS[level] < self.level:
            return
        with self._lock:
            sys.stderr.write(f"{_PREFIX[level]} {msg}\n")
            sys.stderr.flush()

    def plus(self, msg: str) -> None:
        self._emit("plus", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)

    def error(self, msg: str) -> None:
        self._emit("error", msg)

    def result(self, msg: str) -> None:
        """Outcome line (found keys): printed whatever the level."""
        self._emit("plus", msg, force=True)


_logger: Optional[Logger] = None


def get_logger() -> Logger:
    global _logger
    if _logger is None:
        _logger = Logger()
    return _logger
