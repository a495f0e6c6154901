"""Leveled console logger with keyhunt's prefixes (a copy of
keyhuntm1cpu_tpu/core/log.py): ``[D] [I] [+] [W] [E]`` on stderr and any
file sinks, a level filter for ``-q`` and ``-d``, ``status`` lines that
rewrite themselves on a terminal unless ``matrix`` (``-M``) is set, and
``result`` lines that always print."""

from __future__ import annotations

import sys
import threading
from typing import IO, List, Optional

LEVELS = {"debug": 10, "info": 20, "plus": 25, "warn": 30, "error": 40, "quiet": 100}
_PREFIX = {"debug": "[D]", "info": "[I]", "plus": "[+]", "warn": "[W]", "error": "[E]"}


class Logger:
    def __init__(self, name: str = "keyhunt", level: str = "plus"):
        self.name = name
        self.level = LEVELS[level]
        self.matrix = False  # -M: never rewrite lines
        self._files: List[IO] = []  # beside sys.stderr, looked up at each line
        self._lock = threading.Lock()
        self._last_transient = False

    def add_file_sink(self, path: str) -> None:
        self._files.append(open(path, "a"))

    def set_level(self, level: str) -> None:
        self.level = LEVELS[level]

    def _emit(self, level: str, msg: str, transient: bool = False,
              force: bool = False) -> None:
        if not force and LEVELS[level] < self.level:
            return
        with self._lock:
            for sink in [sys.stderr, *self._files]:
                is_tty = sink is sys.stderr and sink.isatty() and not self.matrix
                if transient and is_tty:
                    sink.write(f"\r{_PREFIX[level]} {msg}\x1b[K")
                    self._last_transient = True
                else:
                    if self._last_transient and is_tty:
                        sink.write("\n")
                    sink.write(f"{_PREFIX[level]} {msg}\n")
                    self._last_transient = False
                sink.flush()

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def plus(self, msg: str) -> None:
        self._emit("plus", msg)

    def warn(self, msg: str) -> None:
        self._emit("warn", msg)

    def error(self, msg: str) -> None:
        self._emit("error", msg)

    def status(self, msg: str) -> None:
        """Progress line that rewrites itself on a terminal; a normal line
        under matrix mode or in a file."""
        self._emit("plus", msg, transient=True)

    def result(self, msg: str) -> None:
        """Outcome line (found keys): printed whatever the level."""
        self._emit("plus", msg, force=True)


_logger: Optional[Logger] = None


def get_logger() -> Logger:
    global _logger
    if _logger is None:
        _logger = Logger()
    return _logger


def set_level(level: str) -> None:
    get_logger().set_level(level)
