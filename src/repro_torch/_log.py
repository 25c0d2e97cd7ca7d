"""The port's logging: ``[name] message`` lines on stderr.

The reference's loggers (``repro.obs.log``) render INFO records as
``[name] message`` and warnings as ``[name] WARNING: message`` on
stderr, filtered by ``REPRO_LOG_LEVEL`` (``DEBUG``, ``INFO``,
``WARNING``, ``ERROR``; default ``INFO``), read per record.  This is
that rendering alone, until the port has ``obs`` (ROADMAP item 10).
"""

from __future__ import annotations

import os
import sys

__all__ = ["Logger", "get_logger"]

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40}


class Logger:
    """Leveled ``[name] message`` lines on stderr."""

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, msg: str) -> None:
        threshold = _LEVELS.get(
            os.environ.get("REPRO_LOG_LEVEL", "INFO").upper(), 20)
        if _LEVELS[level] < threshold:
            return
        tag = "" if level in ("DEBUG", "INFO") else f"{level}: "
        print(f"[{self.name}] {tag}{msg}", file=sys.stderr, flush=True)

    def debug(self, msg: str) -> None:
        self._emit("DEBUG", msg)

    def info(self, msg: str) -> None:
        self._emit("INFO", msg)

    def warning(self, msg: str) -> None:
        self._emit("WARNING", msg)


def get_logger(name: str) -> Logger:
    """The logger that renders ``[name] ...``."""
    return Logger(name)
