"""Structured, level-filtered logging for every repro_torch entry point.

Port of :mod:`repro.obs.log`; the loggers of the port's CLIs (the
trainer, the tuner) and of its obs layer are these.

``get_logger(name)`` returns a tiny stderr logger whose INFO rendering
is exactly the human-readable ``[name] message`` lines the CLIs printed
before observability existed — swapping ``print(f"[train] ...")`` for
``log.info(...)`` changes the destination stream (stderr, so stdout
stays machine-parseable) and adds level filtering, but not the text the
smoke greps key on.

The threshold comes from the ``REPRO_LOG_LEVEL`` environment variable
(``DEBUG`` / ``INFO`` / ``WARNING`` / ``ERROR``, default ``INFO``) and
is read per call, so tests and operators can flip it without rebuilding
loggers.  A logger optionally tees every rendered record into an
:class:`repro_torch.obs.events.EventSink` (``attach_sink``) so warnings fired
mid-run land in the same JSONL stream as the metrics they explain.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional

__all__ = ["Logger", "get_logger", "LEVELS"]

#: Level name -> numeric threshold (python-logging compatible values).
LEVELS: Dict[str, int] = {"DEBUG": 10, "INFO": 20, "WARNING": 30,
                          "ERROR": 40}

_DEFAULT_LEVEL = "INFO"


def _threshold() -> int:
    """Resolve ``REPRO_LOG_LEVEL`` each call (monkeypatch-friendly)."""
    name = os.environ.get("REPRO_LOG_LEVEL", _DEFAULT_LEVEL).upper()
    return LEVELS.get(name, LEVELS[_DEFAULT_LEVEL])


class Logger:
    """Minimal leveled logger rendering ``[name] message`` to stderr.

    ``warning``/``error`` records prefix the message with ``WARNING:``/
    ``ERROR:`` so drift warnings stand out in a scrollback the same way
    the pre-obs ad-hoc prints did.
    """

    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream  # None = resolve sys.stderr per record
        self._sink = None

    def attach_sink(self, sink) -> None:
        """Tee rendered records into an EventSink as ``log`` events."""
        self._sink = sink

    def _emit(self, level: str, msg: str) -> None:
        if LEVELS[level] < _threshold():
            return
        tag = "" if level in ("DEBUG", "INFO") else f"{level}: "
        print(f"[{self.name}] {tag}{msg}",
              file=self.stream or sys.stderr, flush=True)
        if self._sink is not None:
            self._sink.emit("log", level=level, logger=self.name,
                            msg=msg)

    def debug(self, msg: str) -> None:
        self._emit("DEBUG", msg)

    def info(self, msg: str) -> None:
        self._emit("INFO", msg)

    def warning(self, msg: str) -> None:
        self._emit("WARNING", msg)

    def error(self, msg: str) -> None:
        self._emit("ERROR", msg)


_loggers: Dict[str, Logger] = {}
_lock = threading.Lock()


def get_logger(name: str, stream=None) -> Logger:
    """Get (or create) the process-wide logger for ``name``.

    ``stream`` overrides the output stream of an existing logger too —
    tests redirect a named logger without touching global state.
    """
    with _lock:
        log = _loggers.get(name)
        if log is None:
            log = _loggers[name] = Logger(name, stream)
        elif stream is not None:
            log.stream = stream
        return log


def reset_logger(name: str, stream: Optional[object] = None) -> Logger:
    """Drop any cached logger for ``name`` and return a fresh one."""
    with _lock:
        _loggers.pop(name, None)
    return get_logger(name, stream)
