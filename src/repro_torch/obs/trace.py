"""Span tracer with Chrome-trace (``chrome://tracing`` / Perfetto) export.

Port of :mod:`repro.obs.trace` (standard library only).

``Tracer.span`` is a context manager measuring host wall time (the
caller is responsible for blocking on device work inside the span —
CUDA is asynchronous: the train loop converts the loss to float before
the span closes, and the serve runner reads the sampled tokens back to
the host inside its ``prefill`` and ``decode_tick`` spans).  Each closed
span becomes one event:

``{"type": "span", "name": ..., "ts": <us since tracer start>,``
``  "dur": <us>, "tid": <thread id>, "args": {...}}``

When the tracer is built over an :class:`~repro_torch.obs.events.EventSink`
the spans stream straight into the JSONL file (bounded memory over long
runs); without a sink they accumulate in ``tracer.events`` for tests
and ad-hoc use.  :func:`to_chrome` converts span events — from either
source — into the Chrome Trace Event JSON the ``python -m repro_torch.obs
export`` CLI writes: complete ("ph": "X") events that chrome://tracing
and https://ui.perfetto.dev open directly.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

__all__ = ["Tracer", "to_chrome"]


class Tracer:
    """Nestable wall-time spans, streamed to a sink or kept in memory."""

    def __init__(self, sink=None):
        self._sink = sink
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        #: retained span events (only when no sink streams them out)
        self.events: List[dict] = []

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a block; record it as one span event on exit.

        Spans nest naturally (the ``with`` discipline guarantees a
        child closes before — and therefore lies inside — its parent);
        exceptions still close the span, flagged ``error=True``.
        """
        start = self._now_us()
        try:
            yield self
        except BaseException:
            args = {**args, "error": True}
            raise
        finally:
            event = {"name": str(name), "ts": start,
                     "dur": self._now_us() - start,
                     "tid": threading.get_ident() % 10_000_000,
                     "args": args}
            if self._sink is not None:
                self._sink.emit("span", **event)
            else:
                with self._lock:
                    self.events.append({"type": "span", **event})


def to_chrome(events, process_name: str = "repro") -> dict:
    """Span events -> Chrome Trace Event Format JSON document.

    ``events`` is any iterable of event dicts; non-span entries are
    ignored, so a whole JSONL run file can be passed verbatim.  The
    output is the stable subset every trace viewer understands:
    ``traceEvents`` of complete ("ph": "X") events with microsecond
    ``ts``/``dur``, one pid, per-thread tids, plus the process-name
    metadata record.
    """
    trace_events = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for ev in events:
        if ev.get("type") != "span":
            continue
        trace_events.append({
            "name": ev.get("name", "?"),
            "cat": "repro.obs",
            "ph": "X",
            "ts": float(ev.get("ts", 0.0)),
            "dur": float(ev.get("dur", 0.0)),
            "pid": 1,
            "tid": int(ev.get("tid", 0)),
            "args": ev.get("args", {}),
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(events, path) -> "Optional[str]":
    """Serialize :func:`to_chrome` to ``path``; returns the path."""
    import json
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome(events)) + "\n")
    return str(path)
