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

Layer spans.  The port's layers open spans of their own (the train
step's phases, each offloaded site's execution, ``ozaki_matmul`` and
its slicing, kernel launch and combine) through the module-level
:func:`span`, which records into the process's *active* tracer and
costs one global read and one branch when there is none.
:func:`activate` makes a tracer the active one for a block.  The
active tracer is process-wide, not per thread, so the cotangent
products that autograd runs on its device thread reach it too.  A
span's parent is the span that encloses it in time on its own thread:
the caller's ``train.backward`` span encloses, in time, the spans that
autograd's thread opens, and no field of the event says so.  While a
tracer is active its spans are held in ``tracer.events`` and reach its
sink (if it has one) when the outermost :func:`activate` block ends,
so tracing writes nothing while a run lasts.

``Tracer.t0_ns`` anchors the stamps: a span's start on
``time.perf_counter_ns`` is ``t0_ns + ts * 1e3``, which lays it over
another timeline read on the same clock (a device trace's).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional

__all__ = ["Tracer", "activate", "active", "span", "to_chrome"]


class Tracer:
    """Nestable wall-time spans, streamed to a sink or kept in memory."""

    def __init__(self, sink=None):
        self._sink = sink
        #: ``time.perf_counter_ns`` at the tracer's start, from which the
        #: spans' ``ts`` count (in microseconds)
        self.t0_ns = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._active = 0
        #: retained span events (when no sink streams them out, and while
        #: the tracer is active)
        self.events: List[dict] = []

    def span(self, name: str, **args):
        """Time a block; record it as one span event on exit.

        Spans nest naturally (the ``with`` discipline guarantees a
        child closes before — and therefore lies inside — its parent);
        exceptions still close the span, flagged ``error=True``.  The
        block gets the tracer.
        """
        return _Span(self, str(name), args)

    def _record(self, event: dict) -> None:
        if self._sink is not None and not self._active:
            self._emit(event)
        else:
            with self._lock:
                self.events.append(event)

    def _emit(self, event: dict) -> None:
        self._sink.emit("span", **{k: v for k, v in event.items()
                                   if k != "type"})

    def flush(self) -> None:
        """Write the span events held in memory to the sink (a tracer
        without a sink keeps them)."""
        if self._sink is None:
            return
        with self._lock:
            held, self.events = self.events, []
        for event in held:
            self._emit(event)


class _Span:
    """A span of a tracer being timed (what :meth:`Tracer.span`
    returns)."""

    __slots__ = ("_tracer", "_name", "_args", "_start")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self._tracer, self._name, self._args = tracer, name, args

    def __enter__(self) -> Tracer:
        self._start = time.perf_counter_ns()
        return self._tracer

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter_ns()
        tracer, args = self._tracer, self._args
        if exc_type is not None:
            args = {**args, "error": True}
        tracer._record({"type": "span", "name": self._name,
                        "ts": (self._start - tracer.t0_ns) / 1e3,
                        "dur": (end - self._start) / 1e3,
                        "tid": threading.get_ident() % 10_000_000,
                        "args": args})
        return False


#: The process's active tracer (:func:`activate`), None while tracing
#: is off.
_ACTIVE: Optional[Tracer] = None
_OFF = contextlib.nullcontext()


def span(name: str, **args):
    """A span of the active tracer; a shared no-op context when no
    tracer is active."""
    tracer = _ACTIVE
    if tracer is None:
        return _OFF
    return _Span(tracer, name, args)


def active() -> Optional[Tracer]:
    """The process's active tracer, or None."""
    return _ACTIVE


@contextlib.contextmanager
def activate(tracer: Tracer):
    """Make ``tracer`` the process's active tracer for a block.

    The tracer active before is restored on exit, also after an
    exception.  The tracer holds its spans in memory while it is active
    and writes them to its sink when its outermost block ends.
    """
    global _ACTIVE
    earlier = _ACTIVE
    with tracer._lock:
        tracer._active += 1
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = earlier
        with tracer._lock:
            tracer._active -= 1
            done = not tracer._active
        if done:
            tracer.flush()


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
