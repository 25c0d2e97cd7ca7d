"""JSONL structured-event sink and the run-scoped ``MetricsRun`` bundle.

Port of :mod:`repro.obs.events` (standard library only; the
offload's hook payloads and site records it writes are built by
:mod:`repro_torch.core.intercept`).

Every telemetry record — per-site GEMM executions, per-step loss and
timing, numerics-drift checks, serve per-request latencies, tracer
spans, registry snapshots — is one JSON object on one line of a
run-scoped ``events-NNNN.jsonl`` file.  The envelope is uniform::

    {"t": <unix seconds>, "type": <event type>, ...fields}

with types ``run_start``, ``site_decl``, ``site_exec``, ``step``,
``numerics``, ``request``, ``tick``, ``span``, ``metric``,
``bench_row``, ``log``, ``run_end`` (the README catalogs the fields of
each).  ``python -m repro_torch.obs report`` aggregates a directory of these
files into tables; ``python -m repro_torch.obs export`` converts the span
events into a Chrome trace.

:class:`MetricsRun` is the per-invocation bundle the entry points
construct: it allocates the next run file in the metrics directory,
owns one :class:`~repro_torch.obs.registry.Registry` and one
:class:`~repro_torch.obs.trace.Tracer` streaming into the sink, and exposes
``site_event_handler`` — the callable
:func:`repro_torch.core.intercept.offload` accepts as ``on_site_event``,
incrementing a per-site execution counter and (once per site) emitting
the static ``site_exec`` declaration.  Closing the run flushes the
registry snapshot as ``metric`` events, so a file is self-contained.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from .registry import Registry
from .trace import Tracer

__all__ = ["EventList", "EventSink", "MetricsRun", "json_safe",
           "read_events", "load_runs"]


def json_safe(v):
    """Coerce numpy scalars/arrays, dtypes, tuples, paths to JSON types."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [json_safe(x) for x in v]
    item = getattr(v, "item", None)
    if callable(item):  # numpy / torch scalar (and 0-d arrays)
        try:
            return json_safe(item())
        except (TypeError, ValueError, RuntimeError):
            pass   # a multi-element array or tensor
    tolist = getattr(v, "tolist", None)
    if callable(tolist):  # numpy array
        return json_safe(tolist())
    return str(v)


class EventSink:
    """Append-only JSONL writer; thread-safe, line-buffered.

    The offload's hook writes here from autograd's device threads as
    well as the caller's, so every emit takes the lock and flushes — a killed run keeps everything
    emitted before the kill.
    """

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a")
        self._closed = False

    def emit(self, type: str, **fields) -> None:
        record = {"t": time.time(), "type": str(type)}
        record.update({k: json_safe(v) for k, v in fields.items()})
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _next_run_id(directory: Path) -> str:
    taken = []
    for p in directory.glob("events-*.jsonl"):
        tail = p.stem.rpartition("-")[2]
        if tail.isdigit():
            taken.append(int(tail))
    return f"{max(taken) + 1 if taken else 0:04d}"


class MetricsRun:
    """One invocation's telemetry: JSONL sink + registry + tracer.

    Args:
      directory: the run-scoped metrics directory; each MetricsRun
        allocates the next ``events-NNNN.jsonl`` inside it, so resumed
        or repeated invocations never clobber earlier runs.
      run_id: override the allocated id (tests).
    """

    def __init__(self, directory, run_id: Optional[str] = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.run_id = run_id or _next_run_id(self.directory)
        self.sink = EventSink(self.directory
                              / f"events-{self.run_id}.jsonl")
        self.registry = Registry()
        self.tracer = Tracer(sink=self.sink)
        self._lock = threading.Lock()
        self._declared_exec: set = set()
        self._closed = False
        self.sink.emit("run_start", run_id=self.run_id)

    # -- event helpers -------------------------------------------------

    def event(self, type: str, **fields) -> None:
        self.sink.emit(type, **fields)

    def declare_sites(self, sites) -> None:
        """Emit one ``site_decl`` per Site decision (static facts).

        ``sites`` are :class:`repro_torch.core.Site` records — the exact
        list ``offload(...).sites(...)``/``site_report`` produce, so
        the CI coverage gate can hold ``site_exec`` counts against the
        authoritative site report.  The dtype is written by its numpy
        name, as the reference writes it.
        """
        for s in sites:
            self.sink.emit(
                "site_decl", site=s.name, offloaded=bool(s.offloaded),
                eligible=bool(s.eligible), backend=s.backend,
                splits=int(s.splits), lhs_shape=list(s.lhs_shape),
                rhs_shape=list(s.rhs_shape),
                dtype=str(s.dtype).replace("torch.", ""),
                m=s.m, k=s.k, n=s.n, batch=s.batch, mult=s.mult,
                spmd_axes=list(s.spmd_axes), flops=s.flops,
                reason=s.reason,
                tiles=dict(s.tiles) if getattr(s, "tiles", None) else None)

    def site_event_handler(self):
        """The ``on_site_event`` callable for :func:`repro_torch.core.offload`.

        Called on the host once per *execution* of each offloaded site
        (scan iterations and backward products each count; on the card
        a backward site's call comes from autograd's device thread):
        increments the ``site_exec`` counter labeled by site name and,
        on the first execution of a site, emits its static
        ``site_exec`` record —
        so the JSONL stream proves the hook fired even if the process
        dies before the registry snapshot is flushed.
        """

        def handler(payload: dict) -> None:
            site = payload.get("site", "?")
            self.registry.counter("site_exec", site=site).inc()
            with self._lock:
                first = site not in self._declared_exec
                if first:
                    self._declared_exec.add(site)
            if first:
                self.sink.emit("site_exec", **payload)

        return handler

    # -- lifecycle -----------------------------------------------------

    def flush_registry(self) -> None:
        """Write the current registry snapshot as ``metric`` events."""
        for snap in self.registry.snapshot():
            self.sink.emit("metric", **snap)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.flush_registry()
        self.sink.emit("run_end", run_id=self.run_id)
        self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- reading (the report/export CLI's input layer) ---------------------


class EventList(list):
    """A list of events that also counts the lines it could NOT parse.

    ``dropped`` is the ``events_torn_lines`` count: malformed JSONL
    lines (a killed run's torn final write, a truncated copy) that
    :func:`read_events` skipped.  It is an attribute rather than a
    second return value so every existing ``for ev in read_events(p)``
    caller keeps working unchanged.
    """

    def __init__(self, events=(), dropped: int = 0):
        super().__init__(events)
        self.dropped = int(dropped)


def read_events(path) -> "EventList":
    """Parse one JSONL file; malformed lines are counted in the
    returned :class:`EventList`'s ``dropped``, not silently lost (a
    killed run may leave a torn final line — the report surfaces how
    many lines that cost)."""
    events = EventList()
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            events.dropped += 1
            continue
        if isinstance(ev, dict):
            events.append(ev)
        else:
            events.dropped += 1  # parseable but not an event object
    return events


def load_runs(directory) -> Dict[str, List[dict]]:
    """All runs in a metrics directory: ``{run_id: [events...]}``.

    Run ids are the ``events-<id>.jsonl`` stems, sorted, so the last
    key is the most recent run.
    """
    directory = Path(directory)
    runs: Dict[str, List[dict]] = {}
    for p in sorted(directory.glob("events-*.jsonl")):
        runs[p.stem.partition("-")[2]] = read_events(p)
    return runs
