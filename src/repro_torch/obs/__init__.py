"""``repro_torch.obs``: unified telemetry for the BLAS-offload stack.

Port of :mod:`repro.obs`, threaded through the port's offload, serve
engine and trainer as the reference threads it through its own.  Both
packages write the same JSONL event lines (timestamps, run ids and
measured durations aside) and the same Prometheus text on the same
inputs.  Only :mod:`~repro_torch.obs.numerics` and
:mod:`~repro_torch.obs.attrib` reach into the rest of the port; the
other modules need the standard library alone:

* :mod:`repro_torch.obs.log` — leveled stderr logger (``REPRO_LOG_LEVEL``)
  whose INFO rendering matches the pre-existing ``[train]``-style
  prints;
* :mod:`repro_torch.obs.registry` — labeled counters/gauges/histograms
  (with p50/p95/p99 estimates), safe to update from autograd's device
  threads, where the offload's hook fires for backward GEMMs;
* :mod:`repro_torch.obs.trace` — span tracer with Chrome-trace export,
  and the layer spans that the port's modules open into the active
  tracer (:func:`activate`, :func:`span`);
* :mod:`repro_torch.obs.events` — JSONL structured-event sink and the
  run-scoped :class:`MetricsRun` bundle the entry points construct;
* :mod:`repro_torch.obs.numerics` — :class:`NumericsMonitor`, the runtime
  drift check that closes the calibrate→train loop (loaded on first
  use: it imports :mod:`repro_torch.core`, whose modules open spans
  through :mod:`~repro_torch.obs.trace`);
* :mod:`repro_torch.obs.server` — the live plane: :class:`MetricsServer`
  serves ``/metrics`` in Prometheus text format while a job runs, and
  aggregates multi-process pushes (:func:`push_snapshot`);
* :mod:`repro_torch.obs.slo` — :class:`SLOTracker`, rolling-window
  burn-rate accounting for serve latency targets;
* :mod:`repro_torch.obs.attrib` — per-site cost attribution (measured wall
  × tile-model costs → ranked retuning table);
* :mod:`repro_torch.obs.diff` — structured cross-run regression comparison;
* ``python -m repro_torch.obs`` — the ``report``/``export``/``attrib``/
  ``diff`` CLI (:mod:`repro_torch.obs.cli`).
"""

from .attrib import AttribRow, attribution
from .diff import DiffReport, diff_runs
from .events import EventList, EventSink, MetricsRun, json_safe, \
    load_runs, read_events
from .log import LEVELS, Logger, get_logger, reset_logger
from .registry import Counter, Gauge, Histogram, Registry
from .server import MetricsServer, push_snapshot, render_prometheus
from .slo import SLOTracker
from .trace import Tracer, activate, span, to_chrome, write_chrome_trace

__all__ = [
    "AttribRow",
    "Counter",
    "DiffReport",
    "EventList",
    "EventSink",
    "Gauge",
    "Histogram",
    "LEVELS",
    "Logger",
    "MetricsRun",
    "MetricsServer",
    "NumericsMonitor",
    "NumericsReport",
    "Registry",
    "SLOTracker",
    "Tracer",
    "activate",
    "attribution",
    "diff_runs",
    "get_logger",
    "json_safe",
    "load_runs",
    "push_snapshot",
    "read_events",
    "render_prometheus",
    "reset_logger",
    "span",
    "to_chrome",
    "write_chrome_trace",
]


def __getattr__(name):
    if name in ("NumericsMonitor", "NumericsReport"):
        from . import numerics

        return getattr(numerics, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
