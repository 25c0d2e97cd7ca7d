"""Rolling-window SLO tracking for the serve path.

Port of :mod:`repro.obs.slo`.  Requests carry a ``latency_target_s``
and the scheduler an edf policy that orders by deadline — but nothing
there watches whether the deadlines were *met* in aggregate.
:class:`SLOTracker` turns each finished request's latency-vs-target
outcome into the standard SRE burn-rate signal:

    burn = (violating fraction of the window) / (1 - objective)

At ``objective = 0.99``, a window where 1% of requests miss their
target burns at exactly 1.0 — spending error budget precisely as fast
as the SLO allows.  Burn 10 means the budget drains 10x too fast; the
``warn_burn`` / ``page_burn`` thresholds convert that into counters an
alerting rule can fire on (``slo_warn`` / ``slo_page``).

The window is a deque of ``(t, ok)`` outcomes pruned to ``window_s``
seconds on every observation, so the gauge always reflects the recent
past rather than the whole run.  Requests with no latency target are
not observed — an SLO only exists where a target does.

Wired in two places:

* ``serve.Engine`` observes every request's TTFT against its target as
  the request finishes (and seeds the ``slo_burn_rate`` gauge at 0 on
  startup, so the series exists from the first scrape);
* ``serve.Scheduler``'s edf path calls :meth:`late_admission` when it
  admits a request whose deadline already passed while queued —
  admission-time lateness is an SLO violation the engine would
  otherwise only discover a full prefill later.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Optional, Tuple

from .log import get_logger

__all__ = ["SLOTracker"]

log = get_logger("obs.slo")


class SLOTracker:
    """Burn-rate SLO accounting over a rolling time window.

    Args:
      registry: optional :class:`repro_torch.obs.Registry`; when given, the
        tracker maintains the gauge/counter series below.
      objective: target success fraction (0.99 => 1% error budget).
      window_s: rolling window length in seconds.
      warn_burn / page_burn: burn-rate thresholds; crossing them
        increments ``slo_warn`` / ``slo_page`` (edge-triggered — one
        increment per excursion above the threshold, not per request).
      sink: optional :class:`repro_torch.obs.EventSink`; threshold crossings
        emit ``slo`` events so the JSONL stream records when the
        budget started draining.

    Registry series:
      ``slo_burn_rate`` (gauge) — current burn;
      ``slo_window_requests`` / ``slo_window_violations`` (gauges);
      ``slo_violations`` (counter) — total target misses;
      ``slo_late_admissions`` (counter) — edf admissions past deadline;
      ``slo_warn`` / ``slo_page`` (counters) — threshold crossings.
    """

    def __init__(self, registry=None, *, objective: float = 0.99,
                 window_s: float = 60.0, warn_burn: float = 1.0,
                 page_burn: float = 10.0, sink=None):
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.objective = float(objective)
        self.window_s = float(window_s)
        self.warn_burn = float(warn_burn)
        self.page_burn = float(page_burn)
        self.registry = registry
        self.sink = sink
        self._lock = threading.Lock()
        self._window: Deque[Tuple[float, bool]] = collections.deque()
        self._above_warn = False
        self._above_page = False
        if registry is not None:
            # Materialize the series at 0 so a scrape taken before the
            # first request still carries them (the CI gate greps for
            # slo_burn_rate on a freshly started engine).
            registry.gauge("slo_burn_rate").set(0.0)
            registry.gauge("slo_window_requests").set(0.0)
            registry.gauge("slo_window_violations").set(0.0)

    # -- core ----------------------------------------------------------

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()

    def _burn_locked(self) -> float:
        if not self._window:
            return 0.0
        bad = sum(1 for _, ok in self._window if not ok)
        frac = bad / len(self._window)
        return frac / (1.0 - self.objective)

    def observe(self, latency_s: float, target_s: Optional[float],
                *, now: Optional[float] = None) -> Optional[float]:
        """Record one finished request; returns the new burn rate.

        ``target_s`` of ``None`` (no SLO on this request) records
        nothing and returns ``None``.
        """
        if target_s is None:
            return None
        now = time.monotonic() if now is None else float(now)
        ok = float(latency_s) <= float(target_s)
        with self._lock:
            self._window.append((now, ok))
            self._prune_locked(now)
            burn = self._burn_locked()
            n = len(self._window)
            bad = sum(1 for _, k in self._window if not k)
            warn_edge = burn > self.warn_burn and not self._above_warn
            page_edge = burn > self.page_burn and not self._above_page
            self._above_warn = burn > self.warn_burn
            self._above_page = burn > self.page_burn
        if self.registry is not None:
            if not ok:
                self.registry.counter("slo_violations").inc()
            self.registry.gauge("slo_burn_rate").set(burn)
            self.registry.gauge("slo_window_requests").set(n)
            self.registry.gauge("slo_window_violations").set(bad)
            if warn_edge:
                self.registry.counter("slo_warn").inc()
            if page_edge:
                self.registry.counter("slo_page").inc()
        if warn_edge or page_edge:
            level = "page" if page_edge else "warn"
            log.warning(f"SLO {level}: burn rate {burn:.2f} "
                        f"({bad}/{n} requests over target in the last "
                        f"{self.window_s:.0f}s, objective "
                        f"{self.objective})")
            if self.sink is not None:
                self.sink.emit("slo", level=level, burn=burn,
                               window_requests=n,
                               window_violations=bad,
                               objective=self.objective)
        return burn

    def late_admission(self, overdue_s: float) -> None:
        """The scheduler's edf hook: a request was admitted
        ``overdue_s`` seconds after its latency deadline had already
        expired in the queue — a violation in the making that the
        burn rate should not have to wait a prefill to see."""
        if self.registry is not None:
            self.registry.counter("slo_late_admissions").inc()
        if self.sink is not None:
            self.sink.emit("slo", level="late_admission",
                           overdue_s=float(overdue_s))

    # -- introspection -------------------------------------------------

    @property
    def burn_rate(self) -> float:
        with self._lock:
            self._prune_locked(time.monotonic())
            return self._burn_locked()

    def window_counts(self) -> Tuple[int, int]:
        """(requests, violations) currently inside the window."""
        with self._lock:
            self._prune_locked(time.monotonic())
            bad = sum(1 for _, ok in self._window if not ok)
            return len(self._window), bad
