"""Metric registry: labeled counters, gauges, and histograms.

Port of :mod:`repro.obs.registry` (standard library only).

The registry is the in-memory side of the telemetry layer.  Metric
updates happen on the *host*, typically from the offload's per-site
hook (:func:`repro_torch.core.offload`'s ``on_site_event``), which for a
backward GEMM on the card fires on autograd's device thread: every
mutating path takes a lock.  Nothing here touches a tensor; values must
already be host-side scalars (the hook's payload is built on the host
and never reads the device).

Metric identity is ``(kind, name, sorted labels)`` — asking twice for
``registry.counter("site_exec", site="dot0")`` returns the same object,
and asking for the same name+labels as a different kind raises instead
of silently shadowing.  ``Registry.snapshot()`` renders everything as
plain JSON-safe dicts, which is what :class:`repro_torch.obs.events.MetricsRun`
flushes into the JSONL stream at close.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry"]

#: Histogram bucket upper bounds: ten decades, 1e-6 .. 1e3, plus +inf.
#: Wide enough for seconds-scale latencies and relative errors alike.
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** e for e in range(-6, 4)) + (math.inf,)


class _Metric:
    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = dict(labels)
        self._lock = threading.Lock()

    def _snap_head(self, kind: str) -> dict:
        return {"kind": kind, "name": self.name,
                "labels": dict(self.labels)}


class Counter(_Metric):
    """Monotonic count; ``inc`` is the only mutation."""

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {**self._snap_head("counter"), "value": self.value}


class Gauge(_Metric):
    """Last-write-wins scalar (slot occupancy, realized error, ...)."""

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        with self._lock:
            self._value += float(n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {**self._snap_head("gauge"), "value": self.value}


class Histogram(_Metric):
    """count/sum/min/max plus fixed geometric buckets.

    The bucket bounds (:data:`BUCKET_BOUNDS`) are decades from 1e-6 to
    1e3 — coarse, but stable across runs, which is what the report
    tables need.  :meth:`quantile` estimates p50/p95/p99 from those
    buckets by geometric interpolation inside the covering decade,
    clamped to the observed min/max — decade-resolution estimates, which
    is exactly the precision the latency tables and the ``/metrics``
    summary series advertise.
    """

    def __init__(self, name, labels):
        super().__init__(name, labels)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.bucket_counts = [0] * len(BUCKET_BOUNDS)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            for i, bound in enumerate(BUCKET_BOUNDS):
                if v <= bound:
                    self.bucket_counts[i] += 1
                    break

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def _quantile_locked(self, q: float) -> float | None:
        """Estimate the q-quantile from the decade buckets (lock held).

        Geometric interpolation inside the covering bucket (its lower
        edge is the previous bound; the first bucket extends one decade
        below its bound), clamped to the observed [min, max] so values
        outside the decade grid — negatives in the first bucket, the
        +inf tail — degrade to the true extrema instead of nonsense.
        """
        if not self.count:
            return None
        target = q * self.count
        cum = 0.0
        for i, cnt in enumerate(self.bucket_counts):
            if cum + cnt >= target and cnt:
                hi = BUCKET_BOUNDS[i]
                if math.isinf(hi):
                    return self.max
                lo = BUCKET_BOUNDS[i - 1] if i else BUCKET_BOUNDS[0] / 10
                frac = (target - cum) / cnt
                est = lo * (hi / lo) ** frac
                return min(max(est, self.min), self.max)
            cum += cnt
        return self.max

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0 < q <= 1); ``None`` when empty."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile q must be in (0, 1], got {q}")
        with self._lock:
            return self._quantile_locked(q)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                **self._snap_head("histogram"),
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.sum / self.count if self.count else None,
                "p50": self._quantile_locked(0.50),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
                "buckets": [[("inf" if math.isinf(b) else b), c]
                            for b, c in zip(BUCKET_BOUNDS,
                                            self.bucket_counts)],
            }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Get-or-create store of labeled metrics.

    Thread-safe: the get-or-create path locks the registry, each metric
    locks itself.  ``snapshot()`` returns a deterministic (sorted)
    list of JSON-safe dicts.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple, _Metric] = {}

    def _get(self, kind: str, name: str, labels: dict):
        key_labels = tuple(sorted((str(k), str(v))
                           for k, v in labels.items()))
        key = (name, key_labels)
        with self._lock:
            got = self._metrics.get(key)
            if got is not None:
                if not isinstance(got, _KINDS[kind]):
                    raise ValueError(
                        f"metric {name!r} with labels {dict(key_labels)} "
                        f"already registered as "
                        f"{type(got).__name__.lower()}, not {kind}")
                return got
            metric = _KINDS[kind](name, key_labels)
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def snapshot(self) -> List[dict]:
        with self._lock:
            metrics = list(self._metrics.items())
        return [m.snapshot()
                for _, m in sorted(metrics, key=lambda kv: kv[0])]
