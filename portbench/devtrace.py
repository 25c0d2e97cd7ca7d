"""The device trace of a ``--trace 1`` run, and its reductions.

The traced stretch runs under ``torch.profiler`` with CUDA activity
only; what is kept is each kernel's name and interval, not a chrome
trace.  From
them: the device's busy seconds (the union of the intervals, so kernels
that overlap count once), the time of the kernels whose name holds a
given key, the device operations that took most time, and the longest
gaps in which no kernel ran, each named by the benchmark's own span
that was open on the host at the time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, int, int]   # (name, start ns, end ns)

_CLOCKS = {"time_ns": time.time_ns, "monotonic_ns": time.monotonic_ns,
           "perf_counter_ns": time.perf_counter_ns}


class Spans:
    """The benchmark's own host spans: (name, start, end) on every clock
    the profiler might use, so they can be laid over its timeline."""

    def __init__(self):
        self.closed: List[Tuple[str, Dict[str, int], Dict[str, int]]] = []
        self.durations: Dict[str, List[float]] = defaultdict(list)

    @staticmethod
    def now() -> Dict[str, int]:
        return {name: clock() for name, clock in _CLOCKS.items()}

    def wrap(self, name: str, fn):
        """``fn`` with every call recorded as a span ``name``."""
        def timed(*args, **kwargs):
            start = self.now()
            try:
                return fn(*args, **kwargs)
            finally:
                end = self.now()
                self.closed.append((name, start, end))
                self.durations[name].append(
                    (end["perf_counter_ns"] - start["perf_counter_ns"]) / 1e9)
        return timed


class DeviceTrace:
    """Profile the CUDA work between ``start`` and ``stop``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.kernels: List[Interval] = []
        self.trace_start_ns = 0
        self.host_start: Dict[str, int] = {}

    def start(self) -> None:
        self._prof.start()
        self.host_start = Spans.now()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.stop()
        results = self._prof.profiler.kineto_results
        self.trace_start_ns = results.trace_start_ns()
        for ev in results.events():
            if ev.device_type().name != "CUDA":
                continue
            start = ev.start_ns()
            self.kernels.append((ev.name(), start, start + ev.duration_ns()))
        self.kernels.sort(key=lambda iv: iv[1])


def busy_seconds(kernels: List[Interval]) -> float:
    """Seconds in which at least one kernel ran (interval union)."""
    total, end = 0, None
    for _, s, e in sorted(kernels, key=lambda iv: iv[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def kernel_seconds(kernels: List[Interval], key: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name holds
    ``key``."""
    hits = [e - s for name, s, e in kernels if key in name]
    return sum(hits) / 1e9, len(hits)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list (template arguments kept, cut at 120 characters)."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].removeprefix("void ").strip()
    head, sep, tail = name.partition("<")
    return (head.split("::")[-1] + sep + tail)[:120]


def top_ops(kernels: List[Interval], count: int = 10) -> List[list]:
    by_name: Dict[str, int] = defaultdict(int)
    for name, s, e in kernels:
        by_name[short_name(name)] += e - s
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
    return [[name, ns / 1e9] for name, ns in ranked]


def _profiler_clock(trace: DeviceTrace) -> Optional[str]:
    """The host clock the profiler stamps with: the one whose reading
    when the trace started lies within a second of the trace's own
    start stamp (None when no clock does)."""
    near = [(abs(trace.trace_start_ns - host), name)
            for name, host in trace.host_start.items()
            if abs(trace.trace_start_ns - host) < 10 ** 9]
    return min(near)[1] if near else None


def idle_gaps(trace: DeviceTrace, spans: Spans, count: int = 10) -> List[list]:
    """The ``count`` longest stretches with no kernel running between
    two kernels of the trace, each named by the innermost
    benchmark span open at its middle ("host" when none was)."""
    clock = _profiler_clock(trace)
    gaps, end = [], None
    for _, s, e in trace.kernels:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    ranked = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
    out = []
    for s, e in ranked:
        label = "host"
        if clock is not None:
            mid = (s + e) // 2
            open_spans = [(sp[clock] - st[clock], name)
                          for name, st, sp in spans.closed
                          if st[clock] <= mid <= sp[clock]]
            if open_spans:
                label = min(open_spans)[1]
        out.append([label, (e - s) / 1e9])
    return out
