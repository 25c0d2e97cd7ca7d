"""The program's layer spans over the device trace, and what is read
from them.

The port opens spans at its layer boundaries (``repro_torch.obs.trace``:
``train.step`` and its phases, ``offload.site``, ``ozaki`` with its
``ozaki.slice``, ``ozaki.kernel`` and ``ozaki.combine``) into the
process's active tracer.  A tracer stamps its spans in microseconds
from ``t0_ns`` on ``time.perf_counter_ns``; :func:`program_spans` lays
them on the profiler's timeline through the three host clocks that
``devtrace.Spans.now()`` reads when the trace starts.

:class:`LaunchTrace` is a ``devtrace.DeviceTrace`` that also keeps, for
each device operation, the correlation id that ties it to the host
call that launched it, and those host calls' stamps.  A kernel is put
down to the span open on the host when it was launched: the innermost
span open then, on any thread (autograd runs the cotangent products on
a thread of its own while the caller's thread waits inside
``train.backward``, so the innermost open span is the launching
thread's).  Kernels are never matched by name: the model's own
elementwise kernels share the slicing's names.

The readings, each a plain function of the spans and the trace:

* :func:`ozaki_host_ms` — mean ``ozaki`` span: the host's enqueue cost
  of one ``ozaki_matmul`` call;
* :func:`offload_site_us` — mean self time of ``offload.site``: its
  duration less the ``ozaki`` spans inside it;
* :func:`slicing_device_ms` — device ms a step of the kernels launched
  inside ``ozaki.slice`` spans; it raises unless every K1 launch lies
  inside an ``ozaki.kernel`` span (the check of the clock mapping);
* :func:`idle_in_ozaki_share` — share of the idle time between kernels
  whose innermost open span is ``ozaki`` or one of its parts;
* :func:`idle_gaps` — ``devtrace.idle_gaps`` with each gap named by the
  innermost program span open at its middle first.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from . import devtrace

#: (name, start ns, end ns, thread) on the profiler's clock.
ProgramSpan = Tuple[str, int, int, int]
#: (name, start ns, end ns, correlation id) of a device operation.
DeviceOp = Tuple[str, int, int, int]

OZAKI = "ozaki"
K1 = "split_gemm_kernel"


class LaunchTrace(devtrace.DeviceTrace):
    """A device trace that keeps each device operation's correlation id
    (``ops``) and the profiler-clock stamp of each host call that
    launched one (``launches``: correlation id to start ns)."""

    def __init__(self):
        super().__init__()
        self.ops: List[DeviceOp] = []
        self.launches: Dict[int, int] = {}

    def stop(self) -> None:
        super().stop()
        host = {}
        for ev in self._prof.profiler.kineto_results.events():
            corr = ev.correlation_id()
            if ev.device_type().name == "CUDA":
                start = ev.start_ns()
                self.ops.append((ev.name(), start,
                                 start + ev.duration_ns(), corr))
            elif corr:
                host[corr] = ev.start_ns()
        wanted = {op[3] for op in self.ops}
        self.launches = {c: t for c, t in host.items() if c in wanted}
        self.ops.sort(key=lambda op: op[1])


def clock_offset(trace) -> Optional[int]:
    """Nanoseconds to add to a ``time.perf_counter_ns`` stamp to put it
    on the profiler's clock (None when no host clock is near the
    profiler's)."""
    clock = devtrace._profiler_clock(trace)
    if clock is None:
        return None
    return trace.host_start[clock] - trace.host_start["perf_counter_ns"]


def program_spans(events: Sequence[dict], t0_ns: int,
                  offset: int = 0) -> List[ProgramSpan]:
    """A tracer's span events (``tracer.events``, anchored at its
    ``t0_ns``) as intervals shifted by ``offset`` ns, by start."""
    out = []
    for ev in events:
        if ev.get("type", "span") != "span":
            continue
        start = t0_ns + round(ev["ts"] * 1e3) + offset
        out.append((ev["name"], start, start + round(ev["dur"] * 1e3),
                    ev["tid"]))
    return sorted(out, key=lambda s: s[1])


def innermost(spans: Sequence[ProgramSpan],
              times: Sequence[int]) -> List[Optional[str]]:
    """For each stamp in ``times``, the name of the innermost span open
    then on any thread: the open one that started last (None where none
    is open)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    ranked = sorted(spans, key=lambda s: s[1])
    out: List[Optional[str]] = [None] * len(times)
    heap: list = []   # (-start, end, name) of spans begun so far
    j = 0
    for i in order:
        t = times[i]
        while j < len(ranked) and ranked[j][1] <= t:
            name, start, end, _ = ranked[j]
            heapq.heappush(heap, (-start, end, name))
            j += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        if heap:
            out[i] = heap[0][2]
    return out


def _gaps(kernels: Sequence[Tuple]) -> List[Tuple[int, int]]:
    """The stretches between kernels in which none ran."""
    gaps, end = [], None
    for _, s, e, *_ in sorted(kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def _in_ozaki(name: Optional[str]) -> bool:
    return name is not None and (name == OZAKI
                                 or name.startswith(OZAKI + "."))


def ozaki_host_ms(spans: Sequence[ProgramSpan], k1_launches: int,
                  gemms: int) -> Optional[float]:
    """Mean ``ozaki`` span in ms.  The spans, the program's K1 launch
    counter and the GEMMs counted from the shapes must count the same
    calls: a mismatch raises, since the mean would then hold other
    calls or miss some."""
    calls = [e - s for name, s, e, _ in spans if name == OZAKI]
    if not calls:
        return None
    if not len(calls) == k1_launches == gemms:
        raise RuntimeError(
            f"ozaki: {len(calls)} spans, {k1_launches} K1 launches by the "
            f"program, {gemms} GEMMs counted from the shapes")
    return sum(calls) / len(calls) / 1e6


def offload_site_us(spans: Sequence[ProgramSpan]) -> Optional[float]:
    """Mean self time of ``offload.site`` in us: each execution's
    duration less the ``ozaki`` spans on its thread inside it."""
    sites = [s for s in spans if s[0] == "offload.site"]
    if not sites:
        return None
    calls = sorted((s for s in spans if s[0] == OZAKI), key=lambda s: s[1])
    starts = [s[1] for s in calls]
    total = 0
    for _, s, e, tid in sites:
        own = e - s
        i = bisect.bisect_left(starts, s)
        while i < len(calls) and calls[i][1] < e:
            if calls[i][3] == tid and calls[i][2] <= e:
                own -= calls[i][2] - calls[i][1]
            i += 1
        total += own
    return total / len(sites) / 1e3


def _launched_in(ops: Sequence[DeviceOp], launches: Dict[int, int],
                spans: Sequence[ProgramSpan]) -> List[Optional[str]]:
    """For each device operation, the innermost span open when its host
    call launched it (None when its launch is not in the trace or no
    span was open)."""
    found = [i for i, op in enumerate(ops) if op[3] in launches]
    names = innermost(spans, [launches[ops[i][3]] for i in found])
    out: List[Optional[str]] = [None] * len(ops)
    for i, name in zip(found, names):
        out[i] = name
    return out


def slicing_device_ms(ops: Sequence[DeviceOp], launches: Dict[int, int],
                      spans: Sequence[ProgramSpan],
                      steps: int) -> Optional[float]:
    """Device ms a step of the operations launched inside
    ``ozaki.slice`` spans.  Every K1 launch must lie inside an
    ``ozaki.kernel`` span, else the clock mapping or the spans are at
    fault and this raises."""
    if not ops or not launches or not steps:
        return None
    where = _launched_in(ops, launches, spans)
    stray = sum(1 for op, name in zip(ops, where)
                if K1 in op[0] and name != "ozaki.kernel")
    k1 = sum(1 for op in ops if K1 in op[0])
    if stray or not k1:
        raise RuntimeError(f"{stray} of {k1} K1 launches lie outside an "
                           "ozaki.kernel span")
    ns = sum(op[2] - op[1] for op, name in zip(ops, where)
             if name == "ozaki.slice")
    return ns / steps / 1e6


def idle_in_ozaki_share(kernels: Sequence[Tuple],
                        spans: Sequence[ProgramSpan]) -> Optional[float]:
    """Share in % of the idle time between kernels whose innermost open
    span at the gap's middle is ``ozaki`` or one of its parts."""
    gaps = _gaps(kernels)
    total = sum(e - s for s, e in gaps)
    if not total or not spans:
        return None
    names = innermost(spans, [(s + e) // 2 for s, e in gaps])
    ozaki = sum(e - s for (s, e), name in zip(gaps, names)
                if _in_ozaki(name))
    return 100 * ozaki / total


def idle_gaps(trace, harness: devtrace.Spans,
              spans: Sequence[ProgramSpan], count: int = 10) -> List[list]:
    """``devtrace.idle_gaps``, each gap named by the innermost program
    span open at its middle on any thread; where none is, by the
    harness's own span (``unit``), else "host"."""
    base = devtrace.idle_gaps(trace, harness, count)
    gaps = sorted(_gaps(trace.kernels), key=lambda g: g[0] - g[1])[:count]
    names = innermost(spans, [(s + e) // 2 for s, e in gaps])
    return [[name or label, length]
            for (label, length), name in zip(base, names)]
