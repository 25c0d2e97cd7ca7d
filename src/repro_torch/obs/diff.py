"""Structured cross-run comparison: one answer to "what changed?".

Port of :mod:`repro.obs.diff` (standard library only).

``python -m repro_torch.obs diff RUN_A RUN_B`` takes two recorded runs (two
``events-*.jsonl`` files, or two metrics directories whose latest runs
are used) and joins everything the telemetry stream lets us join:

* **metric series** — the flushed counter/gauge snapshots, keyed by
  ``(name, labels)``, with the B/A ratio; histogram series compare
  count and the p95 estimate.
* **bench rows** — ``bench_row`` events (the CSV mirror from
  ``benchmarks/run.py``): per-row timing ratio plus per-key deltas of
  the parsed ``derived`` payload, with skip state tracked so a row
  that silently *became* a skip is a first-class finding.
* **numerics** — per-site drift counts and worst realized relative
  error, so a precision regression ranks next to a perf one.

Two consumption modes.  Human mode ranks regressions by ratio and
prints tables.  ``--check`` mode is the CI gate and deliberately only
fails on *machine-portable* structural regressions — a bench row that
vanished, a row that newly skips, a counter series that disappeared, a
site whose numerics drift count grew — because raw wall-clock ratios
between a laptop and a CI runner are noise.  Pass ``--max-ratio R`` to
additionally gate timing ratios (same-machine comparisons, and the
injected-regression test).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

__all__ = ["SeriesDelta", "BenchDelta", "NumericsDelta", "DiffReport",
           "diff_runs", "parse_derived"]


def parse_derived(derived: str) -> Dict[str, float]:
    """The numeric view of a bench row's ``;``-separated payload.

    ``key=value`` pairs whose value leads with a float parse (units and
    suffixes like ``20.35TFLOPS`` keep the number); everything else is
    skipped — the diff compares numbers, not prose.
    """
    out: Dict[str, float] = {}
    for part in str(derived or "").split(";"):
        key, sep, val = part.partition("=")
        if not sep:
            continue
        num = ""
        for ch in val.strip():
            if ch.isdigit() or ch in "+-.eE":
                num += ch
            else:
                break
        try:
            out[key.strip()] = float(num)
        except ValueError:
            continue
    return out


def _ratio(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None or a <= 0:
        return None
    return b / a


@dataclasses.dataclass
class SeriesDelta:
    """One metric series in both runs (or only one of them)."""

    name: str
    labels: Dict[str, str]
    kind: str
    a: Optional[float]            # None when absent from that run
    b: Optional[float]
    ratio: Optional[float]

    @property
    def key(self) -> str:
        lbl = ",".join(f"{k}={v}"
                       for k, v in sorted(self.labels.items()))
        return f"{self.name}{{{lbl}}}" if lbl else self.name


@dataclasses.dataclass
class BenchDelta:
    """One bench row in both runs: timing ratio + derived deltas."""

    name: str
    us_a: Optional[float]
    us_b: Optional[float]
    ratio: Optional[float]        # us_b / us_a; None when not timeable
    skipped_a: bool
    skipped_b: bool
    derived: Dict[str, Tuple[Optional[float], Optional[float]]]

    @property
    def new_skip(self) -> bool:
        return self.skipped_b and not self.skipped_a


@dataclasses.dataclass
class NumericsDelta:
    """One site's numerics health in both runs."""

    site: str
    drift_a: int
    drift_b: int
    realized_a: Optional[float]   # worst realized_rel in the run
    realized_b: Optional[float]


@dataclasses.dataclass
class DiffReport:
    """Everything :func:`diff_runs` found, pre-joined and rankable."""

    run_a: str
    run_b: str
    series: List[SeriesDelta]
    bench: List[BenchDelta]
    numerics: List[NumericsDelta]

    def missing_series(self) -> List[SeriesDelta]:
        return [s for s in self.series if s.b is None]

    def new_series(self) -> List[SeriesDelta]:
        return [s for s in self.series if s.a is None]

    def missing_rows(self) -> List[str]:
        return [b.name for b in self.bench
                if b.us_a is not None and b.us_b is None]

    def new_skips(self) -> List[str]:
        return [b.name for b in self.bench if b.new_skip]

    def regressions(self, threshold: float = 1.0) -> List[BenchDelta]:
        """Timed bench rows whose B/A ratio exceeds ``threshold``,
        worst first — the human-mode headline table."""
        slow = [b for b in self.bench
                if b.ratio is not None and b.ratio > threshold
                and not (b.skipped_a or b.skipped_b)]
        return sorted(slow, key=lambda b: -b.ratio)

    def drift_increases(self) -> List[NumericsDelta]:
        return [n for n in self.numerics if n.drift_b > n.drift_a]

    def failures(self, max_ratio: Optional[float] = None) -> List[str]:
        """The ``--check`` gate: structural regressions (always), plus
        timing ratios beyond ``max_ratio`` when one is given."""
        fails: List[str] = []
        for name in self.missing_rows():
            fails.append(f"bench row {name!r} present in run "
                         f"{self.run_a} but missing from {self.run_b}")
        for name in self.new_skips():
            fails.append(f"bench row {name!r} ran in {self.run_a} but "
                         f"is skipped in {self.run_b}")
        for s in self.missing_series():
            if s.kind == "counter":
                fails.append(f"counter series {s.key} disappeared "
                             f"between runs")
        for n in self.drift_increases():
            fails.append(f"numerics drift count for site {n.site!r} "
                         f"rose {n.drift_a} -> {n.drift_b}")
        if max_ratio is not None:
            for b in self.regressions(max_ratio):
                fails.append(f"bench row {b.name!r} slowed "
                             f"{b.ratio:.2f}x "
                             f"({b.us_a:.0f} -> {b.us_b:.0f} us, "
                             f"max allowed {max_ratio:.2f}x)")
        return fails


def _series_values(events: List[dict]) -> Dict[Tuple, dict]:
    """Last flushed value per (kind-class, name, labels) series.

    Counters/gauges map to their value; histograms to ``count`` and the
    ``p95`` estimate (ratio-compared on count — the stable axis)."""
    out: Dict[Tuple, dict] = {}
    for ev in events:
        if ev.get("type") != "metric":
            continue
        kind = ev.get("kind")
        labels = {str(k): str(v)
                  for k, v in (ev.get("labels") or {}).items()}
        key = (ev.get("name"), tuple(sorted(labels.items())))
        if kind in ("counter", "gauge"):
            out[key] = {"kind": kind, "labels": labels,
                        "value": float(ev.get("value", 0.0))}
        elif kind == "histogram":
            out[key] = {"kind": kind, "labels": labels,
                        "value": float(ev.get("count", 0)),
                        "p95": ev.get("p95")}
    return out


def _bench_rows(events: List[dict]) -> Dict[str, dict]:
    rows: Dict[str, dict] = {}
    for ev in events:
        if ev.get("type") != "bench_row":
            continue
        derived = ev.get("derived") or ""
        nums = ev.get("derived_num")
        if not isinstance(nums, dict):
            nums = parse_derived(derived)
        else:
            nums = {str(k): float(v) for k, v in nums.items()
                    if isinstance(v, (int, float))}
        skipped = ("skipped=" in derived
                   or str(ev.get("name", "")).endswith("_skipped"))
        rows[str(ev.get("name"))] = {
            "us": ev.get("us_per_call"), "skipped": skipped,
            "derived": nums}
    return rows


def _numerics(events: List[dict]) -> Dict[str, dict]:
    sites: Dict[str, dict] = {}
    for ev in events:
        if ev.get("type") != "numerics":
            continue
        site = str(ev.get("site", "?"))
        rec = sites.setdefault(site, {"drift": 0, "realized": None})
        if ev.get("drift"):
            rec["drift"] += 1
        rel = ev.get("realized_rel")
        if rel is not None:
            rec["realized"] = (rel if rec["realized"] is None
                               else max(rec["realized"], float(rel)))
    return sites


def diff_runs(events_a: List[dict], events_b: List[dict], *,
              run_a: str = "A", run_b: str = "B") -> DiffReport:
    """Join two runs' event lists into a :class:`DiffReport`."""
    sa, sb = _series_values(events_a), _series_values(events_b)
    series: List[SeriesDelta] = []
    for key in sorted(set(sa) | set(sb), key=str):
        va, vb = sa.get(key), sb.get(key)
        ref = va or vb
        a = va["value"] if va else None
        b = vb["value"] if vb else None
        series.append(SeriesDelta(
            name=str(key[0]), labels=ref["labels"], kind=ref["kind"],
            a=a, b=b, ratio=_ratio(a, b)))

    ba, bb = _bench_rows(events_a), _bench_rows(events_b)
    bench: List[BenchDelta] = []
    for name in sorted(set(ba) | set(bb)):
        ra = ba.get(name, {"us": None, "skipped": False, "derived": {}})
        rb = bb.get(name, {"us": None, "skipped": False, "derived": {}})
        us_a = ra["us"] if name in ba and not ra["skipped"] else None
        us_b = rb["us"] if name in bb and not rb["skipped"] else None
        derived = {k: (ra["derived"].get(k), rb["derived"].get(k))
                   for k in sorted(set(ra["derived"])
                                   | set(rb["derived"]))}
        bench.append(BenchDelta(
            name=name,
            us_a=ra["us"] if name in ba else None,
            us_b=rb["us"] if name in bb else None,
            ratio=_ratio(us_a, us_b),
            skipped_a=ra["skipped"], skipped_b=rb["skipped"],
            derived=derived))

    na, nb = _numerics(events_a), _numerics(events_b)
    numerics = [NumericsDelta(
        site=site,
        drift_a=na.get(site, {}).get("drift", 0),
        drift_b=nb.get(site, {}).get("drift", 0),
        realized_a=na.get(site, {}).get("realized"),
        realized_b=nb.get(site, {}).get("realized"))
        for site in sorted(set(na) | set(nb))]

    return DiffReport(run_a=run_a, run_b=run_b, series=series,
                      bench=bench, numerics=numerics)
