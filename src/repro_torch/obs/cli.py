"""``python -m repro_torch.obs`` — report, export, attribute, and diff runs.

Port of :mod:`repro.obs.cli`, with the same subcommands, flags and
tables; it reads files only, so it reads the reference's runs as well
as the port's.

Four subcommands over a metrics directory of ``events-NNNN.jsonl``
files (as written by :class:`repro_torch.obs.events.MetricsRun`):

``report <dir>``
    Aggregate the latest run (or every run with ``--all``) into
    human-readable tables: the per-site decision/execution table
    (backend, splits, flops, executions, realized numerics error),
    the per-step loss/timing summary, numerics-drift checks, serve
    per-request latencies with p50/p95/p99 estimates, and span
    totals.  Torn JSONL lines (a killed run's final write) are
    counted, not silently skipped.  ``--check`` turns the report into
    a CI gate: exit nonzero unless every *offloaded* declared site
    recorded at least one execution.

``export <dir> [-o trace.json]``
    Convert the run's span events into a Chrome Trace Event JSON file
    that ``chrome://tracing`` and https://ui.perfetto.dev open
    directly.

``attrib <dir>``
    The per-site cost attribution table (:mod:`repro_torch.obs.attrib`):
    measured hot-loop wall time distributed over offloaded sites by
    their modeled cost on one H100, with INT8-GEMM shares and a demote-to
    suggestion per site.

``diff <run_a> <run_b>``
    Structured cross-run comparison (:mod:`repro_torch.obs.diff`): bench
    timing ratios ranked worst-first, metric-series deltas, numerics
    drift changes.  ``--check`` gates machine-portable structural
    regressions for CI; ``--max-ratio R`` additionally gates timing.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

from .events import load_runs, read_events
from .trace import write_chrome_trace

__all__ = ["main"]


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1e5 or abs(v) < 1e-3:
            return f"{v:.3e}"
        return f"{v:.4g}"
    return str(v)


def _table(headers: List[str], rows: List[List], out) -> None:
    cells = [[_fmt(c) for c in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells
              else len(h) for i, h in enumerate(headers)]
    print("  " + "  ".join(h.ljust(w)
                           for h, w in zip(headers, widths)), file=out)
    for row in cells:
        print("  " + "  ".join(c.ljust(w)
                               for c, w in zip(row, widths)), file=out)


def _by_type(events: List[dict]) -> Dict[str, List[dict]]:
    grouped: Dict[str, List[dict]] = {}
    for ev in events:
        grouped.setdefault(ev.get("type", "?"), []).append(ev)
    return grouped


def _site_exec_counts(grouped) -> Dict[str, float]:
    """Per-site execution counts: registry snapshot if the run closed
    cleanly, else the first-execution ``site_exec`` records (>= 1)."""
    counts: Dict[str, float] = {}
    for ev in grouped.get("metric", ()):
        if ev.get("kind") == "counter" and ev.get("name") == "site_exec":
            site = (ev.get("labels") or {}).get("site", "?")
            counts[site] = counts.get(site, 0) + float(ev.get("value", 0))
    if not counts:
        for ev in grouped.get("site_exec", ()):
            site = ev.get("site", "?")
            counts[site] = counts.get(site, 0) + 1
    return counts


def _cache_event_counts(grouped) -> Dict[str, float]:
    """Transform-cache resolutions by kind (``miss`` / ``disk_hit`` /
    ``disk_decisions_hit``): registry snapshot if the run closed
    cleanly, else the raw ``transform_cache`` event stream."""
    counts: Dict[str, float] = {}
    for ev in grouped.get("metric", ()):
        if (ev.get("kind") == "counter"
                and ev.get("name") == "transform_cache"):
            kind = (ev.get("labels") or {}).get("result", "?")
            counts[kind] = counts.get(kind, 0) + float(
                ev.get("value", 0))
    if not counts:
        for ev in grouped.get("transform_cache", ()):
            kind = ev.get("result", "?")
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def _last_gauges(grouped, names) -> Dict[str, float]:
    """Final value of each named gauge (metric events are snapshots in
    write order, so the last one wins)."""
    vals: Dict[str, float] = {}
    for ev in grouped.get("metric", ()):
        if ev.get("kind") == "gauge" and ev.get("name") in names:
            vals[ev["name"]] = float(ev.get("value", 0))
    return vals


def _report_run(run_id: str, events: List[dict], out,
                check: bool = False,
                expect_cache_hit: bool = False) -> int:
    grouped = _by_type(events)
    failures = 0
    torn = getattr(events, "dropped", 0)
    suffix = (f" ({torn} torn line(s) dropped — killed run or "
              "truncated copy)") if torn else ""
    print(f"run {run_id}: {len(events)} events{suffix}", file=out)

    decls = grouped.get("site_decl", [])
    execs = _site_exec_counts(grouped)
    # Last realized error per site from the numerics checks.
    realized: Dict[str, float] = {}
    for ev in grouped.get("numerics", ()):
        realized[ev.get("site", "?")] = ev.get("realized_rel")
    if decls:
        print("sites:", file=out)
        rows = []
        for d in sorted(decls, key=lambda d: d.get("site", "")):
            site = d.get("site", "?")
            rows.append([site, d.get("backend") or "native",
                         d.get("splits"), d.get("offloaded"),
                         d.get("dtype"),
                         f"{d.get('lhs_shape')}x{d.get('rhs_shape')}",
                         float(d.get("flops", 0)),
                         execs.get(site), realized.get(site)])
        _table(["site", "backend", "splits", "offload", "dtype",
                "shapes", "flops", "execs", "realized_rel"], rows, out)
        if check:
            for d in decls:
                if d.get("offloaded") and not execs.get(d.get("site")):
                    print(f"CHECK FAIL: offloaded site "
                          f"{d.get('site')!r} recorded no executions",
                          file=out)
                    failures += 1
    elif check:
        print("CHECK FAIL: no site_decl events in this run (was the "
              "run launched without a backend/plan, or killed before "
              "site discovery?)", file=out)
        failures += 1

    steps = grouped.get("step", [])
    if steps:
        losses = [s["loss"] for s in steps if s.get("loss") is not None]
        mss = [s["ms"] for s in steps if s.get("ms") is not None]
        gemms = [s.get("int8_gemms") for s in steps
                 if s.get("int8_gemms") is not None]
        print("steps:", file=out)
        _table(["steps", "first_loss", "last_loss", "mean_ms",
                "int8_gemms/step"],
               [[len(steps),
                 losses[0] if losses else None,
                 losses[-1] if losses else None,
                 sum(mss) / len(mss) if mss else None,
                 gemms[-1] if gemms else None]], out)

    checks = grouped.get("numerics", [])
    if checks:
        print("numerics:", file=out)
        _table(["checks", "site", "splits", "max_realized_rel",
                "budget", "drift"],
               [[len(checks), checks[-1].get("site"),
                 checks[-1].get("splits"),
                 max(c.get("realized_rel", 0.0) for c in checks),
                 checks[-1].get("budget"),
                 sum(1 for c in checks if c.get("drift"))]], out)

    cache_counts = _cache_event_counts(grouped)
    if cache_counts or expect_cache_hit:
        if cache_counts:
            print("transform cache:", file=out)
            _table(["result", "count"],
                   [[k, v] for k, v in sorted(cache_counts.items())],
                   out)
        warm = (cache_counts.get("disk_hit", 0)
                + cache_counts.get("disk_decisions_hit", 0))
        if expect_cache_hit and warm < 1:
            print("CHECK FAIL: --expect-cache-hit but the run "
                  "recorded no disk_hit/disk_decisions_hit transform-"
                  "cache resolutions (cold trace, or warm_cache_dir "
                  "not set?)", file=out)
            failures += 1

    reqs = grouped.get("request", [])
    if reqs:
        def mean(key):
            vals = [r[key] for r in reqs if r.get(key) is not None]
            return sum(vals) / len(vals) if vals else None

        print("serve:", file=out)
        _table(["requests", "mean_admission_s", "mean_prefill_s",
                "mean_ttft_s", "mean_tokens_per_s"],
               [[len(reqs), mean("admission_wait_s"),
                 mean("prefill_s"), mean("ttft_s"),
                 mean("tokens_per_s")]], out)
        kv = _last_gauges(grouped, ("serve_kv_blocks_allocated",
                                    "serve_kv_blocks_hwm",
                                    "serve_kv_block_utilization",
                                    "serve_queue_depth"))
        if kv:
            print("serve kv/queue:", file=out)
            _table(["blocks_allocated", "blocks_hwm",
                    "block_utilization", "queue_depth"],
                   [[kv.get("serve_kv_blocks_allocated"),
                     kv.get("serve_kv_blocks_hwm"),
                     kv.get("serve_kv_block_utilization"),
                     kv.get("serve_queue_depth")]], out)

    hists = [ev for ev in grouped.get("metric", ())
             if ev.get("kind") == "histogram" and ev.get("count")
             and str(ev.get("name", "")).startswith("serve_")]
    if hists:
        print("serve latency quantiles (decade-bucket estimates):",
              file=out)
        _table(["metric", "count", "mean", "p50", "p95", "p99"],
               [[h.get("name"), h.get("count"), h.get("mean"),
                 h.get("p50"), h.get("p95"), h.get("p99")]
                for h in sorted(hists, key=lambda h: h.get("name"))],
               out)

    rows = grouped.get("bench_row", [])
    if rows:
        print("bench:", file=out)
        _table(["name", "us_per_call", "derived"],
               [[r.get("name"), r.get("us_per_call"),
                 r.get("derived")] for r in rows], out)

    spans = grouped.get("span", [])
    if spans:
        agg: Dict[str, List[float]] = {}
        for s in spans:
            agg.setdefault(s.get("name", "?"), []).append(
                float(s.get("dur", 0.0)) / 1e3)
        print("spans:", file=out)
        _table(["name", "count", "total_ms", "mean_ms"],
               [[n, len(d), sum(d), sum(d) / len(d)]
                for n, d in sorted(agg.items())], out)

    if check and not failures:
        print("CHECK OK: every offloaded site recorded executions",
              file=out)
    return failures


def _run_attrib(run_id: str, events: List[dict], out) -> int:
    from .attrib import attribution

    rows = attribution(events)
    print(f"run {run_id}: cost attribution over "
          f"{len(rows)} offloaded site(s)", file=out)
    if not rows:
        print("  (no offloaded site_decl events in this run — was it "
              "launched without a backend/plan?)", file=out)
        return 1
    _table(["site", "s", "execs", "int8_gemms", "gemm%", "wall%",
            "wall_s", "suggestion"],
           [[r.site, r.splits, r.execs, r.int8_gemms,
             f"{100 * r.gemm_share:.1f}", f"{100 * r.wall_share:.1f}",
             r.wall_s, r.suggestion()] for r in rows], out)
    return 0


def _run_diff(args, out) -> int:
    from .diff import diff_runs

    (id_a, ev_a), = _select_runs(args.run_a, False, None).items()
    (id_b, ev_b), = _select_runs(args.run_b, False, None).items()
    report = diff_runs(ev_a, ev_b, run_a=f"{args.run_a}:{id_a}",
                       run_b=f"{args.run_b}:{id_b}")
    print(f"diff {report.run_a} -> {report.run_b}", file=out)

    slower = report.regressions(1.0)
    if slower:
        print("bench rows slower in B (ratio = B/A):", file=out)
        _table(["name", "us_a", "us_b", "ratio"],
               [[b.name, b.us_a, b.us_b, b.ratio]
                for b in slower[:15]], out)
    missing = report.missing_rows()
    if missing:
        print(f"bench rows missing from B: {', '.join(missing)}",
              file=out)
    skips = report.new_skips()
    if skips:
        print(f"bench rows newly skipped in B: {', '.join(skips)}",
              file=out)
    gone = [s.key for s in report.missing_series()]
    if gone:
        print(f"metric series missing from B: {', '.join(gone[:20])}",
              file=out)
    drifted = report.drift_increases()
    if drifted:
        print("numerics drift increases:", file=out)
        _table(["site", "drift_a", "drift_b", "realized_a",
                "realized_b"],
               [[n.site, n.drift_a, n.drift_b, n.realized_a,
                 n.realized_b] for n in drifted], out)
    if not (slower or missing or skips or gone or drifted):
        print("no regressions detected", file=out)

    if not args.check:
        return 0
    failures = report.failures(max_ratio=args.max_ratio)
    for f in failures:
        print(f"CHECK FAIL: {f}", file=out)
    if not failures:
        print("CHECK OK: no structural regressions between runs",
              file=out)
    return 1 if failures else 0


def _select_runs(directory: str, all_runs: bool,
                 run_id: Optional[str]) -> Dict[str, List[dict]]:
    path = Path(directory)
    if path.is_file():
        return {path.stem.partition("-")[2] or path.stem:
                read_events(path)}
    runs = load_runs(path)
    if not runs:
        raise SystemExit(f"no events-*.jsonl runs under {directory}")
    if run_id is not None:
        if run_id not in runs:
            raise SystemExit(f"run {run_id!r} not found; have "
                             f"{sorted(runs)}")
        return {run_id: runs[run_id]}
    if all_runs:
        return runs
    last = sorted(runs)[-1]
    return {last: runs[last]}


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Report and export repro telemetry runs.")
    sub = parser.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="aggregate a metrics dir "
                         "into tables")
    rep.add_argument("directory", help="metrics dir (or one "
                     "events-*.jsonl file)")
    rep.add_argument("--all", action="store_true",
                     help="report every run, not just the latest")
    rep.add_argument("--run", default=None, help="report this run id")
    rep.add_argument("--check", action="store_true",
                     help="exit nonzero unless every offloaded site "
                     "recorded at least one execution")
    rep.add_argument("--expect-cache-hit", action="store_true",
                     help="exit nonzero unless the run resolved at "
                     "least one transform-cache entry from the "
                     "persistent on-disk cache (warm start)")

    exp = sub.add_parser("export", help="write a Chrome trace from "
                         "the run's span events")
    exp.add_argument("directory", help="metrics dir (or one "
                     "events-*.jsonl file)")
    exp.add_argument("--all", action="store_true",
                     help="merge spans from every run")
    exp.add_argument("--run", default=None, help="export this run id")
    exp.add_argument("-o", "--output", default="trace.json",
                     help="output path (default trace.json)")

    att = sub.add_parser("attrib", help="per-site cost attribution "
                         "(wall x tile-model) for one run")
    att.add_argument("directory", help="metrics dir (or one "
                     "events-*.jsonl file)")
    att.add_argument("--run", default=None,
                     help="attribute this run id (default: latest)")

    dif = sub.add_parser("diff", help="compare two recorded runs")
    dif.add_argument("run_a", help="baseline: metrics dir (latest "
                     "run) or one events-*.jsonl file")
    dif.add_argument("run_b", help="candidate: metrics dir (latest "
                     "run) or one events-*.jsonl file")
    dif.add_argument("--check", action="store_true",
                     help="exit nonzero on structural regressions "
                     "(missing bench rows, new skips, vanished "
                     "counter series, numerics drift increases)")
    dif.add_argument("--max-ratio", type=float, default=None,
                     help="with --check: also fail bench rows whose "
                     "B/A timing ratio exceeds this (same-machine "
                     "comparisons only — wall clock is not portable)")

    args = parser.parse_args(argv)
    if args.cmd == "diff":
        return _run_diff(args, out)
    runs = _select_runs(args.directory, args.all
                        if args.cmd != "attrib" else False, args.run)

    if args.cmd == "attrib":
        run_id, events = sorted(runs.items())[-1]
        return _run_attrib(run_id, events, out)

    if args.cmd == "report":
        failures = 0
        for i, (run_id, events) in enumerate(sorted(runs.items())):
            if i:
                print("", file=out)
            failures += _report_run(
                run_id, events, out, check=args.check,
                expect_cache_hit=args.expect_cache_hit)
        return 1 if failures else 0

    events = [ev for _, evs in sorted(runs.items()) for ev in evs]
    path = write_chrome_trace(events, args.output)
    n = sum(1 for ev in events if ev.get("type") == "span")
    print(f"wrote {n} spans from {len(runs)} run(s) to {path} "
          "(open in chrome://tracing or https://ui.perfetto.dev)",
          file=out)
    return 0
