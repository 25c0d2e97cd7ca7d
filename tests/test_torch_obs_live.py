"""Port parity: the live observability plane of repro_torch.obs against
repro.obs — the Prometheus ``/metrics`` server and its text rendering,
push aggregation, SLO burn-rate tracking, per-site cost attribution
priced by the H100, and the obs diff regression gate.

Mirrors ``tests/test_obs_live.py`` class by class.  Exact against the
reference: the Prometheus text of the same registry operations (timing
series aside), the SLO series, the diff reports, and attribution's
order, ``execs``, ``int8_gemms``, ``gemm_share`` and demotions on the
reference's fixtures.  ``wall_share`` is held against the Hopper
formula computed by hand.  Port only: over a scan with ``mult`` > 1 the
attributed INT8 GEMMs are the run's, ``execs * pairs``, where the
reference multiplies by ``mult`` once more (ROADMAP section 3).  The
servers bind 127.0.0.1 on port 0.
"""

import dataclasses
import io
import json
import re
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LMConfig as LMConfigRef
from repro.core import PrecisionPolicy as PolicyRef
from repro.models import Model as ModelRef
from repro.obs import MetricsRun as MetricsRunRef
from repro.obs import Registry as RegistryRef
from repro.obs import SLOTracker as SLOTrackerRef
from repro.obs import attribution as attribution_ref
from repro.obs import diff_runs as diff_runs_ref
from repro.obs import load_runs as load_runs_ref
from repro.obs import render_prometheus as render_prometheus_ref
from repro.serve import Engine as EngineRef
from repro.serve import Request as RequestRef
from repro_torch.configs import LMConfig
from repro_torch.core import PrecisionPolicy, num_pair_gemms, offload, scan
from repro_torch.core import site_report
from repro_torch.kernels import tile_model
from repro_torch.models import Model, params_from_reference
from repro_torch.obs import (MetricsRun, MetricsServer, Registry, SLOTracker,
                             attribution, diff_runs, load_runs,
                             push_snapshot, render_prometheus)
from repro_torch.obs.attrib import publish
from repro_torch.obs.cli import main as obs_main
from repro_torch.obs.diff import parse_derived
from repro_torch.serve import Engine, Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.tune import count_int8_gemms

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

# -- a small but real Prometheus text-format parser (the reference's) --

_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 1 < len(v):
            out.append({"n": "\n", '"': '"', "\\": "\\"}
                       .get(v[i + 1], v[i:i + 2]))
            i += 2
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def parse_prometheus(text: str) -> dict:
    """{(name, ((label, value), ...)): float} plus a _types map."""
    series, types = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            continue
        assert not line.startswith("#"), line
        m = _SAMPLE.match(line)
        assert m, f"invalid exposition line: {line!r}"
        name, labels, value = m.groups()
        lbls = {}
        if labels:
            consumed = _LABEL.sub("", labels).replace(",", "")
            assert consumed == "", f"unparsed labels in {line!r}"
            for k, v in _LABEL.findall(labels):
                lbls[k] = _unescape(v)
        key = (name, tuple(sorted(lbls.items())))
        assert key not in series, f"duplicate series {key}"
        series[key] = (float("inf") if value == "+Inf"
                       else float(value))
    series["_types"] = types
    return series


def _registry_ops(reg):
    """One fixed sequence of registry operations (no timings)."""
    reg.counter("site_exec", site="dot0").inc(5)
    reg.counter("site_exec", site='shmap0/dot1 [dp=4,tp=2]').inc()
    reg.counter("site_exec", site='a"b\\c\nd').inc(2)
    reg.counter("bad-name.1").inc()
    reg.gauge("slo_burn_rate").set(1.25)
    h = reg.histogram("serve_ttft_s")
    for v in (0.002, 0.03, 0.04, 5.0, 2e-7, 7e3):
        h.observe(v)
    reg.histogram("never_observed_s")
    return reg


class TestRenderPrometheus:
    def test_counters_gauges_and_types(self):
        reg = Registry()
        reg.counter("site_exec", site="dot0").inc(5)
        reg.gauge("slo_burn_rate").set(1.25)
        parsed = parse_prometheus(render_prometheus(reg.snapshot()))
        assert parsed[("site_exec", (("site", "dot0"),))] == 5
        assert parsed[("slo_burn_rate", ())] == 1.25
        assert parsed["_types"]["site_exec"] == "counter"
        assert parsed["_types"]["slo_burn_rate"] == "gauge"

    def test_label_escaping_round_trips(self):
        names = ['shmap0/dot1 [dp=4,tp=2]', 'a"b', "back\\slash",
                 "new\nline"]
        reg = Registry()
        for n in names:
            reg.counter("site_exec", site=n).inc()
        parsed = parse_prometheus(render_prometheus(reg.snapshot()))
        for n in names:
            assert parsed[("site_exec", (("site", n),))] == 1

    def test_histogram_buckets_sum_count_quantiles(self):
        reg = Registry()
        h = reg.histogram("serve_ttft_s")
        for v in (0.002, 0.03, 0.04, 5.0):
            h.observe(v)
        parsed = parse_prometheus(render_prometheus(reg.snapshot()))
        assert parsed["_types"]["serve_ttft_s"] == "histogram"
        assert parsed[("serve_ttft_s_count", ())] == 4
        assert parsed[("serve_ttft_s_sum", ())] == pytest.approx(5.072)
        buckets = sorted(
            ((dict(k[1])["le"], v) for k, v in parsed.items()
             if isinstance(k, tuple) and k[0] == "serve_ttft_s_bucket"),
            key=lambda kv: float(kv[0]))
        counts = [v for _, v in buckets]
        assert counts == sorted(counts)
        assert buckets[-1][0] == "+Inf" and buckets[-1][1] == 4
        for q in ("0.5", "0.95", "0.99"):
            key = ("serve_ttft_s_quantile", (("quantile", q),))
            assert 0.002 <= parsed[key] <= 5.0

    def test_empty_and_name_sanitization(self):
        assert render_prometheus([]) == ""
        reg = Registry()
        reg.counter("bad-name.1").inc()
        assert "bad_name_1 1" in render_prometheus(reg.snapshot())

    def test_text_equals_reference(self):
        """Exact: the same registry operations render the same text,
        pushed sources (the ``src`` label) included."""
        ours = _registry_ops(Registry()).snapshot()
        theirs = _registry_ops(RegistryRef()).snapshot()
        pushed = [dict(s, src="train-proc1") for s in ours[:3]]
        assert render_prometheus(ours + pushed) == \
            render_prometheus_ref(theirs + pushed)
        assert render_prometheus(theirs) == render_prometheus_ref(ours)


class TestMetricsServer:
    def test_metrics_endpoint_parses(self, tmp_path):
        run = MetricsRun(tmp_path)
        run.registry.counter("site_exec",
                             site="shmap0/dot1 [dp=4,tp=2]").inc(3)
        srv = MetricsServer(run.registry, runs_dir=tmp_path).start()
        try:
            body = urllib.request.urlopen(
                f"{srv.url}/metrics").read().decode()
            parsed = parse_prometheus(body)
            key = ("site_exec", (("site", "shmap0/dot1 [dp=4,tp=2]"),))
            assert parsed[key] == 3
            health = json.loads(urllib.request.urlopen(
                f"{srv.url}/healthz").read())
            assert health["status"] == "ok"
            assert health["series"] == 1
            runs = json.loads(urllib.request.urlopen(
                f"{srv.url}/runs").read())
            assert runs["runs"][0]["run_id"] == run.run_id
            assert runs["runs"][0]["events_torn_lines"] == 0
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{srv.url}/nope")
            assert e.value.code == 404
        finally:
            srv.close()
            run.close()

    def test_push_aggregation(self):
        local = Registry()
        local.counter("steps").inc(2)
        srv = MetricsServer(local).start()
        try:
            worker = Registry()
            worker.counter("steps").inc(7)
            ack = push_snapshot(srv.url, "proc1", worker)
            assert ack["ok"] and ack["series"] == 1
            parsed = parse_prometheus(urllib.request.urlopen(
                f"{srv.url}/metrics").read().decode())
            assert parsed[("steps", ())] == 2
            assert parsed[("steps", (("src", "proc1"),))] == 7
            worker.counter("steps").inc(1)
            push_snapshot(srv.url, "proc1", worker)
            parsed = parse_prometheus(urllib.request.urlopen(
                f"{srv.url}/metrics").read().decode())
            assert parsed[("steps", (("src", "proc1"),))] == 8
            assert srv.sources() == ["proc1"]
        finally:
            srv.close()

    def test_bad_push_is_400(self):
        srv = MetricsServer(Registry()).start()
        try:
            req = urllib.request.Request(
                f"{srv.url}/push", data=b'{"metrics": 3}',
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 400
        finally:
            srv.close()

    def test_scrape_equals_reference_rendering(self):
        """A live scrape is the reference's rendering of the same
        registry, byte for byte."""
        srv = MetricsServer(_registry_ops(Registry())).start()
        try:
            body = urllib.request.urlopen(
                f"{srv.url}/metrics").read().decode()
        finally:
            srv.close()
        assert body == render_prometheus_ref(
            _registry_ops(RegistryRef()).snapshot())


class TestSLOTracker:
    def test_burn_rate_math(self):
        reg = Registry()
        slo = SLOTracker(registry=reg, objective=0.99, window_s=1e6)
        for i in range(99):
            assert slo.observe(0.1, 1.0, now=float(i)) == 0.0
        burn = slo.observe(5.0, 1.0, now=99.0)
        assert burn == pytest.approx(1.0)
        assert reg.gauge("slo_burn_rate").value == pytest.approx(1.0)
        assert reg.counter("slo_violations").value == 1
        assert reg.gauge("slo_window_requests").value == 100

    def test_no_target_not_observed(self):
        slo = SLOTracker(objective=0.99)
        assert slo.observe(10.0, None) is None
        assert slo.window_counts() == (0, 0)

    def test_window_pruning(self):
        slo = SLOTracker(objective=0.9, window_s=10.0)
        slo.observe(5.0, 1.0, now=0.0)
        assert slo.observe(0.1, 1.0, now=1.0) > 0
        assert slo.observe(0.1, 1.0, now=20.0) == 0.0

    def test_warn_page_edges_and_events(self, tmp_path):
        from repro_torch.obs import EventSink, read_events

        reg = Registry()
        sink = EventSink(tmp_path / "ev.jsonl")
        slo = SLOTracker(registry=reg, objective=0.5, window_s=1e6,
                         warn_burn=1.0, page_burn=1.9, sink=sink)
        for i in range(3):
            slo.observe(9.0, 1.0, now=float(i))
        sink.close()
        assert reg.counter("slo_warn").value == 1
        assert reg.counter("slo_page").value == 1
        levels = [e["level"] for e in read_events(tmp_path / "ev.jsonl")
                  if e["type"] == "slo"]
        assert "warn" in levels or "page" in levels

    def test_series_seeded_at_zero(self):
        reg = Registry()
        SLOTracker(registry=reg)
        parsed = parse_prometheus(render_prometheus(reg.snapshot()))
        assert parsed[("slo_burn_rate", ())] == 0.0

    def test_invalid_params(self):
        with pytest.raises(ValueError, match="objective"):
            SLOTracker(objective=1.0)
        with pytest.raises(ValueError, match="window_s"):
            SLOTracker(window_s=0)

    def test_scheduler_edf_reports_late_admission(self):
        class SpySLO:
            late = []

            def late_admission(self, overdue_s):
                self.late.append(overdue_s)

        sched = Scheduler(64, policy="edf", slo=SpySLO())
        req = Request(prompt=[1, 2], max_new_tokens=2,
                      latency_target_s=1e-9)
        sched.submit([req])
        assert sched.admit([0], lambda slot, r: True) == [(0, req)]
        assert len(SpySLO.late) == 1 and SpySLO.late[0] > 0

    def test_scheduler_fifo_does_not_report(self):
        class SpySLO:
            late = []

            def late_admission(self, overdue_s):
                self.late.append(overdue_s)

        sched = Scheduler(64, policy="fifo", slo=SpySLO())
        sched.submit([Request(prompt=[1], max_new_tokens=1,
                              latency_target_s=1e-9)])
        sched.admit([0], lambda slot, r: True)
        assert SpySLO.late == []

    def test_series_equal_reference(self):
        """Exact: one outcome sequence gives the same registry."""
        regs = []
        for tracker, reg in ((SLOTracker, Registry()),
                             (SLOTrackerRef, RegistryRef())):
            slo = tracker(registry=reg, objective=0.8, window_s=10.0,
                          warn_burn=1.0, page_burn=3.0)
            for i, lat in enumerate((0.1, 2.0, 0.3, 5.0, 5.0, 0.2, 0.1)):
                slo.observe(lat, 1.0, now=float(i * 3))
            slo.late_admission(0.5)
            regs.append(reg.snapshot())
        assert regs[0] == regs[1]


def _attrib_events(exec_counts, splits=None, n=256, mult=1, batch=1,
                   dtype="float32"):
    """site_decl + flushed exec counters + one hot-loop span."""
    splits = splits or {}
    events = []
    for site in exec_counts:
        events.append({"type": "site_decl", "site": site,
                       "offloaded": True,
                       "splits": splits.get(site, 6),
                       "m": n, "k": n, "n": n, "batch": batch,
                       "mult": mult, "dtype": dtype})
    for site, count in exec_counts.items():
        events.append({"type": "metric", "kind": "counter",
                       "name": "site_exec", "labels": {"site": site},
                       "value": count})
    events.append({"type": "span", "name": "train_step", "dur": 3e6})
    return events


def _hopper_time(m, k, n, s, problems, params=tile_model.DEFAULT_PARAMS):
    """The Hopper bound of one site, by hand: INT8 operations over the
    INT8 rate against device-memory bytes over the HBM rate."""
    pairs = s * (s + 1) // 2
    ops = 2.0 * m * k * n * pairs * problems
    tile = tile_model.k1_plan(m, k, n, s, tile_model.block_k_for(k))
    nbytes = tile_model.traffic(m, k, n, s, tile.block_m, tile.block_n,
                                tile_model.block_k_for(k)).total_v2
    return max(ops / params.int8_ops, nbytes * problems / params.hbm_bw)


#: The fixtures of the reference's TestAttrib, by name.
FIXTURES = {
    "ranking": dict(exec_counts={"dot0": 2, "scan0/dot1": 50,
                                 "shmap0/dot1": 10}),
    "splits": dict(exec_counts={"hi": 10, "lo": 10},
                   splits={"hi": 8, "lo": 3}),
    "demote": dict(exec_counts={"dot0": 4}, splits={"dot0": 6}),
    "floor": dict(exec_counts={"d": 1}, splits={"d": 2}),
    "publish": dict(exec_counts={"dot0": 5, "dot1": 1}),
}


class TestAttrib:
    def test_ranking_consistent_with_exec_counts(self):
        rows = attribution(_attrib_events(**FIXTURES["ranking"]))
        assert [r.site for r in rows] == ["scan0/dot1", "shmap0/dot1",
                                         "dot0"]
        assert [r.execs for r in rows] == [50, 10, 2]
        assert sum(r.wall_share for r in rows) == pytest.approx(1.0)
        assert sum(r.gemm_share for r in rows) == pytest.approx(1.0)
        assert sum(r.wall_s for r in rows) == pytest.approx(3.0)

    def test_model_costs_scale_with_splits(self):
        rows = attribution(_attrib_events(**FIXTURES["splits"]))
        hi = next(r for r in rows if r.site == "hi")
        lo = next(r for r in rows if r.site == "lo")
        assert hi.int8_gemms == pytest.approx(6 * lo.int8_gemms)
        assert hi.wall_share > lo.wall_share

    def test_demotion_suggestion(self):
        (row,) = attribution(_attrib_events(**FIXTURES["demote"]))
        assert row.demote_to == 4
        assert row.demote_save_gemms == pytest.approx(11 * 4)
        assert "s=6 -> s=4" in row.suggestion()
        assert "INT8 GEMMs" in row.suggestion()
        floor = attribution(_attrib_events(**FIXTURES["floor"]))[0]
        assert floor.demote_to == 1

    def test_publish_gauges(self):
        reg = Registry()
        rows = attribution(_attrib_events(**FIXTURES["publish"]))
        publish(rows, reg)
        parsed = parse_prometheus(render_prometheus(reg.snapshot()))
        key = ("attrib_wall_share", (("site", "dot0"),))
        assert parsed[key] == pytest.approx(rows[0].wall_share)
        assert ("attrib_int8_gemms", (("site", "dot1"),)) in parsed

    @pytest.mark.parametrize("name", sorted(FIXTURES))
    def test_counts_equal_reference(self, name):
        """Exact on the reference's fixtures (mult 1): the order, the
        executions, the INT8 GEMMs and their shares, the demotions."""
        events = _attrib_events(**FIXTURES[name])

        def key(rows):
            return [(r.site, r.splits, r.execs, r.int8_gemms, r.gemm_share,
                     r.demote_to, r.demote_save_gemms, r.demote_save_frac,
                     r.suggestion()) for r in rows]

        assert key(attribution(events)) == key(attribution_ref(events))

    @pytest.mark.parametrize("shape,counts,splits", [
        ((256, 256, 256), {"a": 2, "b": 50, "c": 10}, {}),
        ((512, 960, 2560), {"a": 3, "b": 3}, {"a": 6, "b": 3}),
        ((49152, 512, 960), {"a": 1, "b": 7}, {"a": 5, "b": 9})])
    def test_wall_share_is_the_hopper_formula(self, shape, counts, splits):
        m, k, n = shape
        events = _attrib_events(counts, splits)
        for ev in events:
            if ev["type"] == "site_decl":
                ev.update(m=m, k=k, n=n)
        rows = {r.site: r for r in attribution(events)}
        want = {site: _hopper_time(m, k, n, splits.get(site, 6), c)
                for site, c in counts.items()}
        total = sum(want.values())
        for site, t in want.items():
            assert rows[site].model_time_s == pytest.approx(t, rel=1e-12)
            assert rows[site].wall_share == pytest.approx(t / total,
                                                          rel=1e-12)
            assert rows[site].wall_s == pytest.approx(3.0 * t / total,
                                                      rel=1e-12)

    def test_loop_program_gemms_are_the_runs(self, tmp_path):
        """The invariant the trainer prints: over N executions of a
        program whose sites sit in a scan (``mult`` 3) and outside it,
        the attributed INT8 GEMMs sum to N * count_int8_gemms(sites).
        The reference's formula multiplies by ``mult`` once more."""
        rng = np.random.default_rng(2)
        c = torch.from_numpy(rng.standard_normal((128, 128)))
        xs = torch.from_numpy(rng.standard_normal((3, 128, 128)))

        def f(c, xs):
            y, _ = scan(lambda c, x: (torch.tanh(c @ x), None), c, xs)
            return y @ xs[0]

        pol = PrecisionPolicy(backend="fp64_int8", default_splits=5,
                              min_dim=64)
        run = MetricsRun(tmp_path)
        wrapped = offload(f, pol, on_site_event=run.site_event_handler())
        sites = wrapped.sites(c, xs)
        run.declare_sites(sites)
        for _ in range(2):
            with run.tracer.span("train_step"):
                wrapped(c, xs)
        run.close()
        events = load_runs(tmp_path)[run.run_id]
        assert [(s.name, s.mult) for s in sites] == [("scan0/dot0", 3),
                                                   ("dot0", 1)]
        rows = {r.site: r for r in attribution(events)}
        assert rows["scan0/dot0"].execs == 6 and rows["dot0"].execs == 2
        per_step = count_int8_gemms(sites)
        assert per_step == 4 * num_pair_gemms(5)
        assert sum(r.int8_gemms for r in rows.values()) == 2 * per_step
        ref_rows = {r.site: r for r in attribution_ref(events)}
        assert ref_rows["scan0/dot0"].int8_gemms == \
            3 * rows["scan0/dot0"].int8_gemms

    def test_cli_attrib_on_recorded_run(self, tmp_path):
        def f(a, b):
            return torch.sum(torch.tanh(a @ b) @ b)

        a = torch.ones((128, 128))
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=4,
                              min_dim=64)
        sites = site_report(f, pol)(a, a)
        run = MetricsRun(tmp_path)
        run.declare_sites(sites)
        handler = run.site_event_handler()
        for s in sites:
            if s.offloaded:
                handler({"site": s.name})
        with run.tracer.span("train_step"):
            pass
        run.close()
        out = io.StringIO()
        assert obs_main(["attrib", str(tmp_path)], out=out) == 0
        text = out.getvalue()
        assert "cost attribution" in text
        for s in sites:
            if s.offloaded:
                assert s.name in text
        assert "s=4 -> s=2" in text

    def test_cli_attrib_without_decls_fails(self, tmp_path):
        MetricsRun(tmp_path).close()
        out = io.StringIO()
        assert obs_main(["attrib", str(tmp_path)], out=out) == 1
        assert "no offloaded site_decl" in out.getvalue()


def _record_run(tmp_path, name, rows, drift=0, cls=MetricsRun):
    """One recorded metrics run with bench rows (+ numerics events)."""
    run = cls(tmp_path / name)
    for row_name, us, derived in rows:
        run.event("bench_row", name=row_name, us_per_call=us,
                  derived=derived, derived_num=parse_derived(derived))
    run.registry.counter("site_exec", site="dot0").inc(3)
    for i in range(drift):
        run.event("numerics", step=i, site="dot0", splits=4,
                  realized_rel=1e-2, budget=1e-6, drift=True)
    run.close()
    return str(tmp_path / name)


BASE_ROWS = [("lm_step_native", 100.0, "tiny;tokens=256"),
             ("kernel_v2_s6_128", 50.0,
              "hbm_read_reduction=3.50;pairs=21")]


class TestDiff:
    def test_identical_runs_pass(self, tmp_path):
        a = _record_run(tmp_path, "a", BASE_ROWS)
        b = _record_run(tmp_path, "b", BASE_ROWS)
        out = io.StringIO()
        rc = obs_main(["diff", a, b, "--check", "--max-ratio", "1.5"],
                      out=out)
        assert rc == 0
        assert "CHECK OK" in out.getvalue()
        assert "no regressions detected" in out.getvalue()

    def test_timing_regression_flagged(self, tmp_path):
        a = _record_run(tmp_path, "a", BASE_ROWS)
        b = _record_run(tmp_path, "b", [
            ("lm_step_native", 400.0, "tiny;tokens=256"), BASE_ROWS[1]])
        out = io.StringIO()
        assert obs_main(["diff", a, b, "--check"], out=out) == 0
        assert "slower in B" in out.getvalue()
        out = io.StringIO()
        rc = obs_main(["diff", a, b, "--check", "--max-ratio", "2.0"],
                      out=out)
        assert rc == 1
        assert "slowed 4.00x" in out.getvalue()

    def test_missing_row_and_new_skip(self, tmp_path):
        a = _record_run(tmp_path, "a", BASE_ROWS)
        b = _record_run(tmp_path, "b", [
            ("kernel_v2_s6_128", 0.0, "skipped=ImportError;pairs=21")])
        out = io.StringIO()
        assert obs_main(["diff", a, b, "--check"], out=out) == 1
        text = out.getvalue()
        assert "'lm_step_native'" in text and "missing" in text
        assert "skipped" in text

    def test_drift_increase_fails_check(self, tmp_path):
        a = _record_run(tmp_path, "a", BASE_ROWS, drift=0)
        b = _record_run(tmp_path, "b", BASE_ROWS, drift=2)
        out = io.StringIO()
        assert obs_main(["diff", a, b, "--check"], out=out) == 1
        assert "drift count" in out.getvalue()

    def test_vanished_counter_fails_check(self, tmp_path):
        a = _record_run(tmp_path, "a", BASE_ROWS)
        run = MetricsRun(tmp_path / "b")
        for row_name, us, derived in BASE_ROWS:
            run.event("bench_row", name=row_name, us_per_call=us,
                      derived=derived)
        run.close()
        out = io.StringIO()
        rc = obs_main(["diff", a, str(tmp_path / "b"), "--check"],
                      out=out)
        assert rc == 1
        assert "site_exec" in out.getvalue()

    def test_derived_num_round_trip(self):
        assert parse_derived(
            "hbm_read_reduction=3.50;pairs=21;backend=xla_cpu;"
            "modeled=18.76TFLOPS") == {
                "hbm_read_reduction": 3.5, "pairs": 21.0,
                "modeled": 18.76}
        report = diff_runs(
            [{"type": "bench_row", "name": "x", "us_per_call": 1.0,
              "derived": "pairs=21"}],
            [{"type": "bench_row", "name": "x", "us_per_call": 1.0,
              "derived": "pairs=10"}])
        (row,) = report.bench
        assert row.derived["pairs"] == (21.0, 10.0)

    def test_report_equals_reference(self, tmp_path):
        """Exact: two recorded runs (the port's and the reference's)
        give the same DiffReport and the same gate in both packages."""
        a = _record_run(tmp_path, "a", BASE_ROWS, cls=MetricsRunRef)
        b = _record_run(tmp_path, "b", [
            ("lm_step_native", 400.0, "tiny;tokens=256")], drift=1)
        ev_a = load_runs_ref(a)["0000"]
        ev_b = load_runs(b)["0000"]
        ours, theirs = diff_runs(ev_a, ev_b), diff_runs_ref(ev_a, ev_b)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.failures(2.0) == theirs.failures(2.0)
        assert len(ours.failures(2.0)) == 3


SMALL = dict(name="test_obs_live_serve", vocab_size=128, num_layers=1,
             d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
             d_ff=128)
# Wide enough that prefill waves of >= 128 tokens offload at min_dim=128.
WIDE = dict(name="test_obs_live_wide", vocab_size=128, num_layers=2,
            d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
            d_ff=256)


def _pair(arch):
    ref = ModelRef(LMConfigRef(**arch))
    params = ref.init_params(jax.random.PRNGKey(0))
    params["lm_head"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), params["lm_head"].shape, dtype=jnp.float32)
    port = Model(LMConfig(**arch), device="cpu")
    port.load_params(params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return ref, params, port


class TestEngineLiveMetrics:
    @pytest.fixture(scope="class")
    def small(self):
        return _pair(SMALL)[2]

    def test_live_engine_serves_metrics(self, small, tmp_path):
        run = MetricsRun(tmp_path)
        eng = Engine(small, small.params, batch_slots=2, max_len=64,
                     metrics=run, metrics_port=0, scheduler_policy="edf")
        try:
            url = eng.metrics_server.url
            assert url.startswith("http://127.0.0.1:")
            parsed = parse_prometheus(urllib.request.urlopen(
                f"{url}/metrics").read().decode())
            assert parsed[("slo_burn_rate", ())] == 0.0
            rng = np.random.default_rng(0)
            reqs = [Request(prompt=[int(t) for t in
                                    rng.integers(1, 128, 6)],
                            max_new_tokens=4, latency_target_s=60.0)
                    for _ in range(3)]
            eng.run(reqs)
            parsed = parse_prometheus(urllib.request.urlopen(
                f"{url}/metrics").read().decode())
            assert parsed[("serve_ttft_s_count", ())] == 3
            assert parsed[("serve_tokens", ())] == 12
            assert parsed[("slo_window_requests", ())] == 3
            assert parsed[("slo_burn_rate", ())] == 0.0
            assert parsed["_types"]["serve_ttft_s"] == "histogram"
            runs = json.loads(urllib.request.urlopen(
                f"{url}/runs").read())
            assert runs["runs"][0]["run_id"] == run.run_id
        finally:
            eng.close()
            run.close()
        assert eng.metrics_server is None
        eng.close()

    def test_slo_violation_burns(self, small, tmp_path):
        run = MetricsRun(tmp_path)
        eng = Engine(small, small.params, batch_slots=1, max_len=64,
                     metrics=run, slo_objective=0.5)
        eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2,
                         latency_target_s=1e-9)])
        run.close()
        reg = run.registry
        assert reg.counter("slo_violations").value == 1
        assert reg.counter("serve_latency_miss").value == 1
        assert reg.gauge("slo_burn_rate").value == pytest.approx(2.0)

    def test_metrics_port_requires_metrics(self, small):
        with pytest.raises(ValueError, match="metrics_port"):
            Engine(small, small.params, metrics_port=0)

    def test_offloaded_prefill_scrape_equals_reference(self, tmp_path):
        """Exact, timings aside: the same requests served under
        pallas_int8_4 (prefill waves of >= 128 tokens through the
        split-GEMM's plain version) give the reference's tokens, site
        declarations, per-site executions and scraped series; the
        executions are the site report's prediction."""
        ref, params, port = _pair(WIDE)
        rng = np.random.default_rng(5)
        prompts = [[int(t) for t in rng.integers(1, 128, n)]
                   for n in (140, 200, 9)]
        kw = dict(batch_slots=2, max_len=256, block_size=16)
        outs, scraped, shapes = {}, {}, []

        def body(run, pkg):
            if pkg == "ref":
                eng = EngineRef(ref, params, metrics=run, metrics_port=0,
                                policy=PolicyRef(backend="pallas_int8",
                                                 default_splits=4), **kw)
                reqs = [RequestRef(prompt=p, max_new_tokens=3)
                        for p in prompts]
            else:
                eng = Engine(port, port.params, metrics=run,
                             metrics_port=0,
                             policy=PrecisionPolicy(backend="pallas_int8",
                                                    default_splits=4), **kw)
                reqs = [Request(prompt=p, max_new_tokens=3)
                        for p in prompts]
                wave = eng.runner.prefill_wave

                def recorded():
                    res = wave()
                    if res is not None:
                        shapes.append((res.rows, res.width))
                    return res

                eng.runner.prefill_wave = recorded
            try:
                outs[pkg] = [r.out for r in eng.run(reqs)]
                scraped[pkg] = parse_prometheus(urllib.request.urlopen(
                    f"{eng.metrics_server.url}/metrics").read().decode())
            finally:
                eng.close()
            if pkg == "port":
                scraped["predicted"] = sum(
                    s.mult for shape in shapes
                    for s in eng.prefill_sites(*shape) if s.offloaded)

        ref_ev, port_ev = _pair_run(tmp_path, body)
        assert outs["port"] == outs["ref"]

        def decls(events):
            # The tile pick is each package's own (K1's plan tile on
            # Hopper); everything else of a declaration is shared.
            return [{k: v for k, v in e.items() if k not in ("t", "tiles")}
                    for e in events if e["type"] == "site_decl"]

        assert decls(port_ev) == decls(ref_ev) != []
        assert all(e["tiles"] for e in port_ev
                   if e["type"] == "site_decl" and e["offloaded"])
        execs = {k: v for k, v in scraped["port"].items()
                 if isinstance(k, tuple) and k[0] == "site_exec"}
        assert execs == {k: v for k, v in scraped["ref"].items()
                         if isinstance(k, tuple) and k[0] == "site_exec"}
        assert sum(execs.values()) == scraped["predicted"] > 0
        for key in (("serve_tokens", ()), ("serve_kv_blocks_hwm", ()),
                    ("serve_ttft_s_count", ()), ("slo_burn_rate", ())):
            assert scraped["port"][key] == scraped["ref"][key], key


def _pair_run(tmp_path, body):
    found = {}
    for pkg, cls, loader in (("ref", MetricsRunRef, load_runs_ref),
                             ("port", MetricsRun, load_runs)):
        run = cls(tmp_path / pkg)
        body(run, pkg)
        run.close()
        found[pkg] = loader(tmp_path / pkg)[run.run_id]
    return found["ref"], found["port"]
