"""Port parity: repro_torch.obs against repro.obs — registry, tracer,
events, the offload's per-site hook, NumericsMonitor, serve metrics,
the report/export CLI and the logger.

Mirrors ``tests/test_obs.py`` class by class: each reference test is
held on the port, and where both packages can see the same inputs the
port's output is held against the reference's.  Exact: registry
snapshots, hook payloads (float32 and float64, a forward scan, the LM
train step), JSONL lines (timestamps, run ids, pids and durations
aside), the engine's tokens, ``serve_tokens`` and request events.
Within 1e-3 relative: ``NumericsMonitor.realized_rel``.  The port
differs from the reference in one documented place: under a gradient
taken outside the offloaded function, a loop-body site fires once per
iteration in the port and once per step in the reference (ROADMAP
section 3).
"""

import io
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LMConfig as LMConfigRef
from repro.configs import get_config as get_config_ref
from repro.core import PrecisionPolicy as PolicyRef
from repro.core import offload as offload_ref
from repro.core import site_report as site_report_ref
from repro.launch.train import build_train_step as build_train_step_ref
from repro.models import Model as ModelRef
from repro.obs import MetricsRun as MetricsRunRef
from repro.obs import NumericsMonitor as NumericsMonitorRef
from repro.obs import Registry as RegistryRef
from repro.obs import Tracer as TracerRef
from repro.obs import load_runs as load_runs_ref
from repro.obs import to_chrome as to_chrome_ref
from repro.serve import Engine as EngineRef
from repro.serve import Request as RequestRef
from repro.train import AdamW as AdamWRef
from repro.train import SyntheticText as SyntheticTextRef
from repro_torch.configs import LMConfig, get_config
from repro_torch.core import PrecisionPolicy, offload, scan, site_report
from repro_torch.launch.train import build_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, params_from_reference
from repro_torch.obs import (Logger, MetricsRun, NumericsMonitor, Registry,
                             Tracer, load_runs, read_events, to_chrome)
from repro_torch.obs.cli import main as obs_main
from repro_torch.obs.events import EventSink, json_safe
from repro_torch.serve import Engine, Request
from repro_torch.train import AdamW
from repro_torch.train.checkpoint import tree_flatten

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Keys whose values differ between two runs of one program: wall-clock
#: stamps, run ids, thread ids and every measured duration.
VOLATILE = {"t", "ts", "dur", "tid", "run_id", "ms", "admission_wait_s",
            "prefill_s", "ttft_s", "tokens_per_s", "uptime_s"}
#: Metrics whose values are timings.
TIMED = ("serve_admission_wait_s", "serve_prefill_s", "serve_ttft_s",
         "serve_latency_slack_s")


def _stable(events):
    """Event dicts without their volatile keys; timing metrics keep only
    their name, kind, labels and count."""
    out = []
    for ev in events:
        ev = {k: v for k, v in ev.items() if k not in VOLATILE}
        if ev.get("type") == "metric" and ev.get("name") in TIMED:
            ev = {k: ev[k] for k in ("type", "kind", "name", "labels",
                                     "count")}
        out.append(ev)
    return out


def _pair_run(tmp_path, body):
    """Run ``body(run, pkg)`` on a reference and a port MetricsRun in
    sibling directories; return both runs' event lists."""
    found = {}
    for pkg, cls, loader in (("ref", MetricsRunRef, load_runs_ref),
                             ("port", MetricsRun, load_runs)):
        run = cls(tmp_path / pkg)
        body(run, pkg)
        run.close()
        found[pkg] = loader(tmp_path / pkg)[run.run_id]
    return found["ref"], found["port"]


class TestRegistry:
    def test_counter_identity_and_inc(self):
        reg = Registry()
        c = reg.counter("site_exec", site="dot0")
        assert reg.counter("site_exec", site="dot0") is c
        assert reg.counter("site_exec", site="dot1") is not c
        c.inc()
        c.inc(2)
        assert c.value == 3
        with pytest.raises(ValueError, match=">= 0"):
            c.inc(-1)

    def test_gauge_set_add(self):
        g = Registry().gauge("occupancy")
        g.set(3)
        g.add(-1)
        assert g.value == 2.0

    def test_histogram_stats_and_buckets(self):
        h = Registry().histogram("lat_s")
        for v in (5e-7, 2.0, 5000.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 3
        assert snap["min"] == 5e-7 and snap["max"] == 5000.0
        assert snap["mean"] == pytest.approx(snap["sum"] / 3)
        buckets = dict((str(b), c) for b, c in snap["buckets"])
        assert buckets["1e-06"] == 1
        assert buckets["10.0"] == 1
        assert buckets["inf"] == 1
        assert sum(c for _, c in snap["buckets"]) == 3

    def test_histogram_quantiles(self):
        h = Registry().histogram("lat_s")
        assert h.quantile(0.5) is None
        for v in (0.01, 0.02, 0.03, 0.04, 9.0):
            h.observe(v)
        p50, p95, p99 = (h.quantile(q) for q in (0.5, 0.95, 0.99))
        assert 0.01 <= p50 <= p95 <= p99 <= 9.0
        assert p50 < 0.1
        assert p99 > 1.0
        snap = h.snapshot()
        assert snap["p50"] == pytest.approx(p50)
        assert snap["p95"] == pytest.approx(p95)
        assert snap["p99"] == pytest.approx(p99)
        for bad in (0.0, 1.5, -1.0):
            with pytest.raises(ValueError, match="quantile"):
                h.quantile(bad)

    def test_histogram_quantile_single_value(self):
        h = Registry().histogram("lat_s")
        h.observe(2.5)
        assert h.quantile(0.5) == 2.5
        assert h.quantile(0.99) == 2.5

    def test_kind_conflict_raises(self):
        reg = Registry()
        reg.counter("x", a="1")
        reg.gauge("x", a="2")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x", a="1")

    def test_snapshot_is_json_and_sorted(self):
        reg = Registry()
        reg.counter("b").inc()
        reg.gauge("a").set(1)
        snap = reg.snapshot()
        json.dumps(snap)
        assert [s["name"] for s in snap] == ["a", "b"]

    def test_counter_from_concurrent_threads(self):
        """The hook's case on the card: a backward site's handler runs
        on autograd's device thread while the caller's thread counts
        forward sites; no increment may be lost."""
        reg = Registry()

        def work():
            for _ in range(2000):
                reg.counter("site_exec", site="dot0").inc()

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert reg.counter("site_exec", site="dot0").value == 8000

    def test_snapshot_equals_reference(self):
        """Exact: the same operations give the same snapshot."""
        snaps = []
        for cls in (RegistryRef, Registry):
            reg = cls()
            reg.counter("site_exec", site="scan0/dot1").inc(7)
            reg.gauge("serve_slot_occupancy").set(3)
            reg.gauge("serve_slot_occupancy").add(-1)
            h = reg.histogram("serve_ttft_s")
            for v in (3e-7, 0.002, 0.03, 0.04, 5.0, 4e3):
                h.observe(v)
            reg.histogram("empty_s")
            snaps.append(reg.snapshot())
        assert snaps[0] == snaps[1]


class TestTracer:
    def test_span_nesting(self):
        tr = Tracer()
        with tr.span("outer", step=1):
            with tr.span("inner"):
                pass
        inner, outer = tr.events
        assert inner["name"] == "inner" and outer["name"] == "outer"
        assert inner["ts"] >= outer["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert outer["args"] == {"step": 1}

    def test_exception_flags_error_and_reraises(self):
        tr = Tracer()
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("x")
        assert tr.events[0]["args"]["error"] is True

    def test_streams_to_sink(self, tmp_path):
        sink = EventSink(tmp_path / "ev.jsonl")
        tr = Tracer(sink=sink)
        with tr.span("s"):
            pass
        sink.close()
        assert tr.events == []
        events = read_events(tmp_path / "ev.jsonl")
        assert [e["type"] for e in events] == ["span"]

    def test_chrome_trace_schema(self):
        tr = Tracer()
        with tr.span("work", k=1):
            pass
        doc = to_chrome(tr.events + [{"type": "step"}])
        json.dumps(doc)
        assert doc["displayTimeUnit"] == "ms"
        meta, ev = doc["traceEvents"]
        assert meta["ph"] == "M" and meta["name"] == "process_name"
        assert ev["ph"] == "X" and ev["pid"] == 1
        assert ev["name"] == "work" and ev["args"] == {"k": 1}
        assert isinstance(ev["ts"], float) and ev["dur"] >= 0.0

    def test_chrome_trace_keeps_error_flag(self):
        tr = Tracer()
        with pytest.raises(ValueError):
            with tr.span("load_ckpt", step=3):
                raise ValueError("corrupt")
        doc = to_chrome(tr.events)
        (ev,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert ev["args"] == {"step": 3, "error": True}

    def test_chrome_trace_concurrent_spans(self):
        tr = Tracer()
        gate = threading.Barrier(2)

        def work(name):
            with tr.span(name):
                gate.wait()
                with tr.span(f"{name}/inner"):
                    pass

        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("prefill", "decode")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        spans = [e for e in to_chrome(tr.events)["traceEvents"]
                 if e["ph"] == "X"]
        assert {s["name"] for s in spans} == {
            "prefill", "decode", "prefill/inner", "decode/inner"}
        tids = {s["name"]: s["tid"] for s in spans}
        assert tids["prefill"] != tids["decode"]
        assert tids["prefill"] == tids["prefill/inner"]
        assert tids["decode"] == tids["decode/inner"]

    def test_chrome_trace_equals_reference(self):
        """Exact, timestamps and thread ids aside: one event list gives
        the same Chrome trace in both packages."""
        events = [{"type": "span", "name": "train_step", "ts": 1.5,
                   "dur": 20.25, "tid": 7, "args": {"step": 1}},
                  {"type": "step", "loss": 2.0},
                  {"type": "span", "name": "prefill", "ts": 30.0,
                   "dur": 4.0, "tid": 9, "args": {"rows": 2}}]
        assert to_chrome(events) == to_chrome_ref(events)
        tr, tr_ref = Tracer(), TracerRef()
        for t in (tr, tr_ref):
            with t.span("outer", step=2):
                with t.span("inner"):
                    pass
        assert _stable(to_chrome(tr.events)["traceEvents"]) == \
            _stable(to_chrome_ref(tr_ref.events)["traceEvents"])


class TestEvents:
    def test_json_safe_coerces_numpy_and_torch(self):
        out = json_safe({"a": np.float32(1.5), "b": np.arange(2),
                         "c": (1, 2), "d": torch.float32,
                         "e": torch.tensor(2.5), "f": torch.arange(3)})
        json.dumps(out)
        assert out == {"a": 1.5, "b": [0, 1], "c": [1, 2],
                       "d": str(torch.float32), "e": 2.5,
                       "f": [0, 1, 2]}

    @pytest.mark.parametrize("dtype", ["float64", "complex128"])
    def test_site_decl_dtype_is_the_numpy_name(self, tmp_path, dtype):
        """Exact: a site record's dtype is written by its numpy name,
        as the reference writes ``s.dtype.name``."""
        a = (np.arange(128 * 128).reshape(128, 128) % 7).astype(dtype)

        def body(run, pkg):
            pol = (PolicyRef if pkg == "ref" else PrecisionPolicy)(
                backend="fp64_int8", default_splits=3, min_dim=64)
            if pkg == "ref":
                sites = site_report_ref(lambda x: x @ x, pol)(jnp.asarray(a))
            else:
                sites = site_report(lambda x: x @ x, pol)(
                    torch.from_numpy(a))
            run.declare_sites(sites)

        ref, port = _pair_run(tmp_path, body)
        (decl,) = [e for e in port if e["type"] == "site_decl"]
        assert decl["dtype"] == dtype
        assert _stable(port) == _stable(ref)

    def test_run_id_allocation(self, tmp_path):
        with MetricsRun(tmp_path) as r0:
            pass
        with MetricsRun(tmp_path) as r1:
            pass
        assert (r0.run_id, r1.run_id) == ("0000", "0001")
        assert sorted(load_runs(tmp_path)) == ["0000", "0001"]

    def test_site_event_handler_counts_and_declares_once(self, tmp_path):
        run = MetricsRun(tmp_path)
        handler = run.site_event_handler()
        for _ in range(3):
            handler({"site": "dot0", "backend": "fp64_int8_4"})
        handler({"site": "scan0/dot1"})
        run.close()
        events = load_runs(tmp_path)[run.run_id]
        execs = [e for e in events if e["type"] == "site_exec"]
        assert [e["site"] for e in execs] == ["dot0", "scan0/dot1"]
        counters = {(e["labels"]["site"]): e["value"]
                    for e in events if e["type"] == "metric"
                    and e["name"] == "site_exec"}
        assert counters == {"dot0": 3, "scan0/dot1": 1}
        types = [e["type"] for e in events]
        assert types[0] == "run_start" and types[-1] == "run_end"

    def test_read_events_skips_torn_line(self, tmp_path):
        path = tmp_path / "events-0000.jsonl"
        path.write_text('{"t": 1, "type": "step", "loss": 2.0}\n'
                        '{"t": 2, "type": "ru')
        events = read_events(path)
        assert len(events) == 1 and events[0]["loss"] == 2.0
        assert events.dropped == 1

    def test_read_events_counts_all_torn_lines(self, tmp_path):
        path = tmp_path / "events-0000.jsonl"
        path.write_text('{"type": "step", "loss": 2.0}\n'
                        'not json at all\n'
                        '[1, 2, 3]\n'
                        '{"type": "step", "loss": 1.0}\n')
        events = read_events(path)
        assert [e["loss"] for e in events] == [2.0, 1.0]
        assert events.dropped == 2

    def test_site_decl_carries_tile_choice(self, tmp_path):
        # Kernel-family sites declare the tile model's pick (K1's plan
        # tile on Hopper, so the numbers are the port's own); the
        # others declare tiles=None, as the reference.
        def f(a, b):
            return torch.sum(a @ b)

        a = torch.ones((128, 128), dtype=torch.float32)
        for backend, has_tiles in (("pallas_int8", True),
                                   ("fp64_int8", False)):
            pol = PrecisionPolicy(backend=backend, default_splits=4,
                                  min_dim=64)
            sites = site_report(f, pol)(a, a)
            with MetricsRun(tmp_path / backend) as run:
                run.declare_sites(sites)
            events = load_runs(tmp_path / backend)[run.run_id]
            (decl,) = [e for e in events if e["type"] == "site_decl"]
            if has_tiles:
                assert set(decl["tiles"]) == {"block_m", "block_n",
                                              "block_k", "pairs",
                                              "schedule"}
                assert decl["tiles"]["schedule"] == "ordered"
            else:
                assert decl["tiles"] is None

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_event_lines_equal_reference(self, tmp_path, dtype):
        """Exact, stamps aside: declarations, hook executions of a
        forward scan, step and numerics events, a span, the flushed
        registry and the run's envelope."""
        rng = np.random.default_rng(0)
        c = rng.standard_normal((128, 96)).astype(dtype)
        xs = rng.standard_normal((3, 96, 96)).astype(dtype)

        def f_ref(c, xs):
            return jax.lax.scan(lambda c, x: (jnp.tanh(c @ x), None),
                                c, xs)[0] @ xs[0]

        def f_port(c, xs):
            return scan(lambda c, x: (torch.tanh(c @ x), None),
                        c, xs)[0] @ xs[0]

        def body(run, pkg):
            if pkg == "ref":
                pol = PolicyRef(backend="fp64_int8", default_splits=3,
                                min_dim=64)
                args = (jnp.asarray(c), jnp.asarray(xs))
                wrapped = offload_ref(f_ref, pol,
                                      on_site_event=run.site_event_handler())
                run.declare_sites(site_report_ref(f_ref, pol)(*args))
                wrapped(*args)
                jax.effects_barrier()
            else:
                pol = PrecisionPolicy(backend="fp64_int8", default_splits=3,
                                      min_dim=64)
                args = (torch.from_numpy(c), torch.from_numpy(xs))
                wrapped = offload(f_port, pol,
                                  on_site_event=run.site_event_handler())
                run.declare_sites(site_report(f_port, pol)(*args))
                wrapped(*args)
            run.event("step", step=1, loss=3.5, ms=12.0, int8_gemms=24)
            run.event("numerics", step=1, site="dot0", splits=3,
                      realized_rel=1.5e-6, budget=3.8e-6, drift=False)
            with run.tracer.span("train_step", step=1):
                pass

        ref, port = _pair_run(tmp_path, body)
        assert _stable(port) == _stable(ref)
        assert sum(e["value"] for e in port if e["type"] == "metric"
                   and e["name"] == "site_exec") == 4


def _counter():
    counts = {}

    def handler(p):
        counts[p["site"]] = counts.get(p["site"], 0) + 1

    return counts, handler


class TestOnSiteEvent:
    """The intercept hook: offload(..., on_site_event=...)."""

    def test_scan_counts_per_iteration(self):
        counts, handler = _counter()

        def f(c, xs):
            return scan(lambda c, x: (c @ x, torch.sum(c)), c, xs)

        c = torch.ones((128, 128))
        xs = torch.ones((3, 128, 128))
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=2,
                              min_dim=64)
        wrapped = offload(f, pol, on_site_event=handler)
        wrapped(c, xs)
        # Forward: one firing per scan iteration, as the reference.
        assert counts == {"scan0/dot0": 3}
        assert [s.name for s in wrapped.sites(c, xs)] == ["scan0/dot0"]

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_payload_equals_reference(self, dtype):
        """Exact: the payload dicts of a plain and a scanned site."""
        rng = np.random.default_rng(1)
        a = rng.standard_normal((128, 96)).astype(dtype)
        b = rng.standard_normal((96, 128)).astype(dtype)
        xs = rng.standard_normal((2, 128, 128)).astype(dtype)
        got, want = [], []
        pol_ref = PolicyRef(backend="fp64_int8", default_splits=3,
                            min_dim=64)
        offload_ref(lambda a, b, xs: jax.lax.scan(
            lambda c, x: (c @ x, None), a @ b, xs)[0], pol_ref,
            on_site_event=want.append)(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(xs))
        jax.effects_barrier()
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=3,
                              min_dim=64)
        offload(lambda a, b, xs: scan(lambda c, x: (c @ x, None),
                                      a @ b, xs)[0], pol,
                on_site_event=got.append)(
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(xs))
        assert [p["site"] for p in got] == ["dot0", "scan0/dot0",
                                           "scan0/dot0"]
        assert got[0]["dtype"] == dtype and got[0]["k"] == 96
        assert got == json.loads(json.dumps(want))

    def test_payload_carries_static_site_facts(self):
        seen = []
        a = torch.ones((128, 96))
        b = torch.ones((96, 128))
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=3,
                              min_dim=64)
        offload(lambda a, b: torch.sum(a @ b), pol,
                on_site_event=seen.append)(a, b)
        (p,) = seen
        assert p["site"] == "dot0" and p["splits"] == 3
        assert p["backend"] == "fp64_int8"
        assert list(p["lhs_shape"]) == [128, 96] and p["k"] == 96
        assert p["dtype"] == "float32" and p["flops"] > 0

    def test_handler_gets_a_copy(self):
        seen = []

        def handler(p):
            p["site"] = "mangled"
            seen.append(p)

        a = torch.ones((128, 128))
        w = offload(lambda x: scan(lambda c, x: (c @ x, None), x,
                                   torch.stack([x, x]))[0],
                    PrecisionPolicy(backend="fp64_int8", min_dim=64),
                    on_site_event=handler)
        w(a)
        assert len(seen) == 2
        w(a)
        assert len(seen) == 4

    def test_non_offloaded_sites_do_not_fire(self):
        seen = []
        a = torch.ones((32, 32))
        offload(lambda a, b: torch.sum(a @ b), PrecisionPolicy(min_dim=64),
                on_site_event=seen.append)(a, a)
        assert seen == []

    def test_fires_under_external_grad(self):
        """A gradient after the offloaded call: the forward site fires
        once (the reference: at least once), its cotangents run through
        the forward site's engine and fire nothing."""
        counts, handler = _counter()
        a = (torch.ones((128, 128)) * 0.01).requires_grad_()
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=2,
                              min_dim=64)
        loss = offload(lambda a, b: torch.sum(torch.tanh(a @ b)), pol,
                       on_site_event=handler)(a, a)
        (g,) = torch.autograd.grad(loss, [a])
        assert g.shape == (128, 128)
        assert counts == {"dot0": 1}

    def test_loop_under_external_grad_counts_per_iteration(self):
        """The documented difference (ROADMAP section 3): a 3-iteration
        scan differentiated from outside fires 3 times in the port, once
        in the reference, whose zero-operand callback is hoisted out of
        the differentiated loop."""
        ref_counts, ref_handler = _counter()
        counts, handler = _counter()
        a = np.full((128, 128), 0.01, np.float32)
        xs = np.full((3, 128, 128), 0.01, np.float32)

        def f_ref(a, xs):
            return jnp.sum(jax.lax.scan(
                lambda c, x: (jnp.tanh(c @ x), None), a, xs)[0])

        jax.grad(offload_ref(f_ref, PolicyRef(
            backend="fp64_int8", default_splits=2, min_dim=64),
            on_site_event=ref_handler))(jnp.asarray(a), jnp.asarray(xs))
        jax.effects_barrier()
        at = torch.from_numpy(a).requires_grad_()
        loss = offload(lambda a, xs: torch.sum(scan(
            lambda c, x: (torch.tanh(c @ x), None), a, xs)[0]),
            PrecisionPolicy(backend="fp64_int8", default_splits=2,
                            min_dim=64),
            on_site_event=handler)(at, torch.from_numpy(xs))
        torch.autograd.grad(loss, [at])
        assert ref_counts == {"scan0/dot0": 1}
        assert counts == {"scan0/dot0": 3}

    def test_train_step_counts_equal_reference(self):
        """Exact: every site of the tiny LM's train step (the gradient
        taken inside the step, forward and backward scans) fires as
        often as the reference's, and the sum is the site report's
        executions."""
        tiny = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                    head_dim=16, d_ff=192, vocab_size=160)
        ref = ModelRef(get_config_ref("tiny").replace(**tiny))
        params = ref.init_params(jax.random.PRNGKey(0))
        port = Model(get_config("tiny").replace(**tiny), device="cpu")
        pparams = params_from_reference(
            jax.tree_util.tree_map(np.asarray, params), "cpu")
        batch = SyntheticTextRef(160, 24, 4).batch(0)
        ref_counts, ref_handler = _counter()
        counts, handler = _counter()
        opt_ref, opt = AdamWRef(lr=1e-3), AdamW(lr=1e-3)
        offload_ref(build_train_step_ref(ref, opt_ref), PolicyRef(
            backend="fp64_int8", default_splits=3, min_dim=32),
            on_site_event=ref_handler)(params, opt_ref.init(params),
                                       jnp.asarray(batch))
        jax.effects_barrier()
        wrapped = offload(build_train_step(port, opt), PrecisionPolicy(
            backend="fp64_int8", default_splits=3, min_dim=32),
            on_site_event=handler)
        state = opt.init(pparams)
        batch_t = torch.from_numpy(batch)
        wrapped(pparams, state, batch_t)
        assert counts == ref_counts
        sites = wrapped.sites(pparams, state, batch_t)
        assert sum(counts.values()) == sum(
            s.batch * s.mult for s in sites if s.offloaded) == 45


class TestNumericsMonitor:
    @staticmethod
    def _fn(a, b):
        return torch.sum(a @ b)

    @staticmethod
    def _fn_ref(a, b):
        return jnp.sum(a @ b)

    @pytest.fixture(scope="class")
    def operands(self):
        rng = np.random.default_rng(0)
        return (rng.standard_normal((128, 128)).astype(np.float32),
                rng.standard_normal((128, 128)).astype(np.float32))

    def test_healthy_no_drift(self, operands):
        a, b = (torch.from_numpy(x) for x in operands)
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=6,
                              min_dim=64)
        mon = NumericsMonitor(self._fn, policy=pol, budget=1e-3)
        report = mon.check(0, a, b)
        assert report.site == "dot0" and report.splits == 6
        assert 0 < report.realized_rel < 1e-3
        assert report.drift is False

    def test_stale_plan_drifts_and_records(self, operands, tmp_path):
        a, b = (torch.from_numpy(x) for x in operands)
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=1,
                              min_dim=64)
        run = MetricsRun(tmp_path)
        stream = io.StringIO()
        mon = NumericsMonitor(self._fn, policy=pol, budget=1e-9,
                              registry=run.registry, sink=run.sink,
                              log=Logger("numerics", stream=stream))
        report = mon.check(7, a, b)
        assert report.drift is True
        assert report.realized_rel > 1e-9
        assert "WARNING: numerics drift at step 7" in stream.getvalue()
        assert "re-tune" in stream.getvalue()
        gauge = run.registry.gauge("numerics_realized_rel", site="dot0")
        assert gauge.value == pytest.approx(report.realized_rel)
        assert run.registry.counter("numerics_drift",
                                    site="dot0").value == 1
        run.close()
        events = load_runs(tmp_path)[run.run_id]
        (num,) = [e for e in events if e["type"] == "numerics"]
        assert num["step"] == 7 and num["drift"] is True

    def test_probe_never_perturbs_output(self, operands):
        a, b = (torch.from_numpy(x) for x in operands)
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=1,
                              min_dim=64)
        mon = NumericsMonitor(self._fn, policy=pol, budget=1e-9)
        mon.check(0, a, b)
        assert torch.equal(mon._wrapped(a, b), self._fn(a, b))

    def test_maybe_check_period(self, operands):
        a, b = (torch.from_numpy(x) for x in operands)
        pol = PrecisionPolicy(backend="fp64_int8", default_splits=4,
                              min_dim=64)
        mon = NumericsMonitor(self._fn, policy=pol, budget=1.0, every=3)
        assert mon.maybe_check(1, a, b) is None
        assert mon.maybe_check(2, a, b) is None
        assert mon.maybe_check(3, a, b) is not None
        mon.every = 0
        assert mon.maybe_check(3, a, b) is None

    def test_requires_plan_or_policy(self):
        with pytest.raises(ValueError, match="plan or a policy"):
            NumericsMonitor(self._fn)

    @pytest.mark.parametrize("splits", [1, 3, 6])
    def test_realized_rel_equals_reference(self, operands, splits):
        """Within 1e-3 relative: the same program and operands give the
        reference's realized error, probe site and budget (32 float32
        ulps without a plan)."""
        a, b = operands
        mon_ref = NumericsMonitorRef(self._fn_ref, policy=PolicyRef(
            backend="fp64_int8", default_splits=splits, min_dim=64))
        want = mon_ref.check(0, jnp.asarray(a), jnp.asarray(b))
        mon = NumericsMonitor(self._fn, policy=PrecisionPolicy(
            backend="fp64_int8", default_splits=splits, min_dim=64))
        got = mon.check(0, torch.from_numpy(a), torch.from_numpy(b))
        assert (got.site, got.splits, got.drift) == (
            want.site, want.splits, want.drift)
        assert got.budget == want.budget
        assert got.realized_rel == pytest.approx(want.realized_rel,
                                                 rel=1e-3)

    def test_check_leaves_the_callers_state(self):
        """The monitored pass of a train step reads the parameters and
        the optimizer state and writes neither."""
        tiny = dict(num_layers=1, d_model=64, num_heads=2, num_kv_heads=1,
                    head_dim=32, d_ff=128, vocab_size=128)
        model = Model(get_config("tiny").replace(**tiny), device="cpu",
                      seed=0)
        with torch.no_grad():   # a nonzero head: nonzero cotangents
            model.lm_head.copy_(0.1 * torch.randn(
                model.lm_head.shape,
                generator=torch.Generator().manual_seed(1)))
        opt = AdamW(lr=1e-2)
        params = model.params
        state = opt.init(params)
        before = [t.clone() for t in tree_flatten((params, state))]
        batch = torch.from_numpy(SyntheticTextRef(128, 16, 2).batch(0))
        mon = NumericsMonitor(build_train_step(model, opt),
                              policy=PrecisionPolicy(
                                  backend="fp64_int8", default_splits=4,
                                  min_dim=32))
        report = mon.check(0, params, state, batch)
        assert report.site != "<none>" and report.realized_rel > 0
        after = tree_flatten((params, state))
        assert all(torch.equal(x, y) for x, y in zip(before, after))


SMALL = dict(name="test_obs_serve", vocab_size=128, num_layers=1,
             d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
             d_ff=128)


def _small_pair():
    ref = ModelRef(LMConfigRef(**SMALL))
    params = ref.init_params(jax.random.PRNGKey(0))
    port = Model(LMConfig(**SMALL), device="cpu")
    port.load_params(params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return ref, params, port


class TestServeMetrics:
    @pytest.fixture(scope="class")
    def models(self):
        return _small_pair()

    @staticmethod
    def _prompts():
        rng = np.random.default_rng(0)
        return [[int(t) for t in rng.integers(1, 128, n)]
                for n in (3, 7, 12)]

    def test_per_request_metrics(self, models, tmp_path):
        model = models[2]
        run = MetricsRun(tmp_path)
        eng = Engine(model, model.params, batch_slots=2, max_len=64,
                     metrics=run)
        done = eng.run([Request(prompt=p, max_new_tokens=5)
                        for p in self._prompts()])
        run.close()
        assert all(len(r.out) == 5 for r in done)
        events = load_runs(tmp_path)[run.run_id]
        reqs = [e for e in events if e["type"] == "request"]
        assert sorted(e["prompt_len"] for e in reqs) == [3, 7, 12]
        for ev in reqs:
            assert ev["new_tokens"] == 5
            assert ev["decode_ticks"] == 4
            assert ev["ttft_s"] is not None and ev["ttft_s"] >= 0
            assert ev["admission_wait_s"] >= 0
            assert ev["prefill_s"] > 0
            assert ev["tokens_per_s"] > 0
        metric = {e["name"]: e for e in events if e["type"] == "metric"}
        assert metric["serve_tokens"]["value"] == 15
        assert metric["serve_slot_occupancy"]["value"] == 0
        assert metric["serve_ttft_s"]["count"] == 3
        spans = {e["name"] for e in events if e["type"] == "span"}
        assert {"prefill", "decode_tick"} <= spans

    def test_metrics_off_is_untouched(self, models):
        model = models[2]
        eng = Engine(model, model.params, batch_slots=1, max_len=64)
        (done,) = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=3)])
        assert len(done.out) == 3

    def test_equals_reference_engine(self, models, tmp_path):
        """Exact: the reference's SMALL engine test through both
        packages — the served tokens, every request event (durations
        aside), the flushed counters and gauges, and the span names in
        order."""
        ref, params, port = models
        outs = {}

        def body(run, pkg):
            if pkg == "ref":
                eng = EngineRef(ref, params, batch_slots=2, max_len=64,
                                metrics=run)
                reqs = [RequestRef(prompt=p, max_new_tokens=5)
                        for p in self._prompts()]
            else:
                eng = Engine(port, port.params, batch_slots=2, max_len=64,
                             metrics=run)
                reqs = [Request(prompt=p, max_new_tokens=5)
                        for p in self._prompts()]
            outs[pkg] = [r.out for r in eng.run(reqs)]

        ref_ev, port_ev = _pair_run(tmp_path, body)
        assert outs["port"] == outs["ref"]

        def pick(events, kind):
            return [e for e in _stable(events) if e["type"] == kind]

        for kind in ("request", "metric", "run_start", "run_end"):
            assert pick(port_ev, kind) == pick(ref_ev, kind), kind
        assert [e["name"] for e in port_ev if e["type"] == "span"] == \
            [e["name"] for e in ref_ev if e["type"] == "span"]
        assert [e for e in pick(port_ev, "metric")
                if e["name"] == "serve_tokens"][0]["value"] == 15


def _seed_run(tmp_path, with_execs=True):
    """A metrics dir with real Site declarations (+ optional execs)."""

    def f(a, b):
        return torch.sum(torch.tanh(a @ b) @ b)

    a = torch.ones((128, 128))
    pol = PrecisionPolicy(backend="fp64_int8", default_splits=4,
                          min_dim=64)
    sites = site_report(f, pol)(a, a)
    run = MetricsRun(tmp_path)
    run.declare_sites(sites)
    if with_execs:
        handler = run.site_event_handler()
        for s in sites:
            if s.offloaded:
                handler({"site": s.name})
    run.event("step", step=1, loss=3.5, ms=12.0, int8_gemms=20)
    run.event("numerics", step=1, site="dot0", splits=4,
              realized_rel=1.5e-6, budget=3.8e-6, drift=False)
    with run.tracer.span("train_step", step=1):
        pass
    run.close()
    return run.run_id, sites


class TestCli:
    def test_report_tables(self, tmp_path):
        run_id, sites = _seed_run(tmp_path)
        out = io.StringIO()
        rc = obs_main(["report", str(tmp_path)], out=out)
        text = out.getvalue()
        assert rc == 0
        assert f"run {run_id}:" in text
        for s in sites:
            assert s.name in text
        assert "int8_gemms/step" in text
        assert "train_step" in text
        assert "1.500e-06" in text

    def test_check_passes_with_execs(self, tmp_path):
        _seed_run(tmp_path)
        out = io.StringIO()
        assert obs_main(["report", str(tmp_path), "--check"],
                        out=out) == 0
        assert "CHECK OK" in out.getvalue()

    def test_check_fails_without_execs(self, tmp_path):
        _seed_run(tmp_path, with_execs=False)
        out = io.StringIO()
        assert obs_main(["report", str(tmp_path), "--check"],
                        out=out) == 1
        assert "recorded no executions" in out.getvalue()

    def test_check_fails_on_run_without_decls(self, tmp_path):
        MetricsRun(tmp_path).close()
        out = io.StringIO()
        assert obs_main(["report", str(tmp_path), "--check"],
                        out=out) == 1
        assert "no site_decl events" in out.getvalue()

    def test_run_selection(self, tmp_path):
        first, _ = _seed_run(tmp_path)
        MetricsRun(tmp_path).close()
        out = io.StringIO()
        obs_main(["report", str(tmp_path)], out=out)
        assert "run 0001:" in out.getvalue()
        out = io.StringIO()
        obs_main(["report", str(tmp_path), "--run", first], out=out)
        assert f"run {first}:" in out.getvalue()
        out = io.StringIO()
        obs_main(["report", str(tmp_path), "--all"], out=out)
        assert "run 0000:" in out.getvalue()
        assert "run 0001:" in out.getvalue()
        with pytest.raises(SystemExit):
            obs_main(["report", str(tmp_path), "--run", "9999"],
                     out=io.StringIO())

    def test_report_surfaces_torn_lines(self, tmp_path):
        run_id, _ = _seed_run(tmp_path)
        with (tmp_path / f"events-{run_id}.jsonl").open("a") as f:
            f.write('{"type": "ru')
        out = io.StringIO()
        assert obs_main(["report", str(tmp_path)], out=out) == 0
        assert "1 torn line(s) dropped" in out.getvalue()

    def test_report_latency_quantile_table(self, tmp_path):
        run = MetricsRun(tmp_path)
        h = run.registry.histogram("serve_ttft_s")
        for v in (0.01, 0.02, 0.03, 4.0):
            h.observe(v)
        run.close()
        out = io.StringIO()
        assert obs_main(["report", str(tmp_path)], out=out) == 0
        text = out.getvalue()
        assert "serve latency quantiles" in text
        assert "p50" in text and "p95" in text and "p99" in text
        assert "serve_ttft_s" in text

    def test_export_writes_chrome_trace(self, tmp_path):
        _seed_run(tmp_path / "metrics")
        target = tmp_path / "trace.json"
        out = io.StringIO()
        rc = obs_main(["export", str(tmp_path / "metrics"),
                       "-o", str(target)], out=out)
        assert rc == 0
        doc = json.loads(target.read_text())
        assert doc["traceEvents"][0]["ph"] == "M"
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert [s["name"] for s in spans] == ["train_step"]

    def test_empty_dir_errors(self, tmp_path):
        with pytest.raises(SystemExit, match="no events"):
            obs_main(["report", str(tmp_path)], out=io.StringIO())

    def test_report_equals_reference_cli(self, tmp_path):
        """The CLI reads files only: on one recorded run both packages
        print the same report."""
        from repro.obs.cli import main as obs_main_ref

        _seed_run(tmp_path)
        texts = []
        for fn in (obs_main, obs_main_ref):
            out = io.StringIO()
            assert fn(["report", str(tmp_path), "--check"], out=out) == 0
            texts.append(out.getvalue())
        assert texts[0] == texts[1]

    def test_trainer_telemetry_on_by_default(self, tmp_path):
        """The trainer on the CPU writes a run into <ckpt-dir>/metrics
        unasked; ``python -m repro_torch.obs report <dir> --check``
        exits 0 over it; ``--metrics-dir none`` writes none."""
        cli = ["--arch", "tiny", "--overrides", json.dumps({
            "num_layers": 1, "d_model": 64, "num_heads": 2,
            "num_kv_heads": 1, "head_dim": 32, "d_ff": 128,
            "vocab_size": 128}), "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--log-every", "100",
            "--backend", "pallas_int8_4", "--min-dim", "32",
            "--numerics-every", "1"]
        report = {}
        train_main(cli + ["--ckpt-dir", str(tmp_path / "on")],
                   device="cpu", report=report)
        metrics = tmp_path / "on" / "metrics"
        assert report["metrics_dir"] == str(metrics)
        events = load_runs(metrics)["0000"]
        kinds = [e["type"] for e in events]
        assert kinds[:2] == ["run_start", "config"]
        assert kinds.count("step") == 2 and kinds.count("numerics") == 2
        spans = [e for e in events if e["type"] == "span"]
        assert [s["name"] for s in spans] == ["train_step"] * 2
        execs = sum(e["value"] for e in events if e["type"] == "metric"
                    and e["name"] == "site_exec")
        assert execs == 2 * sum(s.batch * s.mult for s in report["sites"]
                                if s.offloaded)
        assert all(not e["drift"] for e in events
                   if e["type"] == "numerics")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "report",
             str(metrics), "--check"], capture_output=True, text=True,
            env=env, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "CHECK OK" in proc.stdout
        train_main(cli + ["--ckpt-dir", str(tmp_path / "off"),
                          "--metrics-dir", "none"], device="cpu")
        assert not (tmp_path / "off" / "metrics").exists()


class TestLogger:
    def test_level_filtering(self, monkeypatch):
        stream = io.StringIO()
        log = Logger("t", stream=stream)
        monkeypatch.setenv("REPRO_LOG_LEVEL", "WARNING")
        log.info("hidden")
        log.warning("shown")
        monkeypatch.setenv("REPRO_LOG_LEVEL", "DEBUG")
        log.debug("now visible")
        assert stream.getvalue().splitlines() == [
            "[t] WARNING: shown", "[t] now visible"]

    def test_info_renders_like_legacy_prints(self):
        stream = io.StringIO()
        Logger("serve", stream=stream).info("OK (3 requests)")
        assert stream.getvalue() == "[serve] OK (3 requests)\n"

    def test_attach_sink_tees(self, tmp_path):
        sink = EventSink(tmp_path / "ev.jsonl")
        log = Logger("train", stream=io.StringIO())
        log.attach_sink(sink)
        log.warning("drift!")
        sink.close()
        (ev,) = read_events(tmp_path / "ev.jsonl")
        assert ev == {**ev, "type": "log", "level": "WARNING",
                      "logger": "train", "msg": "drift!"}

    def test_get_logger_caches(self):
        from repro_torch.obs import get_logger, reset_logger
        a = get_logger("test_torch_obs_cache")
        assert get_logger("test_torch_obs_cache") is a
        b = reset_logger("test_torch_obs_cache")
        assert b is not a

    def test_renders_as_the_reference(self, capsys):
        """The CLIs' stderr lines are the reference's, level by level."""
        from repro.obs.log import Logger as LoggerRef

        for cls in (Logger, LoggerRef):
            for level in ("info", "warning", "error"):
                getattr(cls("train"), level)("step 1/4 loss=2.0000")
        err = capsys.readouterr().err.splitlines()
        assert err[:3] == err[3:] and len(err) == 6
