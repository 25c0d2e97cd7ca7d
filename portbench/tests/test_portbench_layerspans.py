"""The program's layer spans over the device trace (``layerspans.py``):
the clock mapping, the gaps' names and the readings, on synthetic
intervals and on real host clocks; on the card, one short traced run
whose K1 launches must all map into ``ozaki.kernel`` spans.

    python3 -m pytest -q -p no:cacheprovider portbench/tests
"""

import time
from types import SimpleNamespace

import pytest
from conftest import tiny_spec

from portbench import devtrace, harness, layerspans
from repro_torch.obs import trace


def _spans(*rows):
    """Program spans from (name, start, end[, tid]) rows."""
    return [(r[0], r[1], r[2], r[3] if len(r) > 3 else 1) for r in rows]


@pytest.mark.parametrize("clock", ["perf_counter_ns", "time_ns",
                                   "monotonic_ns"])
def test_a_program_span_maps_inside_its_unit(clock):
    """A span the program opens inside a harness unit lies inside that
    unit on the profiler's clock, whichever host clock it stamps with."""
    tracer = trace.Tracer()
    harness_spans = devtrace.Spans()
    start = devtrace.Spans.now()
    fake = SimpleNamespace(host_start=start, trace_start_ns=start[clock])

    def step():
        time.sleep(0.001)
        with trace.activate(tracer):
            with trace.span("train.step"):
                time.sleep(0.002)
        time.sleep(0.001)

    harness_spans.wrap("unit", step)()
    (name, s, e, _), = layerspans.program_spans(
        tracer.events, tracer.t0_ns, layerspans.clock_offset(fake))
    _, unit_start, unit_end = harness_spans.closed[0]
    assert name == "train.step"
    assert unit_start[clock] < s < e < unit_end[clock]
    assert e - s >= 2_000_000


def test_no_clock_near_the_profiler_maps_nothing():
    fake = SimpleNamespace(host_start=devtrace.Spans.now(),
                           trace_start_ns=10 ** 15)
    assert layerspans.clock_offset(fake) is None


KERNELS = [("elementwise", 100, 200), ("split_gemm_kernel<1, 64>", 300, 400),
           ("elementwise", 500, 600), ("elementwise", 900, 950)]


class _Trace:
    kernels = KERNELS
    trace_start_ns = 0
    host_start = {"time_ns": 0}


def test_idle_gaps_named_by_the_innermost_program_span():
    harness_spans = devtrace.Spans()
    harness_spans.closed.append(("unit", {"time_ns": 0}, {"time_ns": 800}))
    program = _spans(("train.step", 150, 620),
                     ("ozaki", 180, 320), ("ozaki.kernel", 240, 260, 7))
    gaps = layerspans.idle_gaps(_Trace(), harness_spans, program)
    # Gaps by length: 600-900 (middle 750: only the unit is open),
    # 200-300 (middle 250: ozaki.kernel, on another thread, began last),
    # 400-500 (middle 450: train.step).
    assert gaps == [["unit", pytest.approx(300 / 1e9)],
                    ["ozaki.kernel", pytest.approx(100 / 1e9)],
                    ["train.step", pytest.approx(100 / 1e9)]]
    # No program span and no harness span open: "host", as before.
    assert [g[0] for g in layerspans.idle_gaps(
        _Trace(), devtrace.Spans(), [])] == ["host"] * 3
    # The harness's own naming is left as it was.
    assert [g[0] for g in devtrace.idle_gaps(_Trace(), harness_spans)] \
        == ["unit"] * 3


def test_innermost_takes_the_span_begun_last():
    program = _spans(("outer", 0, 100), ("a", 10, 50), ("b", 20, 30, 2),
                     ("c", 60, 200, 3))
    assert layerspans.innermost(program, [25, 40, 5, 70, 150, 300]) == [
        "b", "a", "outer", "c", "c", None]


def test_ozaki_host_ms_holds_three_counts():
    program = _spans(("ozaki", 0, 2_000_000), ("ozaki", 5_000_000,
                                               6_000_000),
                     ("ozaki.slice", 0, 1_000_000))
    assert layerspans.ozaki_host_ms(program, 2, 2) == pytest.approx(1.5)
    with pytest.raises(RuntimeError):
        layerspans.ozaki_host_ms(program, 3, 2)
    with pytest.raises(RuntimeError):
        layerspans.ozaki_host_ms(program, 2, 1)
    assert layerspans.ozaki_host_ms([], 0, 0) is None


def test_offload_site_us_is_self_time():
    program = _spans(("offload.site", 0, 10_000), ("ozaki", 2_000, 8_000),
                     ("offload.site", 20_000, 24_000, 2),
                     ("ozaki", 21_000, 23_000, 2),
                     ("ozaki", 20_500, 20_600, 3))   # another thread's
    assert layerspans.offload_site_us(program) == pytest.approx(
        (4_000 + 2_000) / 2 / 1e3)
    assert layerspans.offload_site_us(_spans(("ozaki", 0, 1))) is None


def test_slicing_device_ms_by_correlation_not_by_name():
    ops = [("elementwise", 1000, 1500, 1),       # launched in a slice
           ("elementwise", 2000, 2600, 2),       # the model's own
           ("split_gemm_kernel<1, 64>", 3000, 4000, 3),
           ("elementwise", 4000, 4300, 4)]       # launched in a slice
    launches = {1: 15, 2: 45, 3: 25, 4: 12}
    program = _spans(("ozaki", 10, 30), ("ozaki.slice", 11, 20),
                     ("ozaki.kernel", 21, 29), ("train.forward", 0, 50))
    assert layerspans.slicing_device_ms(ops, launches, program, 2) == \
        pytest.approx(800 / 2 / 1e6)
    launches[3] = 35   # K1 launched outside its span: the mapping is off
    with pytest.raises(RuntimeError):
        layerspans.slicing_device_ms(ops, launches, program, 2)
    assert layerspans.slicing_device_ms(ops, {}, program, 2) is None


def test_idle_in_ozaki_share():
    program = _spans(("ozaki", 150, 350), ("ozaki.combine", 410, 480),
                     ("ozaki", 405, 490), ("train.optimizer", 700, 800))
    # Gaps 200-300 (ozaki), 400-500 (ozaki.combine), 600-900 (the
    # optimizer at 750).
    assert layerspans.idle_in_ozaki_share(KERNELS, program) == \
        pytest.approx(100 * 200 / 500)
    assert layerspans.idle_in_ozaki_share(KERNELS, []) is None


@pytest.mark.parametrize("traced", [False, True])
def test_a_run_leaves_the_tracer_inactive(traced, monkeypatch):
    """The harness activates no program tracer: every unit of a run,
    traced or not, runs with none active (on the CPU, where a traced
    run has no device trace)."""
    spec = tiny_spec("smollm360m-train-s6")
    seen = []
    load = harness.load_driver

    def spying(*args):
        driver = load(*args)
        unit = driver.unit

        def watched():
            seen.append(trace.active())
            unit()
        driver.unit = watched
        return driver

    monkeypatch.setattr(harness, "load_driver", spying)
    res = harness.run_cell(spec, 2 ** 31 + 5, 0.2, traced, device="cpu")
    assert seen and all(t is None for t in seen)
    assert trace.active() is None
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_k1_launches_map_into_ozaki_kernel_spans(cuda_device):
    """A short traced stretch of the LM cell at a small size: every K1
    launch lies inside an ``ozaki.kernel`` span on the profiler's
    clock, the ``ozaki`` spans count the program's K1 launches and the
    shapes' GEMMs, and the readings are in range."""
    from repro_torch.kernels import ops

    spec = tiny_spec("smollm360m-train-s6")
    driver = harness.load_driver(spec, 2 ** 31 + 23, cuda_device)
    driver.setup()
    work0, launched0 = driver.work(), ops.LAUNCHES["split_gemm"]
    tracer, device = trace.Tracer(), layerspans.LaunchTrace()
    device.start()
    with trace.activate(tracer):
        for _ in range(3):
            driver.unit()
    device.stop()
    assert device.ops and device.launches, "the trace holds no launches"
    spans = layerspans.program_spans(tracer.events, tracer.t0_ns,
                                     layerspans.clock_offset(device))
    gemms = driver.work()["train_real_gemms"] - work0["train_real_gemms"]
    host_ms = layerspans.ozaki_host_ms(
        spans, ops.LAUNCHES["split_gemm"] - launched0, gemms)
    assert 0 < host_ms < 100
    assert 0 < layerspans.slicing_device_ms(device.ops, device.launches,
                                            spans, 3) < 1000
    assert 0 < layerspans.offload_site_us(spans) < 1e5
    assert 0 <= layerspans.idle_in_ozaki_share(device.kernels, spans) \
        <= 100
    driver.release()
