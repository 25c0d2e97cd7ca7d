"""The trace's reductions on a synthetic trace."""

import pytest

from portbench import devtrace, readers


class _Trace:
    def __init__(self, kernels, start):
        self.kernels = kernels
        self.trace_start_ns = start
        self.host_start = {"time_ns": start + 5, "monotonic_ns": 17}


KERNELS = [("void (anonymous namespace)::split_gemm_kernel<1, 64, true>"
            "(CUtensorMap_st)", 100, 200),
           ("void at::native::vectorized_elementwise_kernel<4>(int)",
            150, 260),
           ("void (anonymous namespace)::split_gemm_kernel<1, 64, true>"
            "(CUtensorMap_st)", 400, 450),
           ("memcpy", 1000, 1010)]


def test_union_counts_overlap_once():
    assert devtrace.busy_seconds(KERNELS) == pytest.approx(
        (160 + 50 + 10) / 1e9)


def test_kernel_time_and_names():
    assert devtrace.kernel_seconds(KERNELS, "split_gemm_kernel") == (
        pytest.approx(150 / 1e9), 2)
    top = devtrace.top_ops(KERNELS)
    assert top[0] == ["split_gemm_kernel<1, 64, true>",
                      pytest.approx(150 / 1e9)]
    assert top[1][0] == "vectorized_elementwise_kernel<4>"


def test_idle_gaps_named_by_the_open_span():
    spans = devtrace.Spans()
    spans.closed.append(("step", {"time_ns": 500}, {"time_ns": 900}))
    spans.closed.append(("unit", {"time_ns": 0}, {"time_ns": 2000}))
    gaps = devtrace.idle_gaps(_Trace(KERNELS, 90), spans)
    assert gaps == [["step", pytest.approx(550 / 1e9)],
                    ["unit", pytest.approx(140 / 1e9)]]
    # No host clock near the profiler's: every gap is "host".
    far = _Trace(KERNELS, 90)
    far.host_start = {"time_ns": 10 ** 15}
    assert [g[0] for g in devtrace.idle_gaps(far, spans)] == ["host"] * 2


def test_readers_on_a_window():
    from types import SimpleNamespace

    host = SimpleNamespace(window_s=4e-6, work={"train_model_flops": 1979.0},
                           spans={"unit": [1e-6, 3e-6]})
    trace = SimpleNamespace(window_s=2e-6, kernels=KERNELS,
                            launches={"split_gemm": 2},
                            work={"train_real_gemms": 2,
                                  "train_k1_bound_s": 75e-9})
    ctx = SimpleNamespace(host=host, trace=trace)
    # Device metrics read the traced stretch, host-clock ones the
    # untraced window.
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 220 / 2000))
    assert readers.roofline(ctx, "train_k1_bound_s", "split_gemm_kernel",
                            "split_gemm", "train_real_gemms") == \
        pytest.approx(50.0)
    assert readers.mfu(ctx, "train_model_flops") == pytest.approx(
        100 * 1979.0 / (4e-6 * 1979e12))
    trace.launches = {"split_gemm": 3}
    with pytest.raises(RuntimeError):
        readers.roofline(ctx, "train_k1_bound_s", "split_gemm_kernel",
                         "split_gemm", "train_real_gemms")
    trace.kernels = None
    assert readers.idle_share(ctx) is None
