"""The expert-model cell (``mellum2-ep8-train-s6``): its driver's
comparison at a CPU size, a planted fault, the work counted from shapes
and from the program's expert counter, and (on the card) the TF32
control against the committed limits.

    python3 -m pytest -p no:cacheprovider portbench/tests/test_portbench_moe.py
"""

import json
from collections import Counter

import pytest
import torch
from conftest import ROOT, tiny_spec

from portbench import harness
from portbench.work import moe_lm, split_gemm

CELL = "mellum2-ep8-train-s6"
CONFIG = json.loads(
    (ROOT / "portbench/configs/mellum2-12b-a2.5b-ep8.json").read_text())


def _driver(spec, seed=2 ** 31 + 21, units=2):
    driver = harness.load_driver(spec, seed, torch.device("cpu"))
    driver.setup()
    for _ in range(units):
        driver.unit()
    driver.release()
    return driver


def test_compared_on_a_tiny_copy_is_under_every_limit():
    spec = tiny_spec(CELL)
    limits = spec["traffic"]["limits"]
    got = _driver(spec).compared()
    assert set(got) == set(limits)
    assert all(v <= limits[k] for k, v in got.items()), got


def test_first_change_is_held_to_a_float64_run(monkeypatch):
    """The first steps are compared with a float32 and a float64
    reference run, both following the program's routing, the change
    after them with the float64 run's; that run (a sequence at a time,
    its moments and parameters updated in place) agrees with the
    float32 run to float32's rounding."""
    from portbench.reference import moe_lm as ref

    real, seen = ref.train, []

    def train(*args, **kwargs):
        seen.append((kwargs.get("dtype"), kwargs.get("routing") is None))
        return real(*args, **kwargs)

    monkeypatch.setattr(ref, "train", train)
    spec = tiny_spec(CELL)
    driver = _driver(spec, units=1)
    got = driver.compared()
    assert seen == [(torch.float32, False), (torch.float64, False)]
    assert got["delta_median_gap"] != driver.detail["delta_median_gap_f32"]
    wide, narrow = driver.reference(dtype=torch.float64), driver.reference()
    # float32 parts from float64 by up to 1.1e-4 in a leaf's gradient
    # norm here (the experts' outputs); a sequence's share left out of
    # the sum, or a moment not carried, parts them by tenths.
    assert wide["losses"] == pytest.approx(narrow["losses"], rel=1e-6)
    assert wide["delta"] == pytest.approx(narrow["delta"], rel=1e-3)
    assert wide["grad1"] == pytest.approx(narrow["grad1"], rel=1e-3)


def test_half_batch_fault_exceeds_a_limit(monkeypatch):
    """A step whose loss leaves out the second half of the positions."""
    from repro_torch.models import MoEModel

    real = MoEModel.loss

    def half(self, params, tokens):
        return real(self, params, tokens[:, :tokens.shape[1] // 2 + 1])

    monkeypatch.setattr(MoEModel, "loss", half)
    spec = tiny_spec(CELL)
    res = harness.run_cell(spec, 2 ** 31 + 23, 0.05, False, device="cpu")
    assert not res["correct"], res["checks"]
    # Its routing covers half the tokens, which no reference follows.
    for name in ("loss1_rel_gap", "grad1_norm_gap", "route_margin"):
        assert res["checks"][name]["value"] > res["checks"][name]["limit"]


def _route_fault_from(monkeypatch, first):
    """The program routes each token to its least likely experts from
    step ``first`` on."""
    from portbench.drivers import moe_train
    from repro_torch.models import moe

    real_softmax, real_build = moe._softmax, moe_train.build_train_step
    calls = []

    def build(model, opt):
        step = real_build(model, opt)

        def counted(*args):
            calls.append(1)
            return step(*args)
        return counted

    monkeypatch.setattr(moe_train, "build_train_step", build)
    monkeypatch.setattr(moe, "_softmax", lambda x: real_softmax(
        -x if len(calls) >= first else x))


@pytest.mark.parametrize("first", [1, 2, 3])
def test_routing_fault_exceeds_the_margin(monkeypatch, first):
    """A routing fault from checked step ``first`` on: the reference
    follows the program's routing, and the float64 witness of each
    checked step from there on, and only there, exceeds the limit."""
    _route_fault_from(monkeypatch, first)
    spec = tiny_spec(CELL)
    limit = spec["traffic"]["limits"]["route_margin"]
    driver = _driver(spec, seed=2 ** 31 + 27, units=1)
    assert driver.compared()["route_margin"] > limit
    assert driver.failed(spec["traffic"]["limits"]) >= 1
    margins = driver.detail["route_margins"]
    assert len(margins) == 3
    assert all(m <= limit for m in margins[:first - 1]), margins
    assert all(m > limit for m in margins[first - 1:]), margins


def test_window_routing_fault_reads_in_the_detail(monkeypatch):
    """A routing fault from the window on passes the checked steps; the
    window step's margin, which is not compared (sound runs read up to
    0.31 there on an H100), reads it."""
    _route_fault_from(monkeypatch, 4)
    spec = tiny_spec(CELL)
    driver = _driver(spec, seed=2 ** 31 + 27, units=1)
    got = driver.compared()
    assert got["route_margin"] <= spec["traffic"]["limits"]["route_margin"]
    assert driver.detail["route_last_margin"] > 1e-2


def test_state_unchanged_from_the_window_on():
    """A step that returns its state unchanged once the window has begun
    passes every check of the first steps; the window's change catches
    it (the fault ``calibrate_frozen.py`` plants on the card)."""
    from portbench.calibrate_frozen import frozen_from
    from portbench.drivers import moe_train

    spec = tiny_spec(CELL)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(moe_train, "build_train_step", frozen_from(
            spec["traffic"]["check_steps"], moe_train.build_train_step))
        res = harness.run_cell(spec, 2 ** 31 + 25, 0.05, False,
                               device="cpu")
    checks = res["checks"]
    for name in ("loss1_rel_gap", "grad1_norm_gap", "delta_median_gap",
                 "route_margin"):
        assert checks[name]["value"] <= checks[name]["limit"]
    assert not res["correct"] and res["failed"] == 1
    assert checks["delta_last_median_gap"]["value"] >= 0.5


def test_configuration_and_hand_counts():
    """The cut as stated, and the counts of one step at 512 tokens an
    expert, by hand: 12 layers of q, k, v, o and router, 64 per-head
    products of each attention einsum, the head; three products an
    expert; each with its two cotangents."""
    shape = moe_lm.MoEShape.from_config(CONFIG)
    assert shape.num_params() == 12 * 70_930_944 + 2 * 226_492_416 + 2304
    assert shape.kinds == ("sliding", "sliding", "sliding", "full") * 3
    assert (shape.held, shape.router_experts, shape.top_k) == (
        tuple(range(8)), 64, 8)
    routed = [(512,) * 8] * 12
    gemms = moe_lm.emulated(moe_lm.train_gemms(shape, 2, 2048, routed), 128)
    # The router's 64 columns stay under min_dim.
    assert sum(gemms.values()) == 3 * (12 * (4 + 2 * 64) + 1) + 3 * 3 * 96
    # The scores, and the probabilities' cotangent of P @ V.
    assert gemms[(2048, 128, 2048)] == 2 * 12 * 64
    # Gate and up, and the input cotangent of down.
    assert gemms[(512, 2304, 896)] == 12 * 8 * 3
    uneven = [(100,) + (512,) * 7] + routed[1:]
    assert sum(moe_lm.emulated(moe_lm.train_gemms(
        shape, 2, 2048, uneven), 128).values()) == sum(gemms.values()) - 9
    sliding = 1024 * 1025 // 2 + 1024 * 1024
    assert moe_lm.attended(shape, 2048) == 9 * sliding + 3 * 2048 * 2049 // 2
    d, v, q, kv, E, f = 2304, 98304, 4096, 512, 64, 896
    dense = 2 * 4096 * (12 * (2 * d * q + 2 * d * kv + d * E) + d * v)
    attn = 4 * q * 2 * moe_lm.attended(shape, 2048)
    experts = 2 * 3 * d * f * 512 * 96
    assert moe_lm.train_flops(shape, 2, 2048, routed) == \
        pytest.approx(3 * (dense + attn + experts))
    assert split_gemm.k1_bound_s(moe_lm.emulated(
        Counter({(512, 2304, 896): 1}), 128), 6) > 0


def test_counted_gemms_are_the_offloaded_sites():
    """The emulated GEMMs counted from the shapes and the program's
    counter are the products the offload sends to the kernel in a tiny
    step (launches counted on the CPU, where K1 runs its plain
    version)."""
    from repro_torch.kernels import ops

    spec = tiny_spec(CELL)
    driver = harness.load_driver(spec, 7, torch.device("cpu"))
    plain = ops.split_gemm_kmajor_plain
    with pytest.MonkeyPatch.context() as patch:
        def counted(*args, **kwargs):
            ops.LAUNCHES["split_gemm"] += 1
            return plain(*args, **kwargs)

        patch.setattr(ops, "split_gemm_kmajor_plain", counted)
        driver.setup()
        before = ops.LAUNCHES["split_gemm"]
        for _ in range(2):
            driver.unit()
        launches = ops.LAUNCHES["split_gemm"] - before
    work = driver.work()
    assert work["train_steps"] == 2
    assert work["train_real_gemms"] == launches > 0
    assert work["moe_host_ns"] > 0 and work["train_model_flops"] > 0


@pytest.mark.cuda
def test_moe_control_fails(cuda_device):
    """The TF32 reference in the program's place fails a committed limit
    at the cell's own width, where the program passes them all."""
    spec = harness.cell_spec(CELL)
    limits = spec["traffic"]["limits"]
    for seed in (2 ** 31 + 29, 4100000001):
        driver = harness.load_driver(spec, seed, cuda_device)
        driver.setup()
        driver.unit()
        driver.release()
        assert all(v <= limits[k] for k, v in driver.compared().items())
        got = driver.compared(control=True)
        assert any(v > limits[k] for k, v in got.items()), got
        del driver
