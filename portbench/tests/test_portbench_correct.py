"""``correct`` on the CPU at a small size: a sound run of each cell is
correct, and the run comes out not correct when the timed path is
broken underneath it (the chip look is skipped; the rest of a run is
driven as ``run.py`` drives it).  The LM's lower-precision control is
TF32, a mode of the card's matmuls: ``test_portbench_cuda.py`` holds it
against the committed limits."""

import json

import pytest
from conftest import ROOT, tiny_spec

from portbench import harness

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TRAIN = "smollm360m-train-s6"


def _run(cell, seed=2 ** 31 + 5, traced=False, seconds=0.05):
    return harness.run_cell(tiny_spec(cell), seed, seconds, traced,
                            device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert {m for m in res["metrics"]} >= {"setup_s"}


def test_traced_run_reports_per_layer_metrics():
    res = _run(TRAIN, traced=True)
    assert res["correct"], res["checks"]
    # The host-clock metric is read; the device ones need the card.
    assert set(res["metrics"]) == {"mfu.train"}
    assert 0 < res["metrics"]["mfu.train"]["value"] < 100


def test_window_steps_are_compared_and_counted():
    res = _run(TRAIN, seconds=0.5)
    assert {"loss_last_rel_gap", "grad_last_norm_gap"} <= set(res["checks"])
    assert res["attempted"] > 3 + 1


def test_train_state_unchanged(monkeypatch):
    from portbench.drivers import lm_train

    real = lm_train.build_train_step

    def frozen(model, opt):
        step = real(model, opt)

        def unchanged(params, opt_state, batch):
            _, _, loss = step(params, opt_state, batch)
            return params, opt_state, loss
        return unchanged

    monkeypatch.setattr(lm_train, "build_train_step", frozen)
    res = _run(TRAIN)
    assert not res["correct"]
    assert res["checks"]["delta_median_gap"]["value"] > 0.9
    assert res["checks"]["grad1_norm_gap"]["value"] > 0.9


def test_train_state_unchanged_from_the_window_on(monkeypatch):
    """A step that returns its state unchanged only once the window has
    begun passes every check of the first steps; the window's step
    catches it."""
    from portbench.drivers import lm_train

    real = lm_train.build_train_step

    def frozen_late(model, opt):
        step = real(model, opt)
        calls = []

        def late(params, opt_state, batch):
            calls.append(1)
            new_params, new_state, loss = step(params, opt_state, batch)
            if len(calls) > 3:
                return params, opt_state, loss
            return new_params, new_state, loss
        return late

    monkeypatch.setattr(lm_train, "build_train_step", frozen_late)
    res = _run(TRAIN)
    checks = res["checks"]
    for name in ("loss1_rel_gap", "grad1_norm_gap", "delta_median_gap"):
        assert checks[name]["value"] <= checks[name]["limit"]
    assert not res["correct"] and res["failed"] >= 1
    assert checks["grad_last_norm_gap"]["value"] > 0.5


def test_train_half_batch_left_out(monkeypatch):
    from repro_torch.models import Model

    real = Model.loss

    def half(self, params, tokens):
        return real(self, params, tokens[:, :tokens.shape[1] // 2 + 1])

    monkeypatch.setattr(Model, "loss", half)
    res = _run(TRAIN)
    assert not res["correct"], res["checks"]
    assert res["checks"]["loss_last_rel_gap"]["value"] > \
        res["checks"]["loss_last_rel_gap"]["limit"]
