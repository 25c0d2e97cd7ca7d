"""Tests that need the card (marked ``cuda``; skipped without one).

The LM cell's lower-precision control is TF32, a mode of the card's
matmuls, so it is held against the committed limits here, at the
cell's own width: over the first steps and at a window step.  A traced
run at a small size reads its per-layer metrics from a real device
trace.

    python3 -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import pytest
from conftest import tiny_spec

from portbench import harness

pytestmark = pytest.mark.cuda


def test_train_control_fails(cuda_device):
    spec = harness.cell_spec("smollm360m-train-s6")
    limits = spec["traffic"]["limits"]
    for seed in (1, 2 ** 31 + 13, 77):
        driver = harness.load_driver(spec, seed, cuda_device)
        driver.setup()
        driver.unit()
        driver.release()
        assert all(v <= limits[k] for k, v in driver.compared().items())
        got = driver.compared(control=True)
        assert any(v > limits[k] for k, v in got.items()), got


def test_traced_run_reads_the_device(cuda_device):
    spec = tiny_spec("smollm360m-train-s6")
    res = harness.run_cell(spec, 2 ** 31 + 17, 0.3, True, device="cuda")
    assert res["correct"], res["checks"]
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    got = res["metrics"]
    assert 0 < got["k1_roofline.train"]["value"] <= 100
    assert 0 < got["idle_share.train"]["value"] < 100
    assert 0 < got["mfu.train"]["value"] < 100
    assert res["breakdown"]["device_ops"]
