"""Every file the benchmark names exists, loads and resolves, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest
from conftest import ROOT

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in metrics])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else 1
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = harness.cell_spec(cell)
    assert spec["cell"]["chips"] == 1
    driver = harness.load_driver(spec, 1, "cpu")
    for name in ("setup", "unit", "end_to_end", "work", "release",
                 "compared", "failed"):
        assert callable(getattr(driver, name))
    assert set(spec["traffic"]["limits"]) and all(
        v > 0 for v in spec["traffic"]["limits"].values())
    assert any(m["name"] != "setup_s" for m in spec["end_to_end"])
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
