"""Port parity: the roofline model (``repro_torch.analysis.roofline``)
against ``repro.analysis.roofline``.

The reference's seven tests, priced by the H100's peaks; with the
reference's TPU table passed as ``peaks``, the port's analysis equals
the reference's to the bit.
"""

import dataclasses
import json

import pytest

from repro.analysis.roofline import V5E_PEAKS
from repro.analysis.roofline import analyze_cell as analyze_cell_ref
from repro_torch.analysis.roofline import (H100_PEAKS, CellAnalysis,
                                           analyze_cell)
from repro_torch.kernels.tile_model import HopperParams


def _artifact(**kw):
    base = {"cell": "must_n4096_pod16x16", "num_devices": 256,
            "flops": 1.0e15, "int8_flops": 8.0e14,
            "hbm_bytes": 2.0e12, "collective_bytes": 1.0e10}
    base.update(kw)
    return base


class TestAnalyzeCell:
    def test_from_dict(self):
        r = analyze_cell(_artifact())
        assert isinstance(r, CellAnalysis)
        assert r.cell == "must_n4096_pod16x16"
        expected_compute = (0.2e15 / H100_PEAKS["flops"]
                            + 0.8e15 / H100_PEAKS["int8_flops"]) / 256
        assert r.compute_s == pytest.approx(expected_compute)
        assert r.dominant in ("compute", "memory", "collective")
        assert r.bound_s == max(r.compute_s, r.memory_s, r.collective_s)

    def test_from_json_file(self, tmp_path):
        p = tmp_path / "must_n4096_pod16x16.json"
        p.write_text(json.dumps(_artifact()))
        r = analyze_cell(p)
        assert r.num_devices == 256
        assert r.memory_s == pytest.approx(
            2.0e12 / H100_PEAKS["hbm_gbps"] / 256)

    def test_cell_defaults_to_filename(self, tmp_path):
        p = tmp_path / "decode_32k_pod16x16.json"
        art = _artifact()
        del art["cell"]
        p.write_text(json.dumps(art))
        assert analyze_cell(p).cell == "decode_32k_pod16x16"

    def test_memory_bound_cell(self):
        r = analyze_cell(_artifact(flops=1e12, int8_flops=0,
                                   hbm_bytes=5e14))
        assert r.dominant == "memory"

    def test_peak_overrides(self):
        r = analyze_cell(_artifact(
            int8_flops=0, peaks={"flops": 1.0e12}))
        assert r.compute_s == pytest.approx(1.0e15 / 1.0e12 / 256)

    def test_int8_flops_clamped_to_total(self):
        r = analyze_cell(_artifact(flops=1e12, int8_flops=9e15))
        assert r.compute_s == pytest.approx(
            1e12 / H100_PEAKS["int8_flops"] / 256)

    def test_bad_artifacts_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            analyze_cell(_artifact(flops="a lot"))
        p = tmp_path / "broken_pod16x16.json"
        p.write_text("[1, 2, 3]")
        with pytest.raises(ValueError):
            analyze_cell(p)


class TestAgainstReference:
    @pytest.mark.parametrize("art", [
        _artifact(),
        _artifact(flops=1e12, int8_flops=0, hbm_bytes=5e14),
        _artifact(flops=1e12, int8_flops=9e15),
        _artifact(int8_flops=0, peaks={"flops": 1.0e12}),
        _artifact(num_devices=0, collective_bytes=9e13),
        {"flops": 3e12, "int8_flops": 3e12, "hbm_bytes": 7e9},
    ])
    def test_equal_under_the_reference_peaks(self, art):
        got = analyze_cell(art, V5E_PEAKS)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            analyze_cell_ref(art))
        assert (got.dominant, got.bound_s) == (
            analyze_cell_ref(art).dominant, analyze_cell_ref(art).bound_s)

    def test_h100_peaks_are_the_cost_models(self):
        params = HopperParams()
        assert H100_PEAKS["int8_flops"] == params.int8_ops == 1979e12
        assert H100_PEAKS["hbm_gbps"] == params.hbm_bw == 3.35e12
        assert H100_PEAKS["flops"] == 67e12          # FP64 tensor core
        assert H100_PEAKS["ici_gbps"] == 450e9       # NVLink 4, one way
        assert set(H100_PEAKS) == set(V5E_PEAKS)
