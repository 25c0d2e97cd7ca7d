"""Port parity: the precision-plan tuner (``repro_torch.tune``).

Class by class the reference's ``tests/test_tune.py`` held on the port,
then the two packages side by side: the same seeded numpy inputs
through both calibrators give equal site records; solved with the
reference's cost curve they give byte-identical plans (``tiles`` aside:
only its ``block_k`` is the reference's), with the reference's
fingerprint; a plan either package writes runs in the other's trainer.
Tolerances are stated beside each check.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.core import PrecisionPolicy as PolicyRef
from repro.launch.train import build_train_step as build_train_step_ref
from repro.models import Model as ModelRef
from repro.train import AdamW as AdamWRef
from repro.tune import Calibrator as CalibratorRef
from repro.tune import PrecisionPlan as PrecisionPlanRef
from repro.tune import solve_plan as solve_plan_ref
from repro.kernels import tile_model as tile_ref
from repro_torch.configs import get_config
from repro_torch.core import (PrecisionPolicy, canonical_site, offload,
                              site_report)
from repro_torch.kernels import tile_model
from repro_torch.launch.train import build_train_step
from repro_torch.models import Model
from repro_torch.train import AdamW, SyntheticText
from repro_torch.tune import (PLAN_VERSION, CalibrationResult, Calibrator,
                              PlanError, PlanStaleError, PrecisionPlan,
                              SiteRecord, count_int8_gemms, default_budget,
                              site_set_fingerprint, solve_plan,
                              unpinned_family)

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)


def _two_site_fn(a, b):
    return torch.sum(torch.tanh(a @ b) @ b)


def _two_site_fn_ref(a, b):
    return jnp.sum(jnp.tanh(a @ b) @ b)


def _arrays(n=192, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, n)), rng.standard_normal((n, n))


def _operands(n=192, seed=0):
    return tuple(torch.from_numpy(x) for x in _arrays(n, seed))


def _record(site="dot0", k=256, dtype="float64", flops=10**7,
            measured=None, probe=6):
    return SiteRecord(site=site, k=k, dtype=dtype, flops=flops,
                      probe_splits=probe, measured_rel=measured,
                      lhs_exp=0, rhs_exp=0)


def _result(records, policy=None, fingerprint="sha256:test"):
    return CalibrationResult(records=records, fingerprint=fingerprint,
                             policy=policy or PrecisionPolicy(),
                             probe_splits=records[0].probe_splits
                             if records else 6)


class TestCanonicalSite:
    def test_sharded_key_reaches_unsharded_site(self):
        assert canonical_site("shmap0/scan0/dot1") == "scan0/dot1"
        pol = PrecisionPolicy(default_splits=3,
                              site_splits={"shmap0/dot1": 8})
        assert pol.splits_for("dot1") == 8
        a, b = _operands(192)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sites = offload(_two_site_fn, PrecisionPolicy(
                min_dim=64, site_splits={"shmap0/dot1": 8})).sites(a, b)
        assert sites[1].splits == 8


class TestCalibrator:
    def test_records_stats_and_returns_native(self):
        a, b = _operands()
        pol = PrecisionPolicy(default_splits=6, min_dim=128)
        cal = Calibrator(_two_site_fn, pol)
        out = cal.run(a, b)
        # The recording backend returns the native products: the
        # output equals the unwrapped function's to the bit.
        assert torch.equal(out, _two_site_fn(a, b))
        res = cal.result()
        assert [r.site for r in res.records] == ["dot0", "dot1"]
        for r in res.records:
            assert r.k == 192
            assert r.dtype == "float64"
            assert r.flops == 2 * 192**3
            assert r.measured_rel is not None
            assert 1e-14 < r.measured_rel < 1e-8
            assert r.rhs_exp is not None and r.rhs_exp >= 1
        assert res.records[0].lhs_exp >= 1
        assert res.records[1].lhs_exp <= 0

    def test_scan_multiplicity_scales_flops(self):
        from repro_torch.core import scan

        w = torch.eye(160, dtype=torch.float64)

        def f(x):
            def body(c, _):
                return torch.tanh(c @ w), None

            y, _ = scan(body, x, torch.zeros(3))
            return y

        cal = Calibrator(f, PrecisionPolicy(min_dim=64))
        cal.run(torch.ones((160, 160), dtype=torch.float64))
        (rec,) = cal.result().records
        assert rec.site == "scan0/dot0"
        assert rec.flops == 3 * 2 * 160**3

    def test_zero_operand_leaves_model_curve(self):
        a, _ = _operands()
        cal = Calibrator(lambda a, b: a @ b, PrecisionPolicy(min_dim=64))
        cal.run(a, torch.zeros((192, 192), dtype=torch.float64))
        (rec,) = cal.result().records
        assert rec.measured_rel is None
        assert rec.rhs_exp == 0

    def test_demoted_sites_are_still_measured(self):
        a, b = _operands(192)
        pol = PrecisionPolicy(min_dim=64, site_backends={"dot0": "dgemm"},
                              on_unmatched_site="ignore")
        cal = Calibrator(_two_site_fn, pol)
        assert torch.equal(cal.run(a, b), _two_site_fn(a, b))
        recs = {r.site: r for r in cal.result().records}
        assert recs["dot0"].measured_rel is not None
        assert recs["dot1"].measured_rel is not None

    def test_signature_drift_raises(self):
        cal = Calibrator(lambda a, b: a @ b, PrecisionPolicy(min_dim=64))
        cal.run(*_operands(192))
        big = torch.ones((256, 256), dtype=torch.float64)
        with pytest.raises(ValueError, match="site set"):
            cal.run(big, big)

    def test_float32_reference_puts_probes_under_its_floor(self):
        # Against a float32 reference (what the CLI uses for a float32
        # model, as the reference's CLI without x64) a probe at s = 6
        # measures the reference's rounding: below 64 eps(f32) it leaves
        # the site unmeasured, on the a-priori curve.
        a, b = (x.float() for x in _operands())
        cal = Calibrator(_two_site_fn, PrecisionPolicy(min_dim=64),
                         reference_dtype=torch.float32)
        cal.run(a, b)
        assert all(r.measured_rel is None for r in cal.result().records)
        with pytest.raises(ValueError, match="reference_dtype"):
            Calibrator(_two_site_fn, reference_dtype=torch.float16)

    def test_backward_sites_are_calibrated(self):
        a, b = _operands(192)

        def f(a, b):
            a = a.clone().requires_grad_()
            return torch.autograd.grad(_two_site_fn(a, b), a)[0]

        cal = Calibrator(f, PrecisionPolicy(min_dim=64))
        torch.testing.assert_close(cal.run(a, b), f(a, b), rtol=0, atol=0)
        recs = cal.result().records
        assert [r.site for r in recs] == ["dot0", "dot1", "dot2", "dot3"]
        assert all(r.measured_rel is not None for r in recs)


class TestSolver:
    def test_budget_monotone(self):
        recs = [_record("dot0", k=256), _record("dot1", k=1024)]
        loose = solve_plan(_result(recs), budget=1e-4)
        tight = solve_plan(_result(recs), budget=1e-12)
        for s_loose, s_tight in zip(loose.sites, tight.sites):
            assert s_loose.splits <= s_tight.splits
        assert loose.budget_met and tight.budget_met

    def test_measured_anchor_needs_fewer_splits(self):
        modeled = solve_plan(_result([_record(measured=None)]),
                             budget=1e-10)
        anchored = solve_plan(
            _result([_record(measured=1e-13, probe=6)]), budget=1e-10)
        assert anchored.sites[0].splits < modeled.sites[0].splits

    def test_pathological_site_demoted_to_dgemm(self):
        recs = [_record("dot0", measured=1e-3, probe=6),
                _record("dot1", measured=1e-11, probe=6)]
        plan = solve_plan(_result(recs), budget=1e-9)
        by = {s.site: s for s in plan.sites}
        assert by["dot0"].backend == "dgemm"
        assert by["dot0"].splits == 0
        assert by["dot1"].backend == "fp64_int8"
        assert plan.demoted_sites() == ["dot0"]

    def test_cost_weighting_prefers_cheap_sites(self):
        recs = [_record("cheap", flops=10**6),
                _record("costly", flops=10**8)]
        plan = solve_plan(_result(recs), budget=1e-9)
        by = {s.site: s.splits for s in plan.sites}
        assert by["costly"] <= by["cheap"]

    def test_unreachable_budget_flagged(self):
        plan = solve_plan(_result([_record()]), budget=1e-300)
        assert not plan.budget_met
        assert all(s.splits == 14 for s in plan.sites)

    def test_deterministic(self):
        recs = [_record(f"dot{i}", k=128 * (i + 1)) for i in range(5)]
        a = solve_plan(_result(recs), budget=1e-9)
        b = solve_plan(_result(list(reversed(recs))), budget=1e-9)
        assert a.to_json() == b.to_json()

    def test_default_budget_tracks_loosest_dtype(self):
        f32 = default_budget([_record(dtype="float32")])
        f64 = default_budget([_record(dtype="float64")])
        assert f32 == pytest.approx(32 * np.finfo(np.float32).eps)
        assert f64 == pytest.approx(32 * np.finfo(np.float64).eps)
        assert default_budget([_record(dtype="float32"),
                               _record(dtype="float64")]) == f32
        bf16 = default_budget([_record(dtype="bfloat16")])
        assert bf16 == pytest.approx(32 * 2.0 ** -7)
        assert solve_plan(_result([_record(dtype="bfloat16")])
                          ).budget == pytest.approx(bf16)

    def test_unpinned_family(self):
        assert unpinned_family("fp64_int8_6") == "fp64_int8"
        assert unpinned_family("fp64_int8") == "fp64_int8"
        assert unpinned_family("pallas_int8_6:fused") == \
            "pallas_int8:fused"
        assert unpinned_family("adaptive:1e-9") == "adaptive:1e-9"

    @pytest.mark.parametrize("budget", [1e-4, 1e-9, 1e-12])
    def test_cost_curve_is_an_argument(self, budget):
        # The reference's curve reproduces the reference's solve on the
        # same records, byte for byte; the port's default is the H100's.
        recs = [_record(f"dot{i}", k=128 * (i + 1), flops=10 ** (5 + i))
                for i in range(5)]
        want = solve_plan_ref(_ref_result(recs), budget=budget)
        got = solve_plan(_result(recs), budget=budget,
                         cost=tile_ref.split_cost)
        assert got.to_json() == want.to_json()
        assert solve_plan(_result(recs), budget=budget).budget_met


def _ref_result(records, policy=None):
    from repro.tune import SiteRecord as SiteRecordRef
    from repro.tune.calibrate import CalibrationResult as ResultRef

    recs = [SiteRecordRef(**vars(r)) for r in records]
    return ResultRef(records=recs, fingerprint="sha256:test",
                     policy=policy or PolicyRef(),
                     probe_splits=recs[0].probe_splits)


class TestHopperSplitCost:
    def test_rises_strictly_with_splits(self):
        costs = [tile_model.split_cost(s) for s in range(1, 17)]
        assert all(b > a for a, b in zip(costs, costs[1:]))

    def test_tax_from_the_cards_rates(self):
        p = tile_model.DEFAULT_PARAMS
        assert (p.int8_ops, p.hbm_bw) == (1979e12, 3.35e12)
        assert (p.num_sms, p.smem_per_sm) == (tile_model.NUM_SMS,
                                              tile_model.SMEM_PER_SM)
        tax = tile_model.split_cost(1) - 1
        assert tax == pytest.approx(989.5e12 * (2 / 1024) / 3.35e12,
                                    rel=1e-12)
        assert tax == pytest.approx(0.577, abs=1e-3)
        # More per split than on the reference's TPU v5e (~0.037).
        assert tax > 10 * (tile_ref.split_cost(1) - 1)
        half = tile_model.HopperParams(hbm_bw=6.7e12)
        assert tile_model.split_cost(6, half) < tile_model.split_cost(6)

    @pytest.mark.parametrize("s", [1, 3, 5, 6, 9])
    def test_select_tiles_takes_params_and_keeps_its_pick(self, s):
        shapes = [(37, 130, 51), (100, 200, 60), (64, 96, 64),
                  (1, 129, 1), (40, 300, 24), (256, 256, 4096),
                  (512, 960, 2560), (None, 960, None)]
        other = tile_model.HopperParams(int8_ops=1e15, hbm_bw=1e12)
        for m, k, n in shapes:
            for fused in (False, True):
                plain = tile_model.select_tiles(m, k, n, s, fused=fused)
                for params in (tile_model.DEFAULT_PARAMS, other):
                    got = tile_model.select_tiles(m, k, n, s, fused=fused,
                                                  params=params)
                    assert got == plain

    def test_k1_rule_reads_the_cards_sms_and_l2_rate(self):
        # K1's plan rule prices against the rates object: a card with
        # 16 SMs no longer counts a 4x4 grid of 64x64 tiles as small
        # (so it keeps the 64x64 tile resident), and a tenth of the L2
        # rate makes the streamed LM GEMMs L2-bound (the 128x64 tile
        # reads least).  The defaults give today's picks.
        few = tile_model.HopperParams(num_sms=16)
        slow = tile_model.HopperParams(l2_bw=tile_model.K1_L2_BYTES_PER_S
                                       / 10)
        cases = [((256, 256, 256), (64, 32), (64, 64), (64, 32)),
                 ((512, 960, 960), (64, 32), (64, 64), (128, 64))]
        for shape, today, on_few, on_slow in cases:
            for params, want in ((tile_model.DEFAULT_PARAMS, today),
                                 (few, on_few), (slow, on_slow)):
                got = tile_model.select_tiles(*shape, 6, params=params)
                assert (got.block_m, got.block_n) == want, (shape, params)
                plan = tile_model.k1_plan(*shape, 6, got.block_k,
                                          params=params)
                assert (plan.block_m, plan.block_n) == want


class TestPlanArtifact:
    def _plan(self):
        return solve_plan(_result([_record("dot0", k=256),
                                   _record("scan0/dot1", k=512)]),
                          budget=1e-9)

    def test_roundtrip_byte_identical(self, tmp_path):
        plan = self._plan()
        path = plan.save(tmp_path / "p.json")
        loaded = PrecisionPlan.load(path)
        assert loaded.to_json() == plan.to_json()
        assert path.read_text() == plan.to_json()

    def test_unknown_version_rejected(self):
        bad = self._plan().to_json().replace(
            f'"version": {PLAN_VERSION}', '"version": 99')
        with pytest.raises(PlanError, match="version"):
            PrecisionPlan.from_json(bad)

    def test_malformed_rejected(self, tmp_path):
        with pytest.raises(PlanError, match="JSON"):
            PrecisionPlan.from_json("{nope")
        with pytest.raises(PlanError, match="missing"):
            PrecisionPlan.from_json(f'{{"version": {PLAN_VERSION}}}')
        with pytest.raises(PlanError, match="object"):
            PrecisionPlan.from_json("[1]")
        with pytest.raises(PlanError, match="site entry"):
            doc = json.loads(self._plan().to_json())
            doc["sites"][0]["bogus"] = 1
            PrecisionPlan.from_json(json.dumps(doc))
        with pytest.raises(PlanError, match="no precision plan"):
            PrecisionPlan.load(tmp_path / "absent.json")

    def test_fingerprint_ignores_free_extents(self):
        a, b = _operands(192)
        pol = PrecisionPolicy(min_dim=64)
        wide = site_report(lambda a, b: a @ b, pol)(
            torch.ones((640, 192), dtype=torch.float64), b)
        narrow = site_report(lambda a, b: a @ b, pol)(a, b)
        assert site_set_fingerprint(wide) == site_set_fingerprint(narrow)

    def test_fingerprint_equals_reference(self):
        # The port's sites (torch dtypes) and the reference's (jnp
        # dtypes) of one program hash to the same fingerprint.
        arrays = _arrays(192)
        for dtype in (np.float32, np.float64, np.complex128):
            args = [x.astype(dtype) for x in arrays]
            pol_ref, pol = PolicyRef(min_dim=64), PrecisionPolicy(min_dim=64)
            want = site_set_fingerprint(site_report_ref(
                lambda a, b: a @ b @ b, pol_ref)(*map(jnp.asarray, args)))
            got = site_set_fingerprint(site_report(
                lambda a, b: a @ b @ b, pol)(*map(torch.from_numpy, args)))
            assert got == want

    def test_validate_sites_stale_names_drift(self):
        plan = self._plan()
        a, b = _operands(192)
        sites = site_report(_two_site_fn, PrecisionPolicy(min_dim=64))(a, b)
        with pytest.raises(PlanStaleError, match="dot1"):
            plan.validate_sites(sites)

    def test_from_plan_policy(self):
        recs = [_record("dot0", k=256, measured=1e-3, probe=6),
                _record("scan0/dot1", k=512)]
        plan = solve_plan(_result(recs), budget=1e-9)
        pol = PrecisionPolicy.from_plan(plan)
        assert pol.backend == "fp64_int8"
        assert pol.backend_for("dot0") == "dgemm"
        s = plan.site_splits()["scan0/dot1"]
        assert pol.splits_for("shmap0/scan0/dot1") == s
        assert pol.min_dim == plan.min_dim
        assert PrecisionPolicy.from_plan(
            plan, on_unmatched_site="ignore").on_unmatched_site == "ignore"


def site_report_ref(fn, policy):
    from repro.core import site_report as report

    return report(fn, policy)


class TestPlanTiles:
    """The tile model's canonical picks in the plan artifact (the
    port's own CTA tiles; ``block_k`` is the reference's)."""

    def _pallas_plan(self):
        recs = [_record("dot0", k=256, dtype="float32"),
                _record("dot1", k=512, dtype="float32",
                        measured=1e-1, probe=6)]  # demoted
        pol = PrecisionPolicy(backend="pallas_int8")
        return solve_plan(_result(recs, policy=pol), budget=1e-6)

    def test_pallas_plan_records_canonical_tiles(self):
        plan = self._pallas_plan()
        by_name = {s.site: s for s in plan.sites}
        solved = by_name["dot0"]
        d = tile_model.select_tiles(None, solved.k, None, solved.splits,
                                    dtype=solved.dtype)
        assert solved.tiles == (d.block_m, d.block_n, d.block_k)
        assert solved.tiles[2] == tile_ref.select_tiles(
            None, solved.k, None, solved.splits).block_k
        assert "tiles=" in plan.describe()
        assert by_name["dot1"].tiles is None

    def test_jnp_plan_has_no_tiles(self):
        plan = solve_plan(_result([_record("dot0")]), budget=1e-9)
        assert all(s.tiles is None for s in plan.sites)

    def test_tiles_survive_roundtrip_byte_identical(self, tmp_path):
        plan = self._pallas_plan()
        loaded = PrecisionPlan.load(plan.save(tmp_path / "p.json"))
        assert loaded.to_json() == plan.to_json()
        assert {s.site: s.tiles for s in loaded.sites} == \
            {s.site: s.tiles for s in plan.sites}

    def test_plan_without_tiles_field_still_loads(self):
        doc = json.loads(self._pallas_plan().to_json())
        for s in doc["sites"]:
            s.pop("tiles")
        plan = PrecisionPlan.from_json(json.dumps(doc))
        assert all(s.tiles is None for s in plan.sites)

    def test_tiles_table_written_next_to_plan(self, tmp_path):
        from repro_torch.tune.plan import tiles_table, write_tiles_table

        plan = self._pallas_plan()
        path = plan.save(tmp_path / "p.json")
        tpath = write_tiles_table(plan, path)
        assert tpath == tmp_path / "p.tiles.json"
        doc = tiles_table(plan)
        assert doc["fingerprint"] == plan.fingerprint
        (row,) = doc["sites"]
        assert row["site"] == "dot0"
        d = tile_model.select_tiles(None, 256, None, row["splits"])
        assert (row["vmem_bytes"], row["mxu_cycles_step"],
                row["hbm_bytes_step"]) == (d.vmem_bytes, d.mxu_cycles_step,
                                           d.hbm_bytes_step)
        assert json.loads(tpath.read_text()) == json.loads(
            json.dumps(doc, sort_keys=True))

    def test_calibrator_probes_tiles_for_pallas_backend(self):
        a, b = _operands(192)
        pol = PrecisionPolicy(backend="pallas_int8", default_splits=4,
                              min_dim=64)
        cal = Calibrator(_two_site_fn, pol)
        cal.run(a, b)
        result = cal.result()
        assert all(r.tiles is not None for r in result.records)
        assert "tiles=" in result.describe()


class TestUnmatchedSiteOverrides:
    def _run(self, pol):
        return offload(_two_site_fn, pol).sites(*_operands(192))

    def test_typo_warns_by_default(self):
        pol = PrecisionPolicy(min_dim=64, site_splits={"dot7_typo": 9})
        with pytest.warns(UserWarning, match="dot7_typo"):
            self._run(pol)

    def test_strict_mode_raises(self):
        pol = PrecisionPolicy(min_dim=64, site_splits={"nope": 9},
                              on_unmatched_site="raise")
        with pytest.raises(ValueError, match="nope"):
            offload(_two_site_fn, pol)(*_operands(192))

    def test_ignore_mode_is_silent(self):
        pol = PrecisionPolicy(min_dim=64, site_splits={"nope": 9},
                              on_unmatched_site="ignore")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            offload(_two_site_fn, pol)(*_operands(192))

    def test_matching_keys_do_not_warn(self):
        pol = PrecisionPolicy(min_dim=64, site_splits={"dot1": 7})
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sites = self._run(pol)
        assert sites[1].splits == 7


class TestOffloadWithPlan:
    def _plan_for(self, fn, *args, min_dim=64):
        cal = Calibrator(fn, PrecisionPolicy(min_dim=min_dim))
        cal.run(*args)
        return solve_plan(cal.result())

    def test_plan_drives_per_site_splits(self):
        a, b = _operands(192)
        plan = self._plan_for(_two_site_fn, a, b)
        wrapped = offload(_two_site_fn, plan=plan)
        sites = {s.name: s for s in wrapped.sites(a, b)}
        for ps in plan.sites:
            assert sites[ps.site].splits == ps.splits
        # The reference's bound: 1e-9 relative to the native result.
        assert float(wrapped(a, b)) == pytest.approx(
            float(_two_site_fn(a, b)), rel=1e-9)

    def test_strict_match_raises_on_drift(self):
        a, b = _operands(192)
        plan = self._plan_for(_two_site_fn, a, b)

        def drifted(a, b):  # one extra eligible site
            return torch.sum(torch.tanh(a @ b) @ b @ b)

        with pytest.raises(PlanStaleError, match="Re-run calibration"):
            offload(drifted, plan=plan).sites(a, b)
        with pytest.raises(PlanStaleError, match="only in trace"):
            offload(drifted, plan=plan)(a, b)

    def test_subset_match_applies_overlap_without_warning(self):
        a, b = _operands(192)
        plan = self._plan_for(_two_site_fn, a, b)
        wrapped = offload(lambda a, b: a @ b, plan=plan,
                          plan_match="subset")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            (site,) = wrapped.sites(a, b)
            wrapped(a, b)
        assert site.splits == plan.site_splits()["dot0"]
        with pytest.raises(ValueError, match="plan_match"):
            offload(_two_site_fn, plan=plan, plan_match="loose")

    def test_per_site_backend_promotion(self):
        from repro_torch.core import register_backend
        from repro_torch.core.backends import _FACTORIES, OzakiBackend

        calls = []

        class SpyBackend(OzakiBackend):
            def matmul(self, a, b, **kw):
                calls.append(kw.get("site"))
                return super().matmul(a, b, **kw)

        register_backend("spy_int8", lambda spec, policy, splits, arg:
                         SpyBackend(spec, policy, splits))
        try:
            a, b = _operands(128, seed=3)
            pol = PrecisionPolicy(default_splits=4, min_dim=64,
                                  site_backends={"dot0": "spy_int8_4"})
            wrapped = offload(_two_site_fn, pol)
            sites = wrapped.sites(a, b)
            assert sites[0].backend == "spy_int8_4"
            assert sites[1].backend == "fp64_int8"
            got = float(wrapped(a, b))
            assert set(calls) == {"dot0"} and calls
            # s=4 emulation summed over 128^2 outputs: ~1e-2 headroom.
            assert got == pytest.approx(float(_two_site_fn(a, b)),
                                        abs=5e-2)
        finally:
            _FACTORIES.pop("spy_int8", None)

    def test_backward_sites_follow_the_plan(self):
        a, b = _operands(192)

        def f(a, b):
            a = a.clone().requires_grad_()
            return torch.autograd.grad(_two_site_fn(a, b), a)[0]

        plan = self._plan_for(f, a, b)
        pol = PrecisionPolicy.from_plan(plan)
        pol.site_splits["dot3"] = 2
        sites = {s.name: s for s in offload(f, pol).sites(a, b)}
        assert sites["dot3"].splits == 2
        assert sites["dot2"].splits == plan.site_splits()["dot2"]


class TestLMTunedPlanAcceptance:
    """Reduced preset: tuned plan == uniform-6 accuracy, fewer GEMMs."""

    def test_tuned_beats_uniform_cost_at_same_tolerance(self):
        cfg = get_config("reduced")
        model = Model(cfg, device="cpu", seed=0)
        opt = AdamW(lr=3e-3)
        params = model.params
        state = opt.init(params)
        batch = torch.from_numpy(SyntheticText(cfg.vocab_size, 32, 2,
                                               seed=0).batch(0))
        step = build_train_step(model, opt)

        uniform_pol = PrecisionPolicy(backend="fp64_int8",
                                      default_splits=6, min_dim=64)
        cal = Calibrator(step, uniform_pol)
        cal.run(params, state, batch)
        plan = solve_plan(cal.result())
        assert plan.budget_met

        tuned = offload(step, PrecisionPolicy.from_plan(plan), plan=plan)
        uniform = offload(step, uniform_pol)
        n_tuned = count_int8_gemms(tuned.sites(params, state, batch))
        n_uniform = count_int8_gemms(uniform.sites(params, state, batch))
        assert n_tuned < n_uniform, (n_tuned, n_uniform)

        _, _, loss_native = step(params, state, batch)
        _, _, loss_tuned = tuned(params, state, batch)
        _, _, loss_uniform = uniform(params, state, batch)
        tol = 1e-4  # the reference's shared end-to-end loss tolerance
        assert abs(float(loss_tuned) - float(loss_native)) <= tol
        assert abs(float(loss_uniform) - float(loss_native)) <= tol


# -- across the packages ------------------------------------------------

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=192, vocab_size=160)
_RECORD_FIELDS = ("site", "k", "dtype", "flops", "lhs_exp", "rhs_exp",
                  "measured_rel", "probe_splits")


def _plan_json_without_tiles(plan):
    doc = json.loads(plan.to_json())
    for site in doc["sites"]:
        site.pop("tiles")
    return json.dumps(doc, sort_keys=True)


def _assert_same_calibration(cal_ref, cal):
    ref, got = cal_ref.result(), cal.result()
    assert [tuple(getattr(r, f) for f in _RECORD_FIELDS)
            for r in got.records] == \
        [tuple(getattr(r, f) for f in _RECORD_FIELDS) for r in ref.records]
    assert got.fingerprint == ref.fingerprint
    want = solve_plan_ref(ref)
    plan = solve_plan(got, cost=tile_ref.split_cost)
    assert _plan_json_without_tiles(plan) == _plan_json_without_tiles(want)
    assert [s.tiles and s.tiles[2] for s in plan.sites] == \
        [s.tiles and s.tiles[2] for s in want.sites]
    return plan, want


def _inputs_only_fn(a, b):
    return a @ b, b.T @ a


def _inputs_only_fn_ref(a, b):
    return a @ b, b.T @ a


class TestAgainstReference:
    # The probe error is held to the bit where both calibrators see the
    # same operands: every site of the toy programs multiplies inputs or
    # float64 products of them.  (A float32 tanh, or the LM's float32
    # softmax and gate, differ between XLA and torch in the last bit,
    # and at s = 4..6 the probe's max error resolves those bits.)
    @pytest.mark.parametrize("backend", ["fp64_int8", "pallas_int8_4"])
    @pytest.mark.parametrize("program,dtype", [
        ("two_site", np.float64), ("inputs_only", np.float64),
        ("inputs_only", np.float32)])
    def test_toy_programs(self, program, dtype, backend):
        fn, fn_ref = {"two_site": (_two_site_fn, _two_site_fn_ref),
                      "inputs_only": (_inputs_only_fn,
                                      _inputs_only_fn_ref)}[program]
        arrays = [x.astype(dtype) for x in _arrays(192, seed=5)]
        head, _, splits = backend.partition("_int8_")
        kw = dict(min_dim=128, backend=f"{head}_int8",
                  **({"default_splits": int(splits)} if splits else {}))
        cal_ref = CalibratorRef(fn_ref, PolicyRef(**kw))
        cal_ref.run(*map(jnp.asarray, arrays))
        cal = Calibrator(fn, PrecisionPolicy(**kw))
        cal.run(*map(torch.from_numpy, arrays))
        plan, _ = _assert_same_calibration(cal_ref, cal)
        assert all(r.measured_rel is not None
                   for r in cal.result().records)

    # Sites on which the plan solved from the port's own LM records may
    # differ from the reference's plan, as measured: at fp64_int8_6 the
    # two sites whose probe errors differ most (scan1/dot9, 2.4x, and
    # scan1/dot10, 4.4x) swap which one is demoted, and the budget that
    # frees moves scan0/dot8 from 10 splits to 9; at pallas_int8_4 none.
    _LM_PLAN_SITES_DIFFER = {"fp64_int8_6": 3, "pallas_int8_4": 0}
    # Largest ratio of the port's LM probe error to the reference's (or
    # back) allowed: measured 4.4x at fp64_int8_6, 1.7x at pallas_int8_4.
    _LM_PROBE_RATIO = 8.0

    @pytest.mark.parametrize("backend", ["fp64_int8_6", "pallas_int8_4"])
    def test_tiny_lm_train_step(self, backend):
        # The float64 tiny LM's train step from one seed in both packages
        # (F1: the same parameters), at x64: 30 sites, forward and
        # backward.  Its operands agree only to float32 rounding (the
        # reference's float32 softmax and gate, ROADMAP section 3), and
        # a probe at s = 4..6 resolves those bits, so the probe errors
        # are held within _LM_PROBE_RATIO, not to the bit.  Held equal:
        # site set, k, dtype, FLOPs, exponents and which sites were
        # measured.  The plan solved from the port's own records is held
        # against the reference's plan site by site (_LM_PLAN_SITES_DIFFER);
        # solved from the port's records with the reference's probe
        # errors, it is the reference's plan byte for byte apart from
        # tiles.
        over = dict(TINY, dtype="float64", param_dtype="float64")
        ref = ModelRef(get_config_ref("tiny").replace(**over))
        params_ref = ref.init_params(jax.random.PRNGKey(3))
        head = np.random.default_rng(3).standard_normal(
            params_ref["lm_head"].shape) * 0.1
        params_ref["lm_head"] = jnp.asarray(head)
        port = Model(get_config("tiny").replace(**over), device="cpu",
                     seed=3)
        params = dict(port.params, lm_head=torch.from_numpy(head))
        batch = SyntheticText(TINY["vocab_size"], 24, 4).batch(0)

        family, splits = backend.rsplit("_", 1)
        kw = dict(backend=family, min_dim=16, default_splits=int(splits))
        cal_ref = CalibratorRef(
            build_train_step_ref(ref, AdamWRef(lr=3e-3)), PolicyRef(**kw))
        cal_ref.run(params_ref, AdamWRef().init(params_ref),
                    jnp.asarray(batch))
        cal = Calibrator(build_train_step(port, AdamW(lr=3e-3)),
                         PrecisionPolicy(**kw))
        cal.run(params, AdamW().init(params), torch.from_numpy(batch))
        ref_res, got = cal_ref.result(), cal.result()
        fields = [f for f in _RECORD_FIELDS if f != "measured_rel"]
        assert [tuple(getattr(r, f) for f in fields)
                for r in got.records] == \
            [tuple(getattr(r, f) for f in fields) for r in ref_res.records]
        assert len(got.records) == 30
        assert got.fingerprint == ref_res.fingerprint
        assert [r.measured_rel is None for r in got.records] == \
            [r.measured_rel is None for r in ref_res.records]
        for mine, theirs in zip(got.records, ref_res.records):
            if mine.measured_rel is not None:
                ratio = mine.measured_rel / theirs.measured_rel
                assert 1 / self._LM_PROBE_RATIO <= ratio \
                    <= self._LM_PROBE_RATIO, (mine.site, ratio)

        want = solve_plan_ref(ref_res)
        own = solve_plan(got, cost=tile_ref.split_cost)
        assert own.budget_met and want.budget_met
        assert len(own.demoted_sites()) == len(want.demoted_sites())
        differ = [(a.site, a.splits, b.splits)
                  for a, b in zip(own.sites, want.sites)
                  if (a.site, a.splits, a.backend)
                  != (b.site, b.splits, b.backend)]
        assert [a.site for a in own.sites] == [b.site for b in want.sites]
        assert len(differ) <= self._LM_PLAN_SITES_DIFFER[backend], differ
        # Where neither plan demotes a site, its split counts differ by
        # at most one.
        assert all(abs(a - b) <= 1 for _, a, b in differ if a and b)

        for mine, theirs in zip(got.records, ref_res.records):
            mine.measured_rel = theirs.measured_rel
        plan = solve_plan(got, cost=tile_ref.split_cost)
        assert _plan_json_without_tiles(plan) == \
            _plan_json_without_tiles(want)
        assert [s.tiles and s.tiles[2] for s in plan.sites] == \
            [s.tiles and s.tiles[2] for s in want.sites]

    def test_from_plan_fields_equal(self):
        import dataclasses

        recs = [_record("dot0", k=256, measured=1e-3),
                _record("scan0/dot1", k=512),
                _record("scan1/dot2", k=1024, flops=10**9)]
        want = solve_plan_ref(_ref_result(recs), budget=1e-9)
        plan = PrecisionPlan.from_json(want.to_json())
        for kw in ({}, {"on_unmatched_site": "ignore"}):
            assert dataclasses.asdict(PrecisionPolicy.from_plan(plan, **kw)) \
                == dataclasses.asdict(PolicyRef.from_plan(want, **kw))

    def test_port_plan_loads_in_the_reference(self, tmp_path):
        a, b = _operands(192)
        cal = Calibrator(_two_site_fn, PrecisionPolicy(min_dim=64))
        cal.run(a, b)
        plan = solve_plan(cal.result())
        loaded = PrecisionPlanRef.load(plan.save(tmp_path / "p.json"))
        assert loaded.to_json() == plan.to_json()
        loaded.validate_sites(site_report_ref(
            _two_site_fn_ref, PolicyRef(min_dim=64))(
                *map(jnp.asarray, _arrays(192))))
