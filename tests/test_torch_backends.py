"""Port parity: the backend registry and the precision layer.

The spec grammar round-trips, every family resolves, and the engines
behind the specs give the reference's bits on the same numpy inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backends as backends_ref
from repro.core import precision as precision_ref
from repro_torch.core import backends, precision
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)


def _operands(m, k, n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((k, n))
    if complex_:
        a = a + 1j * rng.standard_normal((m, k))
        b = b + 1j * rng.standard_normal((k, n))
    return a, b


class TestRegistry:
    def test_round_trip_every_example_spec(self):
        assert backends.example_specs() == backends_ref.example_specs()
        for spec in backends.example_specs():
            assert backends.get_backend(spec).spec == spec

    def test_same_families(self):
        assert (backends.registered_families()
                == backends_ref.registered_families())

    def test_spec_parsing(self):
        b = backends.get_backend("fp64_int8_6")
        assert b.pinned_splits == 6
        assert backends.get_backend("fp64_int8").pinned_splits is None
        k = backends.get_backend("pallas_int8_4:fused")
        assert k.fused and k.pinned_splits == 4
        assert backends.get_backend("adaptive:1e-7").target_rel == 1e-7

    @pytest.mark.parametrize("spec", ["fp32", "dgemm_3", "dgemm:x",
                                      "fp64_int8:x", "pallas_int8:bad",
                                      "adaptive_3", ""])
    def test_malformed_specs_rejected_like_the_reference(self, spec):
        with pytest.raises(ValueError):
            backends_ref.get_backend(spec)
        with pytest.raises(ValueError):
            backends.get_backend(spec)

    def test_custom_family_registration(self):
        class Doubling(backends.GemmBackend):
            def matmul(self, a, b, *, out_dtype=None, num_splits=None,
                       site="default"):
                return 2 * (a @ b)

        backends.register_backend(
            "doubling_test", lambda spec, policy, splits, arg:
            Doubling(spec, policy))
        try:
            a = torch.eye(3)
            assert torch.equal(backends.get_backend("doubling_test")(a, a),
                               2 * a)
        finally:
            backends._FACTORIES.pop("doubling_test")


class TestPolicy:
    def test_from_reference_round_trip(self):
        ref = precision_ref.PrecisionPolicy(
            default_splits=5, min_dim=64, accumulator="f64",
            backend="pallas_int8", site_splits={"dot1": 9},
            site_backends={"dot0": "dgemm"}, on_unmatched_site="raise")
        pol = precision.PrecisionPolicy.from_reference(
            dataclasses.asdict(ref))
        assert dataclasses.asdict(pol) == dataclasses.asdict(ref)
        for site in ("dot0", "dot1", "shmap0/dot1", "dot7"):
            assert pol.splits_for(site) == ref.splits_for(site)
            assert pol.backend_for(site) == ref.backend_for(site)
        with pytest.raises(ValueError):
            precision.PrecisionPolicy.from_reference({"bogus": 1})

    def test_canonical_site_and_unmatched(self):
        pol = precision.PrecisionPolicy(site_splits={"scan0/dot0": 4,
                                                     "typo": 3})
        ref = precision_ref.PrecisionPolicy(site_splits={"scan0/dot0": 4,
                                                         "typo": 3})
        names = ["shmap0/scan0/dot0", "dot1"]
        assert pol.unmatched_overrides(names) == \
            ref.unmatched_overrides(names)
        assert precision.canonical_site("pmap1/shmap0/cond1/br0/dot0") == \
            precision_ref.canonical_site("pmap1/shmap0/cond1/br0/dot0")

    def test_pinned_spec_is_authoritative(self):
        a, b = (torch.from_numpy(x) for x in _operands(64, 64, 64, 0))
        pinned = backends.get_backend(
            "fp64_int8_3", precision.PrecisionPolicy(default_splits=9))
        assert torch.equal(pinned(a, b, num_splits=9),
                           backends.get_backend("fp64_int8_3")(a, b))


class TestSplitModels:
    def test_a_priori_model_identical(self):
        for tol in (1e-3, 1e-6, 1e-9, 1e-12, 1e-15, 1e-30):
            for k in (1, 64, 256, 4096):
                assert (precision.splits_for_tolerance(tol, k)
                        == precision_ref.splits_for_tolerance(tol, k))
                assert (precision.estimate_rel_error(5, k)
                        == precision_ref.estimate_rel_error(5, k))

    def test_predict_and_measure_pick_the_same_splits(self):
        a, b = _operands(96, 96, 96, 2)
        for tol in (1e-4, 1e-8, 1e-12):
            assert (precision.predict_splits(torch.from_numpy(a),
                                             torch.from_numpy(b), tol)
                    == precision_ref.predict_splits(jnp.asarray(a),
                                                    jnp.asarray(b), tol))
            s_t, e_t = precision.measure_splits(
                torch.from_numpy(a), torch.from_numpy(b), tol)
            s_r, e_r = precision_ref.measure_splits(
                jnp.asarray(a), jnp.asarray(b), tol)
            assert s_t == s_r
            assert e_t == pytest.approx(e_r, rel=1e-6)

    def test_predict_rejects_mismatched_k(self):
        with pytest.raises(ValueError):
            precision.predict_splits(torch.ones(4, 8), torch.ones(7, 4))

    def test_adaptive_probes_caches_and_matches(self):
        a, b = _operands(64, 64, 64, 3)
        g_t = precision.AdaptiveGemm(target_rel=1e-9)
        g_r = precision_ref.AdaptiveGemm(target_rel=1e-9)
        t = g_t(torch.from_numpy(a), torch.from_numpy(b), site="tau")
        r = g_r(jnp.asarray(a), jnp.asarray(b), site="tau")
        g_t(torch.from_numpy(a), torch.from_numpy(b), site="tau")
        assert g_t.sites["tau"].splits == g_r.sites["tau"].splits
        assert g_t.sites["tau"].calls == 2
        assert same_bits(r, t)


class TestBackendNumerics:
    @pytest.mark.parametrize("complex_", [False, True])
    def test_kernel_fused_and_plain_families_against_reference(self,
                                                               complex_):
        # pallas_int8_4 vs pallas_int8_4:fused vs fp64_int8_4, each
        # against its reference counterpart, bit for bit.
        a, b = _operands(64, 96, 48, 16, complex_)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        odt = "complex128" if complex_ else "float64"
        got = {}
        for spec in ("pallas_int8_4", "pallas_int8_4:fused",
                     "fp64_int8_4"):
            r = backends_ref.get_backend(spec)(ja, jb,
                                               out_dtype=jnp.dtype(odt))
            t = backends.get_backend(spec)(ta, tb,
                                           out_dtype=getattr(torch, odt))
            assert same_bits(r, t), spec
            got[spec] = t
        # f64 sources: the fused slicing may pick other (value-
        # preserving) slices, so fused vs plain is an accuracy bound.
        assert torch.equal(got["pallas_int8_4"], got["fp64_int8_4"])
        diff = (got["pallas_int8_4:fused"] - got["pallas_int8_4"]).abs()
        assert float(diff.max()) < 1e-4

    def test_kernel_family_ignores_accumulator_like_the_reference(self):
        a, b = _operands(48, 64, 40, 17)
        pol_t = precision.PrecisionPolicy(accumulator="f64")
        pol_r = precision_ref.PrecisionPolicy(accumulator="f64")
        t = backends.get_backend("pallas_int8_6", pol_t)(
            torch.from_numpy(a), torch.from_numpy(b))
        r = backends_ref.get_backend("pallas_int8_6", pol_r)(
            jnp.asarray(a), jnp.asarray(b))
        assert same_bits(r, t)

    def test_dgemm_matches_native(self):
        a, b = (torch.from_numpy(x) for x in _operands(32, 32, 32, 18))
        assert torch.equal(backends.get_backend("dgemm")(a, b), a @ b)

    def test_f32_out_from_f64_kernel_family(self):
        a, b = _operands(40, 70, 30, 19)
        t = backends.get_backend("pallas_int8_5")(
            torch.from_numpy(a), torch.from_numpy(b),
            out_dtype=torch.float32)
        r = backends_ref.get_backend("pallas_int8_5")(
            jnp.asarray(a), jnp.asarray(b), out_dtype=jnp.float32)
        assert same_bits(r, t)
