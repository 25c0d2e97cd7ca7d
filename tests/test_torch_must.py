"""Port parity: the MuST Green's-function contour on torch tensors.

``build_system`` is byte-identical; the reference's blocked inverse
driven by the port's backends is bitwise equal to the same function
driven by the reference's; ``run_contour`` on the CPU matches the
reference in ``dgemm`` mode to 1e-10 and reproduces each emulated
mode's Table-1 error and Figure-1 peak.  The port's contour uses native
``torch.linalg.inv`` for the diagonal blocks, whose rounding can move a
slice decision, so an emulated mode is compared within a factor of 2,
not bitwise.
"""

import numpy as np
import pytest
import torch

from repro.apps import must as must_ref
from repro_torch.apps import must
from repro_torch.core import PrecisionPolicy, get_backend

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

CFG = dict(n=96, block=24)


@pytest.fixture(scope="module")
def system():
    return must_ref.build_system(must_ref.MustConfig(**CFG))


@pytest.fixture(scope="module")
def contours(system):
    # One 4-energy contour per mode in each package, shared by the
    # comparisons below.
    cfg_r = must_ref.MustConfig(**CFG, n_energies=4)
    cfg_t = must.MustConfig(**CFG, n_energies=4)
    modes = ("dgemm", "fp64_int8_3", "pallas_int8_6")
    return {mode: (must_ref.run_contour(cfg_r, mode, system),
                   must.run_contour(cfg_t, mode, system, device="cpu"))
            for mode in modes}


def _port_gemm(mode):
    backend = get_backend(mode, policy=PrecisionPolicy(accumulator="f64"))

    def gemm(a, b):
        return backend(torch.from_numpy(a), torch.from_numpy(b),
                       out_dtype=torch.complex128).numpy()

    return gemm


class TestSystem:
    def test_build_system_byte_identical(self, system):
        mine = must.build_system(must.MustConfig(**CFG))
        for key in ("H", "evals"):
            assert mine[key].dtype == system[key].dtype
            assert mine[key].tobytes() == system[key].tobytes()

    def test_system_to_device(self, system):
        dev = must.system_to_device(system, device="cpu")
        assert dev["H"].dtype == torch.complex128
        assert dev["H"].numpy().tobytes() == system["H"].tobytes()

    def test_block_must_divide_n(self):
        with pytest.raises(ValueError):
            must.MustConfig(n=100, block=48)

    def test_contour_points_identical(self):
        z_r, w_r = must_ref.contour_points(must_ref.MustConfig(**CFG))
        z_t, w_t = must.contour_points(must.MustConfig(**CFG))
        assert z_r.tobytes() == z_t.tobytes()
        assert w_r.tobytes() == w_t.tobytes()


class TestBlockGemmsBitwise:
    @pytest.mark.parametrize("mode", ["fp64_int8_6", "pallas_int8_6"])
    def test_blocked_inverse_with_port_backend(self, system, mode):
        cfg = must_ref.MustConfig(**CFG)
        z = cfg.fermi + 1j * cfg.eta
        m_mat = z * np.eye(cfg.n) - system["H"]
        want = must_ref._blocked_inverse(m_mat, cfg.block,
                                         must_ref._make_gemm(mode))
        got = must_ref._blocked_inverse(m_mat, cfg.block, _port_gemm(mode))
        assert got.tobytes() == want.tobytes()


class TestContour:
    def test_dgemm_matches_reference(self, contours):
        ref, mine = contours["dgemm"]
        rel = (np.max(np.abs(mine["g_diag"] - ref["g_diag"]))
               / np.max(np.abs(ref["g_diag"])))
        assert rel <= 1e-10
        assert abs(mine["ne"] - ref["ne"]) <= 1e-10 * abs(ref["ne"])
        assert abs(mine["etot"] - ref["etot"]) <= 1e-10 * abs(ref["etot"])

    @pytest.mark.parametrize("mode", ["fp64_int8_3", "pallas_int8_6"])
    def test_emulated_modes_match_reference_errors(self, contours, mode):
        ref_d, mine_d = contours["dgemm"]
        ref, mine = contours[mode]
        e_ref = must_ref.relative_errors(ref_d, ref)
        e_mine = must.relative_errors(mine_d, mine)
        assert 0.5 <= e_mine["max_real"] / e_ref["max_real"] <= 2.0
        assert (np.argmax(e_mine["per_z_real"])
                == np.argmax(e_ref["per_z_real"]))

    def test_table1_ladder_falls(self, contours):
        _, mine_d = contours["dgemm"]
        e3 = must.relative_errors(mine_d, contours["fp64_int8_3"][1])
        e6 = must.relative_errors(mine_d, contours["pallas_int8_6"][1])
        assert e6["max_real"] < e3["max_real"]

    def test_block_gemm_count(self):
        cfg = must.MustConfig(**CFG)
        calls = []

        def gemm(a, b):
            calls.append(1)
            return a @ b

        m = torch.eye(cfg.n, dtype=torch.complex128) * (1 + 1j)
        must._blocked_inverse(m, cfg.block, gemm)
        assert len(calls) == must.block_gemm_calls(cfg)

    def test_needs_a_device_or_an_explicit_cpu(self, system, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            must.run_contour(must.MustConfig(**CFG, n_energies=1),
                             "dgemm", system)

    def test_relative_errors_identical_function(self, contours):
        base, test = contours["dgemm"][0], contours["fp64_int8_3"][1]
        a = must_ref.relative_errors(base, test)
        b = must.relative_errors(base, test)
        assert set(a) == set(b)
        for key in a:
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key]))

