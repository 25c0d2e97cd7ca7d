"""Port parity: repro_torch.core.ozaki against repro.core.ozaki, bitwise.

The same numpy inputs, made from a seed, go through the JAX reference
and the PyTorch port on the CPU; every result must agree to the bit
(compared as raw bytes), over the cases of ``tests/test_ozaki.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ozaki as ref
from repro_torch.core import ozaki as port
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)


def _gauss(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _cgauss(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _both(a, b, out_dtype=None, **kw):
    """Run both packages; ``out_dtype`` is a dtype name such as "float64"."""
    r = ref.ozaki_matmul(jnp.asarray(a), jnp.asarray(b),
                         out_dtype=out_dtype and jnp.dtype(out_dtype), **kw)
    t = port.ozaki_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          out_dtype=out_dtype and getattr(torch, out_dtype),
                          **kw)
    return r, t


class TestPrimitives:
    def test_pair_indices_identical(self):
        for s in range(1, 15):
            ri, rj = ref.pair_indices(s)
            ti, tj = port.pair_indices(s)
            assert np.array_equal(ri, ti) and np.array_equal(rj, tj)
            assert port.num_pair_gemms(s) == ref.num_pair_gemms(s)

    def test_pow2_scale_powers_of_two_and_neighbours(self):
        vals = []
        for j in range(-70, 70):
            p = 2.0 ** j
            vals += [p, np.nextafter(p, 0), np.nextafter(p, np.inf),
                     -p, p * (1 + 2.0 ** -40), p * (1 - 2.0 ** -40)]
        x = np.array(vals + [0.0]).reshape(-1, 1)
        for axis, arr in ((1, x), (0, x.T.copy())):
            r = ref._pow2_scale(jnp.asarray(arr), axis)
            t = port._pow2_scale(torch.from_numpy(arr), axis)
            assert same_bits(r, t)

    @pytest.mark.parametrize("axis", [0, 1])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_slice_matrix_bitwise(self, axis, dtype):
        x = _gauss((32, 48), 6, dtype) * np.logspace(-8, 8, 48)
        r_sl, r_sig = ref.slice_matrix(jnp.asarray(x), 5, axis=axis)
        t_sl, t_sig = port.slice_matrix(torch.from_numpy(x), 5, axis=axis)
        assert same_bits(r_sl, t_sl) and same_bits(r_sig, t_sig)

    def test_slice_matrix_seven_bits(self):
        x = _gauss((16, 16), 7) * 3.7e-5
        r = ref.slice_matrix(jnp.asarray(x), 3, axis=1, slice_bits=7)
        t = port.slice_matrix(torch.from_numpy(x), 3, axis=1, slice_bits=7)
        assert same_bits(r[0], t[0]) and same_bits(r[1], t[1])


class TestOzakiMatmulBitwise:
    @pytest.mark.parametrize("accumulator", ["df32", "f64"])
    def test_ladder_cases(self, accumulator):
        a, b = _gauss((256, 256), 0), _gauss((256, 256), 1)
        for s in range(3, 10):
            r, t = _both(a, b, num_splits=s, accumulator=accumulator,
                         out_dtype="float64")
            assert same_bits(r, t), (accumulator, s)

    def test_slice_bits_seven(self):
        a, b = _gauss((128, 128), 2), _gauss((128, 128), 3)
        for bits in (6, 7):
            r, t = _both(a, b, num_splits=4, slice_bits=bits)
            assert same_bits(r, t)

    def test_extreme_row_scales(self):
        a = _gauss((64, 64), 4) * np.logspace(-12, 12, 64)[:, None]
        b = _gauss((64, 64), 5) * np.logspace(8, -8, 64)[None, :]
        for acc in ("f64", "df32"):
            r, t = _both(a, b, num_splits=9, accumulator=acc)
            assert same_bits(r, t)

    def test_f32_inputs_default_out(self):
        a = _gauss((96, 64), 8, np.float32)
        b = _gauss((64, 80), 9, np.float32)
        for acc in ("df32", "f64"):
            r, t = _both(a, b, num_splits=6, accumulator=acc)
            assert t.dtype == torch.float32 and same_bits(r, t)

    @pytest.mark.parametrize("accumulator", ["f64", "df32"])
    def test_complex128(self, accumulator):
        a, b = _cgauss((64, 64), 10), _cgauss((64, 64), 11)
        r, t = _both(a, b, num_splits=9, accumulator=accumulator)
        assert t.dtype == torch.complex128 and same_bits(r, t)

    def test_real_times_complex(self):
        a, b = _gauss((32, 48), 12), _cgauss((48, 40), 13)
        r, t = _both(a, b, num_splits=6, accumulator="f64")
        assert same_bits(r, t)

    def test_rejects_bad_rank_splits_and_accumulator(self):
        a = torch.from_numpy(_gauss((8, 8), 11))
        with pytest.raises(ValueError):
            port.ozaki_matmul(a.reshape(2, 4, 8), a)
        with pytest.raises(ValueError):
            port.ozaki_matmul(a, a, num_splits=0)
        with pytest.raises(ValueError):
            port.ozaki_matmul(a, a, accumulator="f16")


class TestF64AccumulatorOrder:
    """The f64 accumulator's sum order follows the reference's compiled
    loop beyond s = 9 and for single-output products (ROADMAP §3)."""

    @pytest.mark.parametrize("num_splits", [10, 11, 12])
    def test_128_cube_above_s9(self, num_splits):
        a, b = _gauss((128, 128), 20), _gauss((128, 128), 21)
        r, t = _both(a, b, num_splits=num_splits, accumulator="f64")
        assert same_bits(r, t)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_single_output_at_s9(self, seed):
        a, b = _gauss((1, 129), 30 + seed), _gauss((129, 1), 40 + seed)
        r, t = _both(a, b, num_splits=9, accumulator="f64")
        assert same_bits(r, t)

    @pytest.mark.parametrize("num_splits", [8, 9, 10, 11, 12])
    def test_order_on_random_products(self, num_splits):
        # Full-range int32 products make nearly every sum order-
        # sensitive, so any departure from the compiled order shows.
        # The weights are compile-time constants, as inside the
        # reference's jitted ozaki_matmul (called eagerly, the einsum
        # takes them as a parameter and compiles to another order).
        ii, jj = ref.pair_indices(num_splits)
        shifts = ii + jj
        acc = jax.jit(lambda prod: ref._accumulate_f64(prod, shifts, 6))
        rng = np.random.default_rng(num_splits)
        for outputs in (1, 2, 3, 5, 8, 9, 21, 129, 4096):
            prod = rng.integers(-2**31 + 1, 2**31 - 1,
                                size=(len(ii), 1, outputs)).astype(np.int32)
            r = acc(jnp.asarray(prod))
            t = port._accumulate_f64(torch.from_numpy(prod), shifts, 6)
            assert same_bits(r, t), outputs


class TestAccuracyLadder:
    def test_readme_ladder_512_strictly_decreasing(self):
        # The README's accuracy sweep at 512^2, s = 3..9, on the port.
        a = torch.from_numpy(_gauss((512, 512), 0))
        b = torch.from_numpy(_gauss((512, 512), 1))
        exact = a @ b
        denom = a.abs() @ b.abs()
        errs = []
        for s in range(3, 10):
            c = port.ozaki_matmul(a, b, num_splits=s, accumulator="df32",
                                  out_dtype=torch.float64)
            errs.append(float(((c - exact).abs() / denom).max()))
        assert all(lo < hi for lo, hi in zip(errs[1:], errs[:-1])), errs
        assert errs[-1] < 1e-12, errs
