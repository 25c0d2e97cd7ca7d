"""Port parity: the split-GEMM kernels' plain versions against Pallas.

On the CPU the port's kernel wrappers run the kernels' plain versions,
which must equal the reference's Pallas kernels in interpret mode to
the bit (hi and lo compared as raw bytes) at the same ``block_k``.  The
CUDA kernels themselves are held bitwise against these plain versions
on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ops_ref
from repro.kernels import slicing as slicing_ref
from repro.kernels import tile_model as tile_ref
from repro_torch.core import ozaki as core_port
from repro_torch.kernels import ops, slicing, tile_model
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

# The shapes of tests/test_kernels.py's bit-identity cases, plus one
# with three k-tiles at block_k=128.
SHAPES = [(37, 130, 51, None), (100, 200, 60, None), (64, 96, 64, None),
          (1, 129, 1, None), (40, 300, 24, 128)]


def _operands(m, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(dtype),
            rng.standard_normal((k, n)).astype(dtype))


def _block_k(m, k, n, s, fused, explicit):
    if explicit is not None:
        return explicit
    bk = tile_ref.select_tiles(m, k, n, s, fused=fused).block_k
    assert tile_model.select_tiles(m, k, n, s, fused=fused).block_k == bk
    return bk


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("num_splits", [3, 5, 9])
@pytest.mark.parametrize("m,k,n,bk", SHAPES)
class TestPlainKernelsAgainstPallas:
    def test_k1_plain_bitwise(self, m, k, n, bk, num_splits, dtype):
        # The slices come from the port (bitwise equal to the
        # reference's, tests/test_torch_ozaki.py) and feed both kernels.
        a, b = _operands(m, k, n, 7, dtype)
        s = num_splits
        bk = _block_k(m, k, n, s, False, bk)
        t_a, _ = core_port.slice_matrix(torch.from_numpy(a), s, axis=1)
        t_b, _ = core_port.slice_matrix(torch.from_numpy(b), s, axis=0)
        hi_r, lo_r = ops_ref.split_gemm_pallas(
            jnp.asarray(t_a.numpy()), jnp.asarray(t_b.numpy()), s,
            block_k=bk, interpret=True)
        hi_t, lo_t = ops.split_gemm(t_a, t_b, s, block_k=bk)
        assert same_bits(hi_r, hi_t) and same_bits(lo_r, lo_t)

    def test_k2_plain_bitwise(self, m, k, n, bk, num_splits, dtype):
        a, b = _operands(m, k, n, 13, dtype)
        s = num_splits
        bk = _block_k(m, k, n, s, True, bk)
        th, tl, _ = slicing.to_operand_pair(torch.from_numpy(a), axis=1)
        uh, ul, _ = slicing.to_operand_pair(torch.from_numpy(b), axis=0)
        hi_r, lo_r = ops_ref.split_gemm_pallas_fused(
            *(jnp.asarray(x.numpy()) for x in (th, tl, uh, ul)), s,
            block_k=bk, interpret=True)
        hi_t, lo_t = ops.split_gemm_fused(th, tl, uh, ul, s, block_k=bk)
        assert same_bits(hi_r, hi_t) and same_bits(lo_r, lo_t)

    def test_k3_plain_bitwise(self, m, k, n, bk, num_splits, dtype):
        # K3 against the reference's v1 kernel in interpret mode, and
        # against K1's plain version (v1 == v2, the reference's A/B).
        a, b = _operands(m, k, n, 19, dtype)
        s = num_splits
        bk = _block_k(m, k, n, s, False, bk)
        t_a, _ = core_port.slice_matrix(torch.from_numpy(a), s, axis=1)
        t_b, _ = core_port.slice_matrix(torch.from_numpy(b), s, axis=0)
        hi_r, lo_r = ops_ref.split_gemm_pallas_v1(
            jnp.asarray(t_a.numpy()), jnp.asarray(t_b.numpy()), s,
            block_k=bk, interpret=True)
        hi_t, lo_t = ops.split_gemm_v1(t_a, t_b, s, block_k=bk)
        assert same_bits(hi_r, hi_t) and same_bits(lo_r, lo_t)
        hi_1, lo_1 = ops.split_gemm_plain(t_a, t_b, s, block_k=bk)
        assert torch.equal(hi_1, hi_t) and torch.equal(lo_1, lo_t)


class TestSlicing:
    @pytest.mark.parametrize("axis", [0, 1])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_operand_pair_and_fused_slices_bitwise(self, axis, dtype):
        x = _operands(40, 70, 1, 17, dtype)[0] * np.logspace(-6, 6, 70)
        r = slicing_ref.to_operand_pair(jnp.asarray(x), axis=axis)
        t = slicing.to_operand_pair(torch.from_numpy(x), axis=axis)
        assert all(same_bits(u, v) for u, v in zip(r, t))
        r = slicing_ref.slice_matrix_fused(jnp.asarray(x), 6, axis=axis)
        t = slicing.slice_matrix_fused(torch.from_numpy(x), 6, axis=axis)
        assert all(same_bits(u, v) for u, v in zip(r, t))

    def test_quantize_tile_selects_each_slice(self):
        x = torch.from_numpy(_operands(24, 33, 1, 18, np.float64)[0])
        hi, lo, _ = slicing.to_operand_pair(x, axis=1)
        full, _ = slicing.slice_matrix_fused(x, 5, axis=1)
        for t in range(5):
            assert torch.equal(slicing.quantize_tile(hi, lo, t, 5), full[t])
        with pytest.raises(ValueError):
            slicing.quantize_tile(hi, lo, 5, 5)


class TestWrapper:
    @pytest.mark.parametrize("fuse", [False, True])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_ozaki_matmul_matches_reference_wrapper(self, fuse, dtype):
        a, b = _operands(37, 130, 51, 14, dtype)
        r = ops_ref.ozaki_matmul(jnp.asarray(a), jnp.asarray(b),
                                 num_splits=6, interpret=True,
                                 fuse_slicing=fuse, out_dtype=jnp.float64)
        t = ops.ozaki_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             num_splits=6, fuse_slicing=fuse,
                             out_dtype=torch.float64)
        assert same_bits(r, t)

    def test_explicit_blocks_match_reference(self):
        # An explicit block_k below the model's pick gives several
        # k-tiles; both wrappers must round and fold it identically.
        a, b = _operands(64, 300, 48, 15, np.float64)
        r = ops_ref.ozaki_matmul(jnp.asarray(a), jnp.asarray(b),
                                 num_splits=5, interpret=True, block_m=32,
                                 block_n=128, block_k=100)
        t = ops.ozaki_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             num_splits=5, block_m=32, block_n=128,
                             block_k=100)
        assert same_bits(r, t)

    def test_model_blocks_equal_core_df32(self):
        # One k-tile: the kernel path equals the core df32 path exactly.
        a, b = _operands(64, 96, 64, 10, np.float32)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = ops.ozaki_matmul(ta, tb, num_splits=4)
        want = core_port.ozaki_matmul(ta, tb, num_splits=4,
                                      accumulator="df32")
        assert torch.equal(got, want)

    @pytest.mark.parametrize("fuse", [False, True])
    def test_unsupported_accumulator_raises(self, fuse):
        a = torch.ones((32, 32))
        with pytest.raises(ValueError, match="accumulator"):
            ops.ozaki_matmul(a, a, num_splits=3, accumulator="f64",
                             fuse_slicing=fuse)

    def test_none_accumulator_means_df32(self):
        a, b = (torch.from_numpy(x) for x in _operands(32, 32, 32, 12,
                                                       np.float32))
        got = ops.ozaki_matmul(a, b, num_splits=3, accumulator=None)
        want = ops.ozaki_matmul(a, b, num_splits=3, accumulator="df32")
        assert torch.equal(got, want)

    def test_rejects_complex(self):
        a = torch.ones((32, 32), dtype=torch.complex64)
        with pytest.raises(NotImplementedError):
            ops.ozaki_matmul(a, a, num_splits=3)

    def test_wrappers_check_inputs(self):
        a_sl = torch.zeros((3, 8, 16), dtype=torch.int8)
        with pytest.raises(TypeError):
            ops.split_gemm(a_sl.float(), a_sl, 3)
        with pytest.raises(ValueError):
            ops.split_gemm(a_sl, torch.zeros((3, 8, 4), dtype=torch.int8),
                           3)
        with pytest.raises(ValueError):
            ops.split_gemm(a_sl.transpose(1, 2),
                           torch.zeros((3, 8, 4), dtype=torch.int8), 3)
        x = torch.zeros((8, 16))
        with pytest.raises(ValueError):
            ops.split_gemm_fused(x, x, x, x, 3)

    def test_plain_versions_do_not_launch(self):
        before = dict(ops.LAUNCHES)
        a, b = (torch.from_numpy(x) for x in _operands(16, 16, 16, 1,
                                                       np.float64))
        ops.ozaki_matmul(a, b, num_splits=3)
        ops.ozaki_matmul(a, b, num_splits=3, fuse_slicing=True)
        a_sl, _ = core_port.slice_matrix(a, 3, axis=1)
        ops.split_gemm_v1(a_sl, a_sl, 3)
        assert ops.LAUNCHES == before

    def test_gathered_pairs_and_weights(self):
        a_sl = torch.arange(4 * 2 * 3, dtype=torch.int8).reshape(4, 2, 3)
        b_sl = -a_sl.transpose(1, 2).contiguous()
        a_p, b_p, w = ops.gather_pairs(a_sl, b_sl, 4)
        ii, jj = core_port.pair_indices(4)
        assert torch.equal(a_p, a_sl[list(ii)])
        assert torch.equal(b_p, b_sl[list(jj)])
        assert w.dtype == torch.float32
        assert w.tolist() == [2.0 ** ((3 - i - j) * 6)
                              for i, j in zip(ii, jj)]
        with pytest.raises(ValueError):
            ops.split_gemm_v1(a_sl, b_sl, 3)


class TestTileRule:
    def test_block_k_parity_sweep(self):
        ks = [1, 31, 127, 128, 129, 200, 255, 256, 257, 300, 383, 384,
              385, 511, 512, 513, 640, 1000, 1100, 4096, None]
        dims = [None, 1, 37, 96, 256, 4096]
        for k in ks:
            for m in dims:
                for n in dims:
                    if (m is None) != (n is None):
                        continue
                    for s in (1, 3, 6, 9):
                        for fused in (False, True):
                            want = tile_ref.select_tiles(
                                m, k, n, s, fused=fused).block_k
                            got = tile_model.select_tiles(
                                m, k, n, s, fused=fused).block_k
                            assert got == want, (m, k, n, s, fused)

    def test_examples_from_the_reference(self):
        for (m, k, n), bk in {(37, 130, 51): 256, (96, 96, 384): 128,
                              (256, 256, 4096): 256,
                              (4096, 4096, 4096): 512}.items():
            assert tile_model.select_tiles(m, k, n, 6).block_k == bk

    def test_decision_fields_and_summary(self):
        d = tile_model.select_tiles(256, 256, 4096, 6, fused=True)
        r = tile_ref.select_tiles(256, 256, 4096, 6, fused=True)
        assert set(vars(d)) == set(vars(r))
        assert set(d.summary()) == set(r.summary())
        assert (d.pairs, d.schedule, d.fused) == (r.pairs, r.schedule,
                                                  r.fused)

    def test_pair_schedule_matches_reference(self):
        for s in (1, 4, 9):
            for mode in ("ordered", "grouped"):
                ri, rj = tile_ref.pair_schedule(s, mode)
                ti, tj = tile_model.pair_schedule(s, mode)
                assert np.array_equal(ri, ti) and np.array_equal(rj, tj)



class TestTraffic:
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("m,k,n,s", [(128, 128, 128, 6),
                                         (256, 256, 4096, 6),
                                         (37, 130, 51, 3),
                                         (1, 129, 1, 9)])
    def test_formula_at_the_cuda_blocks(self, m, k, n, s, fused):
        bk = tile_model.block_k_for(k)
        t = tile_model.traffic(m, k, n, s, fused=fused)
        mp, kp, np_ = (tile_model.align_up(m, 64),
                       tile_model.align_up(k, bk),
                       tile_model.align_up(n, 64))
        elems = mp * kp + kp * np_
        pairs = s * (s + 1) // 2
        steps = (mp // 64) * (np_ // 64) * pairs * (kp // bk)
        assert t.slice_read_bytes_v1 == pairs * elems
        assert t.slice_read_bytes_v2 == s * elems
        assert t.stage_bytes_v1 == s * elems + 2 * pairs * elems
        assert t.stage_bytes_v2 == (8 * elems if fused else s * elems)
        assert t.stream_bytes == steps * (8 if fused else 1) * (
            64 * bk + bk * 64)
        assert t.out_bytes == 8 * mp * np_
        assert t.read_reduction == pytest.approx((s + 1) / 2)
        # The reference's accounting at the same blocks.
        r = tile_ref.traffic(m, k, n, s, 64, 64, bk, fused=fused)
        assert vars(t) == vars(r)

    def test_read_reduction_is_s_plus_1_over_2(self):
        for s in range(1, 10):
            t = tile_model.traffic(256, 256, 256, s)
            assert t.read_reduction == pytest.approx((s + 1) / 2)

    def test_decisions_carry_the_traffic(self):
        d = tile_model.select_tiles(256, 256, 4096, 6)
        assert d.traffic_model == tile_model.traffic(256, 256, 4096, 6)
        assert d.traffic_model.total_v1 > d.traffic_model.total_v2
        assert tile_model.select_tiles(None, 96, None, 4).traffic_model \
            is None
