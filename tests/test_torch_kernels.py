"""Port parity: the split-GEMM kernels' plain versions against Pallas.

On the CPU the port's kernel wrappers run the kernels' plain versions,
which must equal the reference's Pallas kernels in interpret mode to
the bit (hi and lo compared as raw bytes) at the same ``block_k``.  The
CUDA kernels themselves are held bitwise against these plain versions
on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import ctypes
import dataclasses
import pathlib
import re

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


def _k2_replay(a_hi, a_lo, b_hi, b_lo, s, bits, bk, group):
    """K2's loop nest in eager torch: each k-chunk of the f32 halves is
    sliced once per pair group (the recurrence run once per element,
    every slice the group needs kept), the group's pairs accumulate
    int32 partials, the first pair folds at every k-tile's end and the
    others hold a partial per k-tile until the group ends, then fold
    in schedule order."""
    m, k = a_hi.shape
    n = b_hi.shape[1]
    kc = tile_model.FUSED_K_CHUNK
    ii, jj, wexp = ops.pair_schedule_arrays(s, bits)
    pairs = len(ii)
    nkt, nck, per_tile = -(-k // bk), -(-k // kc), bk // kc
    hold = tile_model.fused_hold(group, nkt)
    radix = float(2 ** bits)
    hi = torch.zeros((m, n), dtype=torch.float32)
    lo = torch.zeros_like(hi)

    def fold(hi, lo, part, p):
        term = part.to(torch.float32) * float(np.ldexp(np.float32(1.0),
                                                       int(wexp[p])))
        hi, err = core_port._two_sum(hi, term)
        return hi, lo + err

    def slices(h, l, count):
        out = []
        for _ in range(count):
            q, h, l = slicing.slice_step(h, l, radix)
            out.append(q.to(torch.int8))
        return out

    for p0 in range(0, pairs, group):
        last = min(pairs, p0 + group)
        nsa = max(int(ii[p]) + 1 for p in range(p0, last))
        nsb = max(int(jj[p]) + 1 for p in range(p0, last))
        acc = [torch.zeros((m, n), dtype=torch.int32) for _ in range(hold)]
        for q in range(nck):
            cols = slice(q * kc, (q + 1) * kc)
            a_q = slices(a_hi[:, cols], a_lo[:, cols], nsa)
            b_q = slices(b_hi[cols], b_lo[cols], nsb)
            t_cur = q // per_tile
            for h in range(hold):
                g, t = (0, t_cur) if h == 0 else (1 + (h - 1) // nkt,
                                                  (h - 1) % nkt)
                if t == t_cur and p0 + g < last:
                    acc[h] += core_port.int8_matmul_exact(
                        a_q[ii[p0 + g]], b_q[jj[p0 + g]])
            if (q + 1) % per_tile == 0 or q + 1 == nck:
                hi, lo = fold(hi, lo, acc[0], p0)
                acc[0] = torch.zeros_like(acc[0])
        for h in range(1, hold):
            g = 1 + (h - 1) // nkt
            if p0 + g < last:
                hi, lo = fold(hi, lo, acc[h], p0 + g)
    return hi, lo


# (m, k, n, block_k): one, two and three k-tiles, ragged k and edges,
# and k-tiles of several chunks.
REPLAY_SHAPES = [(5, 100, 6, 128), (7, 200, 5, 128), (6, 300, 9, 128),
                 (3, 600, 4, 256)]


class TestK2LoopNest:
    @pytest.mark.parametrize("num_splits", [1, 3, 5, 9, 14])
    @pytest.mark.parametrize("m,k,n,bk", REPLAY_SHAPES)
    def test_replay_bitwise_for_every_group_size(self, m, k, n, bk,
                                                 num_splits):
        a, b = _operands(m, k, n, 23, np.float64)
        s = num_splits
        th, tl, _ = slicing.to_operand_pair(torch.from_numpy(a), axis=1)
        uh, ul, _ = slicing.to_operand_pair(torch.from_numpy(b), axis=0)
        want = ops.split_gemm_fused_plain(th, tl, uh, ul, s, block_k=bk)
        hi_r, lo_r = ops_ref.split_gemm_pallas_fused(
            *(jnp.asarray(x.numpy()) for x in (th, tl, uh, ul)), s,
            block_k=bk, interpret=True)
        assert same_bits(hi_r, want[0]) and same_bits(lo_r, want[1])
        top = tile_model.fused_plan(s, -(-k // bk)).group
        for group in range(1, top + 1):
            got = _k2_replay(th, tl, uh, ul, s, 6, bk, group)
            assert torch.equal(got[0], want[0]), group
            assert torch.equal(got[1], want[1]), group

    def test_replay_from_f32_sources_at_the_rule_s_group(self):
        a, b = _operands(33, 257, 40, 24, np.float32)
        th, tl, _ = slicing.to_operand_pair(torch.from_numpy(a), axis=1)
        uh, ul, _ = slicing.to_operand_pair(torch.from_numpy(b), axis=0)
        for s, bk in ((6, 128), (6, 256), (9, 128)):
            group = tile_model.fused_plan(s, -(-257 // bk)).group
            got = _k2_replay(th, tl, uh, ul, s, 6, bk, group)
            want = ops.split_gemm_fused(th, tl, uh, ul, s, block_k=bk)
            assert all(torch.equal(x, y) for x, y in zip(got, want))


def _k1_replay(a_sl, b_sl_t, s, bits, bk, plan):
    """K1's loop nest in eager torch for one plan: each block_m x block_n
    CTA tile, its operand rows zero-padded past m, n and k as the kernel
    stages them; resident, every pair's one k-tile from all 32-byte k
    steps; streamed, the k-tiles of the pairs in fold order from
    128-byte chunks; each exact int32 partial TwoSum-folded."""
    _, m, k = a_sl.shape
    n = b_sl_t.shape[1]
    bm, bn = plan.block_m, plan.block_n
    step = 32 if plan.resident else tile_model.K1_K_CHUNK
    kp = tile_model.align_up(k, tile_model.K1_K_CHUNK)
    ii, jj, wexp = ops.pair_schedule_arrays(s, bits)
    a = torch.zeros((s, tile_model.align_up(m, bm), kp), dtype=torch.int8)
    b = torch.zeros((s, tile_model.align_up(n, bn), kp), dtype=torch.int8)
    a[:, :m, :k], b[:, :n, :k] = a_sl, b_sl_t
    hi = torch.zeros((a.shape[1], b.shape[1]), dtype=torch.float32)
    lo = torch.zeros_like(hi)
    for r0 in range(0, a.shape[1], bm):
        for c0 in range(0, b.shape[1], bn):
            h = torch.zeros((bm, bn), dtype=torch.float32)
            lw = torch.zeros_like(h)
            for p in range(len(ii)):
                w = float(np.ldexp(np.float32(1.0), int(wexp[p])))
                for k0 in range(0, k, bk):
                    part = torch.zeros((bm, bn), dtype=torch.int32)
                    for q in range(k0, min(k0 + bk, kp), step):
                        part += core_port.int8_matmul_exact(
                            a[ii[p], r0:r0 + bm, q:q + step],
                            b[jj[p], c0:c0 + bn, q:q + step].T)
                    h, err = core_port._two_sum(
                        h, part.to(torch.float32) * w)
                    lw = lw + err
            hi[r0:r0 + bm, c0:c0 + bn] = h
            lo[r0:r0 + bm, c0:c0 + bn] = lw
    return hi[:m, :n], lo[:m, :n]


# (m, k, n, block_k): one, two and five k-tiles, ragged edges and k.
K1_REPLAY_SHAPES = [(70, 100, 40, 128), (65, 200, 33, 128),
                    (9, 600, 70, 128)]


class TestK1LoopNest:
    @pytest.mark.parametrize("num_splits", [1, 3, 5, 9, 14])
    @pytest.mark.parametrize("m,k,n,bk", K1_REPLAY_SHAPES)
    def test_replay_bitwise_for_every_plan(self, m, k, n, bk, num_splits):
        a, b = _operands(m, k, n, 41, np.float64)
        s = num_splits
        a_sl, _ = core_port.slice_matrix(torch.from_numpy(a), s, axis=1)
        b_t, _ = core_port.slice_matrix(torch.from_numpy(b).mT, s, axis=1)
        want = ops.split_gemm_kmajor(a_sl, b_t, s, block_k=bk)
        hi_r, lo_r = ops_ref.split_gemm_pallas(
            jnp.asarray(a_sl.numpy()),
            jnp.asarray(b_t.transpose(1, 2).numpy()), s, block_k=bk,
            interpret=True)
        assert same_bits(hi_r, want[0]) and same_bits(lo_r, want[1])
        plans = tile_model.k1_plans(m, k, n, s, bk)
        assert any(p.resident for p in plans) == (k <= bk)
        for plan in plans:
            got = _k1_replay(a_sl, b_t, s, 6, bk, plan)
            assert torch.equal(got[0], want[0]), plan
            assert torch.equal(got[1], want[1]), plan


class TestK1Plan:
    def test_plans_stay_within_their_budgets(self):
        for s in range(1, tile_model.MAX_KERNEL_SPLITS + 1):
            for m, k, n in ((256, 256, 4096), (256, 256, 256),
                            (512, 960, 2560), (221, 2560, 960),
                            (1, 129, 1), (37, 130, 51), (100, 1100, 60)):
                bk = tile_model.block_k_for(k)
                plans = tile_model.k1_plans(m, k, n, s, bk)
                assert {(p.block_m, p.block_n) for p in plans
                        if not p.resident} == set(tile_model.K1_TILES)
                for p in plans:
                    assert (p.smem_bytes + tile_model.K1_STATIC_SMEM
                            <= tile_model.SMEM_PER_BLOCK)
                    assert p.ctas == -(-m // p.block_m) * -(-n // p.block_n)
                    if p.resident:
                        assert k <= bk
                        assert p.smem_bytes == (
                            s * (p.block_m + p.block_n)
                            * tile_model.align_up(k, 128)
                            + tile_model.K1_ALIGN_SLACK)
                assert tile_model.k1_plan(m, k, n, s, bk) in plans

    def test_rule_at_the_main_paths_shapes(self):
        def tile(*shape):
            p = tile_model.k1_plan(*shape)
            return p.block_m, p.block_n, p.resident

        # MuST, one k-tile: s layers resident where they fit.
        assert tile(256, 256, 4096, 6) == (64, 64, True)
        assert tile(256, 256, 4096, 3) == (64, 64, True)
        assert tile(256, 256, 256, 6) == (64, 32, True)
        assert tile(256, 256, 256, 9) == (64, 32, True)
        assert tile(256, 256, 4096, 9)[2] is False
        assert tile(256, 256, 4096, 16)[2] is False
        # SmolLM-360M prefill, two and five k-tiles: streamed.
        assert tile(512, 960, 320, 6) == (64, 32, False)
        assert tile(512, 960, 2560, 6) == (64, 64, False)
        assert tile(512, 2560, 960, 6) == (64, 32, False)

    def test_forced_plans_and_what_k1_cannot_take(self):
        def tiles(*shape):
            return {(p.block_m, p.block_n, p.resident)
                    for p in tile_model.k1_plans(*shape)}

        # A plan is forced by passing one of k1_plans to the wrapper.
        forced = next(p for p in tile_model.k1_plans(256, 256, 4096, 6)
                      if (p.block_m, p.resident) == (128, False))
        assert (forced.block_n, forced.ctas) == (64, 128)
        args = (256, 256, 4096, 6, 6, 256)
        got = ops._k1_launch_args(*args, forced)
        assert (got.block_m, got.block_n, got.resident) == (128, 64, 0)
        # Two k-tiles: no residency.
        assert not any(r for _, _, r in tiles(512, 960, 320, 6, 512))
        # s = 9 layers of 64x64 need 295 KB: only 64x32 stays resident.
        assert {(bm, bn) for bm, bn, r in tiles(256, 256, 4096, 9)
                if r} == {(64, 32)}
        with pytest.raises(ValueError):
            tile_model.k1_plan(256, 256, 4096, 17)
        with pytest.raises(ValueError):
            tile_model.k1_plan(0, 256, 4096, 6)
        for plan in (   # a plan of another shape, and one K1 cannot take
                tile_model.k1_plan(256, 256, 4096, 6),
                dataclasses.replace(
                    tile_model.k1_plan(512, 960, 320, 6), resident=True)):
            with pytest.raises(ValueError):
                ops._k1_launch_args(512, 960, 320, 6, 6, 512, plan)

    def test_launch_arguments_carry_the_plan_and_schedule(self):
        # One struct per shape, laid out as K1Args in split_gemm.cu.
        assert ops._build.MAX_PAIRS == tile_model.num_pair_gemms(
            tile_model.MAX_KERNEL_SPLITS)
        # The ints, then the output kind and a double (8-aligned).
        ints = 4 * (8 + 3 * ops._build.MAX_PAIRS + 1)
        assert ctypes.sizeof(ops._build.K1Args) == -(-ints // 8) * 8 + 8
        for (m, k, n), s in (((256, 256, 4096), 6), ((512, 960, 320), 16),
                             ((37, 130, 51), 1)):
            bk = tile_model.effective_block_k(k, 512)
            plan = tile_model.k1_plan(m, k, n, s, bk)
            got = ops._k1_launch_args(m, k, n, s, 6, 512, None)
            ii, jj, wexp = ops.pair_schedule_arrays(s, 6)
            pairs = len(ii)
            assert (got.m, got.k, got.n, got.block_k, got.num_pairs) == (
                m, k, n, bk, pairs)
            assert (got.block_m, got.block_n, got.resident) == (
                plan.block_m, plan.block_n, int(plan.resident))
            assert list(got.ii[:pairs]) == ii.tolist()
            assert list(got.jj[:pairs]) == jj.tolist()
            assert list(got.wexp[:pairs]) == wexp.tolist()
            assert got.out_kind == ops._build.K1_OUT_PAIR
            assert got.deferred == 2.0 ** (-6 * (s + 1))
        for dtype, kind in ((torch.float32, ops._build.K1_OUT_F32),
                            (torch.float64, ops._build.K1_OUT_F64)):
            got = ops._k1_launch_args(512, 960, 320, 6, 6, 512, None,
                                      ops._OUT_KINDS[dtype])
            assert got.out_kind == kind
            assert got is not ops._k1_launch_args(512, 960, 320, 6, 6, 512,
                                                  None)

    def test_launch_arguments_match_the_source(self):
        # K1Args and the epilogue's output kinds as split_gemm.cu has
        # them.
        text = (pathlib.Path(ops.__file__).resolve().parent / "csrc"
                / "split_gemm.cu").read_text()
        fields = re.search(r"struct K1Args \{(.*?)\};", text,
                           re.S).group(1)
        declared = [(name.split("[")[0], kind)
                    for kind, names in re.findall(r"(int|double) ([^;]+);",
                                                  fields)
                    for name in names.replace(" ", "").split(",")]
        assert [name for name, _ in ops._build.K1Args._fields_] == [
            name for name, _ in declared]
        assert dict(declared)["deferred"] == "double"
        for name in ("K1_OUT_PAIR", "K1_OUT_F32", "K1_OUT_F64"):
            value = re.search(rf"constexpr int {name} = (\d+);", text)
            assert int(value.group(1)) == getattr(ops._build, name)

    def test_plans_and_launch_arguments_are_cached(self):
        args = (512, 960, 2560, 6, 6, 512, None)
        assert ops._k1_launch_args(*args) is ops._k1_launch_args(*args)
        assert tile_model.k1_plan(512, 960, 2560, 6) is \
            tile_model.k1_plan(512, 960, 2560, 6)
        assert tile_model.select_tiles(256, 256, 4096, 6) is \
            tile_model.select_tiles(256, 256, 4096, 6)

    def test_decision_reports_k1_s_plan(self):
        for m, k, n in ((256, 256, 4096), (512, 960, 2560),
                        (512, 2560, 960)):
            d = tile_model.select_tiles(m, k, n, 6)
            p = tile_model.k1_plan(m, k, n, 6, d.block_k)
            assert (d.block_m, d.block_n) == (p.block_m, p.block_n)
            assert d.vmem_bytes == p.smem_bytes
            assert d.mxu_cycles_step == (p.block_m // 64) * (d.block_k // 32)
            assert d.traffic_model == tile_model.traffic(
                m, k, n, 6, p.block_m, p.block_n, d.block_k)


class TestFusedPlan:
    def test_rule_stays_within_its_budgets(self):
        for s in range(1, tile_model.MAX_KERNEL_SPLITS + 1):
            pairs = s * (s + 1) // 2
            for nkt in range(1, 41):
                plan = tile_model.fused_plan(s, nkt)
                assert 1 <= plan.group <= pairs
                assert plan.hold == 1 + (plan.group - 1) * nkt
                assert plan.hold <= tile_model.FUSED_HOLD_MAX
                assert (plan.partial_registers
                        <= tile_model.FUSED_REGISTER_BUDGET)
                assert plan.smem_bytes <= tile_model.SMEM_PER_BLOCK
                # The largest group within the budget.
                if plan.group < pairs:
                    assert (tile_model.fused_hold(plan.group + 1, nkt)
                            > tile_model.FUSED_HOLD_MAX)

    def test_examples(self):
        # MuST (one k-tile): every pair in one group up to s = 6; the
        # LM's k = 960 and 2560 (two and five k-tiles).
        assert tile_model.fused_plan(6, 1).group == 21
        assert tile_model.fused_plan(5, 1).group == 15
        assert tile_model.fused_plan(9, 1).group == 21
        assert tile_model.fused_plan(6, 2).group == 11
        assert tile_model.fused_plan(6, 5).group == 5
        assert tile_model.fused_plan(6, 40).group == 1
        assert tile_model.fused_plan(16, 1).smem_bytes == 34_816 + 16 * 3_072

    def test_fused_decision_reports_k2_s_tile(self):
        d = tile_model.select_tiles(256, 256, 4096, 6, fused=True)
        assert (d.block_m, d.block_n, d.block_k) == (32, 32, 256)
        assert d.vmem_bytes == tile_model.fused_plan(6, 1).smem_bytes
        assert d.traffic_model == tile_model.traffic(
            256, 256, 4096, 6, 32, 32, 256, fused=True)
        assert d.kernel_invocations == 8 * 128 * 21
        plain = tile_model.select_tiles(256, 256, 4096, 6)
        k1 = tile_model.k1_plan(256, 256, 4096, 6)
        assert (plain.block_m, plain.block_n) == (k1.block_m, k1.block_n)

    def test_rejects_what_the_kernel_cannot_take(self):
        with pytest.raises(ValueError):
            tile_model.fused_plan(17, 1)
        with pytest.raises(ValueError):
            tile_model.fused_plan(6, 0)


class TestK3Staging:
    @pytest.mark.parametrize("num_splits", [1, 4, 9])
    def test_kmajor_copies_are_the_gathered_copies_transposed(
            self, num_splits):
        s = num_splits
        rng = np.random.default_rng(25)
        a_sl = torch.from_numpy(rng.integers(-64, 65, (s, 7, 19),
                                             dtype=np.int8))
        b_sl = torch.from_numpy(rng.integers(-64, 65, (s, 19, 11),
                                             dtype=np.int8))
        a_p, b_p, w = ops.gather_pairs(a_sl, b_sl, s)
        a_k, b_k, w_k = ops.gather_pairs_kmajor(a_sl, b_sl, s)
        assert torch.equal(a_k, a_p) and torch.equal(w_k, w)
        assert b_k.shape == (s * (s + 1) // 2, 11, 19)
        assert b_k.is_contiguous()
        assert torch.equal(b_k, b_p.transpose(1, 2))

    @pytest.mark.parametrize("num_splits,bits", [(3, 6), (9, 6), (14, 6),
                                                 (5, 7)])
    def test_cached_schedule_equals_the_reference_s(self, num_splits, bits):
        s = num_splits
        ii, jj, weights = ops._device_schedule(s, bits, torch.device("cpu"))
        ri, rj, rw = ops_ref._pair_schedule_arrays(s, bits)
        assert np.array_equal(ii.numpy(), np.asarray(ri))
        assert np.array_equal(jj.numpy(), np.asarray(rj))
        want = np.ldexp(np.float32(1.0), np.asarray(rw)).astype(np.float32)
        assert weights.dtype == torch.float32
        assert np.array_equal(weights.numpy().view(np.int32),
                              want.view(np.int32))
        ti, tj, tw = ops.pair_schedule_arrays(s, bits)
        assert (list(ops._host_schedule(s, bits)[0]),
                list(ops._host_schedule(s, bits)[1]),
                list(ops._host_schedule(s, bits)[2])) == (
            ti.tolist(), tj.tolist(), tw.tolist())
        # Built once: every call returns the same objects.
        assert ops._device_schedule(s, bits, torch.device("cpu"))[2] \
            is weights
        assert ops._host_schedule(s, bits) is ops._host_schedule(s, bits)

    def test_kernel_alone_on_gathered_copies_equals_k1(self):
        a, b = _operands(21, 150, 13, 26, np.float64)
        t_a, _ = core_port.slice_matrix(torch.from_numpy(a), 5, axis=1)
        t_b, _ = core_port.slice_matrix(torch.from_numpy(b), 5, axis=0)
        got = ops.split_gemm_v1_pairs(
            *ops.gather_pairs_kmajor(t_a, t_b, 5), block_k=128)
        want = ops.split_gemm_plain(t_a, t_b, 5, block_k=128)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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

    def test_kmajor_entry_equals_the_reference_layout_entry(self):
        a, b = _operands(45, 300, 38, 42, np.float64)
        a_sl, _ = core_port.slice_matrix(torch.from_numpy(a), 5, axis=1)
        b_sl, _ = core_port.slice_matrix(torch.from_numpy(b), 5, axis=0)
        b_t, _ = core_port.slice_matrix(torch.from_numpy(b).mT, 5, axis=1)
        want = ops.split_gemm(a_sl, b_sl, 5, block_k=128)
        got = ops.split_gemm_kmajor(a_sl, b_t, 5, block_k=128)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        with pytest.raises(ValueError):   # (s, k, n) given as k-major
            ops.split_gemm_kmajor(a_sl, b_sl, 5)

    def test_unfused_wrapper_takes_the_kmajor_entry(self, monkeypatch):
        # A float64 (or float32) product goes through the k-major entry
        # whose epilogue finishes it; another output dtype through the
        # k-major entry that returns (hi, lo).
        calls = []

        def spy(name):
            entry = getattr(ops, name)

            def counted(a_sl, b_sl_t, *args, **kw):
                calls.append((name, tuple(b_sl_t.shape)))
                return entry(a_sl, b_sl_t, *args, **kw)
            monkeypatch.setattr(ops, name, counted)

        spy("split_gemm_kmajor")
        spy("split_gemm_kmajor_combined")
        a, b = (torch.from_numpy(x) for x in _operands(20, 70, 30, 43,
                                                       np.float64))
        ops.ozaki_matmul(a, b, num_splits=4)
        assert calls == [("split_gemm_kmajor_combined", (4, 30, 70))]
        ops.ozaki_matmul(a, b, num_splits=4, out_dtype=torch.float16)
        assert calls[1:] == [("split_gemm_kmajor", (4, 30, 70))]

    @pytest.mark.parametrize("out_dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("m,k,n,num_splits", [(45, 300, 38, 5),
                                                  (1, 129, 1, 1),
                                                  (70, 600, 33, 9)])
    def test_combined_entry_is_kmajor_then_combine(self, m, k, n,
                                                   num_splits, out_dtype):
        a, b = _operands(m, k, n, 45, np.float64)
        a_sl, sa = core_port.slice_matrix(torch.from_numpy(a), num_splits,
                                          axis=1)
        b_t, sb = core_port.slice_matrix(torch.from_numpy(b).mT,
                                         num_splits, axis=1)
        hi, lo = ops.split_gemm_kmajor(a_sl, b_t, num_splits, block_k=256)
        want = ops.combine(hi, lo, sa, sb, num_splits, out_dtype)
        got = ops.split_gemm_kmajor_combined(a_sl, b_t, sa, sb, num_splits,
                                             out_dtype, block_k=256)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want)

    def test_combined_entry_checks_its_inputs(self):
        a_sl = torch.zeros((3, 8, 16), dtype=torch.int8)
        b_t = torch.zeros((3, 4, 16), dtype=torch.int8)
        sa = torch.ones(8, dtype=torch.float64)
        sb = torch.ones(4, dtype=torch.float64)
        got = ops.split_gemm_kmajor_combined(a_sl, b_t, sa, sb, 3,
                                             torch.float32)
        assert torch.equal(got, torch.zeros((8, 4)))
        with pytest.raises(TypeError):   # the epilogue's two dtypes only
            ops.split_gemm_kmajor_combined(a_sl, b_t, sa, sb, 3,
                                           torch.bfloat16)
        with pytest.raises(TypeError):   # sigma is float64
            ops.split_gemm_kmajor_combined(a_sl, b_t, sa.float(), sb, 3,
                                           torch.float32)
        with pytest.raises(ValueError):  # sigma_b is n long
            ops.split_gemm_kmajor_combined(a_sl, b_t, sa, sa, 3,
                                           torch.float32)

    @pytest.mark.parametrize("num_splits", [1, 3, 9])
    @pytest.mark.parametrize("m,k,n", [(1, 129, 1), (100, 1100, 60),
                                       (70, 600, 33)])
    def test_unfused_wrapper_matches_reference_at_more_shapes(
            self, m, k, n, num_splits):
        a, b = _operands(m, k, n, 44, np.float64)
        r = ops_ref.ozaki_matmul(jnp.asarray(a), jnp.asarray(b),
                                 num_splits=num_splits, interpret=True)
        t = ops.ozaki_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             num_splits=num_splits)
        assert same_bits(r, t)

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
