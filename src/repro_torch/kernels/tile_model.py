"""Tile selection for the Hopper split-GEMM kernels.

PyTorch/CUDA port of the parts of :mod:`repro.kernels.tile_model` that
the kernels' wrappers consult.  Of the three block sizes only
``block_k`` belongs to the numerics: the kernels fold one int32 partial
per (pair, k-tile) into the compensated hi/lo accumulator, so the
k-tile width sets the bits of the result.  ``block_k`` therefore
follows the reference's rule exactly.

The reference scores candidate blocks by ``max(mxu, hbm) / flops``,
then per-flop traffic, then block volume.  Both per-flop terms are
independent of ``block_k`` (the candidates are powers of two, so the
ratios are exact), and the volume term then prefers the largest
``block_k`` candidate that does not pass ``align_up(k, 128)``; the
VMEM budget never binds on that choice.  So ``block_k`` is the largest
of (128, 256, 512) not above ``align_up(k, 128)``, and 512 when ``k``
is unknown, whatever the TPU's rates.  ``tests/test_torch_kernels.py``
holds this against the reference over a sweep of shapes.

``block_m``/``block_n`` are the CUDA kernels' CTA tile (K1's from
:func:`k1_plan`, 64x64 for K3, 32x32 for K2), a Hopper choice that does
not change the bits.  No TPU rate (clock, VMEM, HBM bandwidth) is used
here.

:func:`k1_plan` is K1's launch plan: its CTA tile and whether the CTA
keeps all ``s`` slice layers resident in shared memory (one k-tile) or
streams the (pair, k-chunk) sequence through a ring.  The launcher takes
the plan's fields, so the CPU tests replay the loop nest it drives.

:func:`fused_plan` is K2's group rule: how many consecutive pairs of the
schedule share one slicing pass of each k-chunk, given the split count,
the number of k-tiles and the kernel's register and shared-memory
budget.  The launcher takes its ``group``, so the CPU tests hold the
rule and replay the loop nest it drives.

:func:`traffic` counts the device-memory bytes of one emulated GEMM
for the legacy pair-gathering kernel K3 against K1, at the blocks the
CUDA kernels run (the 64x64 CTA tile and the reference ``block_k``).
"""

from __future__ import annotations

import dataclasses
import functools

from ..core.ozaki import num_pair_gemms, pair_indices

__all__ = [
    "CTA_M",
    "CTA_N",
    "DEFAULT_PARAMS",
    "HopperParams",
    "K_ALIGN",
    "TileDecision",
    "Traffic",
    "align_up",
    "FusedPlan",
    "K1Plan",
    "block_k_for",
    "effective_block_k",
    "fused_plan",
    "hbm_bytes_per_step",
    "k1_plan",
    "k1_plans",
    "pair_schedule",
    "select_tiles",
    "split_cost",
    "traffic",
]

#: Output tile of one CTA of K3 (compiled in).
CTA_M = 64
CTA_N = 64
#: k-tiles are whole multiples of this (the reference's int8 lane rule,
#: kept because the k-tile width is part of the numerics).
K_ALIGN = 128
#: k-chunk one CTA stages in shared memory (int8 bytes per row).
K_CHUNK = 128
# The reference's k-tile candidates.
_BK_CANDIDATES = (128, 256, 512)

#: K2's CTA tile (4 warps of 16x16) and the k-chunk it slices at once.
FUSED_CTA_M = 32
FUSED_CTA_N = 32
FUSED_K_CHUNK = 32
FUSED_THREADS = 128
#: int32 partials one K2 thread may hold at once (the kernel is compiled
#: for capacities up to this and launches the smallest that holds a
#: plan's partials).
FUSED_HOLD_MAX = 21
#: Registers of one held partial: the CTA tile's int32 values per thread.
FUSED_PARTIAL_REGISTERS = FUSED_CTA_M * FUSED_CTA_N // FUSED_THREADS
#: Registers a thread may spend on held partials (of 255), leaving the
#: rest for hi/lo, fragments and addressing.
FUSED_REGISTER_BUDGET = FUSED_HOLD_MAX * FUSED_PARTIAL_REGISTERS
#: Shared memory one block may use on an H100 (227 KB).
SMEM_PER_BLOCK = 232_448
#: K2's shared memory: two f32 stages of the chunk's hi/lo halves (B's
#: rows padded by 4 floats) and one int8 slice of A and B per split
#: (rows padded by 16 bytes).
FUSED_STAGE_BYTES = 2 * 4 * (2 * FUSED_CTA_M * FUSED_K_CHUNK
                             + 2 * FUSED_K_CHUNK * (FUSED_CTA_N + 4))
FUSED_SLICE_BYTES = (FUSED_CTA_M + FUSED_CTA_N) * (FUSED_K_CHUNK + 16)
#: Split counts the kernels take (their pair schedule holds 136 pairs).
MAX_KERNEL_SPLITS = 16
#: K3's ring of cp.async stages, each a 64x64 CTA's 128-byte k-chunk of
#: A and (k-major) B rows padded by 16 bytes, and its shared memory.
V1_STAGES = 4
V1_SMEM_BYTES = V1_STAGES * (CTA_M + CTA_N) * (K_CHUNK + 16)

#: K1's CTA tiles (block_m, block_n), compiled in: warpgroups (128
#: threads) of 64 rows side by side along m, each running wgmma
#: m64n{block_n}k32.
K1_TILES = ((64, 32), (64, 64), (128, 64))
#: k-bytes of one 128-byte-swizzled block of shared rows: a streamed
#: ring stage's k-chunk, and the unit resident rows are padded to.
K1_K_CHUNK = 128
#: Dynamic shared memory K1 asks for beyond its operands, to align them
#: to the swizzle's 1024-byte atoms, and its static shared memory (the
#: mbarriers).
K1_ALIGN_SLACK = 1024
K1_STATIC_SMEM = 32 * 8
#: Streaming multiprocessors of an H100 SXM: a grid with fewer CTAs
#: leaves SMs idle; shared memory of one SM.
NUM_SMS = 132
SMEM_PER_SM = 233_472
#: The streamed plans' cost model (k1_plan), fitted to the plan sweep
#: on an H100 80GB HBM3 at 700 W (``chip_smoke.py --k1-plans``,
#: PERF.md): the L2-to-SM read rate the large LM grids reached, and
#: microseconds per 128-byte chunk of one CTA's chain where the grid is
#: too small for L2 to bind.
K1_L2_BYTES_PER_S = 5.1e12
K1_CHUNK_US = {(64, 32): 0.63, (64, 64): 0.765, (128, 64): 0.75}


@dataclasses.dataclass(frozen=True)
class HopperParams:
    """The rates of one H100 SXM the cost model prices against.

    The port's counterpart of the reference's ``TPUParams``: NVIDIA's
    data-sheet peaks at the 700 W limit (dense INT8 tensor-core
    operations and HBM bandwidth), the SM count and shared memory the
    kernels are planned for, and K1's L2-to-SM read rate fitted to the
    plan sweep (``chip_smoke.py --k1-plans``).  No TPU number.
    :func:`split_cost` prices a split from the first two; K1's plan rule
    (:func:`k1_plan`, and :func:`select_tiles` through it) reads the
    last three.
    """

    int8_ops: float = 1979e12          # INT8 operations per second
    hbm_bw: float = 3.35e12            # bytes per second of HBM
    l2_bw: float = K1_L2_BYTES_PER_S   # K1's fitted L2 read rate
    num_sms: int = NUM_SMS
    smem_per_sm: int = SMEM_PER_SM

    @property
    def int8_macs(self) -> float:
        """INT8 multiply-accumulates per second."""
        return self.int8_ops / 2


DEFAULT_PARAMS = HopperParams()

# Output extent at which split_cost converts a slice layer's bytes into
# pair-GEMM units without knowing m and n (the tuner prices sites by k
# and flops only); the reference's nominal extent.
_NOMINAL_EXTENT = 1024


def split_cost(num_splits: int,
               params: HopperParams = DEFAULT_PARAMS) -> float:
    """Modelled cost of one emulated GEMM at ``num_splits``, in units of
    one pair-GEMM's tensor-core time: the tuner's price of a split.

    cost(s) = pairs(s) + s * slice_tax, the reference's formula in rate
    terms: each split streams one more int8 slice layer of A and B,
    ``k * (m + n)`` bytes, against a pair-GEMM's ``m * n * k`` MACs, so
    at the nominal extent ``m = n = 1024``::

        slice_tax = int8_macs * (2 / 1024) / hbm_bw

    On the H100 that is 989.5e12 * (2/1024) / 3.35e12 ~ 0.58 pair-GEMMs
    per slice, against ~0.037 on the TPU v5e the reference prices: the
    card's INT8 rate is higher against its memory rate, so each added
    split costs more in traffic here.
    """
    tax = params.int8_macs * (2.0 / _NOMINAL_EXTENT) / params.hbm_bw
    return num_pair_gemms(num_splits) + num_splits * tax


def align_up(x: int, multiple: int) -> int:
    """Round ``x`` up to a multiple of ``multiple`` (min one multiple)."""
    return max(multiple, ((x + multiple - 1) // multiple) * multiple)


def block_k_for(k: int | None) -> int:
    """The reference's k-tile width for contraction extent ``k``."""
    if k is None:
        return _BK_CANDIDATES[-1]
    cap = align_up(k, K_ALIGN)
    return max(c for c in _BK_CANDIDATES if c <= cap)


def effective_block_k(k: int, block_k: int) -> int:
    """The k-tile a kernel runs for a requested ``block_k``.

    The reference clamps the request to the padded extent and rounds it
    up to the 128 alignment (``ops._block``); the same rule here keeps
    an explicit ``block_k`` meaning the same k-tiling in both packages.
    """
    return align_up(min(block_k, align_up(k, K_ALIGN)), K_ALIGN)


def fused_hold(group: int, num_k_tiles: int) -> int:
    """int32 partials a K2 thread holds for a group of ``group`` pairs.

    The group's first pair folds at the end of every k-tile (all earlier
    pairs are folded by then); each other pair holds one partial per
    k-tile until the group ends, when they fold in schedule order.
    """
    return 1 + (group - 1) * num_k_tiles


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """K2's launch plan for one (s, k-tile count)."""

    group: int               # consecutive pairs per slicing pass
    hold: int                # int32 partials a thread holds
    partial_registers: int   # registers those partials take
    smem_bytes: int          # dynamic shared memory per CTA


@functools.lru_cache(maxsize=None)
def fused_plan(num_splits: int, num_k_tiles: int) -> FusedPlan:
    """The group, held partials and shared memory K2 runs with.

    The group is as many consecutive pairs as the held-partial budget
    allows, at most every pair; 1 (the reference's own order, no
    partial held) when the k-tiles leave no room.  Shared memory does
    not depend on the group: a 32-wide k-chunk keeps all ``s`` slices
    of A and B beside the two f32 stages for every ``s`` the kernels
    take, so the register budget alone bounds it.
    """
    if not 1 <= num_splits <= MAX_KERNEL_SPLITS:
        raise ValueError(f"num_splits={num_splits} outside [1, "
                         f"{MAX_KERNEL_SPLITS}]")
    if num_k_tiles < 1:
        raise ValueError(f"num_k_tiles={num_k_tiles} < 1")
    group = max(1, min(num_pair_gemms(num_splits),
                       1 + (FUSED_HOLD_MAX - 1) // num_k_tiles))
    hold = fused_hold(group, num_k_tiles)
    return FusedPlan(
        group=group, hold=hold,
        partial_registers=hold * FUSED_PARTIAL_REGISTERS,
        smem_bytes=FUSED_STAGE_BYTES + num_splits * FUSED_SLICE_BYTES)


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """K1's launch plan for one (m, k, n, s, block_k)."""

    block_m: int        # CTA tile rows (64 per warpgroup)
    block_n: int        # CTA tile columns
    resident: bool      # all s slice layers in shared memory at once
    smem_bytes: int     # dynamic shared memory per CTA
    ctas: int           # CTAs in the grid


def k1_stages(bm: int, bn: int) -> int:
    """Streamed K1's ring depth for a tile (compiled in): three
    single-warpgroup CTAs fit an SM, 128x64 runs one."""
    return {96: 6, 128: 4}.get(bm + bn, 8)


def _k1_candidate(m, k, n, s, bk, bm, bn, resident):
    """The plan for one tile and residency, or None if K1 cannot take
    it (residency needs one k-tile, its layers in 227 KB and one
    warpgroup: the rule never picks a resident 128x64 tile, so it is
    not compiled)."""
    if resident:
        if bm != 64 or k > bk:
            return None
        smem = s * (bm + bn) * align_up(k, K1_K_CHUNK) + K1_ALIGN_SLACK
    else:
        smem = k1_stages(bm, bn) * (bm + bn) * K1_K_CHUNK + K1_ALIGN_SLACK
    if smem + K1_STATIC_SMEM > SMEM_PER_BLOCK:
        return None
    return K1Plan(block_m=bm, block_n=bn, resident=resident,
                  smem_bytes=smem, ctas=-(-m // bm) * -(-n // bn))


def _k1_args(m, k, n, num_splits, block_k):
    if min(m, k, n) < 1:
        raise ValueError(f"empty GEMM ({m}, {k}, {n})")
    if not 1 <= num_splits <= MAX_KERNEL_SPLITS:
        raise ValueError(f"num_splits={num_splits} outside [1, "
                         f"{MAX_KERNEL_SPLITS}]")
    return block_k_for(k) if block_k is None else effective_block_k(
        k, block_k)


@functools.lru_cache(maxsize=None)
def k1_plans(m: int, k: int, n: int, num_splits: int,
             block_k: int | None = None) -> tuple[K1Plan, ...]:
    """Every plan K1 can run this launch with (tile, residency)."""
    bk = _k1_args(m, k, n, num_splits, block_k)
    found = (_k1_candidate(m, k, n, num_splits, bk, bm, bn, res)
             for res in (True, False) for bm, bn in K1_TILES)
    return tuple(p for p in found if p is not None)


def _k1_streamed_ms(plan: K1Plan, m: int, k: int, n: int,
                    num_splits: int, params: HopperParams) -> float:
    """Modelled time of a streamed plan: the larger of its L2 reads at
    the rate the plan sweep reached and its waves of per-CTA chunk
    chains (``K1_CHUNK_US`` per 128-byte chunk, measured where the grid
    is too small to be bound by L2)."""
    chunks = num_pair_gemms(num_splits) * -(-k // K1_K_CHUNK)
    reads = plan.ctas * chunks * (plan.block_m + plan.block_n) * K1_K_CHUNK
    per_sm = min(3 if plan.block_m == 64 else 1,
                 params.smem_per_sm // (plan.smem_bytes + K1_STATIC_SMEM))
    waves = -(-plan.ctas // (params.num_sms * per_sm))
    chain = waves * chunks * K1_CHUNK_US[plan.block_m, plan.block_n] / 1e3
    return max(reads / params.l2_bw * 1e3, chain)


@functools.lru_cache(maxsize=None)
def k1_plan(m: int, k: int, n: int, num_splits: int,
            block_k: int | None = None, *,
            params: HopperParams = DEFAULT_PARAMS) -> K1Plan:
    """K1's plan for one launch; cached per shape.

    The rule, from the plan sweep on an H100 (PERF.md): with one
    k-tile, keep the slice layers resident on the 64x64 tile if they
    fit and its grid fills the card's SMs, or, on a smaller grid, on the
    64x32 tile (twice the CTAs) if they fit there; otherwise stream, on
    the tile :func:`_k1_streamed_ms` models fastest (64x32 where the
    grid is small, 64x64 or 128x64 where L2 reads bound it).  The SM
    count, shared memory per SM and L2 rate are ``params``'.  A launch
    forces another plan by passing one of :func:`k1_plans` to the
    wrappers' ``plan=``.
    """
    plans = k1_plans(m, k, n, num_splits, block_k)
    kept = {(p.block_m, p.block_n): p for p in plans if p.resident}
    small = -(-m // 64) * -(-n // 64) < params.num_sms
    for tile in ((64, 32), (64, 64)) if small else ((64, 64),):
        if tile in kept:
            return kept[tile]
    return min((p for p in plans if not p.resident),
               key=lambda p: _k1_streamed_ms(p, m, k, n, num_splits,
                                             params))


def pair_schedule(num_splits: int, mode: str = "ordered"):
    """Slice-pair visit order (ii, jj) for the kernels' pair loop.

    ``"ordered"`` — by ascending total shift ``i + j`` (largest weight
    first), identical to :func:`repro_torch.core.ozaki.pair_indices`.
    This is the only schedule the kernels run: compensated accumulation
    order is part of the bit-identity contract.

    ``"grouped"`` — by A-slice index ``i``; for traffic accounting only.
    """
    ii, jj = pair_indices(num_splits)
    if mode == "ordered":
        return ii, jj
    if mode == "grouped":
        order = sorted(range(len(ii)), key=lambda p: (ii[p], jj[p]))
        return ii[order], jj[order]
    raise ValueError(f"unknown pair schedule {mode!r};"
                     " expected 'ordered' or 'grouped'")


def hbm_bytes_per_step(bm: int, bn: int, bk: int, *,
                       fused: bool = False) -> int:
    """Bytes one (pair, k-tile) step of one CTA streams: an A block and
    a B block, int8 slices or (fused) the f32 hi/lo halves."""
    elem_bytes = 8 if fused else 1
    return elem_bytes * (bm * bk + bk * bn)


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Device-memory bytes of one emulated GEMM, K3 (v1) against K1 (v2).

    The reference's record (``repro.kernels.tile_model.Traffic``):
    ``slice_read_bytes_*`` count the slice data the kernel reads — K3
    reads ``s(s+1)/2`` gathered pair copies, K1 the ``s`` slice layers;
    ``stage_bytes_*`` the writes (and the gather's reads) that produce
    what the kernel consumes; ``stream_bytes`` the per-step block
    traffic, the same for both; ``out_bytes`` the hi/lo f32 result.
    """

    slice_read_bytes_v1: int
    slice_read_bytes_v2: int
    stage_bytes_v1: int
    stage_bytes_v2: int
    stream_bytes: int
    out_bytes: int

    @property
    def total_v1(self) -> int:
        return self.stage_bytes_v1 + self.stream_bytes + self.out_bytes

    @property
    def total_v2(self) -> int:
        return self.stage_bytes_v2 + self.stream_bytes + self.out_bytes

    @property
    def read_reduction(self) -> float:
        """Slice bytes read, v1 / v2 == (s + 1) / 2."""
        return self.slice_read_bytes_v1 / self.slice_read_bytes_v2


def traffic(m: int, k: int, n: int, num_splits: int, bm: int = CTA_M,
            bn: int = CTA_N, bk: int | None = None, *,
            fused: bool = False) -> Traffic:
    """Count the bytes one emulated (m, k) @ (k, n) GEMM moves.

    The reference's accounting over the padded extents, at the blocks
    given (by default K1's and K3's ``CTA_M`` x ``CTA_N`` output tile;
    :func:`select_tiles` passes K2's for ``fused``) and the reference
    ``block_k`` (``bk=None`` picks it).  Fused, the slices
    never exist in device memory: staging writes the f32 hi/lo halves
    once and the "slice read" is their stream.
    """
    bk = block_k_for(k) if bk is None else bk
    mp, kp, np_ = align_up(m, bm), align_up(k, bk), align_up(n, bn)
    elems = mp * kp + kp * np_            # one slice layer, A + B
    pairs = num_pair_gemms(num_splits)
    steps = (mp // bm) * (np_ // bn) * pairs * (kp // bk)
    stream = steps * hbm_bytes_per_step(bm, bn, bk, fused=fused)
    out = 2 * 4 * mp * np_                # hi + lo f32
    # v1: build s slice layers (write), gather the pair copies (read
    # the source layers + write the copies).
    v1_read = pairs * elems
    v1_stage = num_splits * elems + 2 * pairs * elems
    v2_read = num_splits * elems
    v2_stage = 2 * 4 * elems if fused else num_splits * elems
    return Traffic(slice_read_bytes_v1=v1_read,
                   slice_read_bytes_v2=v2_read,
                   stage_bytes_v1=v1_stage, stage_bytes_v2=v2_stage,
                   stream_bytes=stream, out_bytes=out)


@dataclasses.dataclass(frozen=True)
class TileDecision:
    """The pick for one GEMM site; the reference's fields.

    On Hopper ``vmem_bytes`` is one CTA's dynamic shared memory (K1's
    plan's; for K2 the f32 stages and the ``s`` slices; per k-chunk
    staged int8 tiles when the shape is unknown), ``mxu_cycles_step``
    the number of MMA instructions one CTA issues per (pair, k-tile)
    step (K1's wgmma m64nNk32, K2's mma.sync m16n8k32), and
    ``hbm_bytes_step`` the bytes one such step streams (int8 slices, or
    the f32 hi/lo halves when fused).  ``kernel_invocations`` and
    ``traffic_model`` (:func:`traffic`) are None for a canonical pick (m
    or n unknown), as in the reference.
    """

    block_m: int
    block_n: int
    block_k: int
    num_splits: int
    pairs: int
    schedule: str
    fused: bool
    vmem_bytes: int
    mxu_cycles_step: int
    hbm_bytes_step: int
    kernel_invocations: int | None = None
    traffic_model: Traffic | None = None

    def summary(self) -> dict:
        """Compact dict for Site records."""
        return {"block_m": self.block_m, "block_n": self.block_n,
                "block_k": self.block_k, "pairs": self.pairs,
                "schedule": self.schedule}


@functools.lru_cache(maxsize=None)
def select_tiles(m: int | None, k: int | None, n: int | None,
                 num_splits: int, dtype=None, *,
                 fused: bool = False,
                 params: HopperParams = DEFAULT_PARAMS) -> TileDecision:
    """Pick ``block_m/n/k`` for an emulated GEMM — closed form, no sweep,
    cached per site shape.

    ``dtype`` is accepted for the reference's (m, k, n, s, dtype)
    contract and does not change the pick; ``block_k`` is the
    reference's rule, whatever the rates.  Unfused, with the shape
    known, ``block_m``/``block_n`` are K1's plan tile (:func:`k1_plan`
    under ``params``).
    """
    del dtype
    bk = block_k_for(k)
    known = m is not None and k is not None and n is not None
    if fused:
        bm, bn = FUSED_CTA_M, FUSED_CTA_N
        vmem = FUSED_STAGE_BYTES + num_splits * FUSED_SLICE_BYTES
        mmas = (bm // 16) * (bn // 8) * (bk // 32)
    elif known and 1 <= num_splits <= MAX_KERNEL_SPLITS:
        plan = k1_plan(m, k, n, num_splits, bk, params=params)
        bm, bn, vmem = plan.block_m, plan.block_n, plan.smem_bytes
        mmas = (bm // 64) * (bk // 32)
    else:
        bm, bn = CTA_M, CTA_N
        vmem = (bm + bn) * K_CHUNK
        mmas = (bm // 16) * (bn // 8) * (bk // 32)
    pairs = num_pair_gemms(num_splits)
    invocations = traffic_model = None
    if known:
        invocations = ((align_up(m, bm) // bm) * (align_up(n, bn) // bn)
                       * pairs * (align_up(k, bk) // bk))
        traffic_model = traffic(m, k, n, num_splits, bm, bn, bk,
                                fused=fused)
    return TileDecision(
        block_m=bm, block_n=bn, block_k=bk, num_splits=num_splits,
        pairs=pairs, schedule="ordered", fused=fused, vmem_bytes=vmem,
        mxu_cycles_step=mmas,
        hbm_bytes_step=hbm_bytes_per_step(bm, bn, bk, fused=fused),
        kernel_invocations=invocations, traffic_model=traffic_model)
