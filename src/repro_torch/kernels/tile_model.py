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

``block_m``/``block_n`` are the CUDA kernels' CTA tile, a Hopper choice
that does not change the bits.  No TPU rate (clock, VMEM, HBM
bandwidth) is used here; pricing tiles for Hopper is later work.

:func:`traffic` counts the device-memory bytes of one emulated GEMM
for the legacy pair-gathering kernel K3 against K1, at the blocks the
CUDA kernels run (the 64x64 CTA tile and the reference ``block_k``).
"""

from __future__ import annotations

import dataclasses

from ..core.ozaki import num_pair_gemms, pair_indices

__all__ = [
    "CTA_M",
    "CTA_N",
    "K_ALIGN",
    "TileDecision",
    "Traffic",
    "align_up",
    "block_k_for",
    "effective_block_k",
    "hbm_bytes_per_step",
    "pair_schedule",
    "select_tiles",
    "traffic",
]

#: Output tile of one CTA of the split-GEMM kernels (compiled in).
CTA_M = 64
CTA_N = 64
#: k-tiles are whole multiples of this (the reference's int8 lane rule,
#: kept because the k-tile width is part of the numerics).
K_ALIGN = 128
#: k-chunk one CTA stages in shared memory (int8 bytes per row).
K_CHUNK = 128
# The reference's k-tile candidates.
_BK_CANDIDATES = (128, 256, 512)


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
    the CUDA kernels run: the ``CTA_M`` x ``CTA_N`` output tile and the
    reference ``block_k`` (``bk=None`` picks it).  Fused, the slices
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

    On Hopper ``vmem_bytes`` is the shared memory one CTA stages per
    k-chunk (int8 A and B tiles), ``mxu_cycles_step`` is the number of
    ``mma.sync`` m16n8k32 instructions one CTA issues per (pair,
    k-tile) step, and ``hbm_bytes_step`` the bytes one such step
    streams (int8 slices, or the f32 hi/lo halves when fused).
    ``kernel_invocations`` and ``traffic_model`` (:func:`traffic`) are
    None for a canonical pick (m or n unknown), as in the reference.
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


def select_tiles(m: int | None, k: int | None, n: int | None,
                 num_splits: int, dtype=None, *,
                 fused: bool = False) -> TileDecision:
    """Pick ``block_m/n/k`` for an emulated GEMM — closed form, no sweep.

    ``dtype`` is accepted for the reference's (m, k, n, s, dtype)
    contract and does not change the pick.
    """
    del dtype
    bm, bn, bk = CTA_M, CTA_N, block_k_for(k)
    pairs = num_pair_gemms(num_splits)
    invocations = traffic_model = None
    if m is not None and k is not None and n is not None:
        invocations = ((align_up(m, bm) // bm) * (align_up(n, bn) // bn)
                       * pairs * (align_up(k, bk) // bk))
        traffic_model = traffic(m, k, n, num_splits, bm, bn, bk,
                                fused=fused)
    return TileDecision(
        block_m=bm, block_n=bn, block_k=bk, num_splits=num_splits,
        pairs=pairs, schedule="ordered", fused=fused,
        vmem_bytes=(bm + bn) * K_CHUNK,
        mxu_cycles_step=(bm // 16) * (bn // 8) * (bk // 32),
        hbm_bytes_step=hbm_bytes_per_step(bm, bn, bk, fused=fused),
        kernel_invocations=invocations, traffic_model=traffic_model)
