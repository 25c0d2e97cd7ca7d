"""Slicing primitives shared by the fused kernel's plain version and core.

PyTorch port of :mod:`repro.kernels.slicing`.  The fused split-GEMM
kernel (K2) quantizes operands to int8 slices tile by tile in fast
memory, so slices never reach device memory.  A high-precision operand
enters it as an exact pair of f32 halves ``(hi, lo)`` with
``hi + lo == r``; for f32 inputs ``lo == 0`` and every step below
reproduces :func:`repro_torch.core.ozaki.slice_matrix` bit for bit.

The CUDA kernel (``csrc/split_gemm.cu``, ``slice_step``) runs the same
recurrence with the same rounding (``rintf``, half to even) and without
FMA contraction; these functions are its plain version.
"""

from __future__ import annotations

import torch

from ..core.ozaki import SLICE_BITS, _pow2_scale, _two_sum

__all__ = [
    "to_f32_pair",
    "to_operand_pair",
    "slice_step",
    "quantize_tile",
    "slice_matrix_fused",
]


def to_f32_pair(r):
    """Exact f32 decomposition ``r == hi + lo`` (lo == 0 for f32 ``r``)."""
    hi = r.to(torch.float32)
    lo = (r - hi.to(r.dtype)).to(torch.float32)
    return hi, lo


def to_operand_pair(x, axis: int):
    """Scale ``x`` by its power-of-two sigma and decompose to f32 halves.

    The shared preamble of the fused kernel wrapper and of
    :func:`slice_matrix_fused`.  Returns ``(hi, lo, sigma)`` with
    ``sigma`` squeezed like :func:`repro_torch.core.ozaki.slice_matrix`'s.
    """
    x = x.to(torch.float64)
    sigma = _pow2_scale(x, axis=axis)
    hi, lo = to_f32_pair(x / sigma)
    return hi, lo, torch.squeeze(sigma, dim=axis)


def slice_step(hi, lo, radix: float):
    """One slicing step on an f32 pair: extract q, return the residue.

    ``q = round(r*radix); r = r*radix - q`` in pair arithmetic; every
    operation is exact, so ``hi + lo == r_exact`` through every step.
    """
    yh = hi * radix
    yl = lo * radix
    q = torch.round(yh + yl)
    r = yh - q
    hi2, lo2 = _two_sum(r, yl)
    return q, hi2, lo2


def quantize_tile(hi, lo, index: int, num_splits: int,
                  slice_bits: int = SLICE_BITS):
    """Quantize an f32-pair tile and return slice ``index`` as int8.

    Slice ``index`` depends only on the first ``index + 1`` steps of
    the recurrence, so the loop stops there (the reference runs all
    ``num_splits`` steps and selects; the selected value is the same).
    """
    if not 0 <= index < num_splits:
        raise ValueError(f"slice index {index} outside [0, {num_splits})")
    radix = float(2 ** slice_bits)
    for _ in range(index + 1):
        q, hi, lo = slice_step(hi, lo, radix)
    return q.to(torch.int8)


def slice_matrix_fused(x, num_splits: int, axis: int,
                       slice_bits: int = SLICE_BITS):
    """Whole-matrix plain version of the fused kernel's slicing.

    Same contract as :func:`repro_torch.core.ozaki.slice_matrix` —
    returns ``(slices, sigma)`` — computed through the f32-pair
    recurrence.
    """
    hi, lo, sigma = to_operand_pair(x, axis)
    radix = float(2 ** slice_bits)
    out = []
    for _ in range(num_splits):
        q, hi, lo = slice_step(hi, lo, radix)
        out.append(q.to(torch.int8))
    return torch.stack(out), sigma
