"""Operand slicing for the split-GEMM kernels, and its plain versions.

PyTorch port of :mod:`repro.kernels.slicing`, plus the port's own
slicing kernel.  Two ways into the int8 slices:

* :func:`slice_operand` slices a whole operand for K1: on the card one
  launch of the CUDA kernel in ``csrc/slice_operand.cu`` writes the
  operand's power-of-two scale ``sigma`` and all ``s`` slices, bitwise
  equal to :func:`repro_torch.core.ozaki.slice_matrix` (the plain
  version, which it returns for CPU tensors).  :func:`slice_plan` picks
  the kernel's layout from the operand's shape and strides.
* The fused kernel (K2) quantizes operands to int8 slices tile by tile
  in fast memory, so slices never reach device memory.  A
  high-precision operand enters it as an exact pair of f32 halves
  ``(hi, lo)`` with ``hi + lo == r``; for f32 inputs ``lo == 0`` and
  every step below reproduces ``slice_matrix`` bit for bit.  The CUDA
  kernel (``csrc/split_gemm.cu``, ``slice_step``) runs the same
  recurrence with the same rounding (``rintf``, half to even) and
  without FMA contraction; :func:`slice_step`, :func:`quantize_tile`
  and :func:`slice_matrix_fused` are its plain version.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..core.ozaki import SLICE_BITS, _pow2_scale, _two_sum, slice_matrix
from . import _build, ops

__all__ = [
    "SlicePlan",
    "slice_operand",
    "slice_plan",
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


#: Dynamic shared memory a slicing CTA may take (``S_SMEM_MAX`` in
#: ``csrc/slice_operand.cu``).
SLICE_SMEM_MAX = 200 * 1024
#: k a slicing thread writes per plane, as one 16-byte store.
SLICE_UNIT = 16
# A panel above this shares its SM with fewer than three others.
_PANEL_TARGET = 64 * 1024
# Two CTAs per SM of the H100's 132 before the panel grows.
_MIN_CTAS = 264
# k streamed per chunk (twice) when a panel does not fit in shared memory.
_CHUNK_BYTES = 32 * 1024


@dataclass(frozen=True)
class SlicePlan:
    """How the slicing kernel walks one operand.

    ``fast_k``: the panel in shared memory runs along k (x's k stride is
    the smaller) or along m; ``vec``: elements per copy along that axis
    (16 bytes, or 1 where x is strided or unaligned there); ``tm``: rows
    (sigma entries) per CTA; ``tk``: k per chunk; ``chunks``: 1 when the
    whole ``tm x k`` panel stays in shared memory, else the chunks read
    twice.
    """

    fast_k: bool
    vec: int
    tm: int
    tk: int
    chunks: int


def _align16(n: int) -> int:
    return -(-n // SLICE_UNIT) * SLICE_UNIT


def slice_plan(m: int, k: int, stride_m: int, stride_k: int,
               itemsize: int, aligned: bool) -> SlicePlan:
    """The kernel's plan for an (m, k) operand with these element strides.

    Copies are coalesced along the axis of smaller stride.  A CTA takes
    16 rows along k, or 128 bytes of each k line along m, halved while
    its panel passes 64 KB or the grid has fewer than 264 CTAs (down to
    one row, or to one 32-byte sector of a k line); a panel over the
    shared-memory limit streams its k in chunks of 32 KB.
    """
    fast_k = stride_k == 1 or (stride_m != 1 and stride_k <= stride_m)
    fast_len, fast_stride, slow_stride = ((k, stride_k, stride_m) if fast_k
                                          else (m, stride_m, stride_k))
    full = 16 // itemsize
    vec = (full if aligned and fast_stride == 1 and fast_len % full == 0
           and slow_stride % full == 0 else 1)
    kp = _align16(k)
    tm, floor = (16, 1) if fast_k else (128 // itemsize, 32 // itemsize)
    while tm > floor and (tm * kp * itemsize > _PANEL_TARGET
                          or -(-m // tm) < _MIN_CTAS):
        tm //= 2
    if tm * kp * itemsize <= SLICE_SMEM_MAX:
        return SlicePlan(fast_k, vec, tm, kp, 1)
    tk = max(SLICE_UNIT, _CHUNK_BYTES // (tm * itemsize)
             // SLICE_UNIT * SLICE_UNIT)
    return SlicePlan(fast_k, vec, tm, tk, -(-k // tk))


@functools.lru_cache(maxsize=None)
def _slice_args(m, k, stride_m, stride_k, itemsize, aligned, num_splits,
                slice_bits):
    """The launcher's plan struct, built once per operand layout."""
    plan = slice_plan(m, k, stride_m, stride_k, itemsize, aligned)
    return _build.SliceArgs(
        m=m, k=k, stride_m=stride_m, stride_k=stride_k,
        num_splits=num_splits, slice_bits=slice_bits,
        fast_k=int(plan.fast_k), vec=plan.vec, tm=plan.tm, tk=plan.tk,
        chunks=plan.chunks)


def slice_operand(x, num_splits: int, slice_bits: int = SLICE_BITS):
    """``slice_matrix(x, num_splits, axis=1)`` in one kernel launch.

    Args:
      x: (m, k) real tensor, any strides (a transposed view, or the
        ``.real``/``.imag`` view of a complex one, is read in place).
        float16 and bfloat16 widen to float32 and other dtypes to
        float64 first, both exactly as ``slice_matrix``'s cast.

    Returns:
      ``(slices, sigma)``: ``slices`` (s, m, k) int8 contiguous, with
      the slices of each row of ``x`` along k, and ``sigma`` (m,)
      float64.  For CPU tensors, ``slice_matrix``'s result; for CUDA
      tensors, the kernel's, bitwise equal to it.
    """
    dev = x.device
    if dev.type == "cpu":
        return slice_matrix(x, num_splits, axis=1, slice_bits=slice_bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.ndim != 2 or x.is_complex():
        raise ValueError(f"slice_operand takes a real 2-D tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if num_splits < 1 or not 1 <= slice_bits <= 7:
        raise ValueError(f"num_splits {num_splits} and slice_bits "
                         f"{slice_bits}: the kernel takes s >= 1 and 1 to "
                         "7 bits (an int8 slice)")
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32 if x.dtype in (torch.float16, torch.bfloat16)
                 else torch.float64)
    m, k = x.shape
    if x.numel() == 0:
        return slice_matrix(x, num_splits, axis=1, slice_bits=slice_bits)
    return _launch(x, _slice_args(m, k, *x.stride(), x.element_size(),
                                  x.data_ptr() % 16 == 0, num_splits,
                                  slice_bits))


def _launch(x, args):
    """One launch of the slicing kernel on the CUDA float32 or float64
    tensor ``x`` under the plan ``args`` (a ``_build.SliceArgs`` of x's
    shape and strides); returns ``(slices, sigma)``."""
    dev = x.device
    slices = torch.empty((args.num_splits, args.m, args.k), dtype=torch.int8,
                         device=dev)
    sigma = torch.empty((args.m,), dtype=torch.float64, device=dev)
    lib = ops._lib()
    code = lib.slice_operand_launch(x.data_ptr(), x.element_size() // 8,
                                    slices.data_ptr(), sigma.data_ptr(),
                                    args, dev.index or 0, ops._stream(dev))
    ops._raise_on(lib, code, "slice_operand")
    ops.LAUNCHES["slice_operand"] += 1
    return slices, sigma
