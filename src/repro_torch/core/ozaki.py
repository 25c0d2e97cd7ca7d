"""Ozaki-scheme INT8 split-GEMM emulation of high-precision matmuls.

PyTorch port of :mod:`repro.core.ozaki`, bitwise equal to it on the
same inputs.  A floating-point matrix is written as an exact sum of
narrow integer "slices"

    A / sigma_A  =  sum_t  S_t * 2**(-w*(t+1)),      S_t in int8,

where ``sigma_A`` is a per-row power-of-two scale and ``w`` the slice
width in bits.  Slice products are exact in INT8xINT8->INT32
arithmetic, and the high-precision product is recovered by
accumulating the pair products ``S_i(A) @ S_j(B)`` (``i + j < s``,
``s*(s+1)/2`` GEMMs) with power-of-two weights, either in float64
(``"f64"``) or in compensated float32 hi/lo pairs (``"df32"``).

Numerics that keep the port bitwise equal to the reference:

* slicing always runs in float64 (the reference slices in float64
  under x64, which its tests and examples enable);
* power-of-two scales come from ``torch.ldexp``, never ``exp2``;
* ``torch.round`` rounds half to even, as ``jnp.round`` does;
* INT8 pair products accumulate exactly: on torch CPU ``int8 @ int8``
  returns int8 and wraps, so the slices are cast to float64 and
  multiplied there (every partial sum is an integer below 2**53), then
  cast to int32;
* the TwoSum chains run eagerly, in the reference's order.

Complex inputs are handled by four real split-GEMMs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor

__all__ = [
    "SLICE_BITS",
    "complex_matmul_via_real",
    "num_pair_gemms",
    "pair_indices",
    "slice_matrix",
    "ozaki_matmul",
]

# Bits of mantissa carried per int8 slice (the reference's constant).
SLICE_BITS = 6


def num_pair_gemms(num_splits: int) -> int:
    """Number of INT8 GEMMs issued for a given split count."""
    return num_splits * (num_splits + 1) // 2


def pair_indices(num_splits: int) -> tuple[np.ndarray, np.ndarray]:
    """Slice-index pairs (i, j) with i + j < num_splits, by ascending i+j.

    Ordering by total shift means the compensated accumulation adds
    terms from largest to smallest magnitude.
    """
    pairs = [(i, j) for i in range(num_splits) for j in range(num_splits)
             if i + j < num_splits]
    pairs.sort(key=lambda ij: (ij[0] + ij[1], ij[0]))
    ii = np.array([p[0] for p in pairs], dtype=np.int32)
    jj = np.array([p[1] for p in pairs], dtype=np.int32)
    return ii, jj


# The reference's ``jnp.log2`` is ``log(x) / log(2)``, which XLA's CPU
# backend compiles into a multiply by the reciprocal.  At some exact
# powers of two that product lands one ulp off the integer (log2 of
# 2**-59 gives -58.99999999999999), and the ceil below then picks a
# sigma twice as large.  The port computes the same product so that
# its sigmas, and hence its slices, are the reference's.
_INV_LN2 = 1.0 / math.log(2.0)


def _pow2_scale(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-row/col power-of-two scale sigma with |x| / sigma <= 1/2."""
    absmax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    # exponent e with 2**e >= 2*absmax; zero rows get sigma = 1.
    log2 = torch.log(absmax) * _INV_LN2
    e = torch.where(absmax > 0, torch.ceil(log2) + 1.0,
                    torch.zeros_like(absmax))
    return torch.ldexp(torch.ones_like(absmax), e.to(torch.int32))


def slice_matrix(x: torch.Tensor, num_splits: int, axis: int,
                 slice_bits: int = SLICE_BITS):
    """Split ``x`` into int8 slices along its value (mantissa) axis.

    Returns ``(slices, sigma)`` with ``slices`` of shape
    ``(num_splits, *x.shape)`` (int8) and ``sigma`` the per-row (axis=1)
    or per-column (axis=0) power-of-two scale, such that

        x ~= sigma * sum_t slices[t] * 2**(-slice_bits*(t+1)).
    """
    x = as_tensor(x).to(torch.float64)
    sigma = _pow2_scale(x, axis=axis)
    r = x / sigma  # |r| <= 0.5, scaling by a power of two is exact
    radix = float(2 ** slice_bits)
    out = []
    for _ in range(num_splits):
        q = torch.round(r * radix)  # |q| <= 2**(slice_bits-1) after step 1
        out.append(q.to(torch.int8))
        r = r * radix - q  # exact: both operands share an exponent window
    return torch.stack(out), torch.squeeze(sigma, dim=axis)


def int8_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (batched) matmul with an int32 result.

    The plain product of every path: the slices go through float64,
    where each partial sum is an integer below 2**53 and therefore
    exact in any summation order, on the CPU and on the card alike.
    """
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).to(torch.int32)


def _int8_pair_products(a_sl, b_sl, ii, jj):
    """Batched INT8 GEMMs over the selected slice pairs -> int32 (p,m,n)."""
    dev = a_sl.device
    a_p = a_sl[torch.as_tensor(ii, dtype=torch.long, device=dev)]
    b_p = b_sl[torch.as_tensor(jj, dtype=torch.long, device=dev)]
    return int8_matmul_exact(a_p, b_p)


# The reference's f64 accumulator is ``einsum("p,pmn->mn")``, which
# XLA's CPU backend compiles into a loop over the m*n outputs whose
# inner sum over the P pairs carries LLVM's ``reassoc`` flag.  The
# order below was read off the compiled code (``--xla_dump_to`` object
# files, P = 45, 55, 66, 78; m*n = 1, 2, 4, 5, 21, 4096, 16384) and
# then confirmed on random int32 products for P = 45..91 and m*n in
# 1..69, 96..257, 1000, 4096 and 16384 (ROADMAP, section 3).
_SEQUENTIAL_MAX_PAIRS = 36   # s <= 8: the loop is not vectorized
_LANES = 4                   # float64 lanes of one 256-bit vector
_PARTS = 4                   # interleaved vector accumulators
_BLOCK = _LANES * _PARTS     # pairs per vectorized iteration


def _lane_sum(v):
    """Horizontal sum of a 4-lane vector: (l0 + l2) + (l1 + l3)."""
    return (v[0] + v[2]) + (v[1] + v[3])


def _sequential_sum(terms):
    acc = torch.zeros_like(terms[0])
    for p in range(terms.shape[0]):
        acc = acc + terms[p]
    return acc


def _tail_lanes(n_terms: int, outputs: int) -> int:
    """Vector width of the compiled loop's epilogue over the pairs left
    after the 16-pair blocks: 2 for s = 10 with at most 8 outputs, else
    4 (for the other pair counts both widths give the same bits on
    every probed input, since the tail terms sit far below the sum)."""
    return 2 if n_terms == 55 and outputs <= 8 else _LANES


def _reference_order_sum(terms):
    """Sum ``terms`` (P, m, n) over P in the order of the reference.

    Up to 36 pairs (s <= 8), and for 45 pairs (s = 9) when m*n <= 2,
    the compiled loop sums in schedule order.  Otherwise it is
    vectorized 4 lanes wide with 4 interleaved accumulators over blocks
    of 16 pairs, and the backend contracts each multiply-add into an
    FMA, which chains the four accumulators into one per lane: the
    lane adds part 0 of every block, then, for parts 1 to 3, block 1,
    block 0, block 2, block 3, ...  The lanes are summed as (l0 + l2) +
    (l1 + l3).  The pairs left over run through an epilogue vector of
    :func:`_tail_lanes` lanes seeded with the sum, then one by one.
    Every term is exact (an int32 times a power of two; the FMA's
    product is exact too), so only this order rounds.
    """
    n_terms = terms.shape[0]
    outputs = math.prod(terms.shape[1:])
    blocks = n_terms // _BLOCK
    if n_terms <= _SEQUENTIAL_MAX_PAIRS or (n_terms == 45
                                             and outputs <= 2):
        return _sequential_sum(terms)

    def part(b, u):
        start = b * _BLOCK + u * _LANES
        return terms[start:start + _LANES]

    acc = torch.zeros_like(terms[:_LANES])
    for b in range(blocks):
        acc = acc + part(b, 0)
    later = [1, 0, *range(2, blocks)] if blocks > 1 else [0]
    for u in range(1, _PARTS):
        for b in later:
            acc = acc + part(b, u)
    total = _lane_sum(acc)
    p = blocks * _BLOCK
    lanes = _tail_lanes(n_terms, outputs)
    if n_terms - p >= lanes:
        vec = torch.cat([total[None],
                         torch.full_like(terms[1:lanes], -0.0)])
        while p + lanes <= n_terms:
            vec = vec + terms[p:p + lanes]
            p += lanes
        total = _lane_sum(vec) if lanes == _LANES else vec[0] + vec[1]
    for q in range(p, n_terms):
        total = total + terms[q]
    return total


def _accumulate_f64(prod, shifts, slice_bits):
    """Weighted float64 accumulation of the INT32 pair products."""
    w = np.ldexp(1.0, -(np.asarray(shifts) + 2) * slice_bits)
    w = torch.as_tensor(w, dtype=torch.float64, device=prod.device)
    return _reference_order_sum(w[:, None, None] * prod.to(torch.float64))


def _two_sum(acc, term):
    """Knuth TwoSum: acc + term = s + err exactly (any float dtype)."""
    s = acc + term
    bp = s - acc
    err = (acc - (s - bp)) + (term - bp)
    return s, err


def _accumulate_df32(prod, shifts, slice_bits, num_splits):
    """Compensated double-float32 accumulation.

    Each INT32 pair product is split exactly into hi/lo float32 parts,
    weighted by a non-negative power-of-two shift, and folded into a
    compensated (sum, err) float32 pair.  The caller divides by the
    deferred scale 2**(w*(s+1)) at combine time.
    """
    smax = num_splits - 1
    hi = prod.to(torch.float32)
    lo = (prod - hi.to(prod.dtype)).to(torch.float32)
    w = np.ldexp(np.float32(1.0), (smax - np.asarray(shifts)) * slice_bits)
    w = torch.as_tensor(w, dtype=torch.float32,
                        device=prod.device)[:, None, None]
    t_hi = hi * w  # exact: power-of-two weight, well inside f32 range
    t_lo = lo * w
    acc = torch.zeros(prod.shape[1:], dtype=torch.float32,
                      device=prod.device)
    comp = torch.zeros_like(acc)
    for p in range(prod.shape[0]):  # pairs ordered large -> small
        acc, err = _two_sum(acc, t_hi[p])
        comp = comp + err
        acc, err = _two_sum(acc, t_lo[p])
        comp = comp + err
    deferred = 2.0 ** (-slice_bits * (smax + 2))
    return acc, comp, deferred


def _real_ozaki(a, b, num_splits, accumulator, out_dtype, slice_bits):
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if accumulator not in ("f64", "df32"):
        raise ValueError(f"unknown accumulator {accumulator!r};"
                         " expected 'df32' or 'f64'")
    a_sl, sigma_a = slice_matrix(a, num_splits, axis=1,
                                 slice_bits=slice_bits)
    b_sl, sigma_b = slice_matrix(b, num_splits, axis=0,
                                 slice_bits=slice_bits)
    ii, jj = pair_indices(num_splits)
    prod = _int8_pair_products(a_sl, b_sl, ii, jj)
    shifts = ii + jj
    if accumulator == "f64":
        c = _accumulate_f64(prod, shifts, slice_bits).to(out_dtype)
    else:
        acc, comp, deferred = _accumulate_df32(prod, shifts, slice_bits,
                                               num_splits)
        c = (acc.to(out_dtype) + comp.to(out_dtype)) * deferred
    scale = (sigma_a[:, None] * sigma_b[None, :]).to(out_dtype)
    return c * scale


def is_complex_problem(a, b, out_dtype) -> bool:
    """The reference's complex gate: inputs OR output complex."""
    return a.is_complex() or b.is_complex() or out_dtype.is_complex


def _real_part(x):
    return x.real if x.is_complex() else x


def _imag_part(x):
    return x.imag if x.is_complex() else torch.zeros_like(x)


def complex_matmul_via_real(real_matmul, a, b, out_dtype):
    """Complex product from four real GEMMs — shared by every engine.

    ``real_matmul(x, y, real_out_dtype)`` runs one real matmul; the
    decomposition, the real working dtype (f64 for complex128, f32
    otherwise) and the final cast live here so the plain and kernel
    paths cannot drift apart.
    """
    real_out = (torch.float64 if out_dtype in (torch.complex128,
                                               torch.float64)
                else torch.float32)
    ar, ai = _real_part(a), _imag_part(a)
    br, bi = _real_part(b), _imag_part(b)
    cr = real_matmul(ar, br, real_out) - real_matmul(ai, bi, real_out)
    ci = real_matmul(ar, bi, real_out) + real_matmul(ai, br, real_out)
    return torch.complex(cr, ci).to(out_dtype)


def ozaki_matmul(a, b, num_splits: int = 6, accumulator: str = "df32",
                 out_dtype=None, slice_bits: int = SLICE_BITS):
    """Emulated high-precision matmul ``a @ b`` via INT8 split GEMMs.

    Args:
      a: (m, k) real or complex floating tensor.
      b: (k, n) real or complex floating tensor on the same device.
      num_splits: slice count ``s``; issues ``s*(s+1)/2`` INT8 GEMMs and
        carries roughly ``slice_bits * s`` mantissa bits.
      accumulator: ``"df32"`` (compensated float32 pairs) or ``"f64"``
        (plain float64 accumulation).
      out_dtype: result dtype; defaults to the promoted input dtype.
      slice_bits: mantissa bits per int8 slice.

    Returns:
      (m, n) tensor of ``out_dtype`` on the operands' device.
    """
    a = as_tensor(a)
    b = as_tensor(b, device=a.device)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("ozaki_matmul expects 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if num_splits < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)

    if is_complex_problem(a, b, out_dtype):
        def part(x, y, real_out):
            return _real_ozaki(x, y, num_splits, accumulator, real_out,
                               slice_bits)

        return complex_matmul_via_real(part, a, b, out_dtype)

    return _real_ozaki(a, b, num_splits, accumulator, out_dtype,
                       slice_bits)
