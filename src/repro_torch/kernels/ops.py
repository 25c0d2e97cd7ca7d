"""Ozaki split-GEMM kernels for Hopper, their plain versions and wrappers.

Port of :mod:`repro.kernels.ops`.  Three kernels, written in CUDA C++
for ``sm_90a`` in ``csrc/split_gemm.cu``, replace the three Pallas
kernels:

* **K1** :func:`split_gemm` — replaces ``split_gemm_pallas``: pre-sliced
  int8 stacks ``a_sl (s, m, k)`` / ``b_sl (s, k, n)`` in, the
  compensated f32 pair ``(hi, lo)`` out;
* **K2** :func:`split_gemm_fused` — replaces ``split_gemm_pallas_fused``:
  the operands enter as exact f32 ``(hi, lo)`` halves of the
  sigma-scaled A and B and are quantized to int8 in shared memory, so no
  slice reaches device memory;
* **K3** :func:`split_gemm_v1` — replaces ``split_gemm_pallas_v1``, the
  legacy kernel: the wrapper first gathers every slice pair into a
  ``(P, m, k)`` / ``(P, k, n)`` copy plus a per-pair f32 weight array
  (:func:`gather_pairs`), and the kernel reads pair ``p``'s operands
  and weight from them.  It is kept for the A/B check against K1 (the
  two are bitwise equal) and for the traffic accounting of
  :func:`repro_torch.kernels.tile_model.traffic`.

For each output tile all three walk the slice pairs in schedule order and,
inside each pair, the ``block_k``-wide k-tiles; each step's exact int32
partial is weighted by ``2**((s-1-i-j)*w)`` and TwoSum-folded into
``hi`` with ``lo += err``.  The emulated product is
``(hi + lo) * 2**(-w*(s+1)) * sigma_a (x) sigma_b``.

Each wrapper runs the kernel for CUDA tensors (or raises) and the
kernel's plain version, :func:`split_gemm_plain` /
:func:`split_gemm_fused_plain` / :func:`split_gemm_v1_plain`, for CPU
tensors; there is no fallback
from one to the other.  The plain versions execute the kernel's loop
nest in eager torch (pair-major, then k-tile, then the TwoSum fold) and
are held bitwise against the Pallas kernels in interpret mode by the
CPU tests; ``chip_smoke.py`` holds the CUDA kernels bitwise against the
plain versions on the card.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.ozaki import (SLICE_BITS, _two_sum, int8_matmul_exact,
                          is_complex_problem, pair_indices, slice_matrix)
from . import _build, slicing, tile_model

__all__ = [
    "LAUNCHES",
    "gather_pairs",
    "ozaki_matmul",
    "split_gemm",
    "split_gemm_fused",
    "split_gemm_fused_plain",
    "split_gemm_plain",
    "split_gemm_v1",
    "split_gemm_v1_plain",
]

#: Launches of each CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"split_gemm": 0, "split_gemm_fused": 0, "split_gemm_v1": 0}


def pair_schedule_arrays(num_splits: int, slice_bits: int):
    """(ii, jj, wexp) int32 arrays: pair order and weight exponents."""
    ii, jj = pair_indices(num_splits)
    wexp = ((num_splits - 1) - (ii + jj)) * slice_bits
    return ii, jj, wexp.astype(np.int32)


def _fold_k_tiles(hi, lo, a_q, b_q, w: float, bk: int):
    """Fold the exact int32 partial of every k-tile of ``a_q @ b_q``."""
    k = a_q.shape[1]
    for k0 in range(0, k, bk):
        part = int8_matmul_exact(a_q[:, k0:k0 + bk], b_q[k0:k0 + bk, :])
        term = part.to(torch.float32) * w
        hi, err = _two_sum(hi, term)
        lo = lo + err
    return hi, lo


def split_gemm_plain(a_sl, b_sl, num_splits: int,
                     slice_bits: int = SLICE_BITS, block_k: int = 128):
    """Plain version of K1: the kernel's loop nest in eager torch."""
    _, m, k = a_sl.shape
    n = b_sl.shape[2]
    bk = tile_model.effective_block_k(k, block_k)
    ii, jj, wexp = pair_schedule_arrays(num_splits, slice_bits)
    hi = torch.zeros((m, n), dtype=torch.float32, device=a_sl.device)
    lo = torch.zeros_like(hi)
    for p in range(len(ii)):
        w = float(np.ldexp(np.float32(1.0), int(wexp[p])))
        hi, lo = _fold_k_tiles(hi, lo, a_sl[ii[p]], b_sl[jj[p]], w, bk)
    return hi, lo


def gather_pairs(a_sl, b_sl, num_splits: int,
                 slice_bits: int = SLICE_BITS):
    """K3's staging: the pair copies ``a_sl[ii]`` (P, m, k) and
    ``b_sl[jj]`` (P, k, n), contiguous, and the per-pair f32 weights
    ``2**((s-1-i-j)*w)``, built exactly with ``np.ldexp`` as the
    reference builds them."""
    ii, jj = pair_indices(num_splits)
    dev = a_sl.device
    a_pairs = a_sl[torch.as_tensor(ii, dtype=torch.long, device=dev)]
    b_pairs = b_sl[torch.as_tensor(jj, dtype=torch.long, device=dev)]
    w = np.ldexp(np.float32(1.0), (num_splits - 1 - (ii + jj)) * slice_bits)
    weights = torch.as_tensor(w.astype(np.float32), device=dev)
    return a_pairs.contiguous(), b_pairs.contiguous(), weights


def split_gemm_v1_plain(a_sl, b_sl, num_splits: int,
                        slice_bits: int = SLICE_BITS, block_k: int = 128):
    """Plain version of K3: gather the pairs, then fold pair ``p`` with
    the weight read from the array."""
    k = a_sl.shape[2]
    bk = tile_model.effective_block_k(k, block_k)
    a_pairs, b_pairs, weights = gather_pairs(a_sl, b_sl, num_splits,
                                             slice_bits)
    m, n = a_pairs.shape[1], b_pairs.shape[2]
    hi = torch.zeros((m, n), dtype=torch.float32, device=a_sl.device)
    lo = torch.zeros_like(hi)
    for p in range(a_pairs.shape[0]):
        hi, lo = _fold_k_tiles(hi, lo, a_pairs[p], b_pairs[p],
                               float(weights[p]), bk)
    return hi, lo


def split_gemm_fused_plain(a_hi, a_lo, b_hi, b_lo, num_splits: int,
                           slice_bits: int = SLICE_BITS,
                           block_k: int = 128):
    """Plain version of K2: quantize the pair's slices, then K1's fold."""
    m, k = a_hi.shape
    n = b_hi.shape[1]
    bk = tile_model.effective_block_k(k, block_k)
    ii, jj, wexp = pair_schedule_arrays(num_splits, slice_bits)
    hi = torch.zeros((m, n), dtype=torch.float32, device=a_hi.device)
    lo = torch.zeros_like(hi)
    for p in range(len(ii)):
        a_q = slicing.quantize_tile(a_hi, a_lo, int(ii[p]), num_splits,
                                    slice_bits)
        b_q = slicing.quantize_tile(b_hi, b_lo, int(jj[p]), num_splits,
                                    slice_bits)
        w = float(np.ldexp(np.float32(1.0), int(wexp[p])))
        hi, lo = _fold_k_tiles(hi, lo, a_q, b_q, w, bk)
    return hi, lo


def _check_inputs(tensors, dtype, device):
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device.type == "cuda" and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _schedule_ctypes(num_splits, slice_bits):
    """The schedule as int32 arrays (kept alive by the caller) and the
    ctypes pointers the launcher copies from."""
    ii, jj, wexp = pair_schedule_arrays(num_splits, slice_bits)
    arrs = [np.ascontiguousarray(x, dtype=np.int32) for x in (ii, jj, wexp)]
    ptrs = [x.ctypes.data_as(ctypes.POINTER(ctypes.c_int)) for x in arrs]
    return arrs, ptrs, len(ii)


def _raise_on(lib, code: int, what: str):
    if code != 0:
        msg = lib.split_gemm_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


def split_gemm(a_sl, b_sl, num_splits: int, slice_bits: int = SLICE_BITS,
               block_k: int = 128):
    """K1 over pre-sliced operands: ``(hi, lo)`` f32 of shape (m, n).

    Args:
      a_sl: (s, m, k) int8 slices of A, contiguous.
      b_sl: (s, k, n) int8 slices of B, contiguous, on A's device.
      block_k: k-tile width; rounded like the reference's (a multiple of
        128, at most the padded k).  It sets the bits of the result.
    """
    dev = a_sl.device
    _check_inputs({"a_sl": a_sl, "b_sl": b_sl}, torch.int8, dev)
    s, m, k = a_sl.shape
    s2, k2, n = b_sl.shape
    if s != num_splits or s2 != num_splits or k2 != k:
        raise ValueError(f"slice stacks {tuple(a_sl.shape)} @ "
                         f"{tuple(b_sl.shape)} do not match "
                         f"num_splits={num_splits}")
    if dev.type == "cpu":
        return split_gemm_plain(a_sl, b_sl, num_splits, slice_bits, block_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bk = tile_model.effective_block_k(k, block_k)
    lib = _build.load()
    hi = torch.empty((m, n), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    _arrays, (ii, jj, wexp), pairs = _schedule_ctypes(num_splits,
                                                      slice_bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.split_gemm_launch(
        a_sl.data_ptr(), b_sl.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        m, k, n, bk, ii, jj, wexp, pairs, dev.index or 0, stream)
    _raise_on(lib, code, "split_gemm")
    LAUNCHES["split_gemm"] += 1
    return hi, lo


def split_gemm_fused(a_hi, a_lo, b_hi, b_lo, num_splits: int,
                     slice_bits: int = SLICE_BITS, block_k: int = 128):
    """K2 with in-kernel slicing: ``(hi, lo)`` f32 of shape (m, n).

    Args:
      a_hi, a_lo: (m, k) f32 halves of the sigma-scaled A
        (:func:`repro_torch.kernels.slicing.to_operand_pair`).
      b_hi, b_lo: (k, n) f32 halves of the sigma-scaled B.
    """
    dev = a_hi.device
    _check_inputs({"a_hi": a_hi, "a_lo": a_lo, "b_hi": b_hi, "b_lo": b_lo},
                  torch.float32, dev)
    m, k = a_hi.shape
    k2, n = b_hi.shape
    if a_lo.shape != a_hi.shape or b_lo.shape != b_hi.shape or k2 != k:
        raise ValueError(f"operand halves {tuple(a_hi.shape)} @ "
                         f"{tuple(b_hi.shape)} do not match")
    if dev.type == "cpu":
        return split_gemm_fused_plain(a_hi, a_lo, b_hi, b_lo, num_splits,
                                      slice_bits, block_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bk = tile_model.effective_block_k(k, block_k)
    lib = _build.load()
    hi = torch.empty((m, n), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    _arrays, (ii, jj, wexp), pairs = _schedule_ctypes(num_splits,
                                                      slice_bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.split_gemm_fused_launch(
        a_hi.data_ptr(), a_lo.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), m, k, n, bk, slice_bits, ii, jj,
        wexp, pairs, dev.index or 0, stream)
    _raise_on(lib, code, "split_gemm_fused")
    LAUNCHES["split_gemm_fused"] += 1
    return hi, lo


def split_gemm_v1(a_sl, b_sl, num_splits: int,
                  slice_bits: int = SLICE_BITS, block_k: int = 128):
    """K3, the legacy kernel: ``(hi, lo)`` f32 of shape (m, n).

    Same contract and bits as :func:`split_gemm`; the wrapper stages
    the pair copies and weights with :func:`gather_pairs` and the
    kernel reads them, so device memory holds P = s(s+1)/2 pair copies
    instead of s slice layers.
    """
    dev = a_sl.device
    _check_inputs({"a_sl": a_sl, "b_sl": b_sl}, torch.int8, dev)
    s, m, k = a_sl.shape
    s2, k2, n = b_sl.shape
    if s != num_splits or s2 != num_splits or k2 != k:
        raise ValueError(f"slice stacks {tuple(a_sl.shape)} @ "
                         f"{tuple(b_sl.shape)} do not match "
                         f"num_splits={num_splits}")
    if dev.type == "cpu":
        return split_gemm_v1_plain(a_sl, b_sl, num_splits, slice_bits,
                                   block_k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bk = tile_model.effective_block_k(k, block_k)
    lib = _build.load()
    a_pairs, b_pairs, weights = gather_pairs(a_sl, b_sl, num_splits,
                                             slice_bits)
    hi = torch.empty((m, n), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.split_gemm_v1_launch(
        a_pairs.data_ptr(), b_pairs.data_ptr(), weights.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), m, k, n, bk, a_pairs.shape[0],
        dev.index or 0, stream)
    _raise_on(lib, code, "split_gemm_v1")
    LAUNCHES["split_gemm_v1"] += 1
    return hi, lo


def ozaki_matmul(a, b, num_splits: int = 6, accumulator: str = "df32",
                 out_dtype=None, slice_bits: int = SLICE_BITS,
                 block_m: int | None = None, block_n: int | None = None,
                 block_k: int | None = None, fuse_slicing: bool = False,
                 tiles: tile_model.TileDecision | None = None):
    """Kernel-backed drop-in for :func:`repro_torch.core.ozaki_matmul`.

    Same semantics as the reference wrapper (``repro.kernels.ops``):
    the kernels accumulate compensated f32, so ``accumulator`` must be
    ``"df32"`` or ``None`` (anything else raises ``ValueError``);
    complex operands raise ``NotImplementedError`` (route them through
    :func:`repro_torch.core.ozaki_matmul` or a backend).  Blocks come
    from ``tiles`` or explicit ``block_*`` arguments, else from
    :func:`repro_torch.kernels.tile_model.select_tiles`.  Only
    ``block_k`` changes the result; the CUDA kernels run their compiled
    64x64 CTA tile whatever ``block_m``/``block_n`` say.
    """
    if accumulator not in ("df32", None):
        raise ValueError(
            f"unsupported accumulator {accumulator!r} for the split-GEMM "
            "kernels: they always accumulate compensated-f32 ('df32'); "
            "pass 'df32' or None, or use repro_torch.core.ozaki_matmul "
            "for 'f64'")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError("ozaki_matmul expects 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if out_dtype is None:
        out_dtype = torch.promote_types(a.dtype, b.dtype)
    if is_complex_problem(a, b, out_dtype):
        raise NotImplementedError(
            "complex operands: route through repro_torch.core.ozaki_matmul")

    m, k = a.shape
    n = b.shape[1]
    if tiles is None and None in (block_m, block_n, block_k):
        tiles = tile_model.select_tiles(m, k, n, num_splits,
                                        dtype=out_dtype, fused=fuse_slicing)
    if tiles is not None:
        block_k = tiles.block_k if block_k is None else block_k

    if fuse_slicing:
        a_hi, a_lo, sigma_a = slicing.to_operand_pair(a, axis=1)
        b_hi, b_lo, sigma_b = slicing.to_operand_pair(b, axis=0)
        hi, lo = split_gemm_fused(
            a_hi.contiguous(), a_lo.contiguous(), b_hi.contiguous(),
            b_lo.contiguous(), num_splits, slice_bits=slice_bits,
            block_k=block_k)
    else:
        a_sl, sigma_a = slice_matrix(a, num_splits, axis=1,
                                     slice_bits=slice_bits)
        b_sl, sigma_b = slice_matrix(b, num_splits, axis=0,
                                     slice_bits=slice_bits)
        hi, lo = split_gemm(a_sl, b_sl, num_splits, slice_bits=slice_bits,
                            block_k=block_k)
    deferred = 2.0 ** (-slice_bits * (num_splits + 1))
    c = (hi.to(out_dtype) + lo.to(out_dtype)) * deferred
    scale = (sigma_a[:, None] * sigma_b[None, :]).to(out_dtype)
    return c * scale
