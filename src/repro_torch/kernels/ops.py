"""Ozaki split-GEMM kernels for Hopper, their plain versions and wrappers.

Port of :mod:`repro.kernels.ops`.  Three kernels, written in CUDA C++
for ``sm_90a`` in ``csrc/split_gemm.cu``, replace the three Pallas
kernels:

* **K1** :func:`split_gemm_kmajor` — replaces ``split_gemm_pallas``:
  pre-sliced int8 stacks ``a_sl (s, m, k)`` and, k-major,
  ``b_sl_t (s, n, k)`` in, the compensated f32 pair ``(hi, lo)`` out;
  :func:`split_gemm` takes B's stack as the reference lays it out,
  ``(s, k, n)``, and transposes it in front of the kernel.
  :func:`split_gemm_kmajor_combined` is the same kernel with the
  operands' sigma vectors: its epilogue finishes the product in
  float32 or float64 instead of storing ``(hi, lo)``.
  :func:`ozaki_matmul` slices B k-major directly and calls
  :func:`split_gemm_kmajor_combined` (or, for another output dtype,
  :func:`split_gemm_kmajor`), so the main paths never transpose;
* **K2** :func:`split_gemm_fused` — replaces ``split_gemm_pallas_fused``:
  the operands enter as exact f32 ``(hi, lo)`` halves of the
  sigma-scaled A and B and are quantized to int8 in shared memory, so no
  slice reaches device memory;
* **K3** :func:`split_gemm_v1` — replaces ``split_gemm_pallas_v1``, the
  legacy kernel: the wrapper first gathers every slice pair into a
  ``(P, m, k)`` copy of A and a k-major ``(P, n, k)`` copy of B plus a
  per-pair f32 weight array (:func:`gather_pairs_kmajor`, a gather
  kernel of its own), and the kernel (:func:`split_gemm_v1_pairs`)
  reads pair ``p``'s operands and weight from them.  It is kept for the A/B check against K1 (the two
  are bitwise equal) and for the traffic accounting of
  :func:`repro_torch.kernels.tile_model.traffic`.

For each output tile all three walk the slice pairs in schedule order and,
inside each pair, the ``block_k``-wide k-tiles; each step's exact int32
partial is weighted by ``2**((s-1-i-j)*w)`` and TwoSum-folded into
``hi`` with ``lo += err``.  The emulated product is
``(hi + lo) * 2**(-w*(s+1)) * sigma_a (x) sigma_b``: the combine, whose
roundings are fixed as a chain of torch ops (:func:`combine`).  For a
float32 or float64 output K1's epilogue runs that chain itself, one
rounding for one, so the product leaves the kernel finished and bitwise
the chain's.

Each wrapper runs the kernel for CUDA tensors (or raises) and the
kernel's plain version, :func:`split_gemm_plain` /
:func:`split_gemm_kmajor_combined_plain` (plain K1, then
:func:`combine`) / :func:`split_gemm_fused_plain` /
:func:`split_gemm_v1_plain`, for CPU tensors; there is no fallback
from one to the other.  The plain versions execute the kernel's loop
nest in eager torch (pair-major, then k-tile, then the TwoSum fold) and
are held bitwise against the Pallas kernels in interpret mode by the
CPU tests; ``chip_smoke.py`` holds the CUDA kernels bitwise against the
plain versions on the card.  ``LAUNCHES`` counts kernel launches.
:func:`ozaki_matmul` slices each operand with
:func:`repro_torch.kernels.slicing.slice_operand` (one launch of the
slicing kernel per operand on the card, ``slice_matrix`` on the CPU).
It opens the layer span ``ozaki`` around each call, and inside it
``ozaki.slice`` (both operands' slicing), ``ozaki.kernel`` (the
launch, with its epilogue) and, only where the torch combine runs (an
output dtype other than float32 and float64, or K2's path),
``ozaki.combine`` (:mod:`repro_torch.obs.trace`).  ``COMBINES`` counts
the calls that finished in K1's epilogue and those that ran the torch
combine.

The pair schedule is built once per ``(s, slice_bits)`` (and, for K3's
gather, once per device) and shared by all three wrappers.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.ozaki import (SLICE_BITS, _two_sum, int8_matmul_exact,
                          is_complex_problem, pair_indices)
from ..obs.trace import span
from . import _build, slicing, tile_model

__all__ = [
    "COMBINES",
    "LAUNCHES",
    "combine",
    "gather_pairs",
    "gather_pairs_kmajor",
    "gather_pairs_kmajor_plain",
    "ozaki_matmul",
    "split_gemm",
    "split_gemm_fused",
    "split_gemm_fused_plain",
    "split_gemm_kmajor",
    "split_gemm_kmajor_combined",
    "split_gemm_kmajor_combined_plain",
    "split_gemm_kmajor_plain",
    "split_gemm_plain",
    "split_gemm_v1",
    "split_gemm_v1_pairs",
    "split_gemm_v1_plain",
]

#: Launches of each CUDA kernel, counted where the wrapper launches it.
LAUNCHES = {"split_gemm": 0, "split_gemm_fused": 0, "split_gemm_v1": 0,
            "gather_pairs_kmajor": 0, "slice_operand": 0}

#: :func:`ozaki_matmul` calls by where their product was finished: in
#: K1's epilogue or by the torch combine.
COMBINES = {"epilogue": 0, "torch": 0}

#: The output dtypes K1's epilogue finishes, and its kind for each.
_OUT_KINDS = {torch.float32: _build.K1_OUT_F32,
              torch.float64: _build.K1_OUT_F64}


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
    """Plain version of K1: the reference's loop nest in eager torch
    (pair-major, then k-tile, then the TwoSum fold)."""
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


def split_gemm_kmajor_plain(a_sl, b_sl_t, num_splits: int,
                            slice_bits: int = SLICE_BITS,
                            block_k: int = 128):
    """Plain version of K1 on k-major B slices ``(s, n, k)``."""
    return split_gemm_plain(a_sl, b_sl_t.transpose(1, 2), num_splits,
                            slice_bits, block_k)


def combine(hi, lo, sigma_a, sigma_b, num_splits: int, out_dtype,
            slice_bits: int = SLICE_BITS):
    """The emulated product from K1's pair: ``(hi + lo) *
    2**(-w*(s+1)) * sigma_a (x) sigma_b`` in ``out_dtype``, the sigma
    product in float64.  K1's epilogue repeats these roundings."""
    deferred = 2.0 ** (-slice_bits * (num_splits + 1))
    c = (hi.to(out_dtype) + lo.to(out_dtype)) * deferred
    scale = (sigma_a[:, None] * sigma_b[None, :]).to(out_dtype)
    return c * scale


def split_gemm_kmajor_combined_plain(a_sl, b_sl_t, sigma_a, sigma_b,
                                     num_splits: int, out_dtype,
                                     slice_bits: int = SLICE_BITS,
                                     block_k: int = 128):
    """Plain version of K1 with its epilogue: plain K1, then
    :func:`combine`."""
    hi, lo = split_gemm_kmajor_plain(a_sl, b_sl_t, num_splits, slice_bits,
                                     block_k)
    return combine(hi, lo, sigma_a, sigma_b, num_splits, out_dtype,
                   slice_bits)


@functools.lru_cache(maxsize=None)
def _host_schedule(num_splits: int, slice_bits: int):
    """(ii, jj, wexp) as ctypes int arrays, built once per schedule;
    the K2 launcher copies them into the kernel's parameters."""
    arrays = pair_schedule_arrays(num_splits, slice_bits)
    return tuple((ctypes.c_int * len(x))(*x.tolist()) for x in arrays)


@functools.lru_cache(maxsize=None)
def _device_schedule(num_splits: int, slice_bits: int,
                     device: torch.device):
    """K3's gather indices ``ii``, ``jj`` (int64) and per-pair f32
    weights ``2**((s-1-i-j)*w)`` on ``device``, built once per
    (s, slice_bits, device), the weights exactly with ``np.ldexp`` as
    the reference builds them."""
    ii, jj = pair_indices(num_splits)
    w = np.ldexp(np.float32(1.0), (num_splits - 1 - (ii + jj)) * slice_bits)
    return (torch.as_tensor(ii, dtype=torch.long, device=device),
            torch.as_tensor(jj, dtype=torch.long, device=device),
            torch.as_tensor(w.astype(np.float32), device=device))


def gather_pairs(a_sl, b_sl, num_splits: int,
                 slice_bits: int = SLICE_BITS):
    """K3's staging as the reference lays it out: the pair copies
    ``a_sl[ii]`` (P, m, k) and ``b_sl[jj]`` (P, k, n), contiguous, and
    the per-pair f32 weights."""
    ii, jj, weights = _device_schedule(num_splits, slice_bits, a_sl.device)
    return (torch.index_select(a_sl, 0, ii),
            torch.index_select(b_sl, 0, jj), weights)


def gather_pairs_kmajor_plain(a_sl, b_sl, num_splits: int,
                              slice_bits: int = SLICE_BITS):
    """Plain version of K3's gather kernel: :func:`gather_pairs`' copies
    with B's transposed to k-major (P, n, k)."""
    ii, jj, weights = _device_schedule(num_splits, slice_bits, a_sl.device)
    return (torch.index_select(a_sl, 0, ii),
            torch.index_select(b_sl.transpose(1, 2), 0, jj).contiguous(),
            weights)


def gather_pairs_kmajor(a_sl, b_sl, num_splits: int,
                        slice_bits: int = SLICE_BITS):
    """K3's staging as its kernel reads it: the pair copies ``a_sl[ii]``
    (P, m, k) and, k-major, ``b_sl[jj]`` transposed (P, n, k), written
    by one launch of the gather kernel (its plain version for CPU
    tensors), and the cached per-pair weights."""
    dev = a_sl.device
    _check_inputs({"a_sl": a_sl, "b_sl": b_sl}, torch.int8, dev)
    s, m, k = a_sl.shape
    s2, k2, n = b_sl.shape
    if s != num_splits or s2 != num_splits or k2 != k:
        raise ValueError(f"slice stacks {tuple(a_sl.shape)} @ "
                         f"{tuple(b_sl.shape)} do not match "
                         f"num_splits={num_splits}")
    if dev.type == "cpu":
        return gather_pairs_kmajor_plain(a_sl, b_sl, num_splits, slice_bits)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch_gather(_lib(), _stream(dev), a_sl, b_sl,
                          num_splits, slice_bits)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_gather(lib, stream, a_sl, b_sl, num_splits, slice_bits):
    """The gather kernel on slice stacks already checked."""
    dev = a_sl.device
    _, m, k = a_sl.shape
    n = b_sl.shape[2]
    ii, jj, wexp = _host_schedule(num_splits, slice_bits)
    a_pairs = torch.empty((len(ii), m, k), dtype=torch.int8, device=dev)
    b_pairs = torch.empty((len(ii), n, k), dtype=torch.int8, device=dev)
    code = lib.gather_pairs_launch(
        a_sl.data_ptr(), b_sl.data_ptr(), a_pairs.data_ptr(),
        b_pairs.data_ptr(), m, k, n, ii, jj, wexp, len(ii), dev.index or 0,
        stream)
    _raise_on(lib, code, "gather_pairs_kmajor")
    LAUNCHES["gather_pairs_kmajor"] += 1
    return a_pairs, b_pairs, _device_schedule(num_splits, slice_bits,
                                              dev)[2]


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


def _raise_on(lib, code: int, what: str):
    if code != 0:
        msg = lib.split_gemm_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")


def _lib():
    """The kernel library (one attribute read once it is loaded)."""
    return _build._LIB or _build.load()


def _check_k1(a_sl, b_sl, num_splits: int, b_name: str):
    """K1's one validation per call; returns (m, k, n)."""
    dev = a_sl.device
    _check_inputs({"a_sl": a_sl, b_name: b_sl}, torch.int8, dev)
    s, m, k = a_sl.shape
    if b_name == "b_sl_t":
        s2, n, k2 = b_sl.shape
    else:
        s2, k2, n = b_sl.shape
    if s != num_splits or s2 != num_splits or k2 != k:
        raise ValueError(f"slice stacks {tuple(a_sl.shape)} and {b_name} "
                         f"{tuple(b_sl.shape)} do not match "
                         f"num_splits={num_splits}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return m, k, n


def split_gemm(a_sl, b_sl, num_splits: int, slice_bits: int = SLICE_BITS,
               block_k: int = 128, plan: tile_model.K1Plan | None = None):
    """K1 over pre-sliced operands: ``(hi, lo)`` f32 of shape (m, n).

    Args:
      a_sl: (s, m, k) int8 slices of A, contiguous.
      b_sl: (s, k, n) int8 slices of B, contiguous, on A's device; on
        the card it is transposed to k-major in front of the kernel.
      block_k: k-tile width; rounded like the reference's (a multiple of
        128, at most the padded k).  It sets the bits of the result.
      plan: a :class:`~repro_torch.kernels.tile_model.K1Plan` to force
        (one of ``tile_model.k1_plans``); by default ``k1_plan``'s.
    """
    m, k, n = _check_k1(a_sl, b_sl, num_splits, "b_sl")
    if a_sl.device.type == "cpu":
        return split_gemm_plain(a_sl, b_sl, num_splits, slice_bits, block_k)
    return _launch_k1(a_sl, b_sl.transpose(1, 2).contiguous(), m, k, n,
                      num_splits, slice_bits, block_k, plan)


def split_gemm_kmajor(a_sl, b_sl_t, num_splits: int,
                      slice_bits: int = SLICE_BITS, block_k: int = 128,
                      plan: tile_model.K1Plan | None = None):
    """K1 with B's slices k-major: ``(hi, lo)`` f32 of shape (m, n).

    Args:
      a_sl: (s, m, k) int8 slices of A, contiguous.
      b_sl_t: (s, n, k) int8 slices of B, k-major (``slice_matrix(b.mT,
        s, axis=1)``), contiguous, on A's device.
      block_k, plan: as for :func:`split_gemm`.
    """
    m, k, n = _check_k1(a_sl, b_sl_t, num_splits, "b_sl_t")
    if a_sl.device.type == "cpu":
        return split_gemm_kmajor_plain(a_sl, b_sl_t, num_splits, slice_bits,
                                       block_k)
    return _launch_k1(a_sl, b_sl_t, m, k, n, num_splits, slice_bits,
                      block_k, plan)


def split_gemm_kmajor_combined(a_sl, b_sl_t, sigma_a, sigma_b,
                               num_splits: int, out_dtype,
                               slice_bits: int = SLICE_BITS,
                               block_k: int = 128,
                               plan: tile_model.K1Plan | None = None):
    """K1 finishing the product in its epilogue: ``(m, n)`` of
    ``out_dtype``, bitwise :func:`split_gemm_kmajor` followed by
    :func:`combine`, in one launch.

    Args:
      a_sl, b_sl_t: as for :func:`split_gemm_kmajor`.
      sigma_a: (m,) float64 row scales of A; sigma_b: (n,) float64
        column scales of B (the slicing's ``sigma``), contiguous, on A's
        device.
      out_dtype: ``torch.float32`` or ``torch.float64``.
      block_k, plan: as for :func:`split_gemm`.
    """
    if out_dtype not in _OUT_KINDS:
        raise TypeError(f"K1's epilogue writes float32 or float64, not "
                        f"{out_dtype}")
    m, k, n = _check_k1(a_sl, b_sl_t, num_splits, "b_sl_t")
    _check_inputs({"sigma_a": sigma_a, "sigma_b": sigma_b}, torch.float64,
                  a_sl.device)
    if sigma_a.shape != (m,) or sigma_b.shape != (n,):
        raise ValueError(f"sigma_a {tuple(sigma_a.shape)} and sigma_b "
                         f"{tuple(sigma_b.shape)} do not match (m, n) = "
                         f"({m}, {n})")
    if a_sl.device.type == "cpu":
        return split_gemm_kmajor_combined_plain(
            a_sl, b_sl_t, sigma_a, sigma_b, num_splits, out_dtype,
            slice_bits, block_k)
    return _launch_k1(a_sl, b_sl_t, m, k, n, num_splits, slice_bits,
                      block_k, plan, (out_dtype, sigma_a, sigma_b))


@functools.lru_cache(maxsize=None)
def _k1_launch_args(m, k, n, num_splits, slice_bits, block_k, plan,
                    out_kind: int = _build.K1_OUT_PAIR):
    """The launcher's arguments after the pointers, per launch shape:
    the k-tile, the schedule, the plan's fields and the epilogue's
    output kind and deferred scale, in one struct.  A forced plan K1
    cannot take raises ``ValueError``."""
    bk = tile_model.effective_block_k(k, block_k)
    if plan is None:
        plan = tile_model.k1_plan(m, k, n, num_splits, bk)
    elif plan not in tile_model.k1_plans(m, k, n, num_splits, bk):
        raise ValueError(f"K1 cannot take {plan} at (m, k, n, s) = "
                         f"({m}, {k}, {n}, {num_splits}), block_k {bk}")
    ii, jj, wexp = pair_schedule_arrays(num_splits, slice_bits)
    args = _build.K1Args(m=m, k=k, n=n, block_k=bk, num_pairs=len(ii),
                         block_m=plan.block_m, block_n=plan.block_n,
                         resident=int(plan.resident))
    args.ii[:len(ii)], args.jj[:len(ii)] = ii.tolist(), jj.tolist()
    args.wexp[:len(ii)] = wexp.tolist()
    args.out_kind = out_kind
    args.deferred = 2.0 ** (-slice_bits * (num_splits + 1))
    return args


def _launch_k1(a_sl, b_sl_t, m, k, n, num_splits, slice_bits, block_k,
               plan, finish=None):
    """K1 on slice stacks already checked: ``(hi, lo)``, or with
    ``finish = (out_dtype, sigma_a, sigma_b)`` (checked too) the
    product its epilogue finished."""
    dev = a_sl.device
    lib = _lib()
    if finish is None:
        args = _k1_launch_args(m, k, n, num_splits, slice_bits, block_k,
                               plan)
        hi = torch.empty((m, n), dtype=torch.float32, device=dev)
        lo = torch.empty_like(hi)
        result = hi, lo
        ptrs = hi.data_ptr(), lo.data_ptr(), None, None
    else:
        out_dtype, sigma_a, sigma_b = finish
        args = _k1_launch_args(m, k, n, num_splits, slice_bits, block_k,
                               plan, _OUT_KINDS[out_dtype])
        result = torch.empty((m, n), dtype=out_dtype, device=dev)
        ptrs = (result.data_ptr(), None, sigma_a.data_ptr(),
                sigma_b.data_ptr())
    code = lib.split_gemm_launch(a_sl.data_ptr(), b_sl_t.data_ptr(), *ptrs,
                                 args, dev.index or 0, _stream(dev))
    _raise_on(lib, code, "split_gemm")
    LAUNCHES["split_gemm"] += 1
    return result


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
    plan = tile_model.fused_plan(num_splits, -(-k // bk))
    lib = _lib()
    hi = torch.empty((m, n), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    ii, jj, wexp = _host_schedule(num_splits, slice_bits)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.split_gemm_fused_launch(
        a_hi.data_ptr(), a_lo.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), m, k, n, bk, slice_bits, plan.group,
        ii, jj, wexp, len(ii), dev.index or 0, stream)
    _raise_on(lib, code, "split_gemm_fused")
    LAUNCHES["split_gemm_fused"] += 1
    return hi, lo


def split_gemm_v1(a_sl, b_sl, num_splits: int,
                  slice_bits: int = SLICE_BITS, block_k: int = 128):
    """K3, the legacy kernel: ``(hi, lo)`` f32 of shape (m, n).

    Same contract and bits as :func:`split_gemm`; the wrapper stages
    the pair copies and weights with :func:`gather_pairs_kmajor` and
    :func:`split_gemm_v1_pairs` reads them, so device memory holds
    P = s(s+1)/2 pair copies instead of s slice layers.
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
    # The gather's outputs need no second check: one validation per call
    # keeps the host's share of this short call small.
    lib, stream = _lib(), _stream(dev)
    copies = _launch_gather(lib, stream, a_sl, b_sl, num_splits,
                            slice_bits)
    return _launch_v1(lib, stream, *copies,
                      tile_model.effective_block_k(k, block_k))


def split_gemm_v1_pairs(a_pairs, b_pairs_t, weights, block_k: int = 128):
    """K3's kernel alone, on pair copies already gathered.

    Args:
      a_pairs: (P, m, k) int8 pair copies of A, contiguous.
      b_pairs_t: (P, n, k) int8 k-major pair copies of B, contiguous.
      weights: (P,) f32 pair weights.
    """
    dev = a_pairs.device
    _check_inputs({"a_pairs": a_pairs, "b_pairs_t": b_pairs_t},
                  torch.int8, dev)
    _check_inputs({"weights": weights}, torch.float32, dev)
    pairs, m, k = a_pairs.shape
    p2, n, k2 = b_pairs_t.shape
    if p2 != pairs or k2 != k or weights.shape != (pairs,):
        raise ValueError(f"pair copies {tuple(a_pairs.shape)}, "
                         f"{tuple(b_pairs_t.shape)} and weights "
                         f"{tuple(weights.shape)} do not match")
    bk = tile_model.effective_block_k(k, block_k)
    if dev.type == "cpu":
        hi = torch.zeros((m, n), dtype=torch.float32)
        lo = torch.zeros_like(hi)
        for p in range(pairs):
            hi, lo = _fold_k_tiles(hi, lo, a_pairs[p], b_pairs_t[p].T,
                                   float(weights[p]), bk)
        return hi, lo
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch_v1(_lib(), _stream(dev), a_pairs, b_pairs_t,
                      weights, bk)


def _launch_v1(lib, stream, a_pairs, b_pairs_t, weights, bk):
    """K3's kernel on pair copies already checked."""
    dev = a_pairs.device
    pairs, m, k = a_pairs.shape
    n = b_pairs_t.shape[1]
    hi = torch.empty((m, n), dtype=torch.float32, device=dev)
    lo = torch.empty_like(hi)
    code = lib.split_gemm_v1_launch(
        a_pairs.data_ptr(), b_pairs_t.data_ptr(), weights.data_ptr(),
        hi.data_ptr(), lo.data_ptr(), m, k, n, bk, pairs, dev.index or 0,
        stream)
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
    ``block_k`` changes the result; the CUDA kernels run their own CTA
    tile (K1's :func:`~repro_torch.kernels.tile_model.k1_plan`, K2's
    32x32) whatever ``block_m``/``block_n`` say.  A float32 or float64
    product leaves K1 finished (its epilogue runs :func:`combine`'s
    roundings); another output dtype, and the ``fuse_slicing`` path, run
    :func:`combine` after the kernel.  ``COMBINES`` counts which.
    """
    with span("ozaki"):
        if accumulator not in ("df32", None):
            raise ValueError(
                f"unsupported accumulator {accumulator!r} for the "
                "split-GEMM kernels: they always accumulate "
                "compensated-f32 ('df32'); pass 'df32' or None, or use "
                "repro_torch.core.ozaki_matmul for 'f64'")
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError("ozaki_matmul expects 2-D operands, got "
                             f"{tuple(a.shape)} @ {tuple(b.shape)}")
        if out_dtype is None:
            out_dtype = torch.promote_types(a.dtype, b.dtype)
        if is_complex_problem(a, b, out_dtype):
            raise NotImplementedError("complex operands: route through "
                                      "repro_torch.core.ozaki_matmul")

        m, k = a.shape
        n = b.shape[1]
        if tiles is None and None in (block_m, block_n, block_k):
            tiles = tile_model.select_tiles(m, k, n, num_splits,
                                            dtype=out_dtype,
                                            fused=fuse_slicing)
        if tiles is not None:
            block_k = tiles.block_k if block_k is None else block_k

        if fuse_slicing:
            with span("ozaki.slice"):
                a_hi, a_lo, sigma_a = slicing.to_operand_pair(a, axis=1)
                b_hi, b_lo, sigma_b = slicing.to_operand_pair(b, axis=0)
                halves = [x.contiguous()
                          for x in (a_hi, a_lo, b_hi, b_lo)]
            with span("ozaki.kernel"):
                hi, lo = split_gemm_fused(*halves, num_splits,
                                          slice_bits=slice_bits,
                                          block_k=block_k)
        else:
            with span("ozaki.slice"):
                a_sl, sigma_a = slicing.slice_operand(a, num_splits,
                                                      slice_bits)
                # B's slices k-major, (s, n, k): bit for bit the
                # transpose of slicing B along axis 0, written k-major by
                # the same launch.
                b_sl_t, sigma_b = slicing.slice_operand(b.mT, num_splits,
                                                        slice_bits)
            if out_dtype in _OUT_KINDS:
                with span("ozaki.kernel"):
                    c = split_gemm_kmajor_combined(
                        a_sl, b_sl_t, sigma_a, sigma_b, num_splits,
                        out_dtype, slice_bits=slice_bits, block_k=block_k)
                COMBINES["epilogue"] += 1
                return c
            with span("ozaki.kernel"):
                hi, lo = split_gemm_kmajor(a_sl, b_sl_t, num_splits,
                                           slice_bits=slice_bits,
                                           block_k=block_k)
        COMBINES["torch"] += 1
        with span("ozaki.combine"):
            return combine(hi, lo, sigma_a, sigma_b, num_splits, out_dtype,
                           slice_bits)
