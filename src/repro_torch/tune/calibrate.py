"""Calibration: an instrumented pass that measures every GEMM site.

Port of :mod:`repro.tune.calibrate`.  :class:`Calibrator` wraps a
function exactly as :func:`repro_torch.core.offload` does — the same
site names (forward and backward), the same size and dtype gates — but
routes every eligible site, a demoted one too, through a *recording*
backend.  For each site call the backend:

* returns the native product, so a calibration pass leaves the
  caller's results (a train step's update) as the native program's;
* measures the relative error of :func:`repro_torch.core.ozaki_matmul`
  at the probe split count against the product in the reference dtype,
  normalized by ``|A| @ |B|`` (the convention of
  :func:`repro_torch.core.precision.measure_splits`);
* records the operands' max-abs values.

The statistics reach the host by ``.item()``, so every site call
synchronizes with the device: calibration is an offline pass, not a
timed one.  Repeated calls and batch elements aggregate by max.

The reference picks its reference dtype by ``jax_enable_x64`` (float64
with it, float32 without).  Torch has no such mode, so
``Calibrator(..., reference_dtype=)`` names it: float64 by default (the
reference under its tests' x64); the CLI passes float32 for a float32
model, what the reference's own CLI measures against without x64.  A
probe error at or below 64 ulps of the reference dtype is that dtype's
noise and leaves the site on the a-priori curve.

:class:`CalibrationResult` carries one :class:`SiteRecord` per eligible
site, keyed by canonical name, with the solver's inputs: contraction
extent, dtype, per-step FLOPs (scan trips multiplied out), operand
max-abs exponents and the probe error quantized to two significant
digits.
"""

from __future__ import annotations

import dataclasses
from math import floor, log10
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.backends import GemmBackend
from ..core.intercept import Site, offload
from ..core.ozaki import ozaki_matmul
from ..core.precision import PrecisionPolicy, canonical_site
from .plan import dtype_name, site_set_fingerprint

__all__ = ["Calibrator", "CalibrationResult", "SiteRecord"]


def _quantize(x: float, digits: int = 2) -> float:
    """Round to ``digits`` significant decimal digits, so that ulp
    noise in a measurement cannot reach the solver's decisions."""
    if x == 0.0 or not np.isfinite(x):
        return float(x)
    scale = 10.0 ** (digits - 1 - floor(log10(abs(x))))
    return round(x * scale) / scale


@dataclasses.dataclass
class SiteRecord:
    """Calibrated statistics for one eligible GEMM site."""

    site: str            #: canonical site name (SPMD scopes stripped)
    k: int               #: contraction extent (merged)
    dtype: str           #: result dtype name
    flops: int           #: per-step FLOPs across scan trips
    probe_splits: int    #: split count the error probe ran at
    lhs_exp: Optional[int] = None   #: ceil(log2(max|A|)), None if unseen
    rhs_exp: Optional[int] = None   #: ceil(log2(max|B|))
    measured_rel: Optional[float] = None  #: probe error, 2 sig. digits
    calls: int = 0       #: backend calls recorded (diagnostic only)
    #: canonical (k-only) tile pick at the probe split count for kernel
    #: family policies, ``(block_m, block_n, block_k)``; diagnostic.
    tiles: Optional[Tuple[int, int, int]] = None


_COMPLEX_OF = {torch.float32: torch.complex64,
               torch.float64: torch.complex128}


class _CalibrationGemm(GemmBackend):
    """Recording backend: native result out, statistics to the host."""

    #: Every eligible site routes through this backend, overriding any
    #: per-site ``site_backends`` spec, demotions included.
    intercepts_all_sites = True

    def __init__(self, policy: PrecisionPolicy, probe_splits: int,
                 reference_dtype: torch.dtype):
        super().__init__("calibrate", policy)
        if reference_dtype not in _COMPLEX_OF:
            raise ValueError(f"reference_dtype must be torch.float32 or "
                             f"torch.float64, got {reference_dtype}")
        self.probe_splits = int(probe_splits)
        self.reference_dtype = reference_dtype
        self.stats: Dict[str, Dict[str, float]] = {}
        #: per-site measurement floor: ~64 ulps of the reference dtype.
        self.floors: Dict[str, float] = {}
        #: the decisions of the last call, in discovery order.
        self.last_sites: List[Site] = []

    def observe_sites(self, decisions: Dict[str, Site]) -> None:
        self.last_sites = list(decisions.values())

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        del num_splits  # the probe split count is fixed per pass
        native = torch.matmul(a, b)
        ref_dtype = self.reference_dtype
        if a.is_complex() or b.is_complex():
            ref_dtype = _COMPLEX_OF[ref_dtype]
        floor_ = 64.0 * torch.finfo(ref_dtype).eps
        self.floors[site] = max(self.floors.get(site, 0.0), floor_)
        ref = torch.matmul(a.to(ref_dtype), b.to(ref_dtype))
        emul = ozaki_matmul(a, b, num_splits=self.probe_splits,
                            accumulator=self.policy.accumulator,
                            out_dtype=ref_dtype,
                            slice_bits=self.policy.slice_bits)
        real = ref.abs().dtype
        denom = torch.matmul(a.abs().to(real), b.abs().to(real))
        denom = torch.where(denom == 0, torch.ones_like(denom), denom)
        err = float(torch.max(torch.abs(emul - ref) / denom))
        st = self.stats.setdefault(
            site, {"err": 0.0, "al": 0.0, "ar": 0.0, "calls": 0})
        st["err"] = max(st["err"], err)
        st["al"] = max(st["al"], float(a.abs().max()))
        st["ar"] = max(st["ar"], float(b.abs().max()))
        st["calls"] += 1
        return native if out_dtype is None else native.to(out_dtype)


def _exp_of(amax: float) -> int:
    if amax <= 0:
        return 0
    return int(np.ceil(np.log2(amax)))


@dataclasses.dataclass
class CalibrationResult:
    """Everything the plan solver consumes."""

    records: List[SiteRecord]
    fingerprint: str
    policy: PrecisionPolicy
    probe_splits: int
    #: raw (non-canonical) site names that were eligible, for reports
    site_names: Tuple[str, ...] = ()

    def describe(self) -> str:
        lines = [f"Calibration: {len(self.records)} eligible sites, "
                 f"probe s={self.probe_splits}, "
                 f"fingerprint {self.fingerprint}"]
        for r in sorted(self.records, key=lambda r: r.site):
            err = ("unmeasured" if r.measured_rel is None
                   else f"err~{r.measured_rel:.1e}")
            tiles = (" tiles={}x{}x{}".format(*r.tiles)
                     if r.tiles else "")
            lines.append(
                f"  {r.site}: k={r.k} {r.dtype} flops={r.flops:.3g} "
                f"exp=({r.lhs_exp},{r.rhs_exp}) {err}{tiles}")
        return "\n".join(lines)


class Calibrator:
    """Run instrumented passes over ``fn`` and collect site statistics.

    Usage::

        cal = Calibrator(train_step, policy)
        for batch in batches:
            cal.run(params, opt_state, batch)   # returns native output
        plan = solve_plan(cal.result())

    ``run`` calls ``fn`` with every eligible GEMM site instrumented;
    repeated calls aggregate by max.  The site set is fixed by the
    first call; a later call with a *different* eligible site set
    raises — one plan covers one program.  ``reference_dtype`` is the
    dtype the probe error is measured against (module docstring).
    """

    def __init__(self, fn, policy: Optional[PrecisionPolicy] = None,
                 *, probe_splits: Optional[int] = None,
                 reference_dtype: torch.dtype = torch.float64):
        self.fn = fn
        self.policy = policy or PrecisionPolicy()
        self.probe_splits = int(probe_splits
                                if probe_splits is not None
                                else self.policy.default_splits)
        self._gemm = _CalibrationGemm(self.policy, self.probe_splits,
                                      reference_dtype)
        self._wrapped = offload(fn, self.policy, backend=self._gemm)
        self._sites: Optional[List[Site]] = None
        self._fingerprint: Optional[str] = None

    def run(self, *args, **kwargs):
        """One instrumented pass; returns ``fn``'s (native) output."""
        out = self._wrapped(*args, **kwargs)
        sites = self._gemm.last_sites
        fp = site_set_fingerprint(sites)
        if self._fingerprint is None:
            self._fingerprint = fp
            self._sites = sites
        elif fp != self._fingerprint:
            raise ValueError(
                "calibration signatures disagree on the eligible "
                f"site set ({fp} vs {self._fingerprint}); "
                "calibrate one program shape per plan")
        return out

    @property
    def sites(self) -> Optional[List[Site]]:
        """Site decisions of the calibrated program (after the first
        run), for costing other split assignments against them
        (:func:`~repro_torch.tune.count_int8_gemms` with
        ``splits_for``)."""
        return self._sites

    def _probe_tiles(self, k: int, dtype: str):
        """Canonical tile pick at the probe split count (kernel family
        only)."""
        spec = self.policy.backend
        if not spec.startswith("pallas_int8"):
            return None
        from ..kernels import tile_model

        d = tile_model.select_tiles(None, k, None, self.probe_splits,
                                    dtype=dtype,
                                    fused=spec.endswith(":fused"))
        return (d.block_m, d.block_n, d.block_k)

    def result(self) -> CalibrationResult:
        """Aggregate the recorded statistics into solver inputs.

        Sites are merged by canonical name; a canonical collision
        between sites with different contraction extents or dtypes is
        ambiguous and raises.
        """
        if self._sites is None:
            raise ValueError("no calibration pass has run yet")
        by_canon: Dict[str, SiteRecord] = {}
        names = []
        for site in self._sites:
            if not site.eligible:
                continue
            names.append(site.name)
            canon = canonical_site(site.name)
            dtype = dtype_name(site.dtype)
            rec = by_canon.get(canon)
            if rec is None:
                rec = by_canon[canon] = SiteRecord(
                    site=canon, k=site.k, dtype=dtype, flops=0,
                    probe_splits=self.probe_splits,
                    tiles=self._probe_tiles(site.k, dtype))
            elif (rec.k, rec.dtype) != (site.k, dtype):
                raise ValueError(
                    f"sites {site.name!r} and an earlier one share "
                    f"the canonical name {canon!r} but disagree on "
                    f"k/dtype ({site.k}/{dtype} vs "
                    f"{rec.k}/{rec.dtype}); cannot key one plan "
                    "entry on both")
            rec.flops += site.flops
            st = self._gemm.stats.get(site.name)
            if st is not None:
                floor_ = self._gemm.floors.get(site.name, 0.0)
                if st["al"] > 0 and st["ar"] > 0 and st["err"] > floor_:
                    # A zero operand (the zero-initialized LM head at
                    # step 0) and a probe at the reference dtype's noise
                    # floor stay on the a-priori model curve.
                    rec.measured_rel = _quantize(max(
                        st["err"], rec.measured_rel or 0.0))
                rec.lhs_exp = max(_exp_of(st["al"]), rec.lhs_exp
                                  if rec.lhs_exp is not None else -(2**30))
                rec.rhs_exp = max(_exp_of(st["ar"]), rec.rhs_exp
                                  if rec.rhs_exp is not None else -(2**30))
                rec.calls += int(st["calls"])
        return CalibrationResult(
            records=sorted(by_canon.values(), key=lambda r: r.site),
            fingerprint=self._fingerprint,
            policy=self.policy,
            probe_splits=self.probe_splits,
            site_names=tuple(names))
