"""Cost-optimal per-site split solving.

Port of :mod:`repro.tune.solve`.  :func:`solve_plan` turns a
:class:`~repro_torch.tune.calibrate.CalibrationResult` into a
:class:`~repro_torch.tune.plan.PrecisionPlan`: given an end-to-end
relative-error budget, it assigns each site the split count that
minimizes the modelled emulation cost

    cost(s_i) = split_cost(s_i) * flops_i

subject to the composed (first-order additive) error bound
``sum_i err_i(s_i) <= budget``.  ``split_cost`` is an argument: by
default the port's :func:`repro_torch.kernels.tile_model.split_cost`,
priced on the H100's rates, where each added split costs more in
traffic than on the reference's TPU; pass the reference's curve to
reproduce the reference's plan.

Each site's error curve is the a-priori model ``4 sqrt(k) 2**(-w s)``
(:func:`repro_torch.core.precision.estimate_rel_error`), anchored at the
calibrated probe error where one was measured and extrapolated by
``slice_bits`` bits per split, never above the model.  A site measured
``demote_ratio`` times worse than the model at the probe count is
demoted to ``dgemm``.  The assignment is greedy marginal analysis:
everything starts at one split, and each round grants one split to the
site with the best error drop per unit of added cost (ties to the first
name) until the bound meets the budget or every site is at the ceiling.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch

from ..core.backends import _SPLITS_RE
from ..core.intercept import Site
from ..core.ozaki import num_pair_gemms
from ..core.precision import MAX_SPLITS, estimate_rel_error
from ..kernels.tile_model import select_tiles, split_cost
from .calibrate import CalibrationResult, SiteRecord
from .plan import PlanSite, PrecisionPlan

__all__ = ["solve_plan", "default_budget", "count_int8_gemms",
           "unpinned_family"]


def unpinned_family(spec: str) -> str:
    """Strip a pinned split count from a backend spec
    (``"fp64_int8_6" -> "fp64_int8"``): a plan owns the per-site split
    counts, and a pinned spec would override them."""
    head, sep, arg = spec.partition(":")
    m = _SPLITS_RE.fullmatch(head)
    if m:
        head = m.group("family")
    return head + (sep + arg if sep else "")


def _plan_tiles(family: str, k: int, dtype: str, splits: int):
    """Canonical tile pick recorded in a PlanSite (kernel family only),
    from ``(k, dtype, splits)`` alone."""
    if not family.startswith("pallas_int8"):
        return None
    d = select_tiles(None, k, None, splits, dtype=dtype,
                     fused=family.endswith(":fused"))
    return (d.block_m, d.block_n, d.block_k)


def _eps(name: str) -> float:
    return float(torch.finfo(getattr(torch, name)).eps)


def default_budget(records: Iterable[SiteRecord],
                   scale: float = 32.0) -> float:
    """``scale`` times the machine epsilon of the loosest participating
    dtype (~3.8e-6 for a float32 model, ~7.1e-15 for float64)."""
    records = list(records)
    eps = (max(_eps(r.dtype) for r in records) if records
           else _eps("float32"))
    return float(scale * eps)


def _site_err(rec: SiteRecord, splits: int, slice_bits: int) -> float:
    """Calibrated error curve: measured probe anchored, else a-priori."""
    model = estimate_rel_error(splits, rec.k, slice_bits)
    if rec.measured_rel is None:
        return model
    anchored = max(rec.measured_rel, 1e-30) * \
        2.0 ** (slice_bits * (rec.probe_splits - splits))
    return min(model, anchored)


def solve_plan(result: CalibrationResult, *,
               budget: Optional[float] = None,
               demote_ratio: float = 100.0,
               max_splits: int = MAX_SPLITS,
               cost=split_cost) -> PrecisionPlan:
    """Solve the per-site split assignment and build the plan.

    Args:
      result: calibration output (site records + fingerprint).
      budget: end-to-end relative-error budget; default
        :func:`default_budget` of the calibrated dtypes.
      demote_ratio: a site measured worse than ``demote_ratio`` times
        its a-priori model at the probe split count is demoted.
      max_splits: per-site ceiling; an unreachable budget still yields a
        plan, with ``budget_met=False``.
      cost: the cost curve ``cost(s)`` in pair-GEMM units.
    """
    policy = result.policy
    slice_bits = policy.slice_bits
    records = list(result.records)
    if budget is None:
        budget = default_budget(records)
    budget = float(budget)
    if budget <= 0:
        raise ValueError(f"budget must be positive, got {budget}")

    family = unpinned_family(policy.backend)
    demoted: Dict[str, SiteRecord] = {}
    tunable: Dict[str, SiteRecord] = {}
    for rec in records:
        model = estimate_rel_error(rec.probe_splits, rec.k, slice_bits)
        if (rec.measured_rel is not None
                and rec.measured_rel > demote_ratio * model):
            demoted[rec.site] = rec
        else:
            tunable[rec.site] = rec

    splits = {name: 1 for name in tunable}
    errs = {name: _site_err(rec, 1, slice_bits)
            for name, rec in tunable.items()}
    total = math.fsum(errs.values())
    while total > budget:
        best_name, best_gain = None, -1.0
        for name, rec in sorted(tunable.items()):
            s = splits[name]
            if s >= max_splits:
                continue
            drop = errs[name] - _site_err(rec, s + 1, slice_bits)
            gain = drop / ((cost(s + 1) - cost(s)) * max(rec.flops, 1))
            if gain > best_gain:
                best_name, best_gain = name, gain
        if best_name is None:
            break  # every tunable site is at the ceiling
        splits[best_name] += 1
        new_err = _site_err(tunable[best_name], splits[best_name],
                            slice_bits)
        total += new_err - errs[best_name]
        errs[best_name] = new_err

    sites = []
    for name, rec in tunable.items():
        sites.append(PlanSite(
            site=name, k=rec.k, dtype=rec.dtype, flops=rec.flops,
            lhs_exp=rec.lhs_exp or 0, rhs_exp=rec.rhs_exp or 0,
            splits=splits[name], backend=family,
            tiles=_plan_tiles(family, rec.k, rec.dtype, splits[name])))
    for name, rec in demoted.items():
        sites.append(PlanSite(
            site=name, k=rec.k, dtype=rec.dtype, flops=rec.flops,
            lhs_exp=rec.lhs_exp or 0, rhs_exp=rec.rhs_exp or 0,
            splits=0, backend="dgemm"))

    return PrecisionPlan(
        fingerprint=result.fingerprint,
        backend=family,
        accumulator=policy.accumulator,
        slice_bits=slice_bits,
        min_dim=policy.min_dim,
        budget=budget,
        budget_met=total <= budget,
        probe_splits=result.probe_splits,
        sites=tuple(sites))


def count_int8_gemms(sites: Iterable[Site], splits_for=None) -> int:
    """Per-step INT8 GEMM count of a site-decision list.

    Sums, over offloaded sites, the Ozaki pair count ``s(s+1)/2`` times
    the batch extent, the trip multiplicity (enclosing ``scan``
    lengths), and 4 for complex sites (the four-real-GEMM
    decomposition).  ``splits_for(site) -> int | None`` overrides each
    site's recorded split count (``None``: the site runs native and
    counts 0).
    """
    total = 0
    for site in sites:
        if not site.offloaded:
            continue
        s = site.splits if splits_for is None else splits_for(site)
        if s is None:
            continue
        cplx = 4 if site.dtype.is_complex else 1
        total += (num_pair_gemms(s) * max(site.batch, 1)
                  * site.mult * cplx)
    return total
