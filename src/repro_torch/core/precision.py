"""Tunable-precision policy layer: pick the split count for a tolerance.

PyTorch port of :mod:`repro.core.precision`.  The split count trades
INT8 GEMM volume (``s*(s+1)/2`` products) for mantissa bits (roughly
``SLICE_BITS * s``).  Three ways to turn that knob:

* :func:`predict_splits`   — a priori, from the error model;
* :func:`measure_splits`   — empirically, by probing the actual operands;
* :class:`AdaptiveGemm`    — stateful per-call-site tuning;

plus :class:`PrecisionPolicy`, the configuration record consumed by the
offload interceptor (:mod:`repro_torch.core.intercept`).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional

import torch

from .._device import as_tensor
from .ozaki import SLICE_BITS, ozaki_matmul

__all__ = [
    "PrecisionPolicy",
    "SiteState",
    "AdaptiveGemm",
    "canonical_site",
    "predict_splits",
    "splits_for_tolerance",
    "measure_splits",
    "estimate_rel_error",
]

#: Hard ceiling on the split count: beyond this the slices cover more
#: mantissa than an f64 input carries and extra splits cannot help.
MAX_SPLITS = 14

# SPMD scope components of a structural site name ("shmap0/", "pmap1/").
_SPMD_SCOPE_RE = re.compile(r"(shmap|pmap)\d+")


def canonical_site(name: str) -> str:
    """Strip SPMD scopes from a structural site name.

    ``"shmap0/scan0/dot1" -> "scan0/dot1"``: per-site decisions are
    keyed by the canonical name, so a plan calibrated under a mesh
    applies to the single-device program and vice versa.
    """
    return "/".join(p for p in name.split("/")
                    if not _SPMD_SCOPE_RE.fullmatch(p))


@dataclasses.dataclass
class PrecisionPolicy:
    """How the interceptor treats discovered BLAS-3 sites.

    The fields and their meaning are the reference's
    (:class:`repro.core.precision.PrecisionPolicy`): ``default_splits``,
    the ``min_dim`` size gate on m, k and n, the ``accumulator``
    (``"df32"`` or ``"f64"``), ``slice_bits``, the ``backend`` spec,
    per-site ``site_splits`` and ``site_backends`` overrides (a site
    mapped to ``"dgemm"`` is demoted to native), and
    ``on_unmatched_site`` (``"warn"``, ``"raise"`` or ``"ignore"``) for
    override keys that match no site.
    """

    default_splits: int = 6
    min_dim: int = 128
    accumulator: str = "df32"
    slice_bits: int = SLICE_BITS
    backend: str = "fp64_int8"
    site_splits: Dict[str, int] = dataclasses.field(default_factory=dict)
    site_backends: Dict[str, str] = dataclasses.field(default_factory=dict)
    on_unmatched_site: str = "warn"

    @classmethod
    def from_reference(cls, d: dict) -> "PrecisionPolicy":
        """Build the policy from ``dataclasses.asdict`` of a reference one.

        The two records share their fields, so a policy written by the
        JAX package (or stored as JSON) crosses over unchanged.
        """
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown PrecisionPolicy fields {unknown}")
        kw = dict(d)
        kw["site_splits"] = dict(kw.get("site_splits", {}))
        kw["site_backends"] = dict(kw.get("site_backends", {}))
        return cls(**kw)

    @classmethod
    def from_plan(cls, plan, **overrides) -> "PrecisionPolicy":
        """Build the policy a :class:`~repro_torch.tune.PrecisionPlan`
        encodes, as the reference's ``from_plan``: its backend family,
        accumulator, slice bits and size gate, per-site split counts
        and per-site demotions to ``"dgemm"``; ``default_splits`` is the
        plan's largest count (6 for a plan of no sites).  ``overrides``
        replace fields (``on_unmatched_site="ignore"`` where the plan
        covers more sites than the function).
        """
        site_splits = {s.site: s.splits for s in plan.sites
                       if s.backend != "dgemm"}
        site_backends = {s.site: s.backend for s in plan.sites
                         if s.backend != plan.backend}
        kw = dict(
            default_splits=max(site_splits.values(), default=6),
            min_dim=plan.min_dim,
            accumulator=plan.accumulator,
            slice_bits=plan.slice_bits,
            backend=plan.backend,
            site_splits=site_splits,
            site_backends=site_backends,
        )
        kw.update(overrides)
        return cls(**kw)

    def _lookup(self, table: Dict[str, object], site: str):
        if site in table:
            return table[site]
        canon = canonical_site(site)
        if canon in table:
            return table[canon]
        for key, val in table.items():
            if canonical_site(key) == canon:
                return val
        return None

    def splits_for(self, site: str) -> int:
        got = self._lookup(self.site_splits, site)
        return self.default_splits if got is None else got

    def backend_for(self, site: str) -> str:
        """The backend spec an offloaded ``site`` executes on."""
        got = self._lookup(self.site_backends, site)
        return self.backend if got is None else got

    def unmatched_overrides(self, known_sites) -> list:
        """Override keys that match none of ``known_sites``."""
        known = set(known_sites)
        known |= {canonical_site(n) for n in known}
        return sorted(k for k in {*self.site_splits, *self.site_backends}
                      if k not in known and canonical_site(k) not in known)


def estimate_rel_error(num_splits: int, k: int,
                       slice_bits: int = SLICE_BITS) -> float:
    """A-priori bound on max |C_emul - C| / (|A| @ |B|)."""
    return 4.0 * math.sqrt(k) * 2.0 ** (-slice_bits * num_splits)


def splits_for_tolerance(target_rel: float, k: int,
                         slice_bits: int = SLICE_BITS) -> int:
    """Smallest split count whose modeled error meets ``target_rel``."""
    for s in range(1, MAX_SPLITS + 1):
        if estimate_rel_error(s, k, slice_bits) <= target_rel:
            return s
    return MAX_SPLITS


def predict_splits(a, b=None, target_rel: float = 1e-9,
                   slice_bits: int = SLICE_BITS) -> int:
    """Smallest split count whose modeled error meets ``target_rel``.

    ``K`` is read off ``a``'s last axis and ``b``'s second-to-last; a
    mismatch raises.  ``b`` may be omitted, in which case ``a`` alone
    fixes ``K``.
    """
    k = int(a.shape[-1])
    if b is not None:
        kb = int(b.shape[-2]) if b.ndim >= 2 else int(b.shape[-1])
        if kb != k:
            raise ValueError(
                f"contraction extents disagree: a has K={k} (shape "
                f"{tuple(a.shape)}), b has K={kb} (shape "
                f"{tuple(b.shape)})")
    return splits_for_tolerance(target_rel, k, slice_bits)


def measure_splits(a, b, target_rel: float, accumulator: str = "df32",
                   slice_bits: int = SLICE_BITS,
                   start: Optional[int] = None):
    """Empirical split selection against the actual operands.

    Runs the emulated GEMM with increasing split counts until its max
    relative error (vs. the native float64 product, normalized by
    ``|A| @ |B|``) meets ``target_rel``.  Returns
    ``(num_splits, achieved_rel_error)``.
    """
    a = as_tensor(a)
    b = as_tensor(b, device=a.device)
    ref_dtype = (torch.complex128 if a.is_complex() or b.is_complex()
                 else torch.float64)
    ref = torch.matmul(a.to(ref_dtype), b.to(ref_dtype))
    denom = torch.abs(torch.matmul(torch.abs(a).to(ref_dtype),
                                   torch.abs(b).to(ref_dtype)))
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    s0 = start if start is not None else max(
        1, predict_splits(a, b, target_rel, slice_bits) - 2)
    err = float("inf")
    for s in range(s0, MAX_SPLITS + 1):
        c = ozaki_matmul(a, b, num_splits=s, accumulator=accumulator,
                         out_dtype=ref_dtype, slice_bits=slice_bits)
        err = float(torch.max(torch.abs(c - ref) / denom))
        if err <= target_rel:
            return s, err
    return MAX_SPLITS, err


@dataclasses.dataclass
class SiteState:
    """Per-call-site tuning record kept by :class:`AdaptiveGemm`."""

    splits: int
    err_estimate: float
    calls: int = 0


class AdaptiveGemm:
    """Stateful emulated GEMM that tunes its split count per site.

    The first call for a given ``site`` measures the split count needed
    to hit ``target_rel`` on those operands and caches it; subsequent
    calls reuse the cached count.
    """

    def __init__(self, target_rel: float = 1e-9,
                 accumulator: str = "df32",
                 slice_bits: int = SLICE_BITS):
        self.target_rel = float(target_rel)
        self.accumulator = accumulator
        self.slice_bits = slice_bits
        self.sites: Dict[str, SiteState] = {}

    def __call__(self, a, b, site: str = "default", out_dtype=None):
        state = self.sites.get(site)
        if state is None:
            s, err = measure_splits(a, b, self.target_rel,
                                    accumulator=self.accumulator,
                                    slice_bits=self.slice_bits)
            state = SiteState(splits=s, err_estimate=err)
            self.sites[site] = state
        state.calls += 1
        return ozaki_matmul(a, b, num_splits=state.splits,
                            accumulator=self.accumulator,
                            out_dtype=out_dtype,
                            slice_bits=self.slice_bits)

    def report(self) -> str:
        lines = [f"AdaptiveGemm(target_rel={self.target_rel:.1e})"]
        for name, st in sorted(self.sites.items()):
            lines.append(f"  site {name!r}: s={st.splits} "
                         f"(err~{st.err_estimate:.2e}, {st.calls} calls)")
        return "\n".join(lines)
