"""PrecisionPlan: the persistable per-site tuning artifact.

Port of :mod:`repro.tune.plan`, with the reference's JSON schema and
fingerprint byte for byte, so a plan written by either package loads
in the other.  A plan is the output of ``calibrate -> solve``
(:mod:`repro_torch.tune.calibrate`, :mod:`repro_torch.tune.solve`):
one record per eligible GEMM site with its solved split count and
backend, plus the policy-level numerics (backend family, accumulator,
slice bits, size gate) that
:meth:`repro_torch.core.PrecisionPolicy.from_plan` rebuilds the
execution configuration from.

* The **site-set fingerprint** hashes the canonical site set: SPMD
  scopes stripped from names, and only each site's contraction extent
  ``k`` and dtype name (numpy's names: ``float32``, ``complex128``),
  never its free extents, so a plan survives batch-size changes.
* :meth:`PrecisionPlan.validate_sites` recomputes the fingerprint from
  a fresh site list and raises :class:`PlanStaleError` naming the
  sites that appeared or disappeared.

Serialization is deterministic (sorted keys, sorted sites, integers and
short strings), so two calibrations of one configuration write the
same bytes.  ``tiles`` records the port's own tile pick
(:func:`repro_torch.kernels.tile_model.select_tiles`): only its
``block_k`` is the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Tuple

import torch

from ..core.precision import canonical_site

__all__ = [
    "PLAN_VERSION",
    "PlanError",
    "PlanStaleError",
    "PlanSite",
    "PrecisionPlan",
    "dtype_name",
    "site_set_fingerprint",
    "tiles_table",
    "write_tiles_table",
]

#: Schema version of the JSON artifact; bump on breaking layout change.
PLAN_VERSION = 1


class PlanError(RuntimeError):
    """A plan file is malformed, missing, or from an unknown version."""


class PlanStaleError(PlanError):
    """The traced site set no longer matches the plan's fingerprint."""


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (``torch.float32`` -> ``float32``);
    a name given as a string is returned as it is."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def site_set_fingerprint(sites) -> str:
    """Fingerprint of the *eligible* site set of a function.

    ``sites`` are :class:`repro_torch.core.Site` records (from
    ``offload(...).sites(...)``/``site_report``) or :class:`PlanSite`
    entries.  Only sites that pass the dtype/size gates count — a
    plan-demoted site is still eligible, so demotion never changes the
    fingerprint — and each contributes its canonical name, contraction
    extent and dtype name.
    """
    entries = set()
    for s in sites:
        if not getattr(s, "eligible", True):
            continue
        name = canonical_site(getattr(s, "name", None) or s.site)
        entries.add(f"{name}|k={int(s.k)}|{dtype_name(s.dtype)}")
    digest = hashlib.sha256("\n".join(sorted(entries)).encode()).hexdigest()
    return f"sha256:{digest[:16]}"


@dataclasses.dataclass(frozen=True)
class PlanSite:
    """One solved site: the tuning decision plus its solver inputs.

    ``flops`` is the per-step FLOP volume (scan trips multiplied out);
    ``lhs_exp``/``rhs_exp`` the calibrated operand max-abs exponents
    ``ceil(log2(max|X|))``; ``backend == "dgemm"`` demotes the site to
    native execution.  ``tiles`` is the tile model's canonical pick
    ``(block_m, block_n, block_k)`` for kernel-family sites (``None``
    otherwise), from ``(k, dtype, splits)`` only.
    """

    site: str
    k: int
    dtype: str
    flops: int
    lhs_exp: int
    rhs_exp: int
    splits: int
    backend: str
    tiles: Tuple[int, int, int] | None = None

    #: ``site_set_fingerprint`` treats every PlanSite as eligible.
    eligible = True

    def __post_init__(self):
        if self.tiles is not None:
            object.__setattr__(self, "tiles", tuple(self.tiles))


@dataclasses.dataclass
class PrecisionPlan:
    """The versioned per-site precision configuration artifact."""

    fingerprint: str
    backend: str
    accumulator: str
    slice_bits: int
    min_dim: int
    budget: float
    budget_met: bool
    probe_splits: int
    sites: Tuple[PlanSite, ...]
    version: int = PLAN_VERSION

    def __post_init__(self):
        self.sites = tuple(sorted(self.sites, key=lambda s: s.site))

    # -- derived views ------------------------------------------------

    def site_splits(self) -> dict:
        """Canonical-site -> split-count map (demoted sites excluded)."""
        return {s.site: s.splits for s in self.sites
                if s.backend != "dgemm"}

    def demoted_sites(self) -> list:
        return sorted(s.site for s in self.sites if s.backend == "dgemm")

    def describe(self) -> str:
        lines = [f"PrecisionPlan {self.fingerprint} "
                 f"(v{self.version}, backend={self.backend}, "
                 f"budget={self.budget:.2e}"
                 f"{'' if self.budget_met else ' NOT MET'})"]
        for s in self.sites:
            action = ("dgemm (demoted)" if s.backend == "dgemm"
                      else f"s={s.splits}")
            if s.tiles:
                action += " tiles={}x{}x{}".format(*s.tiles)
            lines.append(f"  {s.site}: k={s.k} {s.dtype} "
                         f"flops={s.flops:.3g} -> {action}")
        return "\n".join(lines)

    # -- staleness ----------------------------------------------------

    def validate_sites(self, sites) -> None:
        """Raise :class:`PlanStaleError` if ``sites`` drifted.

        ``sites`` is a fresh site list; the comparison is on the
        canonical fingerprint, and the error names the site entries
        that appeared or disappeared.
        """
        current = site_set_fingerprint(sites)
        if current == self.fingerprint:
            return
        planned = {f"{s.site}(k={s.k},{s.dtype})" for s in self.sites}
        traced = {f"{canonical_site(s.name)}(k={s.k},"
                  f"{dtype_name(s.dtype)})"
                  for s in sites if getattr(s, "eligible", True)}
        raise PlanStaleError(
            f"plan fingerprint {self.fingerprint} does not match the "
            f"traced site set ({current}): the program changed since "
            f"calibration. Sites only in plan: "
            f"{sorted(planned - traced) or '[]'}; only in trace: "
            f"{sorted(traced - planned) or '[]'}. Re-run calibration "
            "(launch/train.py --tune / python -m repro_torch.tune) to "
            "refresh the plan.")

    # -- (de)serialization --------------------------------------------

    def to_json(self) -> str:
        """Deterministic JSON: byte-identical for identical plans."""
        doc = {
            "version": self.version,
            "fingerprint": self.fingerprint,
            "backend": self.backend,
            "accumulator": self.accumulator,
            "slice_bits": self.slice_bits,
            "min_dim": self.min_dim,
            "budget": self.budget,
            "budget_met": self.budget_met,
            "probe_splits": self.probe_splits,
            "sites": [dataclasses.asdict(s) for s in self.sites],
        }
        return json.dumps(doc, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "PrecisionPlan":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise PlanError(f"plan is not valid JSON: {e}") from None
        if not isinstance(doc, dict):
            raise PlanError(f"plan must be a JSON object, got "
                            f"{type(doc).__name__}")
        version = doc.get("version")
        if version != PLAN_VERSION:
            raise PlanError(
                f"plan version {version!r} is not supported (this "
                f"build reads version {PLAN_VERSION}); re-run "
                "calibration to regenerate it")
        required = ["fingerprint", "backend", "accumulator",
                    "slice_bits", "min_dim", "budget", "budget_met",
                    "probe_splits", "sites"]
        missing = [kk for kk in required if kk not in doc]
        if missing:
            raise PlanError(f"plan is missing required keys: {missing}")
        try:
            sites = tuple(PlanSite(**s) for s in doc["sites"])
        except TypeError as e:
            raise PlanError(f"malformed plan site entry: {e}") from None
        return cls(fingerprint=doc["fingerprint"],
                   backend=doc["backend"],
                   accumulator=doc["accumulator"],
                   slice_bits=int(doc["slice_bits"]),
                   min_dim=int(doc["min_dim"]),
                   budget=float(doc["budget"]),
                   budget_met=bool(doc["budget_met"]),
                   probe_splits=int(doc["probe_splits"]),
                   sites=sites,
                   version=int(version))

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())
        return path

    @classmethod
    def load(cls, path) -> "PrecisionPlan":
        path = Path(path)
        if not path.exists():
            raise PlanError(f"no precision plan at {path}")
        return cls.from_json(path.read_text())


def tiles_table(plan: PrecisionPlan) -> dict:
    """Tile-model decision table for a plan's kernel-family sites.

    One row per site that carries a tile pick, with the figures behind
    it recomputed from the solver's canonical inputs: the reference's
    keys, the port's figures on the H100 (``vmem_bytes`` one CTA's
    shared memory, ``mxu_cycles_step`` the MMA instructions one CTA
    issues per (pair, k-tile) step, ``hbm_bytes_step`` the bytes that
    step streams; :class:`repro_torch.kernels.tile_model.TileDecision`).
    """
    from ..kernels import tile_model

    rows = []
    for s in plan.sites:
        if not s.tiles or s.splits < 1:
            continue
        fused = s.backend.endswith(":fused")
        d = tile_model.select_tiles(None, s.k, None, s.splits,
                                    dtype=s.dtype, fused=fused)
        rows.append({
            "site": s.site, "k": s.k, "dtype": s.dtype,
            "backend": s.backend, "splits": s.splits,
            "tiles": list(s.tiles), "pairs": d.pairs,
            "schedule": d.schedule, "fused": fused,
            "vmem_bytes": d.vmem_bytes,
            "mxu_cycles_step": d.mxu_cycles_step,
            "hbm_bytes_step": d.hbm_bytes_step,
        })
    return {"fingerprint": plan.fingerprint, "backend": plan.backend,
            "sites": rows}


def write_tiles_table(plan: PrecisionPlan, plan_path) -> Path:
    """Write the tile-decision table next to the plan JSON
    (``tiny.json`` gets ``tiny.tiles.json``)."""
    path = Path(plan_path)
    path = path.with_name(path.stem + ".tiles.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(tiles_table(plan), indent=2,
                               sort_keys=True) + "\n")
    return path
