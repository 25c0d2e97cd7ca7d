"""repro_torch.tune — precision-plan tuning: calibrate, solve, persist.

Port of :mod:`repro.tune`.  Emulation precision is a per-operator
knob; this package sets it offline and keeps the setting as an
artifact:

* :mod:`repro_torch.tune.calibrate` — :class:`Calibrator`, the
  instrumented pass that records per-site operand statistics and the
  measured probe error;
* :mod:`repro_torch.tune.solve` — :func:`solve_plan`, the cost-optimal
  split assignment under a composed error budget, and
  :func:`count_int8_gemms`, the cost metric;
* :mod:`repro_torch.tune.plan` — :class:`PrecisionPlan`, the versioned,
  fingerprinted JSON artifact (the reference's schema) consumed by
  :meth:`repro_torch.core.PrecisionPolicy.from_plan`,
  ``offload(fn, plan=...)``, ``launch/train.py --plan`` and
  ``Engine(plan=...)``;
* :mod:`repro_torch.tune.cli` — the ``python -m repro_torch.tune`` flow
  (``launch/train.py --tune`` runs the same calibrate-and-solve
  inline).
"""

from .calibrate import CalibrationResult, Calibrator, SiteRecord
from .plan import (PLAN_VERSION, PlanError, PlanSite, PlanStaleError,
                   PrecisionPlan, site_set_fingerprint)
from .solve import (count_int8_gemms, default_budget, solve_plan,
                    unpinned_family)

__all__ = [
    "PLAN_VERSION",
    "CalibrationResult",
    "Calibrator",
    "PlanError",
    "PlanSite",
    "PlanStaleError",
    "PrecisionPlan",
    "SiteRecord",
    "count_int8_gemms",
    "default_budget",
    "site_set_fingerprint",
    "solve_plan",
    "unpinned_family",
]
