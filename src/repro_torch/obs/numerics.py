"""NumericsMonitor: runtime drift detection for tuned precision plans.

Port of :mod:`repro.obs.numerics`.  A precision plan is calibrated
*offline* (:mod:`repro_torch.tune`), typically at step 0 — but the
paper's own observation is that emulation accuracy depends on the
operator's values, and values move as training moves.
:class:`~repro_torch.tune.PlanStaleError` catches *structural* drift
(the program's site set changed); this module is the runtime
complement for *numerical* drift: every Nth train step the monitor
re-runs the program with an instrumented pass that measures the
**realized** relative error of a probe site — the eligible offloaded
site with the largest per-step FLOP volume, i.e. the site whose error
the composed budget is most exposed to — at its *deployed* split count,
against a float64 matmul.  If the realized error of that single site
exceeds the plan's whole end-to-end budget, the composed bound is
certainly violated and a structured warning fires (plus a ``numerics``
JSONL event and a registry gauge), telling the operator to re-tune.

The instrumented pass reuses the offload/calibration machinery: a
recording :class:`~repro_torch.core.GemmBackend`
(``intercepts_all_sites``, ``observe_sites``, as the tuner's recorder)
that returns the *native* product — a monitor check never perturbs
anything — and keeps the probe site's error on the device; the check
reads it back with one ``.item()`` after the pass.  The error is the
core :func:`repro_torch.core.ozaki_matmul` at the policy's splits,
accumulator and ``slice_bits`` against the float64 product, normalized
by ``|A| @ |B|``.  An eager program's sites are only known once it has
run, so the first check finds the probe site with a native
``site_report`` pass first.  Under a mesh (a step inside
:func:`repro_torch.core.spmd_scope`) the realized error is MAX-shared
over every rank of the mesh when the check reads it, so every rank
reports the same global value, as the reference's ``pmax`` makes it:
every rank must run the check.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import torch

from ..core.backends import GemmBackend
from ..core.intercept import Site, offload, spmd_mesh
from ..core.ozaki import ozaki_matmul
from ..core.precision import PrecisionPolicy
from .log import get_logger

__all__ = ["NumericsMonitor", "NumericsReport"]


@dataclasses.dataclass
class NumericsReport:
    """One drift check: the probe site's realized error vs the budget."""

    step: int
    site: str                  #: probe site (structural name)
    splits: int                #: deployed split count it ran at
    realized_rel: float        #: measured max relative error
    budget: float              #: end-to-end budget it is held against
    drift: bool                #: realized_rel > budget


class _ProbeGemm(GemmBackend):
    """Recording backend: native result out, probe-site error kept on
    the device until the check reads it."""

    supports_vjp = False
    intercepts_all_sites = True

    def __init__(self, policy: PrecisionPolicy):
        super().__init__("numerics_probe", policy)
        self._meta: Dict[str, Site] = {}
        self.probe_site: Optional[str] = None
        self._lock = threading.Lock()
        self._err: Optional[torch.Tensor] = None
        self._mesh = None

    def observe_sites(self, decisions: Dict[str, Site]) -> None:
        self._meta.update(decisions)
        offloaded = [s for s in decisions.values() if s.offloaded]
        if offloaded and self.probe_site is None:
            # Deterministic probe choice: the costliest offloaded site
            # (most FLOPs per step), name as the tie-break.
            self.probe_site = max(offloaded,
                                  key=lambda s: (s.flops, s.name)).name

    def reset(self) -> None:
        with self._lock:
            self._err = None
            self._mesh = None

    def realized(self) -> Optional[float]:
        """The pass's worst error over the mesh it ran under (one read of
        the device), or None if the probe site did not run."""
        with self._lock:
            err, mesh = self._err, self._mesh
        if err is None:
            return None
        if mesh is not None:
            err = mesh.all_max(err.clone().reshape(1))[0]
        return float(err.item())

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        del num_splits  # the deployed (plan) split count is measured
        native = torch.matmul(a, b)
        if site == self.probe_site:
            cplx = a.is_complex() or b.is_complex()
            ref_dtype = torch.complex128 if cplx else torch.float64
            ref = torch.matmul(a.to(ref_dtype), b.to(ref_dtype))
            emul = ozaki_matmul(
                a, b, num_splits=self.policy.splits_for(site),
                accumulator=self.policy.accumulator, out_dtype=ref_dtype,
                slice_bits=self.policy.slice_bits)
            real = ref.abs().dtype
            denom = torch.matmul(a.abs().to(real), b.abs().to(real))
            denom = torch.where(denom == 0, torch.ones_like(denom), denom)
            err = torch.max(torch.abs(emul - ref) / denom)
            mesh = spmd_mesh()
            with self._lock:
                self._err = (err if self._err is None
                             else torch.maximum(self._err, err))
                if mesh is not None:
                    self._mesh = mesh
        return native if out_dtype is None else native.to(out_dtype)


class NumericsMonitor:
    """Sample a training program every Nth step for realized GEMM error.

    Args:
      fn: the program to probe — the exact train step (or loss) the
        run executes, *unwrapped* (the monitor builds its own
        instrumented offload around it).
      plan: the active :class:`repro_torch.tune.PrecisionPlan`;
        supplies the per-site split counts and the error budget.
        Applied in ignore-unmatched mode so the monitor also works on
        a site subset (e.g. the forward-only loss).
      policy: alternative to ``plan`` — the active
        :class:`~repro_torch.core.PrecisionPolicy` (a ``--backend`` run
        with uniform splits); the budget then defaults to 32 ulps of
        the probed dtype unless given.
      budget: override the end-to-end relative-error budget.
      every: check period in steps (``maybe_check``); 0 disables.
      registry/sink/log: optional telemetry destinations — a
        ``numerics_realized_rel`` gauge, a ``numerics`` JSONL event
        per check, and a structured WARNING on drift.
    """

    def __init__(self, fn, *, plan=None,
                 policy: Optional[PrecisionPolicy] = None,
                 budget: Optional[float] = None, every: int = 25,
                 registry=None, sink=None, log=None):
        if plan is None and policy is None:
            raise ValueError("NumericsMonitor needs a plan or a policy")
        if policy is None:
            policy = PrecisionPolicy.from_plan(
                plan, on_unmatched_site="ignore")
        self.plan = plan
        self.policy = policy
        self.every = int(every)
        self._budget = budget if budget is None else float(budget)
        self.registry = registry
        self.sink = sink
        self.log = log or get_logger("numerics")
        self._probe = _ProbeGemm(policy)
        self._wrapped = offload(fn, policy, backend=self._probe)
        self.last_report: Optional[NumericsReport] = None

    def _resolve_budget(self) -> float:
        if self._budget is not None:
            return self._budget
        if self.plan is not None:
            return float(self.plan.budget)
        name = self._probe.probe_site
        meta = self._probe._meta.get(name) if name else None
        dtype = meta.dtype if meta is not None else torch.float32
        return 32.0 * float(torch.finfo(dtype.to_real()).eps)

    def maybe_check(self, step: int, *args,
                    **kwargs) -> Optional[NumericsReport]:
        """Run :meth:`check` when ``step`` lands on the period."""
        if self.every <= 0 or step % self.every:
            return None
        return self.check(step, *args, **kwargs)

    def check(self, step: int, *args, **kwargs) -> NumericsReport:
        """One instrumented pass; returns (and records) the report.

        The pass computes ``fn`` natively (outputs are discarded — the
        caller's arguments, a train step's parameters and optimizer
        state, are read and never written) while the probe site
        additionally runs the deployed emulation against a float64
        reference.
        """
        if self._probe.probe_site is None:
            self._probe.observe_sites(
                {s.name: s for s in self._wrapped.sites(*args, **kwargs)})
        self._probe.reset()
        self._wrapped(*args, **kwargs)
        realized = self._probe.realized()
        site = self._probe.probe_site or "<none>"
        splits = (self.policy.splits_for(site)
                  if self._probe.probe_site else 0)
        budget = self._resolve_budget()
        report = NumericsReport(
            step=int(step), site=site, splits=splits,
            realized_rel=float(realized or 0.0), budget=budget,
            drift=bool(realized is not None and realized > budget))
        self.last_report = report
        if self.registry is not None:
            self.registry.gauge("numerics_realized_rel",
                                site=site).set(report.realized_rel)
            if report.drift:
                self.registry.counter("numerics_drift",
                                      site=site).inc()
        if self.sink is not None:
            self.sink.emit("numerics", step=report.step, site=site,
                           splits=splits,
                           realized_rel=report.realized_rel,
                           budget=budget, drift=report.drift)
        if report.drift:
            self.log.warning(
                f"numerics drift at step {step}: site {site} realized "
                f"rel error {report.realized_rel:.3e} exceeds the "
                f"plan budget {budget:.3e} at s={splits} — the "
                "operands have moved since calibration; re-tune "
                "(launch/train.py --tune / python -m repro_torch.tune)")
        else:
            self.log.debug(
                f"numerics ok at step {step}: site {site} realized "
                f"{report.realized_rel:.3e} <= budget {budget:.3e}")
        return report
