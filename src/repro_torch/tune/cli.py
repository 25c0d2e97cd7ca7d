"""``python -m repro_torch.tune`` — calibrate an LM workload, solve, save.

Port of :mod:`repro.tune.cli`, with its flags and ``--device`` as the
trainer has it::

    PYTHONPATH=src python -m repro_torch.tune --arch tiny --device cpu \\
        --batches 2 --plan runs/plans/torch_tiny.json

calibrates the chosen target program (``--target step``: one full train
step, forward + backward + AdamW, the sites ``launch/train.py``
offloads; ``--target loss``: the forward loss only), solves the
cost-optimal per-site split assignment for the error budget, and writes
the plan JSON and its tile table.  The model's parameters are the
reference's for the same ``--seed`` (:mod:`repro_torch.models.prng`),
so both packages calibrate the same program.  The probe error is
measured against the model's dtype (float32 for a float32 model), what
the reference's CLI measures against without x64.

Consume the plan with ``launch/train.py --plan`` (training) and
``Engine(plan=...)`` (serving); ``launch/train.py --tune N --plan path``
runs the same calibrate-and-solve flow inline.  ``--mesh`` is not
ported (ROADMAP item 9).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from .._device import resolve_device
from .._log import get_logger
from ..configs import get_config
from ..core import PrecisionPolicy, get_backend
from ..models import Model
from ..train import AdamW, SyntheticText
from .calibrate import Calibrator
from .plan import write_tiles_table
from .solve import count_int8_gemms, solve_plan, unpinned_family

__all__ = ["main", "tune_policy", "report_plan", "log_report",
           "reference_dtype"]

log = get_logger("tune")


def tune_policy(backend_spec: str, min_dim: int) -> PrecisionPolicy:
    """The calibration policy for a requested backend spec.

    The family is unpinned (the plan owns per-site splits); a pinned
    spec's count (``pallas_int8_6``) becomes the probe/default split
    count, so ``--backend fp64_int8_4`` means "probe at s=4".
    """
    pinned = getattr(get_backend(backend_spec), "pinned_splits", None)
    return PrecisionPolicy(
        backend=unpinned_family(backend_spec), min_dim=min_dim,
        **({"default_splits": pinned} if pinned else {}))


def reference_dtype(model_dtype: str) -> torch.dtype:
    """The dtype the CLI calibrates against: float64 for a float64
    model, else float32 (the reference's CLI without x64)."""
    return torch.float64 if model_dtype == "float64" else torch.float32


def report_plan(plan, sites) -> str:
    """Human-readable tuned-vs-uniform cost summary.

    ``sites`` is the calibration pass's site list, offloaded under the
    uniform probe policy: its splits give the uniform count, the plan's
    assignment (demotions contribute nothing) the tuned one.
    """
    policy = PrecisionPolicy.from_plan(plan, on_unmatched_site="ignore")

    def tuned_splits(site):
        if policy.backend_for(site.name) == "dgemm":
            return None
        return policy.splits_for(site.name)

    n_tuned = count_int8_gemms(sites, splits_for=tuned_splits)
    n_uniform = count_int8_gemms(sites)
    lines = [plan.describe(),
             f"INT8 GEMMs per step: tuned={n_tuned} vs "
             f"uniform={n_uniform} "
             f"(saved {n_uniform - n_tuned})"]
    if not plan.sites:
        lines.append("WARNING: no eligible GEMM sites — every "
                     "matmul fell under the size/dtype gate "
                     "(shapes vs min_dim?); the plan tunes nothing")
    if not plan.budget_met:
        lines.append("WARNING: budget unreachable even at the "
                     "split ceiling; plan uses max splits")
    return "\n".join(lines)


def log_report(logger, report: str) -> None:
    """Render a :func:`report_plan` string line by line through a
    logger (WARNING lines at warning level)."""
    for line in report.splitlines():
        if line.startswith("WARNING: "):
            logger.warning(line[len("WARNING: "):])
        else:
            logger.info(line)


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune",
                                 description=__doc__)
    ap.add_argument("--arch", default="tiny",
                    help="registered LMConfig preset name")
    ap.add_argument("--target", choices=("step", "loss"),
                    default="step",
                    help="program to calibrate: the full train step "
                         "or the forward loss")
    ap.add_argument("--batches", type=int, default=1,
                    help="calibration passes (distinct data batches)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="fp64_int8",
                    help="backend family; a pinned count sets the "
                         "probe splits")
    ap.add_argument("--min-dim", type=int, default=128)
    ap.add_argument("--budget", type=float, default=0.0,
                    help="end-to-end relative error budget; 0 = "
                         "derive from the model dtype")
    ap.add_argument("--mesh", default="",
                    help="data-parallel calibration (not ported yet: "
                         "ROADMAP item 9)")
    ap.add_argument("--plan", required=True,
                    help="output path for the plan JSON")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = _parse(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported to repro_torch yet (ROADMAP item 9)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = Model(cfg, device=dev, seed=args.seed)
    opt = AdamW(lr=args.lr)
    data = SyntheticText(cfg.vocab_size, args.seq_len,
                         args.global_batch, seed=args.seed)
    params = model.params

    if args.target == "step":
        from ..launch.train import build_train_step

        fn = build_train_step(model, opt)
        opt_state = opt.init(params)

        def call_args(batch):
            return (params, opt_state, batch)
    else:
        fn = model.loss

        def call_args(batch):
            return (params, batch)

    policy = tune_policy(args.backend, args.min_dim)
    cal = Calibrator(fn, policy, reference_dtype=reference_dtype(cfg.dtype))
    for i in range(max(args.batches, 1)):
        cal.run(*call_args(torch.as_tensor(data.batch(i), device=dev)))
    result = cal.result()
    plan = solve_plan(result, budget=args.budget or None)
    path = plan.save(args.plan)
    tiles_path = write_tiles_table(plan, path)
    report = report_plan(plan, cal.sites)
    log_report(log, report)
    log.info(f"plan written to {path} (tile decisions: {tiles_path})")
    return report.splitlines()
