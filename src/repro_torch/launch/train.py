"""Training entry point: the LM step loop, optionally fully emulated.

Port of :mod:`repro.launch.train`.  ``main(argv)`` trains the
configured LM on the deterministic synthetic stream up to ``--steps``
*global* steps, checkpointing as it goes and resuming from the newest
checkpoint in ``--ckpt-dir``: kill it and re-invoke it with the same
arguments and it continues bit-exactly.  It runs on the card unless
the caller passes ``device="cpu"`` (or ``--device cpu``).

``--backend`` is where this loop meets the paper: the *entire* train
step (loss forward, backward, AdamW update) is wrapped in the automatic
offload (:func:`repro_torch.core.offload`) with a
:class:`~repro_torch.core.PrecisionPolicy` pointing at that registry
spec, so ``--backend pallas_int8_6`` runs every projection, MLP and LM
head GEMM of the forward *and* backward pass through the Ozaki INT8
emulation (on the card, kernel K1), each backward product a site of its
own (``scan1/...``, ``dot1``, ``dot2``), while sub-``--min-dim``
contractions (attention, k = head_dim) stay native.  The discovered
sites are printed once per run, with the INT8 GEMMs a step issues.

Not ported yet; these raise ``NotImplementedError`` naming their
ROADMAP item: ``--mesh``, ``--grad-reduce`` other than ``bucketed`` and
``--bucket-mb`` (item 9, with ``build_sharded_train_step``); ``--tune``,
``--plan`` and ``--allow-plan-change`` (item 7); and telemetry
(item 10): ``--metrics-dir`` other than ``none``, ``--metrics-port``
and ``--metrics-push-url``.  Telemetry is therefore off by default here,
where the reference turns it on, and ``--numerics-every`` has nothing
to report into.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import torch

from .._device import resolve_device
from ..configs import get_config
from ..core import PrecisionPolicy, get_backend, offload
from ..models import Model
from ..train import AdamW, SyntheticText, checkpoint
from ..tune import count_int8_gemms

__all__ = ["main", "build_train_step", "loss_and_grads"]

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40}


def _log(name: str, msg: str) -> None:
    """``[name] msg`` on stderr, as the reference's loggers render INFO
    (``REPRO_LOG_LEVEL`` above INFO silences it)."""
    level = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
    if _LEVELS.get(level, 20) <= 20:
        print(f"[{name}] {msg}", file=sys.stderr, flush=True)


def build_train_step(model: Model, opt: AdamW):
    """The ``(params, opt_state, batch) -> (params, opt_state, loss)``
    step.  Kept separate so tests and benchmarks can wrap the exact
    function the trainer runs.

    The gradient is taken inside the step (``torch.autograd.grad`` on
    leaves made from ``params``), so under :func:`offload` every
    backward GEMM is a site of its own.  The update returns new tensors
    and leaves its arguments as they were.
    """

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch)
        params, opt_state = opt.update(grads, params, opt_state)
        return params, opt_state, loss

    return train_step


def loss_and_grads(model: Model, params, batch):
    """``model.loss(params, batch)`` and its gradient, a tree like
    ``params``, taken with ``torch.autograd.grad`` on leaves made from
    ``params`` (so a caller under :func:`offload` sees every backward
    GEMM as a site)."""
    leaves = [p.detach().requires_grad_()
              for p in checkpoint.tree_flatten(params)]
    with torch.enable_grad():
        loss = model.loss(checkpoint.tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), checkpoint.tree_unflatten(params, grads)


def _describe_sites(sites) -> None:
    on = [s for s in sites if s.offloaded]
    off = [s for s in sites if not s.offloaded]
    _log("offload", f"{len(on)} of {len(sites)} matmul sites routed "
         "through the registry backend:")
    for s in on:
        _log("offload", f"  {s}")
    if off:
        _log("offload", f"{len(off)} sites stay native (size/dtype gate), "
             "e.g. " + "; ".join(repr(s) for s in off[:3]))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--overrides", default="",
                    help="JSON dict of LMConfig overrides")
    ap.add_argument("--steps", type=int, default=300,
                    help="train until this GLOBAL step (resume-aware)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="",
                    help="GEMM registry spec (e.g. pallas_int8_6); empty "
                         "= native torch matmuls")
    ap.add_argument("--plan", default="",
                    help="precision plan (not ported yet: ROADMAP item 7)")
    ap.add_argument("--tune", type=int, default=0,
                    help="calibrate and solve a plan (not ported yet: "
                         "ROADMAP item 7)")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="relative error budget for --tune")
    ap.add_argument("--allow-plan-change", action="store_true",
                    help="resume under another precision plan (not "
                         "ported yet: ROADMAP item 7)")
    ap.add_argument("--mesh", default="",
                    help="dp/tp mesh (not ported yet: ROADMAP item 9)")
    ap.add_argument("--grad-reduce", default="bucketed",
                    choices=["bucketed", "blocking", "ppermute"],
                    help="gradient all-reduce on the dp axis (ROADMAP "
                         "item 9)")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="gradient bucket size (ROADMAP item 9)")
    ap.add_argument("--min-dim", type=int, default=128,
                    help="offload size gate: min(m,k,n) for emulation")
    ap.add_argument("--ckpt-dir", default="",
                    help="default: runs/ckpt/<arch>")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-dir", default="none",
                    help="telemetry directory; only 'none' (telemetry "
                         "is ROADMAP item 10)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="live /metrics server (ROADMAP item 10)")
    ap.add_argument("--metrics-push-url", default="",
                    help="metrics push target (ROADMAP item 10)")
    ap.add_argument("--numerics-every", type=int, default=25,
                    help="NumericsMonitor period; nothing to report into "
                         "while telemetry is off")
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    unported = [
        (args.mesh, "--mesh", 9),
        (args.grad_reduce != "bucketed", "--grad-reduce", 9),
        (args.bucket_mb, "--bucket-mb", 9),
        (args.tune, "--tune", 7),
        (args.plan, "--plan", 7),
        (args.allow_plan_change, "--allow-plan-change", 7),
        (args.metrics_dir != "none", "--metrics-dir", 10),
        (args.metrics_port is not None, "--metrics-port", 10),
        (args.metrics_push_url, "--metrics-push-url", 10),
    ]
    for given, flag, item in unported:
        if given:
            raise NotImplementedError(
                f"{flag} is not ported to repro_torch yet (ROADMAP item "
                f"{item})")


def _check_resume_plan(ckpt_dir, start: int) -> None:
    """Refuse to resume, plan-less, a lineage trained under a precision
    plan: it would silently continue at different numerics."""
    ckpt_fp = checkpoint.load_meta(ckpt_dir, start).get("plan_fingerprint")
    if ckpt_fp is not None:
        raise SystemExit(
            f"[train] checkpoint step {start} in {ckpt_dir} was written "
            f"under precision plan {ckpt_fp} but this run is configured "
            "with <none>: resuming would silently change training "
            "numerics mid-lineage (precision plans are ROADMAP item 7)")


def main(argv: Optional[Sequence[str]] = None, device=None,
         report: Optional[dict] = None) -> List[float]:
    """Run the loop; returns the per-step losses of THIS invocation.

    ``device`` overrides ``--device``.  ``report``, if given, is filled
    with this run's ``sites`` (an emulated run's site list), its
    ``int8_gemms_per_step`` and each step's wall milliseconds
    (``step_ms``, the loss read back to the host included).
    """
    args = _parse(argv)
    _refuse_unported(args)
    dev = resolve_device(device if device is not None else args.device)
    cfg = get_config(args.arch)
    if args.overrides:
        cfg = cfg.replace(**json.loads(args.overrides))
    model = Model(cfg, device=dev, seed=args.seed)
    opt = AdamW(lr=args.lr)
    data = SyntheticText(cfg.vocab_size, args.seq_len,
                         args.global_batch, seed=args.seed)
    ckpt_dir = args.ckpt_dir or f"runs/ckpt/{args.arch}"

    params = model.params
    opt_state = opt.init(params)
    start = checkpoint.latest_step(ckpt_dir) or 0
    if start:
        _log("train", f"resuming from step {start} in {ckpt_dir}")
        params, opt_state = checkpoint.restore(ckpt_dir, start,
                                               (params, opt_state))
    if start >= args.steps:
        _log("train", f"checkpoint step {start} >= --steps "
             f"{args.steps}; nothing to do")
        return []
    if start:
        _check_resume_plan(ckpt_dir, start)
    ckpt_meta = {"plan_fingerprint": None, "backend": args.backend or None,
                 "plan_path": None}
    train_step = build_train_step(model, opt)

    def batch_at(step):
        return torch.as_tensor(data.batch(step), device=dev)

    if args.backend:
        # A pinned spec ("fp64_int8_4") is authoritative at execution;
        # mirror it into the policy so the printed site report shows
        # the split count that actually runs.
        pinned = getattr(get_backend(args.backend), "pinned_splits", None)
        policy = PrecisionPolicy(backend=args.backend, min_dim=args.min_dim,
                                 **({"default_splits": pinned}
                                    if pinned else {}))
        step_fn = offload(train_step, policy)
        _log("train", f"backend={args.backend} min_dim={args.min_dim} "
             f"({cfg.num_params() / 1e6:.1f}M params)")
        sites = step_fn.sites(params, opt_state, batch_at(start))
        _describe_sites(sites)
        int8_per_step = count_int8_gemms(sites)
        _log("offload", f"{int8_per_step} INT8 GEMMs per step")
    else:
        step_fn, sites, int8_per_step = train_step, [], 0
    if report is not None:
        report.update(sites=sites, int8_gemms_per_step=int8_per_step,
                      step_ms=[])

    losses: List[float] = []
    t_last = time.perf_counter()
    for step in range(start, args.steps):
        batch = batch_at(step)
        t_step = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch)
        losses.append(float(loss))
        if report is not None:
            report["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        if step == start or (step + 1) % args.log_every == 0 \
                or step + 1 == args.steps:
            now = time.perf_counter()
            _log("train", f"step {step + 1}/{args.steps} "
                 f"loss={losses[-1]:.4f} ({(now - t_last) * 1e3:.0f} ms)")
            t_last = now
        if (step + 1) % args.ckpt_every == 0:
            checkpoint.save(ckpt_dir, step + 1, (params, opt_state),
                            meta=ckpt_meta)
    checkpoint.save(ckpt_dir, args.steps, (params, opt_state),
                    meta=ckpt_meta)
    _log("train", f"done at step {args.steps}; checkpoint in {ckpt_dir}")
    return losses


if __name__ == "__main__":
    main()
