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

Precision plans (:mod:`repro_torch.tune`) close the loop, as in the
reference:

* ``--tune N --plan path`` calibrates the exact train step this loop
  would run (N batches from the resume state), solves the cost-optimal
  per-site split assignment, writes the plan JSON and its tile table,
  and exits without training;
* ``--plan path`` trains under the plan: the step runs as
  ``offload(step, plan=plan)`` with a strict match (a drifted program
  raises), and every checkpoint records the plan's fingerprint, so a
  resume under another precision configuration stops instead of
  silently continuing at other numerics; ``--allow-plan-change`` turns
  that stop into a warning, the way to adopt a freshly tuned plan on an
  existing lineage.

Telemetry (:mod:`repro_torch.obs`) is on by default, as in the
reference: each invocation writes one ``events-NNNN.jsonl`` run into
``--metrics-dir`` (default ``<ckpt-dir>/metrics``; ``none`` turns it
off) — a ``config`` event, the site declarations, every offloaded
site's executions (the offload's hook, forward and backward), one
``train_step`` span and one ``step`` event per step, and every
``--numerics-every`` steps a :class:`~repro_torch.obs.NumericsMonitor`
check of an emulated run.  ``--metrics-port`` serves the registry live
at ``/metrics``; ``--metrics-push-url`` pushes it to an aggregating
server every ``--log-every`` steps.  Inspect a run with ``python -m
repro_torch.obs report|export|attrib|diff``.

``--layer-spans`` (off by default) makes the run's tracer the active
one (:func:`repro_torch.obs.activate`) while the steps run, so the
port's layer spans land in the run too: ``train.step`` with its
``train.forward``, ``train.backward`` and ``train.optimizer``, one
``offload.site`` per execution of an offloaded site (backward ones on
autograd's thread), and one ``ozaki`` per ``ozaki_matmul`` call with
its ``ozaki.slice``, ``ozaki.kernel`` and ``ozaki.combine``.  They
are held in memory while the steps run and written to the run's JSONL
when the step loop ends; ``python -m repro_torch.obs export`` renders
them as a Chrome trace.  Without the switch the run's file is as
before.

An ``--arch`` with experts (``mellum2_12b_a2_5b_ep8``, Mellum2-12B-A2.5B
at its published widths as one expert-parallel rank of eight, or its
CPU-sized ``mellum2_tiny``) trains a :class:`~repro_torch.models.MoEModel`
(routed experts, sliding and full attention layers) through the same
step and offload; its expert layers' products change shape with the
routing, so the offload decides them afresh each step.  It has no mesh
form.

``--mesh dp=N`` runs the same step data-parallel over N ranks
(:func:`build_sharded_train_step`), one process per mesh position
(:mod:`repro_torch.shard.launch`): the trainer starts them itself (or
joins ``torchrun``'s), over gloo on the CPU or when ranks share a card
and over NCCL when each has its own.  Each rank runs the step on its
rows of the batch; the loss is averaged and the gradients mean-reduced
over ``dp`` with a *bucketed* all-reduce (leaves grouped by byte size,
one collective per bucket, issued after the backward; ``--bucket-mb``
sets the size, ``--grad-reduce`` picks the blocking baseline or a
``ppermute`` ring instead).  ``--mesh dp=N,tp=M`` adds Megatron-style
tensor parallelism: attention heads and the SwiGLU hidden dim split
over ``tp`` per :mod:`repro_torch.shard.rules`, each sublayer closed by
an all-reduce over the tp group, and checkpoints written as one npz
per tp shard and a manifest (the reference's layout), which a later run
resumes on any mesh or none.  With ``--backend`` the step runs under
the offload inside :func:`repro_torch.core.spmd_scope`, so its sites
are ``shmap0/...`` and each sees its per-shard extents.  Rank 0 logs,
prints the site report, writes the telemetry and the plan; the other
ranks stay silent, or push their registry with ``--metrics-push-url``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..configs import get_config
from ..core import PrecisionPolicy, get_backend, offload
from ..models import Model, MoEModel
from ..core.intercept import spmd_scope
from ..obs import (MetricsRun, MetricsServer, NumericsMonitor, Registry,
                   activate, get_logger, push_snapshot, span)
from ..shard import (DEFAULT_BUCKET_BYTES, DP_AXIS, GRAD_REDUCE_MODES,
                     TP_AXIS, all_reduce_mean, bucket_stats,
                     reduce_gradients, shard_batch, shard_state,
                     train_mesh_setup, validate_tp)
from ..shard.launch import (is_rank_zero, mesh_ranks, rank_device,
                            run_on_mesh)
from ..train import AdamW, SyntheticText, checkpoint
from ..tune import PrecisionPlan, count_int8_gemms

__all__ = ["main", "build_train_step", "build_sharded_train_step",
           "loss_and_grads"]

log = get_logger("train")
offload_log = get_logger("offload")


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
        with span("train.step"):
            loss, grads = loss_and_grads(model, params, batch)
            with span("train.optimizer"):
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
        with span("train.forward"):
            loss = model.loss(checkpoint.tree_unflatten(params, leaves),
                              batch)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), checkpoint.tree_unflatten(params, grads)


def build_sharded_train_step(model: Model, opt: AdamW, mesh,
                             axis: str | None = None, *,
                             grad_reduce: str = "bucketed",
                             bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """dp(×tp)-parallel version of :func:`build_train_step` for one rank
    of ``mesh`` (a :class:`repro_torch.shard.Mesh`).

    The step takes this rank's state and rows: ``params`` and
    ``opt_state`` as :func:`repro_torch.shard.train_mesh_setup` places
    them, the batch as :func:`repro_torch.shard.shard_batch` cuts it.
    It computes the loss and its gradient on the rows, averages the
    loss over the dp axis and mean-reduces the gradient there with
    :func:`repro_torch.shard.reduce_gradients` (``grad_reduce``,
    ``bucket_bytes``), then applies the same AdamW update as every other
    rank, so the global step is the single-device step on the whole
    batch.  The buckets go out after ``torch.autograd.grad`` returns.

    With a ``tp`` axis of size > 1 the model runs tensor-parallel over
    the mesh's tp group (:meth:`Model.tp_view`) on the rank's blocks of
    the parameters, and AdamW updates those blocks elementwise.

    The whole step runs inside :func:`repro_torch.core.spmd_scope`, so
    wrapped in :func:`offload` its forward and backward sites are named
    ``shmap0/...`` and are decided on their per-shard extents
    (``q_dim/tp``, ``d_ff/tp``, the rank's rows for ``dW``).  The step
    carries ``spmd_axes``, which the offload's decision cache keys on.
    """
    dp = axis or mesh.axis_names[0]
    if dp == TP_AXIS and len(mesh.axis_names) > 1:
        dp = next(a for a in mesh.axis_names if a != TP_AXIS)
    if grad_reduce not in GRAD_REDUCE_MODES:
        raise ValueError(f"unknown gradient-reduce mode {grad_reduce!r}; "
                         f"expected one of {GRAD_REDUCE_MODES}")
    tp = mesh.shape.get(TP_AXIS, 1)
    dp_size = mesh.shape[dp]
    if tp > 1:
        validate_tp(model.cfg, tp)
        model = model.tp_view(mesh.groups[TP_AXIS])

    def sharded_train_step(params, opt_state, batch):
        with spmd_scope(mesh):
            loss, grads = loss_and_grads(model, params, batch)
            loss = all_reduce_mean(loss, dp, mesh=mesh)
            grads = reduce_gradients(grads, dp, dp_size, mode=grad_reduce,
                                     bucket_bytes=bucket_bytes, mesh=mesh)
            params, opt_state = opt.update(grads, params, opt_state)
        return params, opt_state, loss

    sharded_train_step.spmd_axes = mesh.spmd_axes
    return sharded_train_step


def _describe_sites(sites) -> None:
    on = [s for s in sites if s.offloaded]
    off = [s for s in sites if not s.offloaded]
    offload_log.info(f"{len(on)} of {len(sites)} matmul sites routed "
                     "through the registry backend:")
    for s in on:
        offload_log.info(f"  {s}")
    if off:
        offload_log.info(f"{len(off)} sites stay native (size/dtype "
                         "gate), e.g. " + "; ".join(repr(s) for s in off[:3]))


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
                    help="precision-plan JSON: with --tune, where the "
                         "calibrated plan is written; without, the "
                         "plan the train step runs under")
    ap.add_argument("--tune", type=int, default=0,
                    help="calibrate the train step over this many "
                         "batches, solve, write --plan, and exit "
                         "(no training)")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="end-to-end relative error budget for "
                         "--tune; 0 = derive from the model dtype")
    ap.add_argument("--allow-plan-change", action="store_true",
                    help="resume a lineage under a DIFFERENT "
                         "precision configuration (a warning instead "
                         "of an error)")
    ap.add_argument("--mesh", default="",
                    help="mesh spec: 'dp=8' (data parallel) or "
                         "'dp=4,tp=2' (2-D: tp splits attention heads "
                         "and the MLP hidden dim); empty = one process. "
                         "The trainer starts one rank per position "
                         "(or joins torchrun's)")
    ap.add_argument("--grad-reduce", default="bucketed",
                    choices=list(GRAD_REDUCE_MODES),
                    help="gradient all-reduce strategy on the dp axis "
                         "(bucketed = one all-reduce per bucket, "
                         "bit-identical to the per-leaf mean at dp=2; "
                         "blocking = one over every leaf; ppermute = "
                         "ring, replicas agree to rounding only)")
    ap.add_argument("--bucket-mb", type=float, default=0.0,
                    help="gradient bucket size in MiB for "
                         "--grad-reduce bucketed; 0 = default (4)")
    ap.add_argument("--min-dim", type=int, default=128,
                    help="offload size gate: min(m,k,n) for emulation")
    ap.add_argument("--ckpt-dir", default="",
                    help="default: runs/ckpt/<arch>")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-dir", default="",
                    help="telemetry directory (repro_torch.obs JSONL "
                         "runs); default: <ckpt-dir>/metrics; 'none' "
                         "disables")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the run's registry live at "
                         "http://127.0.0.1:PORT/metrics (Prometheus "
                         "text format; 0 = ephemeral port) while "
                         "training; requires telemetry on")
    ap.add_argument("--metrics-push-url", default="",
                    help="push this process's registry snapshot to an "
                         "aggregating metrics server (http://host:port"
                         "/push) every --log-every steps")
    ap.add_argument("--layer-spans", action="store_true",
                    help="record the port's layer spans (train step "
                         "phases, offloaded sites, ozaki_matmul's "
                         "slicing, kernel and combine) into the run's "
                         "telemetry, held in memory until the steps "
                         "end; requires telemetry on")
    ap.add_argument("--numerics-every", type=int, default=25,
                    help="NumericsMonitor period: every Nth step "
                         "re-measure the probe site's realized error "
                         "against a float64 matmul (emulated runs with "
                         "telemetry on); 0 disables")
    return ap.parse_args(argv)


def _run_tune(args, cfg, train_step, params, opt_state, batch_at,
              start) -> None:
    """``--tune N --plan path``: calibrate, solve, save, report."""
    from ..tune import Calibrator, solve_plan
    from ..tune.cli import (log_report, reference_dtype, report_plan,
                            tune_policy)
    from ..tune.plan import write_tiles_table

    policy = tune_policy(args.backend or "fp64_int8", args.min_dim)
    log.info(f"tuning: {args.tune} calibration batch(es) from "
             f"step {start}, probe s={policy.default_splits}, "
             f"backend family {policy.backend}")
    cal = Calibrator(train_step, policy,
                     reference_dtype=reference_dtype(cfg.dtype))
    for i in range(args.tune):
        cal.run(params, opt_state, batch_at(start + i))
    plan = solve_plan(cal.result(), budget=args.budget or None)
    if not is_rank_zero():
        return
    path = plan.save(args.plan)
    tiles_path = write_tiles_table(plan, path)
    log_report(get_logger("tune"), report_plan(plan, cal.sites))
    log.info(f"plan written to {path} (tile decisions: "
             f"{tiles_path}); train with --plan {path}")


def _check_resume_plan(ckpt_dir, start: int, plan,
                       allow_change: bool) -> None:
    """Refuse to resume across a precision-configuration change.

    The checkpoint's metadata carries the plan fingerprint the run was
    training under; resuming with another plan, or none, or with a plan
    on a plan-less lineage would silently continue the loss curve at
    other numerics — an error unless ``--allow-plan-change`` makes the
    change explicit.
    """
    ckpt_fp = checkpoint.load_meta(ckpt_dir, start).get("plan_fingerprint")
    active_fp = plan.fingerprint if plan is not None else None
    if ckpt_fp == active_fp:
        return
    if allow_change:
        log.warning(f"precision configuration changes at "
                    f"step {start}: {ckpt_fp or '<none>'} -> "
                    f"{active_fp or '<none>'} (--allow-plan-change); "
                    "later checkpoints record the new fingerprint")
        return
    raise SystemExit(
        f"[train] checkpoint step {start} in {ckpt_dir} was written "
        f"under precision plan {ckpt_fp or '<none>'} but this run is "
        f"configured with {active_fp or '<none>'}: resuming would "
        "silently change training numerics mid-lineage. Pass the "
        "matching --plan; or, to adopt this configuration on purpose "
        "(e.g. a plan just tuned at this resume state), re-run with "
        "--allow-plan-change.")


def main(argv: Optional[Sequence[str]] = None, device=None,
         report: Optional[dict] = None,
         timeout: Optional[float] = None) -> List[float]:
    """Run the loop; returns the per-step losses of THIS invocation.

    ``device`` overrides ``--device``.  ``report``, if given, is filled
    with this run's ``sites`` (an emulated run's site list), its
    ``int8_gemms_per_step``, each step's wall milliseconds (``step_ms``,
    the loss read back to the host included) and ``site_exec``, the
    executions of offloaded sites the offload's hook counted.  Under a
    mesh it also gets ``state``, the rank's final ``(params,
    opt_state)`` blocks, when the process is a rank itself; when the
    trainer starts the ranks, the report is rank 0's and ``ranks``
    holds every rank's (without ``state``).  ``timeout`` bounds, in
    seconds, a run whose ranks the trainer starts (their join and their
    process group's collectives).
    """
    args = _parse(argv)
    if args.tune and not args.plan:
        raise SystemExit("[train] --tune needs --plan (where to write "
                         "the calibrated plan)")
    if args.layer_spans and args.metrics_dir == "none":
        raise SystemExit("[train] --layer-spans records into the run's "
                         "telemetry; it needs --metrics-dir")
    if args.plan and args.backend and not args.tune:
        raise SystemExit("[train] --plan and --backend are both "
                         "precision configurations; pass one (with "
                         "--tune, --backend sets the probe family)")
    if args.mesh and _config(args).num_experts:
        raise SystemExit(f"[train] {args.arch} has experts; the mesh "
                         "rules shard only the dense model's leaves")
    dev = resolve_device(device if device is not None else args.device)
    if args.mesh and not dist.is_initialized():
        world = mesh_ranks(args.mesh)
        argv = list(sys.argv[1:] if argv is None else argv)
        results = run_on_mesh(_main_rank, world,
                              (argv, str(dev), report is not None),
                              device=dev, timeout=timeout, log=log)
        if report is not None:
            report.update(results[0][1])
            report["ranks"] = [rep for _, rep in results]
        return results[0][0]
    return _train(args, dev, report)


def _main_rank(argv, device, want_report):
    """One rank of a mesh run the trainer started: its losses and its
    report (``state`` left out, it stays in the rank)."""
    report = {} if want_report else None
    losses = main(argv, device=device, report=report)
    if report is not None:
        report.pop("state", None)
    return losses, report


def _config(args):
    cfg = get_config(args.arch)
    if args.overrides:
        cfg = cfg.replace(**json.loads(args.overrides))
    return cfg


def _train(args, dev, report) -> List[float]:
    if args.mesh:
        dev = rank_device(dev)
    cfg = _config(args)
    model = (MoEModel if cfg.num_experts else Model)(cfg, device=dev,
                                                     seed=args.seed)
    opt = AdamW(lr=args.lr)
    data = SyntheticText(cfg.vocab_size, args.seq_len,
                         args.global_batch, seed=args.seed)
    ckpt_dir = args.ckpt_dir or f"runs/ckpt/{args.arch}"

    params, opt_state = model.params, None
    start = checkpoint.latest_step(ckpt_dir) or 0
    if start:
        log.info(f"resuming from step {start} in {ckpt_dir}")
        params, opt_state = checkpoint.restore(ckpt_dir, start,
                                               (params, opt.init(params)))
    if start >= args.steps and not args.tune:
        log.info(f"checkpoint step {start} >= --steps "
                 f"{args.steps}; nothing to do")
        return []

    mesh = state_specs = None
    bucket_bytes = (int(args.bucket_mb * (1 << 20)) if args.bucket_mb
                    else DEFAULT_BUCKET_BYTES)
    if args.mesh:
        mesh, _, _, state_specs = train_mesh_setup(
            args.mesh, args.global_batch, cfg)
        dp, tp = mesh.shape[DP_AXIS], mesh.shape[TP_AXIS]
        if tp > 1:
            # The global state every rank holds alike, cut to its blocks.
            params = shard_state(params, state_specs[0], mesh)
            if opt_state is not None:
                opt_state = shard_state(opt_state, state_specs[1], mesh)
        log.info(f"mesh {args.mesh}: {mesh.size} ranks (dp={dp} tp={tp}) "
                 f"over {dist.get_backend() if mesh.size > 1 else 'none'}"
                 f" on {dev.type}, per-shard batch "
                 f"{args.global_batch // dp}, grad-reduce {args.grad_reduce}")
        if args.grad_reduce == "bucketed":
            n_buckets, per_bucket = bucket_stats(params, bucket_bytes)
            log.info(f"gradient buckets: {n_buckets} all-reduce(s), "
                     f"{[round(b / 1024) for b in per_bucket]} KiB")
        train_step = build_sharded_train_step(
            model, opt, mesh, grad_reduce=args.grad_reduce,
            bucket_bytes=bucket_bytes)
    else:
        train_step = build_train_step(model, opt)
    if opt_state is None:
        opt_state = opt.init(params)

    def batch_at(step):
        batch = torch.as_tensor(data.batch(step), device=dev)
        return batch if mesh is None else shard_batch(batch, mesh, DP_AXIS)

    if args.tune:
        _run_tune(args, cfg, train_step, params, opt_state, batch_at,
                  start)
        return []

    plan = PrecisionPlan.load(args.plan) if args.plan else None
    if start:
        _check_resume_plan(ckpt_dir, start, plan, args.allow_plan_change)
    ckpt_meta = {
        "plan_fingerprint": plan.fingerprint if plan is not None
        else None,
        # Informational (resume enforcement keys on the fingerprint).
        "backend": args.backend or None,
        "plan_path": args.plan or None,
    }
    # A tp mesh writes the per-shard layout (one npz per tp shard and a
    # manifest, every rank of the first dp row writing its own shard);
    # restore reassembles the global tree, so a later resume may use any
    # mesh shape, or none.  Otherwise rank 0 writes the one file.
    tp_sharded = mesh is not None and mesh.shape[TP_AXIS] > 1

    def save_ckpt(step_no, state):
        if tp_sharded:
            checkpoint.save_sharded(ckpt_dir, step_no, state, state_specs,
                                    mesh, meta=ckpt_meta)
        elif is_rank_zero():
            checkpoint.save(ckpt_dir, step_no, state, meta=ckpt_meta)

    # Telemetry (repro_torch.obs): one MetricsRun per invocation, scoped
    # to the checkpoint lineage by default, written by rank 0 alone.
    telemetry = args.metrics_dir != "none"
    metrics = registry = None
    if telemetry and is_rank_zero():
        metrics = MetricsRun(args.metrics_dir or f"{ckpt_dir}/metrics")
        registry = metrics.registry
        metrics.event("config", arch=args.arch, steps=args.steps,
                      start=start, seq_len=args.seq_len,
                      global_batch=args.global_batch,
                      backend=args.backend or None,
                      plan=args.plan or None, mesh=args.mesh or None)
    elif telemetry and args.metrics_push_url:
        # Another rank: its registry goes to the aggregator only.
        registry = Registry()
    # Live observability: a pull endpoint over this run's registry
    # and/or periodic pushes into another process's aggregator.
    mserver = None
    push_url = args.metrics_push_url if registry is not None else ""
    rank = dist.get_rank() if dist.is_initialized() else 0
    push_source = f"train-proc{rank}"
    if metrics is not None and args.metrics_port is not None:
        mserver = MetricsServer(metrics.registry, port=args.metrics_port,
                                runs_dir=metrics.directory).start()
        log.info(f"live metrics: {mserver.url}/metrics")
        if report is not None:
            report["metrics_url"] = mserver.url

    def push_metrics() -> None:
        if not push_url:
            return
        try:
            push_snapshot(push_url, push_source, registry)
        except OSError as e:
            log.warning(f"metrics push to {push_url} failed: {e}")

    on_site_event = _site_event_handler(metrics, registry, report)
    monitor = None
    policy = None
    if plan is not None:
        step_fn = offload(train_step, plan=plan, plan_match="strict",
                          on_site_event=on_site_event)
        policy = step_fn.policy
        log.info(f"precision plan {args.plan} "
                 f"({plan.fingerprint}, backend={plan.backend}, "
                 f"{len(plan.sites)} sites"
                 + (f", {len(plan.demoted_sites())} demoted"
                    if plan.demoted_sites() else "") + ")")
    elif args.backend:
        # A pinned spec ("fp64_int8_4") is authoritative at execution;
        # mirror it into the policy so the printed site report shows
        # the split count that actually runs.
        pinned = getattr(get_backend(args.backend), "pinned_splits", None)
        policy = PrecisionPolicy(backend=args.backend, min_dim=args.min_dim,
                                 **({"default_splits": pinned}
                                    if pinned else {}))
        step_fn = offload(train_step, policy, on_site_event=on_site_event)
        log.info(f"backend={args.backend} min_dim={args.min_dim} "
                 f"({cfg.num_params() / 1e6:.1f}M params)")
    if policy is not None:
        sites = step_fn.sites(params, opt_state, batch_at(start))
        _describe_sites(sites)
        int8_per_step = count_int8_gemms(sites)
        offload_log.info(f"{int8_per_step} INT8 GEMMs per step")
        if metrics is not None:
            metrics.declare_sites(sites)
        if telemetry and args.numerics_every > 0:
            # Every rank checks (the check runs the step, collectives
            # and all); rank 0 records.
            monitor = NumericsMonitor(
                train_step, plan=plan,
                policy=None if plan is not None else policy,
                every=args.numerics_every, registry=registry,
                sink=metrics.sink if metrics is not None else None,
                log=log)
    else:
        step_fn, sites, int8_per_step = train_step, [], 0
    if report is not None:
        report.update(sites=sites, int8_gemms_per_step=int8_per_step,
                      step_ms=[])

    losses: List[float] = []
    t_last = time.perf_counter()
    layer_spans = contextlib.ExitStack()
    if args.layer_spans and metrics is not None:
        layer_spans.enter_context(activate(metrics.tracer))
    try:
        for step in range(start, args.steps):
            batch = batch_at(step)
            if monitor is not None:
                monitor.maybe_check(step, params, opt_state, batch)
            t_step = time.perf_counter()
            if metrics is not None:
                with metrics.tracer.span("train_step", step=step + 1):
                    params, opt_state, loss = step_fn(params, opt_state,
                                                      batch)
                    # Reading the loss back waits for the device: the
                    # span measures the whole step, not its dispatch.
                    losses.append(float(loss))
            else:
                params, opt_state, loss = step_fn(params, opt_state, batch)
                losses.append(float(loss))
            step_ms = (time.perf_counter() - t_step) * 1e3
            if report is not None:
                report["step_ms"].append(step_ms)
            if metrics is not None:
                metrics.event("step", step=step + 1, loss=losses[-1],
                              ms=step_ms, int8_gemms=int8_per_step)
            if step == start or (step + 1) % args.log_every == 0 \
                    or step + 1 == args.steps:
                now = time.perf_counter()
                log.info(f"step {step + 1}/{args.steps} "
                         f"loss={losses[-1]:.4f} "
                         f"({(now - t_last) * 1e3:.0f} ms)")
                t_last = now
                push_metrics()
            if (step + 1) % args.ckpt_every == 0:
                save_ckpt(step + 1, (params, opt_state))
        save_ckpt(args.steps, (params, opt_state))
    finally:
        layer_spans.close()   # writes the held spans
        if registry is not None:
            # The site hook runs as each product is issued (backward
            # ones on autograd's threads, done when the step returns),
            # so the execution counters are complete here.
            push_metrics()
        if metrics is not None:
            metrics.close()
        if mserver is not None:
            mserver.close()
    if report is not None and mesh is not None:
        report["state"] = (params, opt_state)
    log.info(f"done at step {args.steps}; checkpoint in {ckpt_dir}")
    if metrics is not None:
        log.info(f"telemetry: {metrics.sink.path} (inspect with "
                 f"python -m repro_torch.obs report {metrics.directory})")
        if report is not None:
            report["metrics_dir"] = str(metrics.directory)
    return losses


def _site_event_handler(metrics, registry, report):
    """The offload's hook: the telemetry's (rank 0), a bare ``site_exec``
    counter in a pushing rank's registry, and the report's tally."""
    handlers = []
    if metrics is not None:
        handlers.append(metrics.site_event_handler())
    elif registry is not None:
        handlers.append(lambda payload: registry.counter(
            "site_exec", site=payload.get("site", "?")).inc())
    if report is not None:
        lock = threading.Lock()
        report["site_exec"] = 0

        def tally(payload: dict) -> None:
            with lock:
                report["site_exec"] += 1
        handlers.append(tally)
    if not handlers:
        return None
    if len(handlers) == 1:
        return handlers[0]

    def handler(payload: dict) -> None:
        for fn in handlers:
            fn(payload)
    return handler


if __name__ == "__main__":
    main()
