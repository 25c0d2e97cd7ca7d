"""Serving entry point: a batch of requests through the engine.

The command-line form of ``examples/serve_lm.py``'s body, the port's
way to serve from a shell::

    python -m repro_torch.launch.serve --arch tiny --ckpt-dir runs/ckpt/tiny
    python -m repro_torch.launch.serve --arch smollm_360m --splits 6
    python -m repro_torch.launch.serve --device cpu --arch tiny \\
        --splits 6 --min-dim 64 --warm-cache-dir runs/serve-cache

It builds the ``--arch`` model (``--overrides``: JSON of config
fields), loads the newest checkpoint in ``--ckpt-dir`` (default
``runs/ckpt/<arch>``, where ``python -m repro_torch.launch.train``
writes; a checkpoint of either package restores here), admits four
prompts of 16 seeded random tokens and decodes them.  A missing
checkpoint directory serves the seed-0 parameters, which equal the
reference's ``init_params(PRNGKey(0))``; a checkpoint that does not fit
the model prints ``restore failed (...)`` and serves those too.

Precision: ``--plan`` serves under a tuned plan (subset match, as the
engine runs a train-calibrated plan); ``--splits s`` offloads every
GEMM of at least ``--min-dim`` rows and columns at ``s`` splits through
``pallas_int8`` (kernel K1 on the card, its plain version on the CPU);
``--warm-cache-dir`` persists the offload's
decisions, so a restarted server reads them back (``python -m
repro_torch.obs report --check --expect-cache-hit``).  Telemetry is on
by default, into ``<ckpt-dir>/metrics`` (``--metrics-dir none`` turns it
off); ``--metrics-port`` serves ``/metrics`` live, and
``--hold-metrics-s`` keeps it up after decoding so a scraper can read
the final counters.

It runs on the card unless ``--device cpu`` (or ``device="cpu"``) is
given, and raises when no card is present and none is named.
``main(argv, device=)`` returns the finished requests.  It is
``run(*build(argv, device))``: ``build`` gives the flags, the engine and
the requests, so a caller can watch ``engine.runner`` before ``run``
serves them.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence

import numpy as np

from .._device import resolve_device
from ..configs import get_config
from ..core import PrecisionPolicy
from ..models import Model
from ..serve import Engine, Request
from ..train import AdamW, checkpoint

__all__ = ["build", "main", "run"]


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--overrides", default="",
                    help="JSON dict of LMConfig overrides")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature "
                         "(0 = greedy, the default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="per-request sampling seed (temperature>0)")
    ap.add_argument("--latency-target-s", type=float, default=None,
                    help="per-request latency target; drives the edf "
                         "scheduler and the latency-slack telemetry")
    ap.add_argument("--scheduler-policy", choices=("fifo", "edf"),
                    default="fifo")
    ap.add_argument("--kv-layout", choices=("paged", "dense"),
                    default="paged")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV cache block size in tokens")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="split prefills into pieces of at most this "
                         "many tokens (default: whole prompt)")
    ap.add_argument("--chunk-token-budget", type=int, default=None,
                    help="pack prefill pieces from multiple requests "
                         "into waves of at most this many tokens")
    ap.add_argument("--plan", default="",
                    help="precision-plan JSON: serve the prefill/"
                         "decode GEMMs under the tuned plan")
    ap.add_argument("--splits", type=int, default=0,
                    help="offload every GEMM at this split count (a "
                         "plain PrecisionPolicy; no plan needed)")
    ap.add_argument("--min-dim", type=int, default=128,
                    help="offload size gate for --splits: min(m,k,n)")
    ap.add_argument("--warm-cache-dir", default="",
                    help="persist the offload's decisions here so a "
                         "restarted server reads them back (needs "
                         "--plan/--splits)")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint lineage to serve (default: "
                         "runs/ckpt/<arch>)")
    ap.add_argument("--metrics-dir", default="",
                    help="telemetry dir (repro_torch.obs JSONL); "
                         "default: <ckpt-dir>/metrics; 'none' disables")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live Prometheus /metrics on this port "
                         "while the engine runs (0 = ephemeral; the "
                         "chosen port is printed)")
    ap.add_argument("--hold-metrics-s", type=float, default=0.0,
                    help="keep /metrics up this many seconds after "
                         "decoding finishes, for an external scraper")
    return ap.parse_args(argv)


def _restore_params(model: Model, ckpt_dir: str):
    """The newest checkpoint's parameters, else the model's own."""
    params = model.params
    last = checkpoint.latest_step(ckpt_dir)
    if last is None:
        return params
    print(f"[serve] loading checkpoint step {last}", flush=True)
    opt_like = AdamW().init(params)
    try:
        params, _ = checkpoint.restore(ckpt_dir, last, (params, opt_like))
    except checkpoint.CheckpointError as e:
        # Only an absent or incompatible checkpoint falls back to the
        # seed-0 parameters; anything else is a real fault and raises.
        print(f"[serve] restore failed ({e}); using random init")
        params = model.params
    return params


def build(argv: Optional[Sequence[str]] = None, device=None):
    """``(args, engine, requests)``: the parsed flags, the engine on the
    restored parameters and the seeded prompts.  ``device`` overrides
    ``--device``."""
    args = _parse(argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = get_config(args.arch)
    if args.overrides:
        cfg = cfg.replace(**json.loads(args.overrides))
    model = Model(cfg, device=dev, seed=0)
    ckpt_dir = args.ckpt_dir or f"runs/ckpt/{args.arch}"
    params = _restore_params(model, ckpt_dir)

    plan = None
    if args.plan:
        from ..tune import PrecisionPlan

        plan = PrecisionPlan.load(args.plan)
        print(f"[serve] precision plan {args.plan} "
              f"({plan.fingerprint}, {len(plan.sites)} sites)")
    policy = None
    if args.splits:
        # The kernel family: K1 on the card, its plain version on the
        # CPU.
        policy = PrecisionPolicy(backend="pallas_int8",
                                 default_splits=args.splits,
                                 min_dim=args.min_dim)
    metrics = None
    if args.metrics_dir != "none":
        from ..obs import MetricsRun

        metrics = MetricsRun(args.metrics_dir or f"{ckpt_dir}/metrics")
    engine = Engine(model, params, batch_slots=4, max_len=512,
                    plan=plan, policy=policy, metrics=metrics,
                    kv_layout=args.kv_layout,
                    block_size=args.block_size,
                    chunk_tokens=args.chunk_tokens,
                    chunk_token_budget=args.chunk_token_budget,
                    warm_cache_dir=args.warm_cache_dir or None,
                    scheduler_policy=args.scheduler_policy,
                    metrics_port=args.metrics_port)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(1, cfg.vocab_size, 16)],
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature,
                    seed=args.seed + i,
                    latency_target_s=args.latency_target_s)
            for i in range(4)]
    return args, engine, reqs


def run(args, engine: Engine, reqs: List[Request]) -> List[Request]:
    """Serve ``reqs`` on ``engine`` as ``build`` made them, hold
    ``/metrics`` open when asked, close the engine and its telemetry;
    returns the finished requests."""
    metrics = engine.metrics
    if engine.metrics_server is not None:
        print(f"[serve] live metrics: "
              f"{engine.metrics_server.url}/metrics", flush=True)
    try:
        done = engine.run(reqs)
        if engine.metrics_server is not None and args.hold_metrics_s:
            print(f"[serve] holding /metrics open for "
                  f"{args.hold_metrics_s:.0f}s", flush=True)
            time.sleep(args.hold_metrics_s)
    finally:
        engine.close()
        if metrics is not None:
            metrics.close()
    for i, r in enumerate(done):
        print(f"[serve] req{i}: prompt[:4]={r.prompt[:4]} "
              f"-> out[:8]={r.out[:8]} ({len(r.out)} tokens)")
    if not all(len(r.out) > 0 for r in done):
        raise SystemExit("[serve] a request finished with no tokens")
    if metrics is not None:
        print(f"[serve] telemetry: {metrics.sink.path}")
    print("[serve] OK", flush=True)
    return done


def main(argv: Optional[Sequence[str]] = None,
         device=None) -> List[Request]:
    """Serve the batch; returns the finished requests.  ``device``
    overrides ``--device``."""
    return run(*build(argv, device))


if __name__ == "__main__":
    main()
