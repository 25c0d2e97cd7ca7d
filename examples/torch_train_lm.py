"""End-to-end driver of the PyTorch port: train an LM with optionally
emulated GEMMs.

The port's ``examples/train_lm.py``: the smollm-360m architecture
family at a preset-selected scale, the deterministic synthetic data
pipeline, AdamW, and checkpoint/restart (kill it mid-run and re-invoke:
it resumes), all through ``repro_torch.launch.train``.  ``--backend``
routes every projection/MLP/LM-head matmul of the forward AND backward
pass through the GEMM registry via the automatic offload
(``pallas_int8_4`` = 4-slice Ozaki INT8 emulation on kernel K1).  It
runs on the card unless ``--device cpu`` is given.

Presets (same architecture, different scale):

  tiny     2 x d128 blocks,  512 vocab  (~0.4M params; CI smoke)
  reduced  6 x d256 blocks, 4096 vocab  (~8M params)
  100m    12 x d1024 blocks, 16k vocab  (~158M params; a real run)

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --steps 4 \\
      --backend fp64_int8_4 --preset tiny --device cpu

Checkpoints go to ``runs/ckpt/torch_lm_<preset>``, a lineage of their
own: the JAX example's ``runs/ckpt/lm_<preset>`` is never resumed by
accident.
"""

import argparse
import json

from repro_torch.launch.train import main as train_main

# preset -> (registered arch name, LMConfig overrides, default
# seq_len, default batch): train_lm.py's table, the port's own copy.
PRESETS = {
    "tiny": ("tiny", {}, 64, 4),
    "reduced": ("reduced", {}, 128, 4),
    "100m": ("reduced_100m", {}, 256, 8),
}


def ckpt_dir_for(preset: str) -> str:
    """Shared with torch_serve_lm.py: one checkpoint lineage per
    preset."""
    return f"runs/ckpt/torch_lm_{preset}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="reduced")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="0 = preset default")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="0 = preset default")
    ap.add_argument("--backend", default="")
    ap.add_argument("--mesh", default="",
                    help="e.g. 'dp=2' or 'dp=2,tp=2' (one process per "
                         "mesh position, started by the trainer)")
    ap.add_argument("--tune", type=int, default=0,
                    help="calibrate N batches, write --plan, exit")
    ap.add_argument("--plan", default="",
                    help="precision-plan JSON (write with --tune, "
                         "train under it without)")
    ap.add_argument("--allow-plan-change", action="store_true",
                    help="adopt a different precision configuration "
                         "on an existing checkpoint lineage")
    ap.add_argument("--ckpt-dir", default="",
                    help="override the per-preset checkpoint dir "
                         "(plans pin training numerics per lineage)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch, overrides, seq_len, batch = PRESETS[args.preset]
    argv = ["--arch", arch,
            "--overrides", json.dumps(overrides),
            "--steps", str(args.steps),
            "--seq-len", str(args.seq_len or seq_len),
            "--global-batch", str(args.global_batch or batch),
            "--ckpt-dir", args.ckpt_dir or ckpt_dir_for(args.preset),
            "--ckpt-every", "100",
            "--log-every", "10"]
    if args.backend:
        argv += ["--backend", args.backend]
    if args.mesh:
        argv += ["--mesh", args.mesh]
    if args.tune:
        argv += ["--tune", str(args.tune)]
    if args.plan:
        argv += ["--plan", args.plan]
    if args.allow_plan_change:
        argv += ["--allow-plan-change"]
    losses = train_main(argv, device=args.device)
    if args.tune:
        print(f"[train_lm] OK: calibrated {args.tune} batch(es); "
              f"plan at {args.plan}")
        return losses
    if len(losses) >= 2:
        if not losses[-1] < losses[0]:
            raise SystemExit(f"[train_lm] loss did not improve: {losses}")
        print("[train_lm] OK: loss improved "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    elif losses:
        print(f"[train_lm] OK: trained 1 step (loss {losses[0]:.3f}); "
              "nothing to compare for improvement")
    else:
        print("[train_lm] OK: nothing to train "
              "(checkpoint already at --steps)")
    return losses


if __name__ == "__main__":
    main()
