"""Serving example of the PyTorch port: batched requests through the
continuous-batching engine.

The port's ``examples/serve_lm.py``: a preset wrapper over ``python -m
repro_torch.launch.serve``.  It loads the newest checkpoint
``examples/torch_train_lm.py`` wrote for the same ``--preset`` if
present (else the seed-0 parameters), admits a batch of prompts and
decodes them greedily.  Every other flag goes to the launcher as is.
It runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_serve_lm.py --preset tiny
  PYTHONPATH=src python examples/torch_serve_lm.py --preset tiny \\
      --temperature 0.8 --seed 7
  PYTHONPATH=src python examples/torch_serve_lm.py --preset tiny \\
      --splits 6 --min-dim 64 --warm-cache-dir runs/serve-cache
"""

import argparse
import json

from repro_torch.launch.serve import main as serve_main

from torch_train_lm import PRESETS, ckpt_dir_for  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Every flag of python -m repro_torch.launch.serve "
                    "is accepted too (--splits, --plan, --metrics-port, "
                    "...).")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="reduced")
    ap.add_argument("--ckpt-dir", default="",
                    help="override the per-preset checkpoint dir")
    args, rest = ap.parse_known_args(argv)
    arch, overrides, _, _ = PRESETS[args.preset]
    return serve_main(["--arch", arch, "--overrides", json.dumps(overrides),
                       "--ckpt-dir",
                       args.ckpt_dir or ckpt_dir_for(args.preset)] + rest)


if __name__ == "__main__":
    main()
