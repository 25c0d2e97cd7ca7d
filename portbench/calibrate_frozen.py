"""Readings of a planted fault at a cell's size: a train step that
leaves the parameters and the optimizer state unchanged once the window
has begun (it still works out and returns its loss).

    python3 portbench/calibrate_frozen.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3]

On the card, in one process, one JSON line per seed (``reading``
``frozen_from_window``): the numbers a run compares and the driver's
detail.  With the state frozen, the window's last step starts from the
state the checked steps left, whatever the window's length, so a short
window reads what a full one would.  For the drivers whose module binds
``build_train_step`` (``lm_train``, ``moe_train``).  The benchmark's
runs never run this.
"""

import pathlib
import sys

if __name__ == "__main__":
    ROOT = pathlib.Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def frozen_from(steps: int, build):
    """``build`` with its step returning the state it was handed from
    call ``steps`` + 1 on."""
    def frozen(model, opt):
        step, calls = build(model, opt), []

        def run(params, opt_state, batch):
            calls.append(1)
            new_params, new_state, loss = step(params, opt_state, batch)
            if len(calls) > steps:
                return params, opt_state, loss
            return new_params, new_state, loss
        return run
    return frozen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    module = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    module.build_train_step = frozen_from(spec["traffic"]["check_steps"],
                                          module.build_train_step)
    for seed in args.seeds:
        driver = harness.load_driver(spec, seed, torch.device("cuda"))
        driver.setup()
        t0 = time.perf_counter()
        while True:
            driver.unit()
            if time.perf_counter() - t0 >= args.seconds:
                break
        driver.release()
        numbers = driver.compared()
        print(json.dumps({"cell": spec["cell"]["name"], "seed": seed,
                          "reading": "frozen_from_window", **numbers,
                          **driver.detail}), flush=True)
        del driver
    return 0


if __name__ == "__main__":
    sys.exit(main())
