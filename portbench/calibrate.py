"""Readings the limits of ``correct`` are set from, at a cell's size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--seconds 51] [--control] [--half-batch] [--f32-last]
        [--no-program]

On the card, in one process, one JSON line per seed and reading:

* the program's numbers as a run compares them: set-up, units for
  ``--seconds`` as a run's window holds them, then the comparison; with
  each unit's host wall seconds, host CPU seconds and seconds in the
  garbage collector (``units``);
* ``--control``: the plain reference in the precision below the
  configuration's (TF32 for the float32 LM) put in the program's place,
  at the same steps;
* ``--half-batch``: the reference with each loss taken over the first
  half of the positions only, a planted fault: over the first steps,
  and (after a program run) at the window's last step;
* ``--f32-last``: the float32 reference's numbers at the window's last
  step against the float64 step that a run compares with, which shows
  how far float32 rounding alone parts a sound gradient there.

The benchmark's runs never run this.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.drivers import lm_train  # noqa: E402


class GcClock:
    """Seconds the garbage collector has run, from ``gc.callbacks``."""

    def __init__(self):
        self.total, self._start = 0.0, None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None


def _print(cell, seed, what, numbers):
    print(json.dumps({"cell": cell, "seed": seed, "reading": what,
                      **numbers}), flush=True)


def readings(spec: dict, seed: int, args, clock: GcClock,
             device="cuda") -> None:
    cell = spec["cell"]["name"]
    driver = harness.load_driver(spec, seed, torch.device(device))
    if args.no_program:
        if args.half_batch:
            rows = spec["traffic"]["seq_len"] // 2
            numbers, detail = lm_train.gaps(driver.reference(rows=rows),
                                            driver.reference())
            _print(cell, seed, "half_batch", dict(numbers, **detail))
        return
    driver.setup()
    units, t0 = [], time.perf_counter()
    while True:
        wall, cpu, in_gc = time.perf_counter(), time.process_time(), \
            clock.total
        driver.unit()
        units.append([time.perf_counter() - wall,
                      time.process_time() - cpu, clock.total - in_gc])
        if time.perf_counter() - t0 >= args.seconds:
            break
    driver.release()
    _print(cell, seed, "program",
           dict(driver.compared(), **driver.detail, units=units))
    if args.control:
        _print(cell, seed, "control",
               dict(driver.compared(control=True), **driver.detail))
    if args.half_batch:
        rows = spec["traffic"]["seq_len"] // 2
        numbers, detail = lm_train.last_gaps(
            driver.reference_last(rows=rows),
            driver.reference_last(dtype=torch.float64))
        _print(cell, seed, "half_batch_last", dict(numbers, **detail))
    if args.f32_last:
        numbers, _ = lm_train.last_gaps(
            driver.reference_last(),
            driver.reference_last(dtype=torch.float64))
        _print(cell, seed, "f32_last", numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half-batch", action="store_true")
    ap.add_argument("--f32-last", action="store_true")
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    clock = GcClock()
    for seed in args.seeds:
        readings(spec, seed, args, clock)
    return 0


if __name__ == "__main__":
    sys.exit(main())
