"""Serve tokens/s of two checkouts, alternated on one CUDA card.

    python3 tools/serve_ab.py PARENT_DIR CHANGE_DIR [--pairs N]

Each directory is the root of a checkout of the port (for example
``git archive`` of a commit unpacked into a directory that
``.gitignore`` lists).  Pair i runs ``chip_smoke.py``'s serve phase
(SmolLM-360M at full width, natively and through ``pallas_int8_6``)
of PARENT then CHANGE, pair i+1 of CHANGE then PARENT, each run in a
process of its own from its checkout's root.  Prints every run's
tokens/s and the medians per checkout; exits non-zero if a run fails.
"""

import argparse
import re
import statistics
import subprocess
import sys

# Runs one checkout's serve phase; phase_serve took no arguments before
# it checked the offloaded GEMM shapes against phase 2's.
_RUN = """
import inspect, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_card()
if "checked_kn" in inspect.signature(c.phase_serve).parameters:
    from repro_torch.configs import get_config
    c.phase_serve(set(c.serve_gemm_shapes(get_config("smollm_360m"))))
else:
    c.phase_serve()
"""

_LINE = re.compile(r"\[serve\] (\S+): prefill .*\(([\d.]+) tok/s\); "
                   r"decode .*\(([\d.]+) tok/s\)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    readings = {}   # (checkout, mode, phase) -> [tokens/s]
    for i in range(args.pairs):
        order = [("parent", args.parent), ("change", args.change)]
        for name, root in (order if i % 2 == 0 else order[::-1]):
            proc = subprocess.run([sys.executable, "-c", _RUN], cwd=root,
                                  capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                sys.exit(f"serve_ab: {name} run {i} failed:\n"
                         f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            for mode, pre, dec in _LINE.findall(proc.stdout):
                print(f"[ab] pair {i} {name} {mode}: prefill {pre} tok/s, "
                      f"decode {dec} tok/s", flush=True)
                readings.setdefault((name, mode, "prefill"), []).append(
                    float(pre))
                readings.setdefault((name, mode, "decode"), []).append(
                    float(dec))
    for (name, mode, phase), vals in sorted(readings.items()):
        print(f"[ab] {name} {mode} {phase}: median "
              f"{statistics.median(vals):.1f} tok/s over {vals}")


if __name__ == "__main__":
    main()
