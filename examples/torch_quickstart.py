"""Quickstart of the PyTorch port: tunable-precision INT8 GEMM
emulation and automatic offload.

The port's ``examples/quickstart.py``, in four sections on
``repro_torch.core``:
  1. accuracy-vs-splits sweep of the emulated DGEMM (paper Table 1
     trend); the max relative error must fall strictly for s = 3..9;
  2. the PEAK-profiler analogue: enumerate the BLAS-3 sites of an
     *unmodified* torch function and offload them at a chosen
     precision, no code changes, then tune one site by its name;
  3. adaptive split selection (the paper's proposed dynamic tuning);
  4. the backend registry: every engine behind one spec string
     (``pallas_int8_6`` is kernel K1 on the card).

It runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (AdaptiveGemm, PrecisionPolicy, get_backend,
                              measure_splits, offload, ozaki_matmul,
                              predict_splits, site_report)


def _operands(seed, shape, dev, dtype=torch.float64):
    gen = np.random.default_rng(seed)
    return (torch.as_tensor(gen.standard_normal(shape), dtype=dtype,
                            device=dev),
            torch.as_tensor(gen.standard_normal(shape), dtype=dtype,
                            device=dev))


def accuracy_sweep(dev):
    """Returns the max relative error for s = 3..9."""
    print("=== 1. DGEMM emulation accuracy vs split count ===")
    a, b = _operands(0, (512, 512), dev)
    ref = a @ b
    denom = a.abs() @ b.abs()
    print(f"{'mode':>14s} {'max rel err':>12s}")
    errs = []
    for s in range(3, 10):
        c = ozaki_matmul(a, b, num_splits=s, accumulator="df32",
                         out_dtype=torch.float64)
        errs.append(float(((c - ref).abs() / denom).max()))
        print(f"  fp64_int8_{s:<2d} {errs[-1]:12.3e}")
    if not all(cur < prev for prev, cur in zip(errs, errs[1:])):
        raise SystemExit(f"[quickstart] the error does not fall strictly "
                         f"with s: {errs}")
    return errs


def automatic_offload(dev):
    print("\n=== 2. Automatic BLAS offload (no code changes) ===")

    def legacy_solver(a, b):  # pretend this is someone else's code
        x = torch.tanh(a @ b)
        for _ in range(2):
            x = x @ b / torch.linalg.norm(x)
        return torch.sum(x)

    a, b = _operands(1, (384, 384), dev, torch.float32)
    policy = PrecisionPolicy(default_splits=6, min_dim=256)
    print("BLAS-3 sites found by the interceptor:")
    for site in site_report(legacy_solver, policy)(a, b):
        print("  ", site)
    ref = legacy_solver(a, b)
    got = offload(legacy_solver, policy)(a, b)
    print(f"native={float(ref):.8f}  emulated={float(got):.8f}  "
          f"rel err={abs(float(got - ref)) / abs(float(ref)):.2e}")

    # The names printed above are stable policy keys: tune one site.
    tuned = PrecisionPolicy(default_splits=6, min_dim=256,
                            site_splits={"dot0": 9})
    print("per-site override (dot0 -> 9 splits):")
    for site in offload(legacy_solver, tuned).sites(a, b):
        print("  ", site)


def adaptive(dev):
    print("\n=== 3. Tunable precision: adaptive split selection ===")
    a, b = _operands(2, (256, 256), dev)
    for tol in (1e-4, 1e-8, 1e-12):
        s_pred = predict_splits(a, b, tol)
        s_meas, est = measure_splits(a, b, tol)
        print(f"  target {tol:.0e}: predicted s={s_pred}, "
              f"measured s={s_meas} (err est {est:.2e})")
    gemm = AdaptiveGemm(target_rel=1e-9)
    gemm(a, b, site="tau")
    print(f"  AdaptiveGemm chose s={gemm.sites['tau'].splits} for site 'tau'")


def backend_registry(dev):
    print("\n=== 4. One registry, every engine (spec strings) ===")
    a, b = _operands(3, (256, 256), dev)
    ref = a @ b
    denom = a.abs() @ b.abs()
    for spec in ("dgemm", "fp64_int8_4", "fp64_int8_8", "pallas_int8_6",
                 "adaptive:1e-9"):
        gemm = get_backend(spec)
        err = float(((gemm(a, b, out_dtype=torch.float64) - ref).abs()
                     / denom).max())
        print(f"  {spec:>14s}: max rel err {err:.2e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    errs = accuracy_sweep(dev)
    automatic_offload(dev)
    adaptive(dev)
    backend_registry(dev)
    print("[quickstart] OK")
    return errs


if __name__ == "__main__":
    main()
