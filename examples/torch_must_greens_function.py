"""MuST G(z) reproduction on the PyTorch port: Table 1 + Figure 1
analogues.

The port's ``examples/must_greens_function.py``, on
``repro_torch.apps.must``:
  * max relative error of Re/Im G(z) for fp64_int8_3..9 vs dgemm
    (Table 1);
  * the per-energy error profile along the contour, showing the
    isolated error peak near the Fermi energy (0.72 Ryd) where G has
    poles, and the decay away from it (Figure 1);
  * contour-integrated observables (total-energy/Fermi analogues)
    converging to the FP64 values by s=5-6.

It runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_must_greens_function.py [--n 512]
  PYTHONPATH=src python examples/torch_must_greens_function.py \\
      --device cpu --n 96 --block 24 --energies 8 --splits 3 6 9

Writes runs/must_torch/table1.csv and runs/must_torch/fig1.csv.
"""

import argparse
from pathlib import Path

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.apps import must as MU


def main(argv=None):
    """Returns ``{mode: relative_errors(...)}`` and the dgemm run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--block", type=int, default=96)
    ap.add_argument("--energies", type=int, default=24)
    ap.add_argument("--splits", type=int, nargs="*",
                    default=[3, 4, 5, 6, 7, 8, 9])
    ap.add_argument("--outdir", default="runs/must_torch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = MU.MustConfig(n=args.n, block=args.block,
                        n_energies=args.energies)
    system = MU.build_system(cfg)
    print(f"[must] n={cfg.n} block={cfg.block} energies={cfg.n_energies} "
          f"states near E_f={cfg.fermi} on {dev.type}")
    ref = MU.run_contour(cfg, "dgemm", system, device=dev)
    print(f"[must] dgemm: Etot={ref['etot']:.6f}  Ne={ref['ne']:.6f}")

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    table_rows = ["mode,max_real,max_imag,etot,d_etot,ne,d_ne"]
    fig_rows = ["mode,re_z,im_z,err_real,err_imag"]

    print(f"{'mode':>14s} {'max_real':>10s} {'max_imag':>10s} "
          f"{'Etot':>12s} {'dEtot':>9s}")
    errors = {}
    for s in args.splits:
        mode = f"fp64_int8_{s}"
        test = MU.run_contour(cfg, mode, system, device=dev)
        err = errors[mode] = MU.relative_errors(ref, test)
        print(f"{mode:>14s} {err['max_real']:10.2e} {err['max_imag']:10.2e}"
              f" {test['etot']:12.6f} {err['d_etot']:9.2e}")
        table_rows.append(
            f"{mode},{err['max_real']:.3e},{err['max_imag']:.3e},"
            f"{test['etot']:.8f},{err['d_etot']:.3e},"
            f"{test['ne']:.8f},{err['d_ne']:.3e}")
        for z, er, ei in zip(ref["z"], err["per_z_real"],
                             err["per_z_imag"]):
            fig_rows.append(f"{mode},{z.real:.5f},{z.imag:.5f},"
                            f"{er:.3e},{ei:.3e}")
        # Figure-1 pattern: where does the error peak?
        zpk = ref["z"][np.argmax(err["per_z_real"])]
        print(f"{'':>14s} error peak at z = {zpk.real:+.3f}{zpk.imag:+.3f}j"
              f"  (Fermi energy {cfg.fermi})")

    (outdir / "table1.csv").write_text("\n".join(table_rows) + "\n")
    (outdir / "fig1.csv").write_text("\n".join(fig_rows) + "\n")
    print(f"[must] wrote {outdir}/table1.csv and fig1.csv")
    return errors, ref


if __name__ == "__main__":
    main()
