"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an
H100 for the numbers in PERF.md).  The script builds the split-GEMM
kernels from ``src/repro_torch/kernels/csrc`` with nvcc, then:

1. prints the card's name and power limit and the kernels' build;
2. holds K1 and K2 bitwise (hi and lo, tolerance 0) against their
   plain PyTorch versions on the card, at the listed shapes and split
   counts, K2 from f32 and from f64 sources;
3. runs the accuracy ladder at 4096^2 in float64 through
   ``pallas_int8_s`` for s = 3..9;
4. runs the MuST Green's-function contour (n=4096, block=256, 9
   energies) through ``dgemm`` and the kernel modes — the port's main
   path — with the launch counters zeroed just before and read just
   after, and checks the Table-1 ladder, the Figure-1 peak and the
   launch counts; then profiles one energy point of it for the
   device's busy share;
5. times each kernel, its plain version, its bound and the library
   call it stands in for at the MuST shape (256, 256, 4096), s=6;
6. prints one JSON line describing every ported kernel, the card line,
   and last ``{"ok": true, "device": {...}}``.

Every phase that fails raises, so the script exits non-zero and prints
no result line.  TF32 is switched off for matmuls and cuDNN at start,
so every float32 product the script computes is full float32.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks from NVIDIA's data sheet (dense, at the 700 W limit).
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
FERMI = 0.72


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bits_equal(x, y):
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def phase_card():
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; "
          "allow_tf32 off (matmul and cuDNN)")
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    print(f"[build] {info['path']} built={info['built']} "
          f"in {time.perf_counter() - t0:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")


def phase_kernels_vs_plain(errs):
    from repro_torch.core.ozaki import slice_matrix
    from repro_torch.kernels import ops, slicing, tile_model

    gen = np.random.default_rng(0)
    shapes = [(37, 130, 51), (1, 129, 1), (100, 1100, 60), (256, 256, 4096)]
    for m, k, n in shapes:
        for s in (3, 6, 9):
            bk = tile_model.select_tiles(m, k, n, s).block_k
            for dtype in (torch.float32, torch.float64):
                a = torch.from_numpy(gen.standard_normal((m, k))).to(
                    "cuda", dtype)
                b = torch.from_numpy(gen.standard_normal((k, n))).to(
                    "cuda", dtype)
                if dtype == torch.float64:
                    a_sl, _ = slice_matrix(a, s, axis=1)
                    b_sl, _ = slice_matrix(b, s, axis=0)
                    got = ops.split_gemm(a_sl, b_sl, s, block_k=bk)
                    want = ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk)
                    check("split_gemm", got, want, errs, (m, k, n, s))
                ah, al, _ = slicing.to_operand_pair(a, axis=1)
                bh, bl, _ = slicing.to_operand_pair(b, axis=0)
                got = ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk)
                want = ops.split_gemm_fused_plain(ah, al, bh, bl, s,
                                                  block_k=bk)
                check("split_gemm_fused", got, want, errs,
                      (m, k, n, s, str(dtype)))
    torch.cuda.synchronize()
    print(f"[kernels] K1 and K2 bitwise equal to their plain versions on "
          f"{len(shapes)} shapes x s in (3, 6, 9) "
          f"(K2 from f32 and f64 sources)")

    # The scales on the card against the CPU, where the port equals the
    # reference: log rounding decides sigma at exact powers of two.
    from repro_torch.core.ozaki import _pow2_scale
    vals = [2.0 ** j * f for j in range(-60, 61)
            for f in (1.0, 1 - 2.0 ** -52, 1 + 2.0 ** -52)]
    x = torch.tensor(vals, dtype=torch.float64).reshape(-1, 1)
    on_card = _pow2_scale(x.cuda(), 1).cpu()
    diff = int((on_card != _pow2_scale(x, 1)).sum())
    print(f"[kernels] _pow2_scale card vs CPU at powers of two and "
          f"neighbours: {diff} of {len(vals)} differ")


def check(name, got, want, errs, case):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    errs[name] = max(errs.get(name, 0.0), err)
    if not all(bits_equal(g, w) for g, w in zip(got, want)):
        bad = (got[0] != want[0]).nonzero()
        total = (got[0].double() + got[1].double()
                 - want[0].double() - want[1].double()).abs().max()
        fail(f"{name} differs from its plain version at {case}: "
             f"max abs err {err}, {len(bad)} hi elements differ "
             f"(first {bad[:4].tolist()}), |hi+lo| differs by "
             f"{float(total)}")


def phase_ladder(size=4096):
    from repro_torch.core import get_backend

    gen = np.random.default_rng(1)
    a = torch.from_numpy(gen.standard_normal((size, size))).cuda()
    b = torch.from_numpy(gen.standard_normal((size, size))).cuda()
    exact = a @ b
    denom = a.abs() @ b.abs()
    floor = 1e-13
    errs = []
    for s in range(3, 10):
        t0 = time.perf_counter()
        c = get_backend(f"pallas_int8_{s}")(a, b, out_dtype=torch.float64)
        err = float(((c - exact).abs() / denom).max())
        torch.cuda.synchronize()
        errs.append(err)
        print(f"[ladder] {size}^2 pallas_int8_{s}: max rel err {err:.3e} "
              f"({time.perf_counter() - t0:.3f} s)")
    for s, (prev, cur) in enumerate(zip(errs, errs[1:]), start=4):
        if prev > floor and not cur < prev:
            fail(f"ladder does not fall at s={s}: {errs}")
        if prev <= floor and cur > floor:
            fail(f"ladder leaves the f64 floor at s={s}: {errs}")
    if errs[-1] > floor:
        fail(f"ladder never reaches the f64 floor {floor}: {errs}")


def phase_must(n=4096, block=256, n_energies=9):
    # Nine energies put E_f = 0.72 on the contour (the midpoint of
    # [0.12, 1.32]).  With an even count the two nearest points sit
    # 2 sigma of the state cluster away on either side, see none of
    # it, and the error profile is flat within 2x (PERF.md, Findings).
    from repro_torch.apps import must
    from repro_torch.kernels import ops

    cfg = must.MustConfig(n=n, block=block, n_energies=n_energies)
    system = must.build_system(cfg)
    z, _ = must.contour_points(cfg)
    dist = np.abs(z.real - FERMI)
    nearest = set(np.flatnonzero(dist <= dist.min() + 1e-12).tolist())
    calls = must.block_gemm_calls(cfg) * cfg.n_energies * 4
    modes = ["dgemm", "pallas_int8_3", "pallas_int8_6", "pallas_int8_9",
             "pallas_int8_6:fused"]
    results = {}
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    for mode in modes:
        t0 = time.perf_counter()
        results[mode] = must.run_contour(cfg, mode, system)
        torch.cuda.synchronize()
        print(f"[must] n={cfg.n} block={cfg.block} "
              f"energies={cfg.n_energies} {mode}: "
              f"{time.perf_counter() - t0:.2f} s")
    launches = dict(ops.LAUNCHES)
    ref = results["dgemm"]
    table = {}
    for mode in modes[1:]:
        e = must.relative_errors(ref, results[mode])
        table[mode] = e
        print(f"[must] {mode}: max_real {e['max_real']:.3e} "
              f"max_imag {e['max_imag']:.3e} d_etot {e['d_etot']:.3e} "
              f"d_ne {e['d_ne']:.3e} peak at E="
              f"{z[int(np.argmax(e['per_z_real']))].real:.4f}")
    ladder = [table[f"pallas_int8_{s}"]["max_real"] for s in (3, 6, 9)]
    if not ladder[0] > ladder[1] > ladder[2]:
        fail(f"MuST Table-1 max_real does not fall with s: {ladder}")
    for mode in ("pallas_int8_6", "pallas_int8_9", "pallas_int8_6:fused"):
        peak = int(np.argmax(table[mode]["per_z_real"]))
        if peak not in nearest:
            fail(f"{mode} error peaks at energy index {peak}, not at the "
                 f"energies nearest E_f ({sorted(nearest)})")
    expected = {"split_gemm": 3 * calls, "split_gemm_fused": calls}
    print(f"[must] launches {launches}, expected {expected} "
          f"({must.block_gemm_calls(cfg)} block GEMMs per energy x "
          f"{cfg.n_energies} energies x 4 real GEMMs per mode)")
    if launches != expected:
        fail(f"launch counts {launches} != expected {expected}")
    for mode, res in results.items():
        if not (np.isfinite(res["g_diag"]).all()
                and res["g_diag"].shape == (cfg.n_energies, cfg.n)):
            fail(f"{mode}: G diagonal not finite or of the wrong shape")
    return launches


def phase_profile(n=4096, block=256):
    """Device busy share of one energy point of pallas_int8_6."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps import must
    from repro_torch.kernels import ops

    cfg = must.MustConfig(n=n, block=block)
    h = torch.as_tensor(must.build_system(cfg)["H"], device="cuda")
    m_mat = complex(FERMI + 1j * cfg.eta) * torch.eye(
        n, dtype=torch.complex128, device="cuda") - h
    gemm = must._make_gemm("pallas_int8_6")
    saved = dict(ops.LAUNCHES)
    must._blocked_inverse(m_mat, block, gemm)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        must._blocked_inverse(m_mat, block, gemm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for key, val in saved.items():
        ops.LAUNCHES[key] = val
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        print("[profile] no device time in the trace: busy share not "
              "measured")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"[profile] one energy (E_f), pallas_int8_6, n={n}: wall "
          f"{wall:.3f} s (profiled), device busy {busy:.3f} s, idle share "
          f"{1 - busy / wall:.3f}")
    for e in top:
        print(f"[profile]   {e.key[:70]}: "
              f"{e.self_device_time_total / 1e3:.1f} ms over {e.count} calls")


def phase_timings(errs, launches, m=256, k=256, n=4096):
    from repro_torch.core.ozaki import num_pair_gemms, slice_matrix
    from repro_torch.kernels import ops, slicing, tile_model

    s = 6
    pairs = num_pair_gemms(s)
    bk = tile_model.select_tiles(m, k, n, s).block_k
    gen = np.random.default_rng(2)
    a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
    b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_sl, _ = slice_matrix(b, s, axis=0)
    ah, al, _ = slicing.to_operand_pair(a, axis=1)
    bh, bl, _ = slicing.to_operand_pair(b, axis=0)
    saved = dict(ops.LAUNCHES)

    library_ms = timed(lambda: a @ b, 20)
    ia = [a_sl[i].contiguous() for i in range(s)]
    ib = [b_sl[j].contiguous() for j in range(s)]
    ii, jj = tile_model.pair_schedule(s)
    int_mm_ms = timed(lambda: [torch._int_mm(ia[i], ib[j])
                               for i, j in zip(ii, jj)], 10)
    ops_count = 2 * m * n * k * pairs
    rows = []
    specs = [
        ("split_gemm", "src/repro/kernels/ops.py:186",
         lambda: ops.split_gemm(a_sl, b_sl, s, block_k=bk),
         lambda: ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk),
         s * (m * k + k * n) + 8 * m * n),
        ("split_gemm_fused", "src/repro/kernels/ops.py:252",
         lambda: ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk),
         lambda: ops.split_gemm_fused_plain(ah, al, bh, bl, s, block_k=bk),
         8 * (m * k + k * n) + 8 * m * n),
    ]
    for name, replaces, kernel, plain, nbytes in specs:
        ms = timed(kernel, 50)
        plain_ms = timed(plain, 5)
        t_ops = ops_count / PEAK_INT8_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/split_gemm.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms})
        print(f"[time] {name} at (m,k,n)=({m},{k},{n}) s={s}: "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({rows[-1]['bound_by']}), f64 "
              f"torch.matmul {library_ms:.4f} ms, {pairs} torch._int_mm "
              f"{int_mm_ms:.4f} ms, {ops_count / ms / 1e9:.1f} int8 TOPS")
    for key, val in saved.items():
        ops.LAUNCHES[key] = val
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_card()
    errs = {}
    phase_kernels_vs_plain(errs)
    phase_ladder()
    launches = phase_must()
    phase_profile()
    rows = phase_timings(errs, launches)
    print(json.dumps({"kernels": rows}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
