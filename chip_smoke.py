"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an
H100 for the numbers in PERF.md).  The script builds the split-GEMM
kernels from ``src/repro_torch/kernels/csrc`` with nvcc, then:

1. prints the card's name and power limit and the kernels' build
   (registers, shared memory and spills of every compiled kernel);
2. holds K1, K2 and K3 bitwise (hi and lo, tolerance 0) against their
   plain PyTorch versions on the card, and K3 against K1, at the listed
   shapes and split counts, K2 from f32 and from f64 sources and also
   at s = 1, 2, 14, 16 on two of them; K1, K2 and K3 so at the GEMM
   shapes the serve phase gives K1 (every projection and MLP (k, n) of
   SmolLM-360M, m a full and a ragged wave: two and five k-tiles); and
   K1 under every plan ``tile_model.k1_plans`` gives, through both of
   its entries, at the MuST, LM, ragged and tiny shapes for s = 1, 2,
   3, 6, 9, 14, 16;
3. runs the accuracy ladder at 4096^2 in float64 through
   ``pallas_int8_s`` for s = 3..9;
4. runs the MuST Green's-function contour (n=4096, block=256, 9
   energies) through ``dgemm`` and the kernel modes — one main path —
   with the launch counters zeroed just before and read just after,
   and checks the Table-1 ladder, the Figure-1 peak and the launch
   counts; then profiles one energy point of ``pallas_int8_6`` and of
   ``pallas_int8_6:fused`` for the device's busy share and K1's and
   K2's share;
5. runs K3's path, the reference's v1/v2 A/B check: K3 (its gather
   kernel, then its split-GEMM kernel) against K1 at the MuST shape for
   s = 3, 6, 9, counters zeroed before and read after, with the traffic
   figures of ``tile_model.traffic``;
6. serves SmolLM-360M at full width (32 layers, random weights from a
   seed) through ``repro_torch.serve.Engine`` — the other main path —
   natively (``dgemm``) and through ``pallas_int8_6``: prefill and
   decode tokens/s on the card's clock, K1's launch count against the
   count the site report predicts, paged == dense greedy tokens, one
   emulated prefill wave profiled for the device's idle share and K1's
   device time, and the float64 LM's prefill logits ladder for s =
   3..9, once as the model computes (softmax and SwiGLU gate in
   float32, as the reference) and once with those float32 stages raised
   to float64, where the ladder shows the emulated GEMMs' own error;
7. times, after phases 8 and 9, K1 at the MuST shapes (256, 256, N), N =
   256 and 4096, for s = 3, 6, 9 and at SmolLM-360M's prefill and
   train-step GEMMs (m = 512) for s = 6,
   and K2 and K3 at (256, 256, 4096) for s = 3, 6, 9: each with its
   bound, the FP64 ``torch.matmul`` it stands in for, the pair products
   as ``torch._int_mm``, its device time with launches queued back to
   back (``device_ms``), and its plain version; K3's kernel alone on
   gathered copies beside its gather;
8. trains it: SmolLM-360M at full width through ``launch.train.main``,
   4 steps natively and 4 through ``pallas_int8_6``, the gradient
   emulated against native at each step, a kill-and-resume (at full
   width, 8 of the 32 layers), one profiled step of each, the native
   run's step-4 checkpoint kept for phase 14; then on meshes of processes that share the
   card over gloo (``phase_shard``): 2 steps at ``--mesh dp=2`` and at
   ``--mesh dp=1,tp=5``, K1 held bitwise at every new per-shard shape,
   each rank's K1 launches against its ``site_exec`` and the site
   report, the dp=2 sites ``shmap0/`` + the single device's, step 1's
   dp-reduced gradient against the single device's, the losses against
   the emulated run above, and the tp=5 sharded checkpoint restored on
   one device bit-equal to the ranks' final parameters; then serves
   phase 6's requests on such meshes (``phase_serve_shard``) through
   ``Engine(mesh=)`` and ``pallas_int8_6``: dp=2 paged and dense and
   dp=1,tp=5, K1 held bitwise at every new per-rank shape first, each
   rank's K1 launches against its ``site_exec`` and its
   ``prefill_sites``, its cache's blocks and kv heads, the same streams
   on every rank, equal to phase 6's up to any token whose phase-6
   top-2 logit gap is under ``SERVE_SHARD_MARGIN`` (exactly at dp=2),
   paged == dense, and each rank's tokens/s and peak memory printed;
   then the tp-heavy corner (``phase_mesh_large``): reduced_100m (12
   layers, d 1024, 16/8 heads, d_ff 2816, vocab 16384) at full width,
   2 steps through ``pallas_int8_6`` on one device and at ``--mesh
   dp=1,tp=8`` (8 ranks, 1 kv head each), K1 held bitwise at every new
   shape of both, launches against ``site_exec`` and the site report,
   the ranks' losses against the single device's, the 8-shard
   checkpoint restored on one device bit-equal to each rank's final
   parameters, and each rank's step-1 gradient under a drawn head
   against the single device's, cut to its blocks;
9. tunes it: calibrates the same train step through ``python -m
   repro_torch.tune``'s ``main`` (probe ``pallas_int8_6``, 2 batches),
   prints the solved split counts, holds K1 bitwise at every ((m, k,
   n), s) the plan launches, trains 4 steps under ``--plan`` (losses
   and gradients against native, K1's launches by split count against
   the site report, K1's device time per step beside the uniform
   run's) and serves phase 6's requests through ``Engine(plan=...)``;
10. observes it (``repro_torch.obs``): trains 4 full-width steps again
   with telemetry on by default, ``--metrics-port 0`` and
   ``--numerics-every 2``, scrapes ``/metrics`` while it trains, runs
   the obs CLI's ``report --check``, ``attrib`` and ``export`` over the
   run, holds the hook's executions against K1's launch counter and the
   site report, the attributed INT8 GEMMs, every numerics report
   within its budget and no synchronizing call added by the hook; then
   serves phase 6's requests through ``Engine(metrics=...,
   metrics_port=0)``, and prints telemetry's cost beside the runs
   without it;
11. warm-starts it: serves phase 6's requests twice, each from a fresh
   ``Engine(warm_cache_dir=build/warm_cache, metrics=...)``; the second
   run must read every offload decision back from disk (byte-identical
   files, no entry decided without one), launch K1 as phase 6 did, emit
   phase 6's streams, and pass ``obs report --check --expect-cache-hit``
   where the first fails it;
12. runs a float64 control-flow program through ``pallas_int8_6``: a
   3-trip ``while_loop`` of a 4096^2 product, a ``cond`` called both ways,
   a 3-operand einsum at the MuST widths and a user
   ``autograd.Function``; holds the site names and extents against the
   reference's (``CF_SITES``), K1's launches against the hook's count,
   the errors against the a-priori bound, the ``Function``'s opacity and
   zero gradient, and prints the loop's roofline
   (``repro_torch.analysis.roofline``) beside its measured time;
13. runs every torch entry point and einsum form the offload once
   missed or refused (``phase_entry_points``: ``tensordot``, ``inner``,
   ``linalg.matmul``, ``linalg.multi_dot``, ``chain_matmul``,
   ``baddbmm``, ``addbmm``, the in-place forms, einsum ellipses and
   implicit outputs) in float64 through ``pallas_int8_6`` at 4096^2:
   K1 held bitwise at the two shapes they add, each form's K1 launches
   against its sites and the hook, its result bitwise equal to the same
   product in a form handled before, its error at the 4096^2 ladder's
   s = 6 level; the vector forms and a repeated index held by name and
   gate reason;
14. runs the examples workflow (``phase_examples``): the port's
   ``examples/torch_*.py`` as processes of their own at the tiny preset
   (train, serve the checkpoint, tune a plan, train and serve under it,
   a warm restart passing ``obs report --expect-cache-hit`` and a live
   ``/metrics`` scrape, both with K1 on the prefill wave, ``obs report
   --all --check`` and ``export``), then ``python -m
   repro_torch.launch.serve``'s ``build`` and ``run`` serving
   SmolLM-360M at full width from phase 8's step-4 checkpoint with K1
   on its prefill wave (launches against the site report, streams
   against an in-process ``Engine``, tokens/s by CUDA events beside
   phase 6's), the
   quickstart's ladder and the MuST study's gates;
15. prints one JSON line describing every ported kernel (K1 once per
   timed shape, the plan's three most-launched pairs among them, the
   tp=8 ranks', the entry points' and the CLI's wave shapes), the card
   line, and last ``{"ok": true, "device": {...}}``.

Before the kernels it holds the seeded parameters (the reference's
``jax.random`` draws, ``repro_torch.models.prng``) card against CPU
bitwise and times the full-width init, and ``_pow2_scale`` card against
CPU bitwise at about a million amax values across the float64 exponent
range.

Every phase that fails raises, so the script exits non-zero and prints
no result line.

    python3 chip_smoke.py --k1-plans

holds K1 under every plan bitwise against its plain version at the timed
shapes and times each plan (the sweep ``tile_model.k1_plan``'s rule and
cost model come from).

    python3 chip_smoke.py --k1-ab PARENT_DIR CHANGE_DIR [PAIRS]
    python3 chip_smoke.py --fused-ab PARENT_DIR CHANGE_DIR [PAIRS]

compare two checkouts of the port on the card (for example ``git
archive`` of two commits unpacked into directories that ``.gitignore``
lists): pair i runs PARENT then CHANGE, pair i+1 CHANGE then PARENT (2
pairs by default), each in a process of its own from its checkout's
root, and print every run and the medians.  A ``--k1-ab`` run times K1
at the shapes of phase 7 (CUDA events and the profiler's device time),
the host time per call of K1's wrapper there and of
``ops.ozaki_matmul`` (slicing included) at the MuST shapes, over many
calls with no synchronize between them, the ``pallas_int8_6`` contour
(n=4096, block=256, 9 energies) on the host clock, and K1's device
time in one emulated SmolLM-360M prefill wave (2 x 256 tokens).  A ``--fused-ab`` run times K2 at (256, 256,
4096), s = 6, the ``pallas_int8_6:fused`` contour, and one profiled
energy point (E_f) of it: the device's busy time and K2's.  TF32 is
switched off for matmuls and cuDNN at start, so every float32 product
the script computes is full float32.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FERMI = 0.72
SPLITS = (3, 6, 9)
# K2 is also held at the fewest and the most splits it takes.
K2_EXTRA_SPLITS = (1, 2, 14, 16)
# K1 is held under every plan at these split counts.
K1_SPLITS = (1, 2, 3, 6, 9, 14, 16)
# The float64 LM's logits ladder (max relative error).  With the
# float32 softmax and gate it falls to float32 rounding and sits there,
# under LM_FLOOR.  With those stages in float64 it follows the GEMMs:
# on an H100 it fell 57-71x per split, 8.5e-4 (s=3) to 9.7e-13 (s=8)
# and 2.8e-13 (s=9) (PERF.md), so each split must buy 10x until it is
# under LM_FLOOR_F64_ISLANDS.
LM_FLOOR = 1e-6
LM_FLOOR_F64_ISLANDS = 1e-12
LM_FALL_F64_ISLANDS = 10.0


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


def device_ms(fn, reps=20):
    """Mean device milliseconds per call of ``fn`` with its launches
    queued back to back, whatever the host's time to issue them: a sleep
    kernel holds the stream while the host issues ``reps`` calls between
    two events, and the reading counts only if the first event was still
    pending when the host was done.  The sleep grows until it is; None
    (and a line saying so) when it never is, as for an ``fn`` that waits
    on the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 22
    for _ in range(6):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    print(f"[device-time] the host never issued {reps} calls ahead of the "
          f"card (last sleep {cycles // 4} cycles)", flush=True)
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bits_equal(x, y):
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def hold_ladder(errs, floor, what, fall=1.0):
    """Fail unless ``errs`` (s = 3, 4, ...) falls strictly, by more than
    ``fall`` times per split, until it is at or below ``floor``, stays
    there, and gets there."""
    for s, (prev, cur) in enumerate(zip(errs, errs[1:]), start=4):
        if prev > floor and not cur * fall < prev:
            fail(f"{what} does not fall {fall}x at s={s}: {errs}")
        if prev <= floor and cur > floor:
            fail(f"{what} leaves its floor {floor} at s={s}: {errs}")
    if errs[-1] > floor:
        fail(f"{what} never reaches its floor {floor}: {errs}")


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
    # ptxas -v: registers, static shared memory and spills per kernel
    # (K1 once per compiled plan: warpgroups, tile width, resident; K2
    # once per compiled capacity of held partials), and any
    # wgmma serialization ptxas reports.
    name = "?"
    for line in info["log"].splitlines():
        found = re.search(r"entry function '.*?"
                          r"(split_gemm(?:_fused|_v1)?_kernel|"
                          r"gather_pairs_kernel)"
                          r"(?:I((?:L[ib]\d+E)+)E)?", line)
        if found:
            name = found.group(1) + (
                "<" + ",".join(re.findall(r"L[ib](\d+)E", found.group(2)))
                + ">" if found.group(2) else "")
        elif ("registers" in line or "spill" in line or "error" in line
              or "wgmma" in line):
            print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")
    from repro_torch.kernels import tile_model
    print("[build] dynamic shared memory: split_gemm_fused_kernel "
          + ", ".join(f"s={s} {tile_model.fused_plan(s, 1).smem_bytes} B"
                      for s in (1, 6, 9, 16))
          + f"; split_gemm_v1_kernel {tile_model.V1_SMEM_BYTES} B; "
          "split_gemm_kernel (K1) "
          + ", ".join(f"{plan_label(p)} {p.smem_bytes} B" for p in
                      (tile_model.k1_plan(256, 256, 4096, s)
                       for s in SPLITS)))


def plan_label(plan):
    """K1 plan as tile/mode, e.g. ``64x64/resident``."""
    return (f"{plan.block_m}x{plan.block_n}/"
            f"{'resident' if plan.resident else 'streamed'}")


def serve_gemm_shapes(cfg):
    """(k, n) of the LM's projection and MLP GEMMs: q/o, k/v, gate/up,
    down."""
    d = cfg.d_model
    return sorted({(d, cfg.q_dim), (d, cfg.kv_dim), (cfg.q_dim, d),
                   (d, cfg.d_ff), (cfg.d_ff, d)})


def phase_kernels_vs_plain(errs):
    """Returns the (k, n) of SmolLM-360M's GEMMs held bitwise here."""
    from repro_torch.configs import get_config
    from repro_torch.core.ozaki import slice_matrix
    from repro_torch.kernels import ops, slicing, tile_model

    gen = np.random.default_rng(0)
    shapes = [(37, 130, 51), (1, 129, 1), (100, 1100, 60), (256, 256, 4096)]
    for m, k, n in shapes:
        extra = K2_EXTRA_SPLITS if (m, k, n) in ((100, 1100, 60),
                                                 (256, 256, 4096)) else ()
        for s in SPLITS + extra:
            bk = tile_model.select_tiles(m, k, n, s).block_k
            for dtype in (torch.float32, torch.float64):
                a = torch.from_numpy(gen.standard_normal((m, k))).to(
                    "cuda", dtype)
                b = torch.from_numpy(gen.standard_normal((k, n))).to(
                    "cuda", dtype)
                if dtype == torch.float64 and s in SPLITS:
                    a_sl, _ = slice_matrix(a, s, axis=1)
                    b_sl, _ = slice_matrix(b, s, axis=0)
                    got = ops.split_gemm(a_sl, b_sl, s, block_k=bk)
                    want = ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk)
                    check("split_gemm", got, want, errs, (m, k, n, s))
                    got3 = ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk)
                    want3 = ops.split_gemm_v1_plain(a_sl, b_sl, s,
                                                    block_k=bk)
                    check("split_gemm_v1", got3, want3, errs, (m, k, n, s))
                    check("split_gemm_v1 vs split_gemm", got3, got, {},
                          (m, k, n, s))
                    check_gather(a_sl, b_sl, s, errs, (m, k, n, s))
                ah, al, _ = slicing.to_operand_pair(a, axis=1)
                bh, bl, _ = slicing.to_operand_pair(b, axis=0)
                got = ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk)
                want = ops.split_gemm_fused_plain(ah, al, bh, bl, s,
                                                  block_k=bk)
                check("split_gemm_fused", got, want, errs,
                      (m, k, n, s, str(dtype)))
    torch.cuda.synchronize()
    print(f"[kernels] K1, K2 and K3 bitwise equal to their plain versions "
          f"and K3 to K1 on {len(shapes)} shapes x s in {SPLITS} "
          f"(K2 from f32 and f64 sources, and also at s in "
          f"{K2_EXTRA_SPLITS} on (100, 1100, 60) and (256, 256, 4096))")

    # The serve phase's K1 shapes: m = a full 2 x 256 wave and a ragged
    # one-row wave, (k, n) every offloaded site of the LM.
    kn = serve_gemm_shapes(get_config("smollm_360m"))
    for m in (512, 221):
        for k, n in kn:
            a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
            b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
            for s in SPLITS:
                bk = tile_model.select_tiles(m, k, n, s).block_k
                a_sl, _ = slice_matrix(a, s, axis=1)
                b_sl, _ = slice_matrix(b, s, axis=0)
                got = ops.split_gemm(a_sl, b_sl, s, block_k=bk)
                want = ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk)
                check("split_gemm", got, want, errs, (m, k, n, s))
                got3 = ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk)
                check("split_gemm_v1", got3, ops.split_gemm_v1_plain(
                    a_sl, b_sl, s, block_k=bk), errs, (m, k, n, s))
                check("split_gemm_v1 vs split_gemm", got3, got, {},
                      (m, k, n, s))
                check_gather(a_sl, b_sl, s, errs, (m, k, n, s))
                for src in (a.float(), a):
                    ah, al, _ = slicing.to_operand_pair(src, axis=1)
                    bh, bl, _ = slicing.to_operand_pair(b.to(src.dtype),
                                                        axis=0)
                    check("split_gemm_fused",
                          ops.split_gemm_fused(ah, al, bh, bl, s,
                                               block_k=bk),
                          ops.split_gemm_fused_plain(ah, al, bh, bl, s,
                                                     block_k=bk),
                          errs, (m, k, n, s, str(src.dtype)))
    torch.cuda.synchronize()
    print(f"[kernels] K1, K2 and K3 bitwise equal to their plain versions "
          f"and K3 to K1 at SmolLM-360M's GEMM shapes: m in (512, 221) x "
          f"(k, n) in {kn} x s in {SPLITS} (K2 from f32 and f64 "
          f"sources)")

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
    return set(kn)


def k1_shapes():
    """K1's shapes on the main paths: the MuST block GEMMs (256, 256, N),
    SmolLM-360M's prefill GEMMs at a full and a ragged wave, and ragged
    and tiny ones whose k is not a multiple of 16."""
    from repro_torch.configs import get_config

    kn = serve_gemm_shapes(get_config("smollm_360m"))
    return ([(256, 256, n) for n in (256, 512, 2048, 4096)]
            + [(m, k, n) for m in (512, 221) for k, n in kn]
            + [(37, 130, 51), (1, 129, 1), (100, 1100, 60)])


def phase_k1_plans(errs):
    """K1 bitwise against its plain version under every plan
    ``tile_model.k1_plans`` gives, through ``split_gemm`` and
    ``split_gemm_kmajor``, at ``k1_shapes()`` x ``K1_SPLITS``; the k-major
    slices equal the axis-0 slices transposed.  Returns the plans held."""
    from repro_torch.core.ozaki import slice_matrix
    from repro_torch.kernels import ops, tile_model

    gen = np.random.default_rng(6)
    held = set()
    for m, k, n in k1_shapes():
        a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
        b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
        for s in K1_SPLITS:
            bk = tile_model.select_tiles(m, k, n, s).block_k
            a_sl, _ = slice_matrix(a, s, axis=1)
            b_sl, sig = slice_matrix(b, s, axis=0)
            b_t, sig_t = slice_matrix(b.mT, s, axis=1)
            if not (b_t.is_contiguous() and torch.equal(
                    b_t, b_sl.transpose(1, 2)) and bits_equal(sig, sig_t)):
                fail(f"k-major slices of B differ at {(k, n, s)}")
            want = ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk)
            for plan in tile_model.k1_plans(m, k, n, s, bk):
                case = (m, k, n, s, plan_label(plan))
                check("split_gemm", ops.split_gemm_kmajor(
                    a_sl, b_t, s, block_k=bk, plan=plan), want, errs, case)
                check("split_gemm", ops.split_gemm(
                    a_sl, b_sl, s, block_k=bk, plan=plan), want, errs, case)
                held.add((plan.block_m, plan.block_n, plan.resident))
    torch.cuda.synchronize()
    print(f"[kernels] K1 bitwise equal to its plain version under every "
          f"plan ({len(held)} tile/mode pairs) through split_gemm and "
          f"split_gemm_kmajor, at {len(k1_shapes())} shapes x s in "
          f"{K1_SPLITS}; k-major slices of B == the axis-0 slices "
          f"transposed, contiguous, same sigma")
    return held


def check(name, got, want, errs, case):
    """Fail unless ``got`` and ``want`` (hi, lo) agree to the bit."""
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


def check_gather(a_sl, b_sl, s, errs, case):
    """Fail unless K3's gather kernel writes its plain version's bytes."""
    from repro_torch.kernels import ops

    got = ops.gather_pairs_kmajor(a_sl, b_sl, s)
    want = ops.gather_pairs_kmajor_plain(a_sl, b_sl, s)
    err = max(int((g.int() - w.int()).abs().max()) for g, w in
              zip(got[:2], want[:2]))
    errs["gather_pairs_kmajor"] = max(errs.get("gather_pairs_kmajor", 0),
                                      err)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        fail(f"gather_pairs_kmajor differs from its plain version at "
             f"{case}: max abs err {err}")


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
    hold_ladder(errs, floor, f"{size}^2 ladder")
    return errs


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
    expected = {"split_gemm": 3 * calls, "split_gemm_fused": calls,
                "split_gemm_v1": 0, "gather_pairs_kmajor": 0}
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


def _device_summary(prof, wall, match, tag, top=6):
    """Read a CUDA profile of ``wall`` seconds: print its ``top`` kernels
    under ``[tag]`` and return the device's busy seconds, its idle share
    and the seconds and launches of the events whose name holds
    ``match``; None (and a line saying so) when the trace holds no
    device time."""
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        print(f"[{tag}] no device time in the trace: idle share not "
              "measured")
        return None
    found = [e for e in events if match in e.key]
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{tag}]   {e.key[:70]}: "
              f"{e.self_device_time_total / 1e3:.1f} ms over {e.count} calls")
    return dict(busy=busy, idle=1 - busy / wall,
                kern=sum(e.self_device_time_total for e in found) / 1e6,
                calls=sum(e.count for e in found))


def phase_profile(mode, n=4096, block=256, n_energies=9):
    """Device busy share of one energy point of ``mode``, and the share
    of the device time its kernel (K1, or K2 for ``:fused``) takes, with
    its extrapolation to the contour's ``n_energies`` energies."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.apps import must
    from repro_torch.kernels import ops

    cfg = must.MustConfig(n=n, block=block)
    h = torch.as_tensor(must.build_system(cfg)["H"], device="cuda")
    m_mat = complex(FERMI + 1j * cfg.eta) * torch.eye(
        n, dtype=torch.complex128, device="cuda") - h
    gemm = must._make_gemm(mode)
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
    label, key = (("K2", "split_gemm_fused") if mode.endswith(":fused")
                  else ("K1", "split_gemm_kernel"))
    print(f"[profile] one energy (E_f), {mode}, n={n}: wall "
          f"{wall:.3f} s (profiled); its top kernels:")
    got = _device_summary(prof, wall, key, "profile")
    if got is None:
        return
    kern_s, busy = got["kern"], got["busy"]
    print(f"[profile] {mode}: device busy {busy:.3f} s, idle share "
          f"{got['idle']:.3f}; {label} {kern_s * 1e3:.1f} ms over "
          f"{got['calls']} launches, {kern_s / busy:.3f} of the device "
          f"time, {kern_s / wall:.3f} of the wall; x {n_energies} energies "
          f"= {kern_s * n_energies:.2f} s of {label} per contour")


def phase_v1_ab(errs, m=256, k=256, n=4096):
    """K3's path: the reference's v1 == v2 A/B check and traffic row."""
    from repro_torch.core.ozaki import slice_matrix
    from repro_torch.kernels import ops, tile_model

    gen = np.random.default_rng(4)
    a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
    b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
    k1 = {}
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    for s in (3, 6, 9):
        a_sl, _ = slice_matrix(a, s, axis=1)
        b_sl, _ = slice_matrix(b, s, axis=0)
        bk = tile_model.select_tiles(m, k, n, s).block_k
        got = ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk)
        saved = dict(ops.LAUNCHES)
        k1[s] = ops.split_gemm(a_sl, b_sl, s, block_k=bk)
        ops.LAUNCHES.update(saved)  # the comparison's K1 launch
        check("split_gemm_v1 vs split_gemm", got, k1[s], {}, (m, k, n, s))
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches != {"split_gemm": 0, "split_gemm_fused": 0,
                    "split_gemm_v1": 3, "gather_pairs_kmajor": 3}:
        fail(f"K3 path launch counts {launches}")
    t = tile_model.traffic(m, k, n, 6)
    if t.read_reduction != 3.5:
        fail(f"traffic read_reduction {t.read_reduction} != (s+1)/2")
    print(f"[v1] K3 == K1 bitwise at (m,k,n)=({m},{k},{n}), s in (3, 6, 9); "
          f"launches {launches}")
    print(f"[v1] traffic at s=6 (64x64 CTA tile, block_k "
          f"{tile_model.block_k_for(k)}): slice_read_bytes_v1 "
          f"{t.slice_read_bytes_v1}, slice_read_bytes_v2 "
          f"{t.slice_read_bytes_v2}, read_reduction {t.read_reduction}, "
          f"total_v1 {t.total_v1}, total_v2 {t.total_v2}")
    return launches


def _timed_runner(runner):
    """Wrap a runner's wave and tick with CUDA events; returns the
    record they fill (device ms, real tokens, the shapes and the pieces'
    slots of the waves it ran, the ticks it ran).  Under a mesh a wave
    or tick with no row on the runner's rank runs no program and is not
    counted, and its tokens are the rank's."""
    rec = {"prefill_ms": 0.0, "decode_ms": 0.0, "prefill_tokens": 0,
           "decode_tokens": 0, "waves": [], "ticks": 0, "wave_ms": [],
           "wave_tokens": [], "wave_slots": []}
    mine = runner.kv.local_slots
    wave, tick = runner.prefill_wave, runner.decode_tick

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed_wave():
        start, stop = events()
        start.record()
        res = wave()
        stop.record()
        stop.synchronize()
        if res is not None and res.rows:
            rec["prefill_ms"] += start.elapsed_time(stop)
            rec["prefill_tokens"] += res.real_tokens
            rec["waves"].append((res.rows, res.width))
            rec["wave_ms"].append(start.elapsed_time(stop))
            rec["wave_tokens"].append(res.real_tokens)
            rec["wave_slots"].append([slot for slot, _, _ in res.pieces])
        return res

    def timed_tick(next_token, active, reqs):
        start, stop = events()
        start.record()
        out = tick(next_token, active, reqs)
        stop.record()
        stop.synchronize()
        if active[mine].any():
            rec["decode_ms"] += start.elapsed_time(stop)
            rec["decode_tokens"] += int(active[mine].sum())
            rec["ticks"] += 1
        return out

    runner.prefill_wave, runner.decode_tick = timed_wave, timed_tick
    return rec


def _smollm(dtype, seed, **overrides):
    """Full-width SmolLM-360M with random weights from ``seed``; the LM
    head, zero at init as in the reference, is drawn from a seeded
    normal (0.1 scale, as tests/test_serve.py does) so that greedy
    decoding does not emit token 0 forever."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("smollm_360m").replace(dtype=dtype, param_dtype=dtype,
                                            **overrides)
    model = Model(cfg, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        model.lm_head.copy_(0.1 * torch.randn(
            model.lm_head.shape, generator=gen, device="cuda",
            dtype=model.lm_head.dtype))
    return model


class _Gaps:
    """For every token an engine emits, the top-2 gap of the logits row
    it was sampled from over that row's largest |logit|: ``gaps[i][j]``
    for the ``j``-th token of ``reqs[i]``."""

    def __init__(self, eng, reqs):
        self.gaps = [[] for _ in reqs]
        index = {id(r): i for i, r in enumerate(reqs)}
        last = {}
        sample, emit = eng.runner._sample, eng._emit

        def recorded_sample(logits, rows):
            top = torch.topk(logits, 2, dim=-1).values
            rel = ((top[:, 0] - top[:, 1])
                   / logits.abs().amax(dim=-1)).cpu().tolist()
            for req, gap in zip(rows, rel):
                if req is not None:
                    last[id(req)] = gap
            return sample(logits, rows)

        def recorded_emit(slot, req, token):
            self.gaps[index[id(req)]].append(last[id(req)])
            emit(slot, req, token)

        eng.runner._sample, eng._emit = recorded_sample, recorded_emit


def phase_serve(checked_kn, seed=3, n_requests=8, max_new=16, splits=6,
                prompt_lengths=(128, 640), **overrides):
    """SmolLM-360M served natively and through pallas_int8_6 (K1).

    ``checked_kn``: the (k, n) at which phase 2 held K1 bitwise; every
    offloaded site must be one of them.  ``overrides`` (config fields)
    and ``prompt_lengths`` shrink it for a rehearsal; the smoke runs
    the defaults.
    """
    from collections import Counter

    from repro_torch.core import PrecisionPolicy, site_report
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, Request

    model = _smollm("float32", seed, **overrides)
    cfg = model.cfg
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.num_params():,} parameters "
          f"({cfg.dtype})")
    rng = np.random.default_rng(seed)
    lengths = rng.integers(prompt_lengths[0], prompt_lengths[1] + 1,
                           n_requests)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    engine_kw = dict(batch_slots=4, max_len=1024, block_size=16,
                     chunk_tokens=256, chunk_token_budget=512)
    policy = PrecisionPolicy(backend="pallas_int8", default_splits=splits)

    def serve(pol, layout="paged", reqs_prompts=prompts, new=max_new,
              gaps=None):
        eng = Engine(model, model.params, policy=pol, kv_layout=layout,
                     **engine_kw)
        rec = _timed_runner(eng.runner)
        reqs = [Request(prompt=p, max_new_tokens=new)
                for p in reqs_prompts]
        if gaps is not None:
            gaps.append(_Gaps(eng, reqs))
        eng.run(reqs)
        torch.cuda.synchronize()
        return eng, [r.out for r in reqs], rec

    # Warm-up: cuBLAS handles, the RoPE table, the offload path.
    serve(None, reqs_prompts=prompts[:1], new=2)
    serve(policy, reqs_prompts=prompts[:1], new=2)

    results = {}
    _, toks_native, rec = serve(None)
    results["dgemm"] = rec
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    eng, toks_emul, rec = serve(policy)
    launches = dict(ops.LAUNCHES)
    results[f"pallas_int8_{splits}"] = rec
    for mode, rec in results.items():
        pre = rec["prefill_tokens"] / (rec["prefill_ms"] / 1e3)
        dec = rec["decode_tokens"] / (rec["decode_ms"] / 1e3)
        print(f"[serve] {mode}: prefill {rec['prefill_tokens']} tokens in "
              f"{len(rec['waves'])} waves, {rec['prefill_ms']:.1f} ms "
              f"({pre:.1f} tok/s); decode {rec['decode_tokens']} tokens "
              f"in {rec['ticks']} ticks, {rec['decode_ms']:.1f} ms "
              f"({dec:.1f} tok/s)")
    for out in toks_native + toks_emul:
        if len(out) != max_new or not all(0 <= t < cfg.vocab_size
                                          for t in out):
            fail(f"served tokens out of range or short: {out}")

    # K1's launches against the site report: offloaded sites x trip
    # count (layers) per wave shape, plus the decode program's.
    shapes = Counter(rec["waves"])
    sites = {shape: [site for site in eng.prefill_sites(*shape)
                     if site.offloaded] for shape in shapes}
    per_shape = {shape: sum(site.mult for site in found)
                 for shape, found in sites.items()}
    kn = {(site.k, site.n) for found in sites.values() for site in found}
    if not kn <= checked_kn:
        fail(f"offloaded (k, n) {sorted(kn - checked_kn)} not held bitwise "
             f"in phase 2 ({sorted(checked_kn)})")
    slots = engine_kw["batch_slots"]
    with torch.no_grad():
        decode_sites = site_report(model.decode_step_paged, policy)(
            model.params, eng.cache,
            torch.zeros(slots, dtype=torch.int32, device="cuda"),
            torch.ones(slots, dtype=torch.bool, device="cuda"))
    per_tick = sum(site.mult for site in decode_sites if site.offloaded)
    predicted = (sum(per_shape[sh] * count for sh, count in shapes.items())
                 + per_tick * rec["ticks"])
    print(f"[serve] K1 launches {launches['split_gemm']}, predicted "
          f"{predicted} from the site report (wave shapes {dict(shapes)}, "
          f"offloaded sites x layers per shape {per_shape}, "
          f"{per_tick} per decode tick x {rec['ticks']} ticks)")
    if launches != {"split_gemm": predicted, "split_gemm_fused": 0,
                    "split_gemm_v1": 0, "gather_pairs_kmajor": 0} \
            or predicted == 0:
        fail(f"serve launch counts {launches} != predicted {predicted}")
    same = sum(a == b for a, b in zip(toks_native, toks_emul))
    print(f"[serve] dgemm and pallas_int8_{splits} greedy streams equal for "
          f"{same} of {n_requests} requests")

    # The dense run, whose times are not read, also records each emitted
    # token's top-2 logit gap (the shard serve phase's margin rule).
    gaps = []
    _, toks_dense, _ = serve(policy, layout="dense", gaps=gaps)
    if toks_dense != toks_emul:
        fail("paged and dense greedy tokens differ under "
             f"pallas_int8_{splits}")
    print(f"[serve] paged == dense: identical greedy tokens for all "
          f"{n_requests} requests under pallas_int8_{splits}")

    _profile_wave(eng, policy)
    del eng
    return launches, dict(tokens=toks_emul, rec=results[
        f"pallas_int8_{splits}"], prompts=prompts, engine_kw=engine_kw,
        splits=splits, seed=seed, max_new=max_new, gaps=gaps[0].gaps)


def _profile_wave(eng, policy, rows=2, width=256):
    """Device busy share of one emulated prefill wave, and K1's device
    time in it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import offload
    from repro_torch.kernels import ops

    model, cache = eng.model, eng.cache
    table = torch.as_tensor(np.tile(eng.kv._table[:1], (rows, 1)),
                            device="cuda")
    tokens = torch.ones((rows, width), dtype=torch.int32, device="cuda")
    start = torch.zeros(rows, dtype=torch.int32, device="cuda")
    piece = torch.full((rows,), width, dtype=torch.int32, device="cuda")
    wave = offload(model.prefill_chunk_paged, policy)
    args = (model.params, cache["k"], cache["v"], table, tokens, start,
            piece)
    saved = dict(ops.LAUNCHES)
    with torch.no_grad():
        wave(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            wave(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    ops.LAUNCHES.update(saved)
    print(f"[serve] one emulated prefill wave ({rows}x{width} tokens): "
          f"wall {wall:.3f} s (profiled); its top kernels:")
    got = _device_summary(prof, wall, "split_gemm_kernel", "serve", top=5)
    if got is not None:
        print(f"[serve] device busy {got['busy']:.3f} s, idle share "
              f"{got['idle']:.3f}; K1 {got['kern'] * 1e3:.1f} ms of device "
              f"time over {got['calls']} launches "
              f"({got['kern'] / got['busy']:.3f} of the busy time)")


def phase_lm_ladder(seed=3, tokens_per_row=256, **overrides):
    """Table-1 trend on the LM: float64 prefill logits through
    pallas_int8_s against native float64, s = 3..9.

    Run twice.  As the model computes (the reference's numerics: the
    attention softmax and the SwiGLU gate in float32 even for a float64
    model) the ladder falls until the GEMM error is below float32
    resolution and then sits at the float32 roundings it flips, held to
    ``LM_FLOOR``.  With those stages raised to float64
    (``lm.ISLAND_DTYPE``, for both the native and the emulated run) the
    ladder follows the emulated GEMMs alone, falling by more than
    ``LM_FALL_F64_ISLANDS`` per split down to ``LM_FLOOR_F64_ISLANDS``,
    so an error of K1 or of the offload at the LM's shapes shows at
    every s.
    """
    from repro_torch.core import PrecisionPolicy, offload
    from repro_torch.models import lm

    model = _smollm("float64", seed, **overrides)
    gen = np.random.default_rng(seed)
    t = tokens_per_row
    tokens = torch.from_numpy(gen.integers(
        1, model.cfg.vocab_size, (2, t)).astype(np.int32)).cuda()
    lengths = torch.tensor([t, t - t // 5], dtype=torch.int32,
                           device="cuda")
    ladders = {}
    for island, floor, fall in (
            (torch.float32, LM_FLOOR, 1.0),
            (torch.float64, LM_FLOOR_F64_ISLANDS, LM_FALL_F64_ISLANDS)):
        label = f"softmax/gate {str(island)[6:]}"
        lm.ISLAND_DTYPE = island
        try:
            with torch.no_grad():
                _, exact = model.prefill(model.params, tokens, lengths, t)
                errs = []
                for s in range(3, 10):
                    t0 = time.perf_counter()
                    _, got = offload(model.prefill, PrecisionPolicy(
                        backend="pallas_int8", default_splits=s))(
                        model.params, tokens, lengths, t)
                    torch.cuda.synchronize()
                    err = float((got - exact).abs().max()
                                / exact.abs().max())
                    errs.append(err)
                    print(f"[lm-ladder] smollm_360m float64 prefill logits, "
                          f"{label}, pallas_int8_{s}: max rel err "
                          f"{err:.3e} ({time.perf_counter() - t0:.2f} s)")
        finally:
            lm.ISLAND_DTYPE = torch.float32
        if not torch.isfinite(exact).all():
            fail(f"native float64 logits ({label}) are not finite")
        ladders[label] = errs
        hold_ladder(errs, floor, f"LM ladder ({label})", fall)
    del model
    return ladders


TRAIN_STEPS = 4
TRAIN_SPLITS = 6
# Per-step relative difference of the emulated run's loss from the
# native run's (pallas_int8_6 against native float32).
TRAIN_LOSS_BOUND = 1e-3
# Per leaf, max |emulated - native| / max |native| of the gradient at the
# parameters after one native step (pallas_int8_6 against native
# float32); step 1's gradient is the head's alone (its init is zero).
# Measured 1.6e-5 at full width (blocks.attn_norm, NVIDIA H100 80GB
# HBM3); a backward GEMM off in scale or wiring is off by O(1).
TRAIN_GRAD_BOUND = 1e-4
# Per leaf, the gradient under a solved plan against the same step with
# its GEMM sites in float64, at every step.  The plan solves for
# float32-level accuracy (a budget of 32 float32 ulps), so it is held to
# what float32 itself reaches there: native float32's own gradient is
# up to 6.4e-4 off the float64-GEMM step (step 3, blocks.wq); the plan's
# worst reading is 1.4e-4 (step 4, final_norm), both at full width on
# an NVIDIA H100 80GB HBM3 at 700 W.  A GEMM off in scale or wiring is
# off by O(1).
TUNE_GRAD_BOUND = 1e-3
TRAIN_DIR = os.path.join(ROOT, "build", "train_smoke")
# The native run's step-4 checkpoint (4.9 GB), kept from phase_train for
# phase_examples, which serves it through ``python -m
# repro_torch.launch.serve``'s ``main`` and deletes it.
SERVE_CKPT_DIR = os.path.join(ROOT, "build", "serve_cli_ckpt")
# Depth of the kill-and-resume check (full width, 8 of the 32 layers).
RESUME_LAYERS = 8


def train_argv(steps, ckpt_dir, backend="", overrides=None,
               metrics_dir="none", arch="smollm_360m"):
    """``launch.train``'s command line for the smoke: ``arch`` at full
    width (``overrides``, config fields, shrink it for a rehearsal),
    4 x 128 tokens a step, lr 3e-3 (the trainer's defaults), a
    checkpoint only at the end.  Telemetry is off unless
    ``metrics_dir`` says otherwise (``""``: the trainer's default, on,
    into ``<ckpt_dir>/metrics``), so the timed runs measure the
    trainer without it."""
    argv = ["--arch", arch, "--steps", str(steps), "--seq-len",
            "128", "--global-batch", "4", "--lr", "3e-3", "--seed", "0",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "1000",
            "--log-every", "1", "--metrics-dir", metrics_dir]
    if overrides:
        argv += ["--overrides", json.dumps(overrides)]
    return argv + (["--backend", backend] if backend else [])


def _train_setup(overrides):
    """The smoke's model, its parameters as the train step takes them,
    fresh AdamW state and the first batch, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import AdamW, SyntheticText

    cfg = get_config("smollm_360m").replace(**overrides)
    model = Model(cfg, device="cuda", seed=0)
    opt = AdamW(lr=3e-3)
    batch = torch.as_tensor(SyntheticText(cfg.vocab_size, 128, 4).batch(0),
                            device="cuda")
    return model, opt, model.params, opt.init(model.params), batch


def train_gemm_shapes(cfg, tokens):
    """(m, k, n) of every GEMM the emulated train step can offload: the
    forward (tokens, k, n) of each projection, MLP and head (k, n), and
    per forward site its two cotangents, dW (n, tokens, k) and dX
    (tokens, n, k)."""
    kn = serve_gemm_shapes(cfg) + [(cfg.d_model, cfg.vocab_size)]
    return sorted({shape for k, n in kn for shape in
                   ((tokens, k, n), (n, tokens, k), (tokens, n, k))})


def phase_k1_train_shapes(errs, shapes, s=TRAIN_SPLITS, tag="train"):
    """K1 bitwise against its plain version, through the k-major entry
    the main paths call, at every shape of ``shapes``: (m, k, n) at
    ``s`` splits, or ((m, k, n), s) pairs (a plan's)."""
    from repro_torch.core.ozaki import slice_matrix
    from repro_torch.kernels import ops, tile_model

    pairs = [shape if isinstance(shape[0], tuple) else (shape, s)
             for shape in shapes]
    gen = np.random.default_rng(7)
    saved = dict(ops.LAUNCHES)
    for (m, k, n), splits in pairs:
        a = torch.from_numpy(gen.standard_normal((m, k), np.float32)).cuda()
        b = torch.from_numpy(gen.standard_normal((k, n), np.float32)).cuda()
        bk = tile_model.select_tiles(m, k, n, splits).block_k
        a_sl, _ = slice_matrix(a, splits, axis=1)
        b_t, _ = slice_matrix(b.mT, splits, axis=1)
        check("split_gemm",
              ops.split_gemm_kmajor(a_sl, b_t, splits, block_k=bk),
              ops.split_gemm_kmajor_plain(a_sl, b_t, splits, block_k=bk),
              errs, (m, k, n, splits))
        del a, b, a_sl, b_t
    torch.cuda.synchronize()
    ops.LAUNCHES.update(saved)
    print(f"[{tag}] K1 bitwise equal to its plain version (k-major entry) "
          f"at the {len(pairs)} ((m, k, n), s) pairs {pairs}")


class _K1Shapes:
    """Records the (m, k, n) of every K1 launch while active, and the
    launches by split count."""

    def __init__(self):
        from collections import Counter

        from repro_torch.kernels import ops
        self.ops, self.seen, self.by_splits = ops, set(), Counter()

    def __enter__(self):
        launch = self.launch = self.ops._launch_k1

        def recorded(a_sl, b_sl_t, m, k, n, num_splits, *rest):
            self.seen.add((m, k, n))
            self.by_splits[num_splits] += 1
            return launch(a_sl, b_sl_t, m, k, n, num_splits, *rest)

        self.ops._launch_k1 = recorded
        return self

    def __exit__(self, *exc):
        self.ops._launch_k1 = self.launch


def _train_batch(cfg, step):
    from repro_torch.train import SyntheticText

    return torch.as_tensor(SyntheticText(cfg.vocab_size, 128, 4).batch(step),
                           device="cuda")


def _f64_gemm_policy(min_dim):
    """A policy whose GEMM sites run in float64 and round to their
    dtype: the train step as the emulation approximates it (an FP64
    product, rounded), the reference the gradient is held against."""
    from repro_torch.core import GemmBackend, PrecisionPolicy
    from repro_torch.core.backends import _FACTORIES, register_backend

    class F64Gemm(GemmBackend):
        def matmul(self, a, b, *, out_dtype=None, num_splits=None,
                   site="default"):
            out = out_dtype or torch.promote_types(a.dtype, b.dtype)
            return torch.matmul(a.double(), b.double()).to(out)

    if "f64gemm" not in _FACTORIES:
        register_backend("f64gemm", lambda spec, policy, splits, arg:
                         F64Gemm(spec, policy))
    return PrecisionPolicy(backend="f64gemm", min_dim=min_dim)


def phase_train_grads(model, opt, params, state, policy, tag="train",
                      f64_bound=TRAIN_GRAD_BOUND):
    """Every backward GEMM's wiring and scale on the card: at each step
    of the native run's ``TRAIN_STEPS`` steps, the gradient emulated
    under ``policy`` leaf by leaf (max|diff| / max|reference|; 0 where
    both are exactly zero, as step 1's blocks are under the zero head)
    against native float32 and against the same step with its GEMM
    sites in float64 (``_f64_gemm_policy``), and native float32 against
    the latter.  Held: the step-2 gradient against native within
    ``TRAIN_GRAD_BOUND``, and every step's against the float64-GEMM
    step within ``f64_bound``.  Native float32 is not held: from step 3
    on its
    own GEMM rounding, amplified by training, exceeds the bound (PERF.md,
    ROADMAP section 3, F3).  Returns the worst leaf per step and
    comparison."""
    from repro_torch.core import offload
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.train import checkpoint

    def paths(node, prefix):
        if isinstance(node, dict):
            return {k: paths(v, f"{prefix}{k}.") for k, v in node.items()}
        return prefix[:-1]

    def worst(got, want):
        rel = {}
        for name, g, w in zip(names, got, want):
            top, diff = float(w.abs().max()), float((g - w).abs().max())
            rel[name] = diff / top if top else (0.0 if diff == 0 else np.inf)
        leaf = max(rel, key=rel.get)
        return leaf, rel[leaf]

    names = checkpoint.tree_flatten(paths(params, ""))
    saved = dict(ops.LAUNCHES)
    step_fn = train.build_train_step(model, opt)
    emulated = offload(train.loss_and_grads, policy)
    exact = offload(train.loss_and_grads, _f64_gemm_policy(policy.min_dim))
    found = []
    for step in range(TRAIN_STEPS):
        batch = _train_batch(model.cfg, step)
        grads = {label: checkpoint.tree_flatten(fn(model, params, batch)[1])
                 for label, fn in (("native", train.loss_and_grads),
                                   ("emul", emulated), ("f64", exact))}
        got = {"emul-native": worst(grads["emul"], grads["native"]),
               "emul-f64": worst(grads["emul"], grads["f64"]),
               "native-f64": worst(grads["native"], grads["f64"])}
        found.append({key: val[1] for key, val in got.items()})
        print(f"[{tag}] step-{step + 1} gradient, worst leaf (max|diff| / "
              f"max|reference|): {policy.backend} against native "
              f"{got['emul-native'][0]} {got['emul-native'][1]:.3e}, "
              f"against float64 GEMMs {got['emul-f64'][0]} "
              f"{got['emul-f64'][1]:.3e}; native against float64 GEMMs "
              f"{got['native-f64'][0]} {got['native-f64'][1]:.3e} (bounds "
              f"{TRAIN_GRAD_BOUND} against native at step 2, {f64_bound} "
              "against float64 GEMMs)", flush=True)
        held = {"emul-f64": f64_bound}
        if step == 1:
            held["emul-native"] = TRAIN_GRAD_BOUND
        for key, (leaf, rel) in got.items():
            if not np.isfinite(rel) or rel > held.get(key, np.inf):
                fail(f"train-step gradient at step {step + 1}, {key}: "
                     f"{leaf} {rel} > {held.get(key)}")
        del grads
        params, state, _ = step_fn(params, state, batch)
    torch.cuda.synchronize()
    ops.LAUNCHES.update(saved)
    return found


def _median_after_first(ms):
    return float(np.median(ms[1:])) if len(ms) > 1 else float(ms[0])


def phase_train(errs, **overrides):
    """SmolLM-360M trained at full width through ``launch.train.main``,
    natively and through pallas_int8_6 (K1 in every forward and
    backward GEMM of the step), then killed and resumed on the card;
    returns K1's launches in the emulated run.  ``overrides`` (config
    fields) shrink the model for a rehearsal; the smoke runs none."""
    import shutil

    from repro_torch.core import PrecisionPolicy, offload
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    tokens = 4 * 128
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    spec = f"pallas_int8_{TRAIN_SPLITS}"
    policy = PrecisionPolicy(backend=spec, default_splits=TRAIN_SPLITS)
    model, opt, params, state, batch = _train_setup(overrides)
    cfg = model.cfg
    step = offload(train.build_train_step(model, opt), policy)
    sites = step.sites(params, state, batch)
    on = [site for site in sites if site.offloaded]
    fwd = [site for site in on
           if site.name.startswith("scan0/") or site.name == "dot0"]
    per_step = sum(site.batch * site.mult for site in on)
    print(f"[train] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.num_params():,} float32 parameters; "
          f"{tokens} tokens a step; {len(sites)} sites, {len(on)} offloaded "
          f"({sum(s.mult for s in fwd)} forward and "
          f"{per_step - sum(s.mult for s in fwd)} backward GEMMs a step "
          f"through K1)")
    held = train_gemm_shapes(cfg, tokens)
    offloaded = sorted({(site.m, site.k, site.n) for site in on})
    if not set(offloaded) <= set(held):
        fail(f"train-step shapes {sorted(set(offloaded) - set(held))} are "
             "not among the shapes K1 is held at")
    phase_k1_train_shapes(errs, held)
    phase_train_grads(model, opt, params, state, policy)
    del step, state, params, model
    torch.cuda.empty_cache()

    runs = {}
    for label, backend in (("native", ""), (spec, spec)):
        report = {}
        torch.cuda.reset_peak_memory_stats()
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        with _K1Shapes() as launched:
            t0 = time.perf_counter()
            losses = train.main(train_argv(
                TRAIN_STEPS, os.path.join(TRAIN_DIR, label), backend,
                overrides), device="cuda", report=report)
            torch.cuda.synchronize()
        runs[label] = dict(
            losses=losses, launches=dict(ops.LAUNCHES),
            shapes=launched.seen, step_ms=report["step_ms"],
            wall=time.perf_counter() - t0,
            peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        if label == "native":
            shutil.rmtree(SERVE_CKPT_DIR, ignore_errors=True)
            os.replace(os.path.join(TRAIN_DIR, label), SERVE_CKPT_DIR)
        shutil.rmtree(os.path.join(TRAIN_DIR, label), ignore_errors=True)
        print(f"[train] {label}: losses {losses}; step ms {report['step_ms']}"
              f" (median after the first "
              f"{_median_after_first(report['step_ms']):.1f}); peak "
              f"memory {runs[label]['peak']:.2f} GiB; main() "
              f"{runs[label]['wall']:.1f} s", flush=True)
    native, emul = runs["native"]["losses"], runs[spec]["losses"]
    for label, losses in (("native", native), (spec, emul)):
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            fail(f"{label} train losses {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{label} train loss does not fall: {losses}")
    rel = [abs(e - n) / abs(n) for e, n in zip(emul, native)]
    print(f"[train] per-step |emulated - native| / native loss: {rel} "
          f"(bound {TRAIN_LOSS_BOUND})")
    if max(rel) > TRAIN_LOSS_BOUND:
        fail(f"emulated train losses {emul} differ from native {native} "
             f"by more than {TRAIN_LOSS_BOUND}")
    launches = runs[spec]["launches"]
    want = {"split_gemm": TRAIN_STEPS * per_step, "split_gemm_fused": 0,
            "split_gemm_v1": 0, "gather_pairs_kmajor": 0}
    print(f"[train] K1 launches {launches['split_gemm']}, predicted "
          f"{want['split_gemm']} ({TRAIN_STEPS} steps x {per_step} from the "
          f"site report); shapes launched {sorted(runs[spec]['shapes'])}")
    if launches != want or runs["native"]["launches"]["split_gemm"]:
        fail(f"train launch counts {launches} (native run "
             f"{runs['native']['launches']}) != predicted {want}")
    if not runs[spec]["shapes"] <= set(held):
        fail(f"K1 launched at {sorted(runs[spec]['shapes'] - set(held))}, "
             "shapes it was not held at")

    # The kill-and-resume runs 8 of the 32 layers: three checkpoints of
    # the full depth (4.9 GB each) took 65 s of the smoke's time limit.
    phase_train_resume(spec, {"num_layers": RESUME_LAYERS, **overrides})
    k1_ms = phase_train_profile(spec, policy, overrides)
    return launches, dict(native_losses=native, emulated_losses=emul,
                          step_ms=_median_after_first(runs[spec]["step_ms"]),
                          k1_ms=k1_ms, site_names=[s.name for s in sites],
                          offloaded=len(on))


def phase_train_resume(spec, overrides):
    """Kill and resume on the card: 2 steps into A; 1 step into B, then
    B resumed to 2.  The two step-2 checkpoints must be the same bytes.
    Telemetry is on, the trainer's default: each run writes its events
    into ``metrics/`` beside the checkpoints, which the resume's
    checkpoint discovery passes over."""
    import shutil

    from repro_torch.launch import train

    dir_a = os.path.join(TRAIN_DIR, "resume_a")
    dir_b = os.path.join(TRAIN_DIR, "resume_b")
    t0 = time.perf_counter()
    train.main(train_argv(2, dir_a, spec, overrides, ""), device="cuda")
    train.main(train_argv(1, dir_b, spec, overrides, ""), device="cuda")
    resumed = train.main(train_argv(2, dir_b, spec, overrides, ""),
                         device="cuda")
    runs = sorted(os.listdir(os.path.join(dir_b, "metrics")))
    if runs != ["events-0000.jsonl", "events-0001.jsonl"]:
        fail(f"kill-and-resume: telemetry runs {runs} in {dir_b}/metrics, "
             "expected one per invocation")
    name = "step_00000002.npz"
    with open(os.path.join(dir_a, name), "rb") as fa, \
            open(os.path.join(dir_b, name), "rb") as fb:
        a, b = fa.read(), fb.read()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if len(resumed) != 1 or a != b:
        fail(f"kill-and-resume on the card: {name} differs "
             f"({len(a)} and {len(b)} bytes, {len(resumed)} resumed steps)")
    print(f"[train] kill-and-resume under {spec}: 2 steps == 1 + resumed 1, "
          f"{name} byte-identical ({len(a):,} bytes; "
          f"{time.perf_counter() - t0:.1f} s)")


def _profile_step(label, fn, args, tag="train-profile", host_time=False):
    """One timed and one profiled call of a train step ``fn``: wall time,
    peak memory (and, ``host_time``, the host's time in
    ``ops.ozaki_matmul`` during the timed call, read from its ``ozaki``
    spans), the device's busy time and idle share, and K1's device time
    and launches; returns K1's device ms (None without a trace)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    tracer = trace.Tracer()
    fn(*args)   # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with trace.activate(tracer) if host_time else contextlib.nullcontext():
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ozaki_us = [ev["dur"] for ev in tracer.events if ev["name"] == "ozaki"]
    host = {"s": sum(ozaki_us) / 1e6, "calls": len(ozaki_us)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    line = (f"[{tag}] {label} step: wall {wall * 1e3:.1f} ms "
            f"(unprofiled), peak memory {peak:.2f} GiB")
    if host["calls"]:
        line += (f", host time in ozaki_matmul {host['s'] * 1e3:.1f} ms "
                 f"over {host['calls']} calls "
                 f"({host['s'] / host['calls'] * 1e3:.3f} ms each)")
    print(line)
    print(f"[{tag}] {label} step profiled: wall {pwall:.3f} s; its top "
          "kernels:")
    got = _device_summary(prof, pwall, "split_gemm_kernel", tag)
    if got is None:
        return None
    print(f"[{tag}] {label}: device busy {got['busy']:.3f} s, idle share "
          f"{got['idle']:.3f}; K1 {got['kern'] * 1e3:.1f} ms over "
          f"{got['calls']} launches ({got['kern'] / got['busy']:.3f} of the "
          "busy time)")
    return got["kern"] * 1e3


def phase_train_profile(spec, policy, overrides):
    """One timed and one profiled step of each kind (``_profile_step``);
    returns the emulated step's K1 device ms."""
    from repro_torch.core import offload
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    model, opt, params, state, batch = _train_setup(overrides)
    native = train.build_train_step(model, opt)
    saved = dict(ops.LAUNCHES)
    args = (params, state, batch)
    _profile_step("native", native, args)
    k1_ms = _profile_step(spec, offload(native, policy), args,
                          host_time=True)
    ops.LAUNCHES.update(saved)
    return k1_ms


SHARD_STEPS = 2
SHARD_DIR = os.path.join(ROOT, "build", "shard_smoke")
# The meshes of the shard phase, each rank a process on the one card:
# dp=2 (each rank half the batch) and tp=5 (the only tp > 1 that divides
# SmolLM-360M's 15 heads, 5 kv heads and d_ff 2560).
SHARD_MESHES = (("dp=2", 2, 1), ("dp=1,tp=5", 1, 5))
SHARD_TIMEOUT = 600


def shard_gemm_shapes(cfg, tokens, tp):
    """(m, k, n) of every GEMM one rank of a dp x tp mesh offloads at the
    default min_dim (128): each projection, MLP and head GEMM at its
    per-shard (k, n) (q_dim/tp, kv_dim/tp, d_ff/tp; the head is
    replicated) over the rank's ``tokens`` rows, and its dW and dX."""
    d = cfg.d_model
    q, kv, f = cfg.q_dim // tp, cfg.kv_dim // tp, cfg.d_ff // tp
    kn = [(d, q), (d, kv), (q, d), (d, f), (f, d), (d, cfg.vocab_size)]
    return sorted({shape for k, n in kn for shape in
                   ((tokens, k, n), (n, tokens, k), (tokens, n, k))
                   if min(shape) >= 128})


def _sha256(tree):
    import hashlib

    from repro_torch.train.checkpoint import tree_flatten

    return [hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()
            for x in tree_flatten(tree)]


def _random_head(model, seed):
    """Draw ``model``'s LM head (zero at init) from ``seed``: 0.1 times a
    normal draw on the CPU, so every process gets the same bits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.lm_head.copy_(0.1 * torch.randn(
            model.lm_head.shape, generator=gen,
            dtype=model.lm_head.dtype).to(model.lm_head.device))


def _shard_grad_check(cfg, dev, policy, spec="dp=2", head_seed=None):
    """Step 1's gradient of a rank of ``spec`` (its parameter blocks),
    all-reduced over dp under ``policy``; on each rank of dp row 0,
    against the single-device emulated gradient of the same seed and
    batch cut to the rank's blocks, worst leaf (max|diff| /
    max|reference|).  ``head_seed`` draws the LM head
    (``_random_head``): under the zero head every layer's gradient is
    zero."""
    from repro_torch.core import offload, spmd_scope
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.shard import reduce_gradients, shard_batch, \
        shard_state, train_mesh_setup, train_state_specs
    from repro_torch.train import checkpoint

    model = Model(cfg, device=dev, seed=0)
    if head_seed is not None:
        _random_head(model, head_seed)
    mesh, _, _, _ = train_mesh_setup(spec, 4, cfg)
    dp, tp = mesh.shape["dp"], mesh.shape.get("tp", 1)
    specs = train_state_specs(cfg)[0]
    view = model.tp_view(mesh.groups["tp"]) if tp > 1 else model
    batch = _train_batch(cfg, 0).to(dev)

    def sharded_grads(params, rows):
        with spmd_scope(mesh):
            _, grads = train.loss_and_grads(view, params, rows)
            return reduce_gradients(grads, "dp", dp, mesh=mesh)

    got = offload(sharded_grads, policy)(shard_state(model.params, specs,
                                                     mesh),
                                         shard_batch(batch, mesh, "dp"))
    if mesh.coords["dp"]:
        return None
    _, want = offload(train.loss_and_grads, policy)(model, model.params,
                                                    batch)
    want = shard_state(want, specs, mesh)
    paths = checkpoint.tree_flatten(_leaf_names(model.params))
    rel = {}
    for name, g, w in zip(paths, checkpoint.tree_flatten(got),
                          checkpoint.tree_flatten(want)):
        top, diff = float(w.abs().max()), float((g - w).abs().max())
        rel[name] = diff / top if top else (0.0 if diff == 0 else np.inf)
    leaf = max(rel, key=rel.get)
    return leaf, rel[leaf]


def _leaf_names(node, prefix=""):
    """``node``'s tree with each leaf replaced by its dotted path."""
    if isinstance(node, dict):
        return {k: _leaf_names(v, f"{prefix}{k}.") for k, v in node.items()}
    return prefix[:-1]


def _shard_rank(mesh_spec, overrides, arch="smollm_360m"):
    """One rank of the shard phase (or of the big-mesh phase, ``arch``):
    (dp=2 only) the step-1 gradient check, then ``launch.train.main``
    with ``--mesh`` on this rank's process group, its K1 launches and
    shapes counted."""
    import torch.distributed as dist

    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.shard import bucket_stats
    from repro_torch.shard.launch import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device("cuda")
    spec = f"pallas_int8_{TRAIN_SPLITS}"
    model_cfg = _train_setup_cfg(overrides, arch)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    if mesh_spec in SHARD_GRAD_CHECKS:
        out["grad"] = _shard_grad_check(model_cfg, dev, PrecisionPolicy(
            backend=spec, default_splits=TRAIN_SPLITS), mesh_spec,
            SHARD_GRAD_CHECKS[mesh_spec])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    report = {}
    ckpt = os.path.join(SHARD_DIR, mesh_spec.replace(",", "_"))
    with _K1Shapes() as launched:
        losses = train.main(train_argv(SHARD_STEPS, ckpt, spec, overrides,
                                       arch=arch)
                            + ["--mesh", mesh_spec], device=dev,
                            report=report)
        torch.cuda.synchronize()
    params, _ = report["state"]
    on = [site for site in report["sites"] if site.offloaded]
    out.update(
        losses=losses, step_ms=report["step_ms"],
        peak=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=dict(ops.LAUNCHES), site_exec=report["site_exec"],
        shapes=sorted(launched.seen),
        names=[site.name for site in report["sites"]], offloaded=len(on),
        spmd=sorted({site.spmd for site in on}),
        predicted=SHARD_STEPS * sum(s.batch * s.mult for s in on),
        buckets=bucket_stats(params)[0], params=_sha256(params))
    return out


def _train_setup_cfg(overrides, arch="smollm_360m"):
    from repro_torch.configs import get_config
    return get_config(arch).replace(**overrides)


def phase_shard(errs, trained, **overrides):
    """The trainer on a mesh of processes sharing the card, over gloo:
    SmolLM-360M at full width through ``launch.train.main --mesh``,
    ``pallas_int8_6``, 2 steps at dp=2 and at dp=1,tp=5.  Held: K1
    bitwise at every new per-shard shape; each rank's K1 launches ==
    its ``site_exec`` == the site report's prediction, at shapes K1 was
    held at; the dp=2 sites ``shmap0/`` + the single-device names, as
    many offloaded; step 1's dp-reduced gradient against the
    single-device emulated one within ``TRAIN_GRAD_BOUND``; the losses
    against phase 8's emulated run within ``TRAIN_LOSS_BOUND``; the
    tp=5 checkpoint, restored on one device in this process and cut to
    each rank's blocks, bit-equal to the ranks' final parameters.  Returns
    K1's launches over every rank and the new per-shard shapes."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.shard.launch import spawn

    cfg = _train_setup_cfg(overrides)
    tokens = 4 * 128
    known = set(train_gemm_shapes(cfg, tokens))
    held = {spec: shard_gemm_shapes(cfg, tokens // dp, tp)
            for spec, dp, tp in SHARD_MESHES}
    new = sorted({shape for shapes in held.values() for shape in shapes}
                 - known)
    phase_k1_train_shapes(errs, new, tag="shard")
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    launches = {key: 0 for key in ops.LAUNCHES}
    for spec, dp, tp in SHARD_MESHES:
        t0 = time.perf_counter()
        ranks = spawn(_shard_rank, dp * tp, (spec, overrides),
                      device="cuda", timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        _hold_ranks("shard", spec, ranks, set(held[spec]) | known,
                    trained["emulated_losses"][:SHARD_STEPS], launches)
        print(f"[shard] {spec}: {dp * tp} ranks in {wall:.1f} s")
        if spec == "dp=2":
            want = ["shmap0/" + name for name in trained["site_names"]]
            for r in ranks:
                if r["names"] != want or r["offloaded"] != trained[
                        "offloaded"]:
                    fail(f"dp=2 rank {r['rank']} sites {r['names']} "
                         f"({r['offloaded']} offloaded) are not shmap0/ + "
                         f"the single device's ({trained['offloaded']})")
            leaf, rel = ranks[0]["grad"]
            print(f"[shard] dp=2 step-1 gradient all-reduced over dp "
                  f"against the single-device emulated step, worst leaf "
                  f"{leaf} {rel:.3e} (bound {TRAIN_GRAD_BOUND})")
            if not rel <= TRAIN_GRAD_BOUND:
                fail(f"dp=2 step-1 gradient {leaf} {rel}")
        else:
            _hold_tp_checkpoint("shard", cfg, spec, dp, tp, ranks)
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return launches, new


def _hold_ranks(tag, spec, ranks, held, want, launches):
    """Print each rank of a train mesh and hold it: K1 launches ==
    ``site_exec`` == the site report's prediction > 0, K1 launched only
    at shapes of ``held``, the losses within ``TRAIN_LOSS_BOUND`` of
    ``want`` (a single device's, same seed and batches).  Adds the
    ranks' launches into ``launches``."""
    for r in ranks:
        print(f"[{tag}] {spec} rank {r['rank']}: backend {r['backend']}"
              f", step ms {r['step_ms']}, peak memory {r['peak']:.2f} "
              f"GiB, K1 launches {r['launches']['split_gemm']} (site_exec"
              f" {r['site_exec']}, predicted {r['predicted']}), "
              f"{r['offloaded']} of {len(r['names'])} sites offloaded "
              f"{r['spmd']}, {r['buckets']} gradient buckets, losses "
              f"{r['losses']}", flush=True)
        for key, val in r["launches"].items():
            launches[key] += val
        if not (r["launches"]["split_gemm"] == r["site_exec"]
                == r["predicted"] > 0):
            fail(f"{tag} {spec} rank {r['rank']}: K1 launches "
                 f"{r['launches']} != site_exec {r['site_exec']} or "
                 f"the site report's {r['predicted']}")
        if not set(r["shapes"]) <= held:
            fail(f"{tag} {spec}: K1 launched at "
                 f"{sorted(set(r['shapes']) - held)}, shapes it was not "
                 "held at")
        rel = [abs(g - w) / abs(w) for g, w in zip(r["losses"], want)]
        print(f"[{tag}] {spec} rank {r['rank']}: |loss - single-device "
              f"emulated| / loss {rel} (bound {TRAIN_LOSS_BOUND})")
        if len(rel) != SHARD_STEPS or max(rel) > TRAIN_LOSS_BOUND:
            fail(f"{tag} {spec} losses {r['losses']} against the single"
                 f" device's {want}")


def _hold_tp_checkpoint(tag, cfg, spec, dp, tp, ranks):
    """The mesh's checkpoint of ``cfg``, restored on one device in this
    process and cut to each rank's blocks (``shard_state``), must be
    bit-equal to every rank's final parameters."""
    from repro_torch.models import Model
    from repro_torch.shard import Mesh, shard_state, train_state_specs
    from repro_torch.train import AdamW, checkpoint

    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    like = (model.params, AdamW().init(model.params))
    ckpt = os.path.join(SHARD_DIR, spec.replace(",", "_"))
    state = checkpoint.restore(ckpt, SHARD_STEPS, like)
    del like, model
    specs = train_state_specs(cfg)[0]
    for r in ranks:
        mesh = Mesh({"dp": dp, "tp": tp}, rank=r["rank"])
        got = _sha256(shard_state(state[0], specs, mesh))
        if got != r["params"]:
            fail(f"tp={tp} checkpoint restored on one device differs "
                 f"from rank {r['rank']}'s parameters")
    names = sorted(os.listdir(os.path.join(ckpt, f"step_{SHARD_STEPS:08d}")))
    print(f"[{tag}] {spec} checkpoint {names} restored on one "
          f"device: each rank's parameter blocks bit-equal to its "
          f"final ones ({time.perf_counter() - t0:.1f} s)")
    del state
    torch.cuda.empty_cache()


# The big-mesh phase: the tp-heavy corner on the card.  tp=8 divides
# reduced_100m's 16 heads, 8 kv heads and d_ff 2816 (no tp > 5 divides
# SmolLM-360M's); its 8 ranks share the card over gloo.  dp=4,tp=8 (32
# CUDA contexts on one card) is left to the CPU tests
# (tests/test_torch_mesh_large.py), which also run dp=16,tp=2.
MESH_LARGE_ARCH = "reduced_100m"
MESH_LARGE = ("dp=1,tp=8", 1, 8)
MESH_LARGE_DIR = os.path.join(ROOT, "build", "mesh_large_smoke")
# The meshes whose ranks check their step-1 gradient against one
# device's, and the seed of the drawn LM head (None: the zero head, so
# only the head's gradient is nonzero).
SHARD_GRAD_CHECKS = {"dp=2": None, MESH_LARGE[0]: 1}


def phase_mesh_large(errs, known, **overrides):
    """reduced_100m at full width trained through ``launch.train.main
    --mesh dp=1,tp=8``, ``pallas_int8_6``, 2 steps of 4 x 128 tokens, and
    on one device in this process with the same seed and batches.
    Held: K1 bitwise at every shape of both runs not in ``known`` (held
    by an earlier phase); the single device's K1 launches == its
    ``site_exec`` == the site report's prediction; per rank the same
    (``_hold_ranks``) and the losses within ``TRAIN_LOSS_BOUND`` of the
    single device's; the 8-shard checkpoint restored on one device and
    cut per rank bit-equal to each rank's final parameters; before the
    training, each rank's step-1 gradient under a drawn head (the zero
    head gives the layers a zero gradient, and the losses see only the
    forward and the head's update) against the single device's cut to
    its blocks within ``TRAIN_GRAD_BOUND`` (``_shard_grad_check``).
    Returns K1's launches over both runs and the tp=8 ranks' new
    shapes."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.shard.launch import spawn

    cfg = _train_setup_cfg(overrides, MESH_LARGE_ARCH)
    spec_mesh, dp, tp = MESH_LARGE
    tokens = 4 * 128
    backend = f"pallas_int8_{TRAIN_SPLITS}"
    single_shapes = set(train_gemm_shapes(cfg, tokens))
    mesh_shapes = set(shard_gemm_shapes(cfg, tokens // dp, tp))
    new = sorted((single_shapes | mesh_shapes) - set(known))
    print(f"[mesh-large] {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.num_params():,} float32 "
          f"parameters; {spec_mesh}: per rank q {cfg.q_dim // tp}, kv "
          f"{cfg.kv_dim // tp}, d_ff {cfg.d_ff // tp} columns", flush=True)
    phase_k1_train_shapes(errs, new, tag="mesh-large")
    shutil.rmtree(MESH_LARGE_DIR, ignore_errors=True)
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    launches = {key: 0 for key in ops.LAUNCHES}

    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    report = {}
    t0 = time.perf_counter()
    with _K1Shapes() as launched:
        want = train.main(train_argv(SHARD_STEPS, MESH_LARGE_DIR, backend,
                                     overrides, arch=MESH_LARGE_ARCH),
                          device="cuda", report=report)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on = [site for site in report["sites"] if site.offloaded]
    predicted = SHARD_STEPS * sum(s.batch * s.mult for s in on)
    got = ops.LAUNCHES["split_gemm"]
    print(f"[mesh-large] one device: step ms {report['step_ms']}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"K1 launches {got} (site_exec {report['site_exec']}, predicted "
          f"{predicted}), {len(on)} of {len(report['sites'])} sites "
          f"offloaded, losses {want}; main() {wall:.1f} s", flush=True)
    for key, val in ops.LAUNCHES.items():
        launches[key] += val
    if not got == report["site_exec"] == predicted > 0:
        fail(f"mesh-large one device: K1 launches {dict(ops.LAUNCHES)} != "
             f"site_exec {report['site_exec']} or the site report's "
             f"{predicted}")
    if not launched.seen <= single_shapes:
        fail(f"mesh-large one device: K1 launched at "
             f"{sorted(launched.seen - single_shapes)}, shapes it was not "
             "held at")
    if len(want) != SHARD_STEPS or not all(np.isfinite(want)):
        fail(f"mesh-large one-device losses {want}")
    shutil.rmtree(MESH_LARGE_DIR, ignore_errors=True)
    del report
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn(_shard_rank, dp * tp, (spec_mesh, overrides,
                                         MESH_LARGE_ARCH),
                  device="cuda", timeout=SHARD_TIMEOUT)
    wall = time.perf_counter() - t0
    _hold_ranks("mesh-large", spec_mesh, ranks, mesh_shapes, want, launches)
    print(f"[mesh-large] {spec_mesh}: {dp * tp} ranks in {wall:.1f} s "
          f"(start-up, model init, sites and {SHARD_STEPS} steps each)")
    for r in ranks:
        leaf, rel = r["grad"]
        print(f"[mesh-large] {spec_mesh} rank {r['rank']}: step-1 gradient "
              f"(random head) against one device's, cut to its blocks, "
              f"worst leaf {leaf} {rel:.3e} (bound {TRAIN_GRAD_BOUND})")
        if not rel <= TRAIN_GRAD_BOUND:
            fail(f"mesh-large {spec_mesh} rank {r['rank']} gradient {leaf} "
                 f"{rel}")
    _hold_tp_checkpoint("mesh-large", cfg, spec_mesh, dp, tp, ranks)
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    return launches, sorted(mesh_shapes - set(known))


# The meshes of the serve-shard phase, ranks sharing the card over gloo,
# and the layouts each serves: dp=2 (two slot groups of 2) paged and
# dense, tp=5 (5 heads and 1 kv head a rank) paged.
SERVE_SHARD_MESHES = (("dp=2", 2, 1, ("paged", "dense")),
                      ("dp=1,tp=5", 1, 5, ("paged",)))
SERVE_SHARD_DIR = os.path.join(ROOT, "build", "serve_shard_smoke")
SERVE_SHARD_TIMEOUT = 600
# A mesh's stream must equal phase 6's up to the first token whose
# top-2 logit gap in phase 6 is under this fraction of that row's
# largest |logit|: the mesh's emulated row-parallel wo and w_down (row
# scales over the rank's k) and its cuBLAS calls at other shapes move
# the logits by about 1e-6 of that (PR 19's tp=5 losses moved 9e-8),
# so a nearer tie may flip.  Beyond such a token the streams may part.
SERVE_SHARD_MARGIN = 1e-4
# Meshes whose streams must equal phase 6's exactly: at dp=2 every
# offloaded GEMM is K1, bitwise and row-independent, at the single
# device's widths.
SERVE_SHARD_EXACT = ("dp=2",)
# The (k, n) of a tp=5 rank's offloaded serve GEMMs: q, o, gate/up, down.
SERVE_TP5_KN = ((960, 192), (192, 960), (960, 512), (512, 960))


def serve_shard_gemm_shapes(cfg, served, dp, tp):
    """(m, k, n) of every GEMM a rank of a dp x tp serving mesh offloads
    at the default min_dim (128), from phase 6's waves: a wave's rows on
    dp rank g are its pieces whose slot is in group g, at the wave's
    width, and each projection and MLP GEMM has its per-shard (k, n).
    Decode (m = the rank's slots) and the head (m = rows) stay under
    the gate."""
    d = cfg.d_model
    q, kv, f = cfg.q_dim // tp, cfg.kv_dim // tp, cfg.d_ff // tp
    kn = [(d, q), (d, kv), (q, d), (d, f), (f, d)]
    per_group = served["engine_kw"]["batch_slots"] // dp
    shapes = set()
    for (_, width), slots in zip(served["rec"]["waves"],
                                 served["rec"]["wave_slots"]):
        for g in range(dp):
            rows = sum(slot // per_group == g for slot in slots)
            shapes |= {(rows * width, k, n) for k, n in kn
                       if min(rows * width, k, n) >= 128}
    return sorted(shapes)


def _site_exec(run):
    return sum(m["value"] for m in run.registry.snapshot()
               if m["name"] == "site_exec")


def _serve_shard_rank(spec, layouts, served, overrides):
    """One rank of the serve-shard phase: ``Engine(mesh=)`` over phase 6's
    model, requests and engine settings through ``pallas_int8_6`` with
    telemetry on, once per layout: its streams, K1's launches and
    shapes, its ``site_exec``, the launches its ``prefill_sites``
    predict over its wave shapes (plus its decode ticks'), its cache's
    shape, its device times and its peak memory."""
    from collections import Counter

    import torch.distributed as dist

    from repro_torch.core import PrecisionPolicy, site_report
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRun
    from repro_torch.serve import Engine, Request
    from repro_torch.shard import build_mesh
    from repro_torch.shard.launch import rank_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank_device("cuda")
    mesh = build_mesh(spec)
    model = _smollm("float32", served["seed"], **overrides)
    policy = PrecisionPolicy(backend="pallas_int8",
                             default_splits=served["splits"])
    prompts = served["prompts"]
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "coords": dict(mesh.coords)}
    for i, layout in enumerate(layouts):
        if i == 0:
            # Warm-up (cuBLAS handles, K1's library, the RoPE table):
            # three requests reach both dp groups.
            Engine(model, model.params, mesh=mesh, policy=policy,
                   kv_layout=layout, **served["engine_kw"]).run(
                [Request(prompt=p, max_new_tokens=2) for p in prompts[:3]])
        metrics = MetricsRun(os.path.join(
            SERVE_SHARD_DIR, spec.replace(",", "_"), layout,
            f"rank{mesh.rank}"))
        eng = Engine(model, model.params, mesh=mesh, policy=policy,
                     kv_layout=layout, metrics=metrics,
                     **served["engine_kw"])
        rec = _timed_runner(eng.runner)
        reqs = [Request(prompt=p, max_new_tokens=served["max_new"])
                for p in prompts]
        torch.cuda.synchronize()
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        with _K1Shapes() as launched:
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        site_exec = _site_exec(metrics)
        metrics.close()
        # In first-run order, which the tp ranks of a group share (a
        # decision-cache hit each: no program runs).
        shapes = Counter(rec["waves"])
        per_shape = {shape: sum(site.mult for site in eng.prefill_sites(
            *shape) if site.offloaded) for shape in shapes}
        slots = len(eng.kv.local_slots)
        decode = (eng.model.decode_step_paged if layout == "paged"
                  else eng.model.decode_step)
        with torch.no_grad():
            per_tick = sum(site.mult for site in site_report(
                decode, policy)(
                eng.params, eng.cache,
                torch.zeros(slots, dtype=torch.int32, device="cuda"),
                torch.ones(slots, dtype=torch.bool, device="cuda"))
                if site.offloaded)
        out[layout] = dict(
            tokens=[r.out for r in reqs], launches=launches,
            site_exec=site_exec, shapes=sorted(launched.seen),
            predicted=sum(per_shape[sh] * count
                          for sh, count in shapes.items())
            + per_tick * rec["ticks"],
            per_shape={str(sh): n for sh, n in per_shape.items()},
            per_tick=per_tick, k_shape=tuple(eng.cache["k"].shape),
            local_slots=eng.kv.local_slots.tolist(), wall=wall, peak=peak,
            **{key: rec[key] for key in ("prefill_ms", "prefill_tokens",
                                         "decode_ms", "decode_tokens",
                                         "waves", "ticks")})
        del eng
        torch.cuda.empty_cache()
    return out


def _margin_rule(got, want, gaps):
    """``(held, near)``: whether ``got`` equals ``want`` up to the first
    token whose phase-6 gap is under ``SERVE_SHARD_MARGIN`` (``near``,
    its index, or None when no token is that near a tie) and is as
    long."""
    if len(got) != len(want):
        return False, None
    for j, (a, b, gap) in enumerate(zip(got, want, gaps)):
        if gap < SERVE_SHARD_MARGIN:
            return True, j
        if a != b:
            return False, None
    return True, None


def phase_serve_shard(errs, served, held, **overrides):
    """Sharded serving on meshes of processes sharing the card, over
    gloo: phase 6's full-width SmolLM-360M, its 8 requests, engine
    settings and 16 new tokens through ``Engine(mesh=)`` and
    ``pallas_int8_6``, at dp=2 (paged and dense) and dp=1,tp=5.  Held:
    K1 bitwise at every new per-rank shape first; per rank, K1's
    launches == its ``site_exec`` == its ``prefill_sites``' prediction
    over its wave shapes; the same streams on every rank; each rank's
    cache its group's blocks (or slots) and ``5/tp`` kv heads; the
    streams against phase 6's under ``SERVE_SHARD_MARGIN`` (exactly at
    dp=2); paged == dense at dp=2.  ``held``: per-shard shapes an
    earlier phase held.  Returns K1's launches over every rank and
    the new shapes."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.shard.launch import spawn

    cfg = _train_setup_cfg(overrides)
    kn = serve_gemm_shapes(cfg)
    known = set(held) | {(m, k, n) for m in (512, 221) for k, n in kn}
    rank_shapes = {spec: serve_shard_gemm_shapes(cfg, served, dp, tp)
                   for spec, dp, tp, _ in SERVE_SHARD_MESHES}
    new = sorted({shape for shapes in rank_shapes.values()
                  for shape in shapes} - known)
    phase_k1_train_shapes(errs, new, s=served["splits"], tag="serve-shard")
    shutil.rmtree(SERVE_SHARD_DIR, ignore_errors=True)
    want, gaps = served["tokens"], served["gaps"]
    slots = served["engine_kw"]["batch_slots"]
    blocks = slots * served["engine_kw"]["max_len"] // served[
        "engine_kw"]["block_size"]
    launches = {key: 0 for key in ops.LAUNCHES}
    # What the ranks need: a small spawn message starts them together.
    job = {key: served[key] for key in ("prompts", "engine_kw", "seed",
                                        "splits", "max_new")}
    print("[serve-shard] ranks sharing one card: what the path costs, "
          "not a gain", flush=True)
    for spec, dp, tp, layouts in SERVE_SHARD_MESHES:
        t0 = time.perf_counter()
        ranks = spawn(_serve_shard_rank, dp * tp,
                      (spec, layouts, job, overrides), device="cuda",
                      timeout=SERVE_SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        for r in ranks:
            for layout in layouts:
                x = r[layout]
                pre = x["prefill_tokens"] / max(x["prefill_ms"], 1e-9) * 1e3
                dec = x["decode_tokens"] / max(x["decode_ms"], 1e-9) * 1e3
                print(f"[serve-shard] {spec} {layout} rank {r['rank']} "
                      f"{r['coords']}: backend {r['backend']}, slots "
                      f"{x['local_slots']}, cache k {x['k_shape']}; prefill "
                      f"{x['prefill_tokens']} tokens in {len(x['waves'])} "
                      f"waves {x['waves']}, {x['prefill_ms']:.1f} ms "
                      f"({pre:.1f} tok/s); decode {x['decode_tokens']} "
                      f"tokens in {x['ticks']} ticks, {x['decode_ms']:.1f} "
                      f"ms ({dec:.1f} tok/s); wall {x['wall']:.2f} s; peak "
                      f"memory {x['peak']:.2f} GiB; K1 launches "
                      f"{x['launches']['split_gemm']} (site_exec "
                      f"{x['site_exec']}, predicted {x['predicted']}: per "
                      f"wave shape {x['per_shape']}, {x['per_tick']} per "
                      f"tick)", flush=True)
                for key, val in x["launches"].items():
                    launches[key] += val
                if not (x["launches"]["split_gemm"] == x["site_exec"]
                        == x["predicted"] > 0) or any(
                            val for key, val in x["launches"].items()
                            if key != "split_gemm"):
                    fail(f"serve-shard {spec} {layout} rank {r['rank']}: "
                         f"launches {x['launches']} != site_exec "
                         f"{x['site_exec']} or the prediction "
                         f"{x['predicted']}")
                if not set(x["shapes"]) <= set(rank_shapes[spec]):
                    fail(f"serve-shard {spec}: K1 launched at "
                         f"{sorted(set(x['shapes']) - set(rank_shapes[spec]))}"
                         f", shapes not predicted from phase 6's waves")
                rows = (blocks // dp + 1 if layout == "paged"
                        else slots // dp)
                if x["k_shape"][1:3] != (rows, cfg.num_kv_heads // tp):
                    fail(f"serve-shard {spec} {layout} rank {r['rank']}: "
                         f"cache k {x['k_shape']}, not {rows} "
                         f"{'blocks' if layout == 'paged' else 'slots'} "
                         f"and {cfg.num_kv_heads // tp} kv heads")
                if x["tokens"] != ranks[0][layouts[0]]["tokens"]:
                    fail(f"serve-shard {spec} {layout}: rank {r['rank']}'s "
                         "streams differ from rank 0's")
        got = ranks[0][layouts[0]]["tokens"]
        ruled = [_margin_rule(g, w, gp) for g, w, gp in zip(got, want, gaps)]
        near = [j for _, j in ruled if j is not None]
        exact = sum(g == w for g, w in zip(got, want))
        print(f"[serve-shard] {spec}: {exact} of {len(want)} streams equal "
              f"phase 6's; {len(near)} reached a token whose phase-6 top-2 "
              f"gap is under {SERVE_SHARD_MARGIN} of its largest |logit| "
              f"(at tokens {near}); smallest gap "
              f"{min(min(gp) for gp in gaps):.3e}; {dp * tp} ranks in "
              f"{wall:.1f} s", flush=True)
        if not all(ok for ok, _ in ruled):
            fail(f"serve-shard {spec}: streams {got} part from phase 6's "
                 f"{want} before any near tie")
        if spec in SERVE_SHARD_EXACT and got != want:
            fail(f"serve-shard {spec}: streams differ from phase 6's")
        if "dense" in layouts:
            for r in ranks:
                if r["dense"]["tokens"] != r["paged"]["tokens"]:
                    fail(f"serve-shard {spec}: paged and dense streams "
                         f"differ on rank {r['rank']}")
            print(f"[serve-shard] {spec}: paged == dense on every rank")
    shutil.rmtree(SERVE_SHARD_DIR, ignore_errors=True)
    return launches, new


TUNE_BATCHES = 2
TUNE_DIR = os.path.join(ROOT, "build", "tune_smoke")


def _histogram(plan):
    from collections import Counter

    return dict(sorted(Counter(site.splits for site in plan.sites
                               if site.backend != "dgemm").items()))


def phase_tune(errs, trained, **overrides):
    """The precision-plan tuner on the card, at full width: calibrate
    the SmolLM-360M train step through ``python -m repro_torch.tune``'s
    ``main`` (probe ``pallas_int8_6``, ``TUNE_BATCHES`` batches, the
    float32 reference its CLI measures against), hold K1 bitwise at
    every ((m, k, n), s) the plan launches, train ``TRAIN_STEPS`` steps
    under ``--plan`` through ``launch.train.main`` (losses against
    ``trained``'s native run, gradients at each step against the
    float64-GEMM step within ``TUNE_GRAD_BOUND`` and at step 2 against
    native within ``TRAIN_GRAD_BOUND``, K1 launches by split count
    against the site report, K1's device time in one profiled step
    beside the uniform run's), then serve the serve
    phase's requests through ``Engine(plan=...)``.  Returns K1's
    launches on the path (the train and serve runs) and the plan's
    ((m, k, n), s) pairs by launches per train step, most first.
    ``overrides`` shrink the model for a rehearsal."""
    import shutil
    from collections import Counter

    from repro_torch.core import offload
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.tune import Calibrator, PrecisionPlan, solve_plan
    from repro_torch.tune import cli as tune_cli

    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    plan_path = os.path.join(TUNE_DIR, "smollm_360m.json")
    spec = f"pallas_int8_{TRAIN_SPLITS}"
    t0 = time.perf_counter()
    lines = tune_cli.main([
        "--arch", "smollm_360m", "--target", "step", "--batches",
        str(TUNE_BATCHES), "--seq-len", "128", "--global-batch", "4",
        "--lr", "3e-3", "--seed", "0", "--backend", spec, "--device",
        "cuda", "--plan", plan_path])
    cal_s = time.perf_counter() - t0
    plan = PrecisionPlan.load(plan_path)
    print(f"[tune] {lines[-1]}")
    print(f"[tune] calibration and solve {cal_s:.1f} s ({TUNE_BATCHES} "
          f"batches, float32 reference); solved split counts "
          f"{_histogram(plan)}; demoted {plan.demoted_sites()}; budget "
          f"{plan.budget:.3e} met {plan.budget_met}", flush=True)
    if not plan.budget_met:
        fail(f"the solved plan misses its budget {plan.budget}")

    model, opt, params, state, batch = _train_setup(overrides)
    step = train.build_train_step(model, opt)
    t0 = time.perf_counter()
    cal = Calibrator(step, tune_cli.tune_policy(spec, 128),
                     reference_dtype=torch.float64)
    cal.run(params, state, batch)
    plan64 = solve_plan(cal.result())
    print(f"[tune] for the record, one batch against a float64 reference "
          f"({time.perf_counter() - t0:.1f} s): solved split counts "
          f"{_histogram(plan64)}, demoted {plan64.demoted_sites()}, "
          f"budget met {plan64.budget_met}", flush=True)
    del cal

    planned = offload(step, plan=plan)
    policy = planned.policy
    sites = planned.sites(params, state, batch)
    on = [site for site in sites if site.offloaded]
    per_pair = Counter()
    for site in on:
        per_pair[((site.m, site.k, site.n), site.splits)] += (
            site.batch * site.mult)
    per_splits = Counter()
    for (_, splits), count in per_pair.items():
        per_splits[splits] += count
    phase_k1_train_shapes(errs, sorted(per_pair), tag="tune")
    phase_train_grads(model, opt, params, state, policy, tag="tune",
                      f64_bound=TUNE_GRAD_BOUND)
    k1_ms = _profile_step("plan", offload(step, policy), (params, state,
                                                           batch),
                          tag="tune-profile")
    del step, state, params, model
    torch.cuda.empty_cache()

    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    report = {}
    with _K1Shapes() as launched:
        losses = train.main(train_argv(
            TRAIN_STEPS, os.path.join(TUNE_DIR, "ckpt"), "", overrides)
            + ["--plan", plan_path], device="cuda", report=report)
        torch.cuda.synchronize()
    train_launches = dict(ops.LAUNCHES)
    shutil.rmtree(os.path.join(TUNE_DIR, "ckpt"), ignore_errors=True)
    native = trained["native_losses"]
    rel = [abs(e - n) / abs(n) for e, n in zip(losses, native)]
    want = {splits: TRAIN_STEPS * count
            for splits, count in sorted(per_splits.items())}
    median = _median_after_first(report["step_ms"])
    print(f"[tune] trained {TRAIN_STEPS} steps under the plan: losses "
          f"{losses}; |plan - native| / native {rel} (bound "
          f"{TRAIN_LOSS_BOUND}); step ms {report['step_ms']} (median after "
          f"the first {median:.1f}, uniform {spec} "
          f"{trained['step_ms']:.1f})")
    print(f"[tune] K1 launches by split count {dict(launched.by_splits)}, "
          f"predicted {want} from the site report; INT8 GEMMs per step "
          f"{report['int8_gemms_per_step']}; K1 device time per step "
          f"{fmt_ms(k1_ms)} under the plan, {fmt_ms(trained['k1_ms'])} "
          f"uniform {spec}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) \
            or max(rel) > TRAIN_LOSS_BOUND:
        fail(f"losses under the plan {losses} against native {native}")
    if dict(launched.by_splits) != want or \
            train_launches["split_gemm"] != sum(want.values()):
        fail(f"K1 launches under the plan {dict(launched.by_splits)} "
             f"({train_launches}) != predicted {want}")
    shapes = {pair[0] for pair in per_pair}
    if not launched.seen <= shapes:
        fail(f"K1 launched at {sorted(launched.seen - shapes)} under the "
             "plan, shapes it was not held at")

    serve_launches = phase_tune_serve(errs, plan, **overrides)
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    launches = {key: train_launches[key] + serve_launches[key]
                for key in train_launches}
    return launches, [pair for pair, _ in per_pair.most_common()]


def phase_tune_serve(errs, plan, seed=3, n_requests=8,
                     max_new=16, prompt_lengths=(128, 640), **overrides):
    """The serve phase's requests through ``Engine(plan=plan)`` (subset
    mode) beside uniform ``pallas_int8_6``: prefill tokens/s, K1's
    launches against the site report, and every greedy stream equal to
    the uniform run's.
    K1 is held bitwise first at every ((m, k, n), s) the plan's prefill
    waves give it."""
    from collections import Counter

    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, Request

    model = _smollm("float32", seed, **overrides)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(prompt_lengths[0], prompt_lengths[1] + 1,
                           n_requests)
    prompts = [rng.integers(1, model.cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    engine_kw = dict(batch_slots=4, max_len=1024, block_size=16,
                     chunk_tokens=256, chunk_token_budget=512)
    uniform = PrecisionPolicy(backend="pallas_int8",
                              default_splits=TRAIN_SPLITS)

    def serve(some=prompts, new=max_new, **kw):
        eng = Engine(model, model.params, **kw, **engine_kw)
        rec = _timed_runner(eng.runner)
        reqs = [Request(prompt=p, max_new_tokens=new) for p in some]
        eng.run(reqs)
        torch.cuda.synchronize()
        return eng, [r.out for r in reqs], rec

    serve(prompts[:1], 2, plan=plan)   # warm
    _, toks_uniform, rec_uniform = serve(policy=uniform)
    waves = Counter(rec_uniform["waves"])
    probe = Engine(model, model.params, plan=plan, **engine_kw)
    wave_sites = {shape: [site for site in probe.prefill_sites(*shape)
                          if site.offloaded] for shape in waves}
    del probe
    pairs = sorted({((site.m, site.k, site.n), site.splits)
                    for found in wave_sites.values() for site in found})
    phase_k1_train_shapes(errs, pairs, tag="tune-serve")
    predicted = sum(sum(site.mult for site in wave_sites[shape]) * count
                    for shape, count in waves.items())
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    _, toks_plan, rec = serve(plan=plan)
    launches = dict(ops.LAUNCHES)
    same = sum(a == b for a, b in zip(toks_uniform, toks_plan))
    for label, r in (("uniform", rec_uniform), ("plan", rec)):
        print(f"[tune-serve] {label}: prefill {r['prefill_tokens']} tokens "
              f"in {len(r['waves'])} waves, {r['prefill_ms']:.1f} ms "
              f"({r['prefill_tokens'] / (r['prefill_ms'] / 1e3):.1f} "
              f"tok/s); decode {r['decode_tokens']} tokens, "
              f"{r['decode_ms']:.1f} ms")
    print(f"[tune-serve] K1 launches {launches['split_gemm']}, predicted "
          f"{predicted} (waves {dict(waves)}); greedy streams equal to "
          f"uniform pallas_int8_{TRAIN_SPLITS} for {same} of {n_requests} "
          "requests")
    if rec["waves"] != rec_uniform["waves"] or launches != {
            "split_gemm": predicted, "split_gemm_fused": 0,
            "split_gemm_v1": 0, "gather_pairs_kmajor": 0}:
        fail(f"plan serve launches {launches} != predicted {predicted}")
    if same != n_requests:
        fail(f"greedy streams under the plan equal uniform "
             f"pallas_int8_{TRAIN_SPLITS} for {same} of {n_requests} "
             "requests, not all")
    for out in toks_plan:
        if len(out) != max_new or not all(0 <= t < model.cfg.vocab_size
                                          for t in out):
            fail(f"served tokens under the plan out of range: {out}")
    del model
    return launches


OBS_DIR = os.path.join(ROOT, "build", "obs_smoke")
OBS_STEPS = 4
OBS_NUMERICS_EVERY = 2
# Pairs of emulated steps without and with the site hook, timed in turns.
OBS_PAIRS = 4


def _prometheus(text):
    """``{(name, labels text): value}`` of a ``/metrics`` body; fails
    on a line the exposition format does not allow."""
    series = {}
    for line in text.splitlines():
        if not line or line.startswith("# TYPE "):
            continue
        found = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$",
                         line)
        if not found:
            fail(f"/metrics: invalid exposition line {line!r}")
        series[(found.group(1), found.group(2) or "")] = float(
            found.group(3).replace("+Inf", "inf"))
    return series


def _scrape(url):
    import urllib.request

    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
        return _prometheus(resp.read().decode())


def _site_exec_total(events):
    return sum(ev["value"] for ev in events if ev.get("type") == "metric"
               and ev.get("name") == "site_exec")


def _obs_cli(*argv):
    """``python -m repro_torch.obs`` in this process: (exit code, text)."""
    import io

    from repro_torch.obs.cli import main as obs_main

    out = io.StringIO()
    return obs_main(list(argv), out=out), out.getvalue()


def _syncs(fn, args):
    """The synchronizing calls ``torch.cuda.set_sync_debug_mode("warn")``
    reports over one call of ``fn`` (backward ones are replayed on this
    thread), counted by the source line that issued them."""
    import warnings
    from collections import Counter

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "called a synchronizing CUDA operation" in str(w.message))


def phase_obs(served, trained, **overrides):
    """Telemetry on the card (``repro_torch.obs``), on both main paths.

    Train: SmolLM-360M at full width, ``OBS_STEPS`` steps through
    pallas_int8_6 by ``launch.train.main`` with telemetry on by default,
    ``--metrics-port 0`` and ``--numerics-every 2``; ``/metrics``
    scraped over 127.0.0.1 while it trains; the obs CLI's ``report
    --check``, ``attrib`` and ``export`` over the run.  Held: one
    ``train_step`` span a step, the sum of ``site_exec`` equal to the
    site report's executions and to K1's launch counter, the attributed
    INT8 GEMMs equal to the steps times ``count_int8_gemms``, every
    numerics report within its budget, and one emulated step issuing
    as many synchronizing calls with the hook as without.  Serve: phase
    6's requests through ``Engine(metrics=..., metrics_port=0)``; held:
    ``serve_tokens``, prefill ``site_exec`` equal to K1's launch
    counter and to phase 6's, the greedy streams equal to phase 6's.
    Prints telemetry's cost against phases 8 and 6 (telemetry off),
    gating nothing.  Returns K1's launches.
    """
    import shutil
    import threading

    from repro_torch.core import PrecisionPolicy, offload
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import MetricsRun, attribution, load_runs
    from repro_torch.serve import Engine, Request
    from repro_torch.tune import count_int8_gemms

    t0 = time.perf_counter()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    spec = f"pallas_int8_{TRAIN_SPLITS}"
    argv = train_argv(OBS_STEPS, os.path.join(OBS_DIR, "train"), spec,
                      overrides, metrics_dir="") + [
        "--metrics-port", "0", "--numerics-every", str(OBS_NUMERICS_EVERY)]
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    report, box = {}, {}

    def run():
        try:
            box["losses"] = train.main(argv, device="cuda", report=report)
        except BaseException as exc:   # re-raised below, on this thread
            box["error"] = exc

    trainer = threading.Thread(target=run, name="obs-train")
    trainer.start()
    live = None
    while trainer.is_alive() and live is None:
        if "metrics_url" in report:
            found = _scrape(report["metrics_url"])
            if any(name == "site_exec" for name, _ in found):
                live = found
        time.sleep(0.1)
    trainer.join()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if "error" in box:
        raise box["error"]
    if live is None:
        fail("obs: no site_exec series scraped from /metrics while the "
             "trainer ran")
    sites = report["sites"]
    per_step = sum(s.batch * s.mult for s in sites if s.offloaded)
    gemms = count_int8_gemms(sites)
    directory = report["metrics_dir"]
    (run_id, events), = list(load_runs(directory).items())[-1:]
    execs = _site_exec_total(events)
    kinds = [ev["type"] for ev in events]
    numerics = [ev for ev in events if ev["type"] == "numerics"]
    budget = 32 * float(torch.finfo(torch.float32).eps)
    emulated = trained.get("emulated_losses")
    print(f"[obs] train: {OBS_STEPS} steps, losses {box['losses']} "
          f"(phase 8's run without telemetry: {emulated}, equal: "
          f"{box['losses'] == emulated}); "
          f"scraped /metrics at {report['metrics_url']} mid-run: "
          f"{len(live)} series, site_exec series "
          f"{sum(1 for n, _ in live if n == 'site_exec')}, numerics gauge "
          f"{[v for (n, _), v in live.items() if n == 'numerics_realized_rel']}")
    print(f"[obs] run {run_id} in {directory}: {len(events)} events "
          f"({kinds.count('step')} step, {kinds.count('site_decl')} "
          f"site_decl, {len(numerics)} numerics); sum of site_exec "
          f"{execs:.0f} = {OBS_STEPS} x {per_step} from the site report; "
          f"K1 launches {launches['split_gemm']}")
    if len(box["losses"]) != OBS_STEPS or not all(
            np.isfinite(box["losses"])):
        fail(f"obs: train losses {box['losses']}")
    if execs != OBS_STEPS * per_step or execs != launches["split_gemm"]:
        fail(f"obs: sum of site_exec {execs} != {OBS_STEPS} x {per_step} "
             f"or != K1's launches {launches}")
    rc, text = _obs_cli("report", directory, "--check")
    print("[obs] report --check:\n" + text.rstrip())
    if rc != 0 or "CHECK OK" not in text:
        fail(f"obs: report --check exited {rc}")
    rc, text = _obs_cli("attrib", directory)
    print("[obs] attrib:\n" + "\n".join(text.splitlines()[:8]))
    rows = attribution(events)
    attributed = sum(r.int8_gemms for r in rows)
    print(f"[obs] attributed INT8 GEMMs {attributed:.0f} = {OBS_STEPS} x "
          f"{gemms} (count_int8_gemms of the site report); wall shares "
          f"sum {sum(r.wall_share for r in rows):.6f}")
    if rc != 0 or attributed != OBS_STEPS * gemms:
        fail(f"obs: attrib exited {rc}, {attributed} INT8 GEMMs != "
             f"{OBS_STEPS} x {gemms}")
    trace = os.path.join(OBS_DIR, "trace.json")
    rc, text = _obs_cli("export", directory, "-o", trace)
    with open(trace) as f:
        spans = [ev for ev in json.load(f)["traceEvents"]
                 if ev.get("ph") == "X"]
    steps = [ev for ev in spans if ev["name"] == "train_step"]
    print(f"[obs] export: {text.strip()}; train_step spans "
          f"{[round(ev['dur'] / 1e3, 1) for ev in steps]} ms")
    if rc != 0 or len(steps) != OBS_STEPS:
        fail(f"obs: export exited {rc} with {len(steps)} train_step spans")
    print(f"[obs] numerics: " + "; ".join(
        f"step {ev['step']} {ev['site']} s={ev['splits']} realized "
        f"{ev['realized_rel']:.3e} (budget {ev['budget']:.3e})"
        for ev in numerics))
    if len(numerics) != -(-OBS_STEPS // OBS_NUMERICS_EVERY) or any(
            ev["drift"] or ev["budget"] != budget
            or not 0 <= ev["realized_rel"] <= budget for ev in numerics):
        fail(f"obs: numerics reports {numerics} not all within {budget}")

    # The hook reads nothing from the device: one emulated step issues
    # as many synchronizing calls with it as without.
    model, opt, params, state, batch = _train_setup(overrides)
    step = train.build_train_step(model, opt)
    policy = PrecisionPolicy(backend=spec, default_splits=TRAIN_SPLITS)
    sync_run = MetricsRun(os.path.join(OBS_DIR, "sync"))
    plain = offload(step, policy)
    hooked = offload(step, policy,
                     on_site_event=sync_run.site_event_handler())
    for fn in (plain, hooked):   # warm: the kernels' plans, allocator
        fn(params, state, batch)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    syncs = {"native": _syncs(step, (params, state, batch)),
             "without": _syncs(plain, (params, state, batch))}
    before = ops.LAUNCHES["split_gemm"]
    execs_before = _site_exec_total(
        [dict(s, type="metric") for s in sync_run.registry.snapshot()])
    syncs["with"] = _syncs(hooked, (params, state, batch))
    where = syncs["with"].most_common(6)
    hooked_execs = _site_exec_total(
        [dict(s, type="metric") for s in sync_run.registry.snapshot()]
    ) - execs_before
    hooked_launches = ops.LAUNCHES["split_gemm"] - before
    sync_run.close()
    print(f"[obs] synchronizing calls in one emulated step "
          f"(set_sync_debug_mode('warn')): "
          f"{sum(syncs['without'].values())} without the hook, "
          f"{sum(syncs['with'].values())} with it, from {where} (the "
          f"native step: {sum(syncs['native'].values())}, from "
          f"{syncs['native'].most_common(6)}); the hooked "
          f"step's site_exec {hooked_execs:.0f}, K1 launches "
          f"{hooked_launches}")
    if syncs["with"] != syncs["without"] or hooked_execs != per_step \
            or hooked_launches != per_step:
        fail(f"obs: the hook changed the step's synchronizing calls "
             f"({syncs}) or its counts ({hooked_execs}, "
             f"{hooked_launches} != {per_step})")
    # The hook's own cost, paired in one process: host clock around a
    # synchronized step, without and with the hook in turns.
    paired = {"without": [], "with": []}
    for i in range(OBS_PAIRS):
        order = (("without", plain), ("with", hooked))
        for label, fn in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn(params, state, batch)
            torch.cuda.synchronize()
            paired[label].append((time.perf_counter() - start) * 1e3)
    print(f"[obs] one emulated step, {OBS_PAIRS} pairs in turns: without "
          f"the hook {[round(x, 1) for x in paired['without']]} ms, with "
          f"it {[round(x, 1) for x in paired['with']]} ms; medians "
          f"{np.median(paired['without']):.1f} and "
          f"{np.median(paired['with']):.1f} ms")
    del model, opt, params, state, batch, step, plain, hooked
    torch.cuda.empty_cache()

    # Serve phase 6's requests with telemetry on.
    model = _smollm("float32", 3, **overrides)
    policy = PrecisionPolicy(backend="pallas_int8",
                             default_splits=served["splits"])
    serve_run = MetricsRun(os.path.join(OBS_DIR, "serve"))
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    eng = Engine(model, model.params, policy=policy, metrics=serve_run,
                 metrics_port=0, **served["engine_kw"])
    try:
        rec = _timed_runner(eng.runner)
        reqs = [Request(prompt=p, max_new_tokens=16)
                for p in served["prompts"]]
        eng.run(reqs)
        torch.cuda.synchronize()
        serve_launches = dict(ops.LAUNCHES)
        scraped = _scrape(eng.metrics_server.url)
    finally:
        eng.close()
        serve_run.close()
    serve_events = load_runs(serve_run.directory)[serve_run.run_id]
    serve_execs = _site_exec_total(serve_events)
    tokens = scraped[("serve_tokens", "")]
    scraped_execs = sum(v for (n, _), v in scraped.items()
                        if n == "site_exec")
    streams = [r.out for r in reqs]
    same = sum(a == b for a, b in zip(streams, served["tokens"]))
    rc, _ = _obs_cli("report", str(serve_run.directory), "--check")
    print(f"[obs] serve: serve_tokens {tokens:.0f}, prefill site_exec "
          f"{serve_execs:.0f} (scraped {scraped_execs:.0f}), K1 launches "
          f"{serve_launches['split_gemm']} (phase 6: "
          f"{served['launches']}); greedy streams equal to phase 6's for "
          f"{same} of {len(streams)}; report --check exit {rc}")
    want_tokens = 16 * len(served["prompts"])
    if (tokens != want_tokens or serve_execs != scraped_execs
            or serve_execs != serve_launches["split_gemm"]
            or serve_execs != served["launches"]
            or same != len(streams) or rc != 0):
        fail("obs: serve telemetry disagrees (tokens, site_exec, K1 "
             "launches, streams or report --check)")

    # Telemetry's cost, host-side readings that spread by tens of
    # percent between runs: printed, gated on nothing.
    def rate(r, skip=0):
        return (sum(r["wave_tokens"][skip:])
                / (sum(r["wave_ms"][skip:]) / 1e3))

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    on_ms = _median_after_first(report["step_ms"])
    print(f"[obs] cost on {card}: train step median after the first "
          f"{on_ms:.1f} ms with telemetry against {trained['step_ms']:.1f} "
          f"ms without (phase 8), x{on_ms / trained['step_ms']:.3f}; "
          f"prefill {rate(rec):.1f} tok/s with against "
          f"{rate(served['rec']):.1f} without (phase 6), "
          f"x{rate(rec) / rate(served['rec']):.3f}; after the first wave "
          f"(whose telemetry declares the sites) {rate(rec, 1):.1f} "
          f"against {rate(served['rec'], 1):.1f}, "
          f"x{rate(rec, 1) / rate(served['rec'], 1):.3f}")
    del eng, model
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    print(f"[obs] phase {time.perf_counter() - t0:.1f} s")
    return {key: launches[key] + serve_launches[key] for key in launches}


WARM_DIR = os.path.join(ROOT, "build", "warm_cache")
WARM_METRICS = os.path.join(ROOT, "build", "warm_smoke")


def _first_wave_ms(runner):
    """Host ms of the runner's first prefill wave (its site declaration
    and the read-back included), filled as it runs."""
    got = {}
    wave = runner.prefill_wave

    def timed():
        start = time.perf_counter()
        res = wave()
        got.setdefault("ms", (time.perf_counter() - start) * 1e3)
        return res

    runner.prefill_wave = timed
    return got


def phase_warm_start(served, **overrides):
    """The serve warm start (``Engine(warm_cache_dir=)``) on phase 6's
    cell: SmolLM-360M at full width, pallas_int8_6, paged, phase 6's 8
    requests.

    Two runs, each from a fresh ``Engine`` (a restarted server: the
    offload decision caches live on its programs' wrappers), both with
    telemetry on and persisting into ``WARM_DIR``, deleted first.
    Held: the cold run wrote entries (``disk_misses`` > 0); the warm
    run read every entry of both programs from disk (``disk_misses`` 0,
    ``disk_decisions_hits`` > 0) and left the files byte-identical; both
    runs' greedy streams equal phase 6's; K1's launches and the summed
    ``site_exec`` equal phase 6's launches; ``python -m repro_torch.obs
    report --check --expect-cache-hit`` exits 1 on the cold run and 0 on
    the warm one.  Prints each run's prefill tok/s and its first wave's
    host ms, findings only.  Returns K1's launches over both runs.
    """
    import shutil

    from repro_torch.core import PrecisionPolicy
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRun, load_runs
    from repro_torch.serve import Engine, Request

    t0 = time.perf_counter()
    shutil.rmtree(WARM_DIR, ignore_errors=True)
    shutil.rmtree(WARM_METRICS, ignore_errors=True)
    model = _smollm("float32", 3, **overrides)
    policy = PrecisionPolicy(backend="pallas_int8",
                             default_splits=served["splits"])
    total = {key: 0 for key in ops.LAUNCHES}
    files = []
    for tag, want_rc in (("cold", 1), ("warm", 0)):
        run = MetricsRun(os.path.join(WARM_METRICS, tag))
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        eng = Engine(model, model.params, policy=policy, metrics=run,
                     warm_cache_dir=WARM_DIR, **served["engine_kw"])
        try:
            rec = _timed_runner(eng.runner)
            first = _first_wave_ms(eng.runner)
            reqs = [Request(prompt=p, max_new_tokens=16)
                    for p in served["prompts"]]
            eng.run(reqs)
            torch.cuda.synchronize()
        finally:
            eng.close()
            run.close()
        launches = dict(ops.LAUNCHES)
        for key in total:
            total[key] += launches[key]
        info = eng.runner._prefill_wrapped.persist_info()
        dinfo = eng.runner._decode_wrapped.persist_info()
        execs = _site_exec_total(load_runs(run.directory)[run.run_id])
        rc, _ = _obs_cli("report", str(run.directory), "--check",
                         "--expect-cache-hit")
        files.append({name: open(os.path.join(WARM_DIR, name), "rb").read()
                      for name in sorted(os.listdir(WARM_DIR))
                      if name.endswith(".json")})
        streams = [r.out for r in reqs]
        same = sum(a == b for a, b in zip(streams, served["tokens"]))
        rate = rec["prefill_tokens"] / (rec["prefill_ms"] / 1e3)
        print(f"[warm] {tag}: prefill {info}, decode {dinfo}; "
              f"{len(files[-1])} decision files; K1 launches "
              f"{launches['split_gemm']} (phase 6: {served['launches']}), "
              f"site_exec {execs:.0f}; streams equal to phase 6's for "
              f"{same} of {len(streams)}; report --check "
              f"--expect-cache-hit exit {rc}; prefill {rate:.1f} tok/s, "
              f"first wave {first['ms']:.1f} ms host")
        if tag == "cold":
            ok = info.disk_misses > 0 and dinfo.disk_misses > 0
        else:
            ok = all(i.disk_misses == 0 and i.disk_decisions_hits > 0
                     and i.disk_hits == 0 for i in (info, dinfo))
        if (not ok or rc != want_rc or same != len(streams)
                or launches["split_gemm"] != served["launches"]
                or execs != launches["split_gemm"]
                or sum(launches.values()) != launches["split_gemm"]):
            fail(f"warm start, {tag} run: persist {info} / {dinfo}, "
                 f"report exit {rc} (want {want_rc}), streams {same}, "
                 f"launches {launches}, site_exec {execs}")
    if not files[0] or files[0] != files[1]:
        fail("warm start: the decision files differ between the cold and "
             "the warm run")
    del eng, model
    shutil.rmtree(WARM_DIR, ignore_errors=True)
    shutil.rmtree(WARM_METRICS, ignore_errors=True)
    print(f"[warm] cold and warm decision files byte-identical; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return total


#: The control-flow program's sites (name, m, k, n) as the reference
#: lists them: ``repro.core.offload(f, PrecisionPolicy(backend=
#: "pallas_int8", default_splits=6)).sites(...)`` for the same program
#: written with ``jax.lax.while_loop``, ``jax.lax.cond`` and
#: ``jnp.einsum`` at these shapes (float64).
CF_SITES = [("while0/dot0", 4096, 4096, 4096),
            ("cond1/br0/dot0", 4096, 256, 4096),
            ("cond1/br1/dot0", 4096, 256, 4096),
            ("dot0", 1024, 256, 256),
            ("dot1", 4096, 256, 1024)]
CF_SPLITS = 6
CF_TRIPS = 3


class _ZeroGradMatmul(torch.autograd.Function):
    """A user ``Function`` around a product, with a zero backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return torch.zeros_like(a), torch.zeros_like(b)


def _cf_loop(y0, x):
    from repro_torch.core import while_loop

    return while_loop(lambda v: v[0] < CF_TRIPS,
                      lambda v: (v[0] + 1, (v[1] @ x) / 64.0), (0, y0))[1]


def _cf_program(pred, x, y0, a, b, c, w):
    """A 3-trip while loop of an n^2 product, a cond, and a 3-operand
    einsum."""
    from repro_torch.core import cond

    y = _cf_loop(y0, x)
    z = cond(pred, lambda t: t @ w, lambda t: (2.0 * t) @ w, a)
    e = torch.einsum("ij,jk,kl->il", a, b, c)
    return y, z, e


def phase_control_flow(n=4096, block=256):
    """Control flow and opaque calls through ``offload`` on the card, in
    float64 through pallas_int8_6 (K1), at the MuST contour's widths
    (``n`` 4096, ``block`` 256; a rehearsal shrinks them and
    ``CF_SITES``).

    Held: the program's sites equal ``CF_SITES`` (the reference's names
    and extents, every branch listed); one call with the cond true and
    one with it false (the second a cache hit) launch K1 once per
    executed site, which is what the hook counts; each output within
    the a-priori bound ``estimate_rel_error(6, k)`` per chained GEMM of
    native FP64, normalized by the chain of |operands|; a user
    ``autograd.Function`` around a product is no site, launches no K1,
    equals the native product and keeps its zero gradient.  Then prints
    the while loop's roofline (``analyze_cell`` at ``H100_PEAKS``) beside
    its measured time, emulated and native, and fails if a time is under
    its bound.  Returns K1's launches of the two calls.
    """
    from collections import Counter

    from repro_torch.analysis.roofline import H100_PEAKS, analyze_cell
    from repro_torch.core import (PrecisionPolicy, estimate_rel_error,
                                  num_pair_gemms, offload)
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    gen = np.random.default_rng(5)

    def rand(*shape):
        return torch.from_numpy(gen.standard_normal(shape)).cuda()

    x, y0 = rand(n, n), rand(n, n)
    a, b, c, w = (rand(n, block), rand(block, block), rand(block, 4 * block),
                  rand(block, n))
    args = (x, y0, a, b, c, w)
    policy = PrecisionPolicy(backend="pallas_int8", default_splits=CF_SPLITS)
    hooked = Counter()
    prog = offload(_cf_program, policy,
                   on_site_event=lambda p: hooked.update([p["site"]]))
    got = [(s.name, s.m, s.k, s.n) for s in prog.sites(True, *args)]
    if got != CF_SITES:
        fail(f"control flow: sites {got} != the reference's {CF_SITES}")
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    outs = {pred: prog(pred, *args) for pred in (True, False)}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    executed = Counter({"while0/dot0": 2 * CF_TRIPS, "cond1/br0/dot0": 1,
                        "cond1/br1/dot0": 1, "dot0": 2, "dot1": 2})
    print(f"[cf] sites {[name for name, *_ in got]} equal the reference's; "
          f"K1 launches {launches['split_gemm']}, hook {dict(hooked)}, "
          f"cache {prog.cache_info()}")
    if (hooked != executed or launches["split_gemm"] != sum(executed.values())
            or sum(launches.values()) != launches["split_gemm"]
            or prog.cache_info()[:2] != (2, 1)):
        fail(f"control flow: launches {launches}, hook {dict(hooked)} != "
             f"executed {dict(executed)}, cache {prog.cache_info()}")

    # Error against native FP64, per chained GEMM, normalized by the
    # chain of |operands|: within the a-priori bound at s = 6.
    beta = estimate_rel_error(CF_SPLITS, n)
    mag_y = _cf_loop(y0.abs(), x.abs())
    mag_e = torch.einsum("ij,jk,kl->il", a.abs(), b.abs(), c.abs())
    worst = 0.0
    for pred, (y, z, e) in outs.items():
        ny, nz, ne = _cf_program(pred, *args)
        mag_z = (2.0 if not pred else 1.0) * (a.abs() @ w.abs())
        for got_, want, mag, chain in ((y, ny, mag_y, CF_TRIPS),
                                       (z, nz, mag_z, 1), (e, ne, mag_e, 2)):
            rel = float(((got_ - want).abs() / mag).max())
            bound_ = chain * beta * (1 + beta) ** chain
            worst = max(worst, rel / bound_)
            if not rel <= bound_:
                fail(f"control flow: error {rel:.3e} over {chain} chained "
                     f"GEMMs > {bound_:.3e} (pred {pred})")
    print(f"[cf] error against native FP64 at most {worst:.4f} of the "
          f"a-priori bound (estimate_rel_error(6, {n}) = {beta:.3e} per "
          "chained GEMM)")

    # A user autograd.Function stays opaque: native product, its rule.
    fa = a.clone().requires_grad_()
    opaque = offload(lambda a, w: _ZeroGradMatmul.apply(a, w), policy)
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    out = opaque(fa, w)
    out.sum().backward()
    torch.cuda.synchronize()
    fn_launches = ops.LAUNCHES["split_gemm"]
    fn_sites = opaque.sites(fa, w)
    print(f"[cf] autograd.Function: sites {fn_sites}, K1 launches "
          f"{fn_launches}, equal to native {torch.equal(out, a @ w)}, "
          f"max |grad| {float(fa.grad.abs().max())}")
    if (fn_sites or fn_launches or not torch.equal(out, a @ w)
            or float(fa.grad.abs().max()) != 0.0):
        fail("control flow: the user autograd.Function was not opaque")

    # The while loop's roofline beside its time (not the main path's
    # launches: the counters were read above).
    loop = offload(_cf_loop, policy)

    def event_ms(fn, reps=3):
        fn(y0, x)   # warm
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(y0, x)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return float(np.median(times))

    m = k = n
    pairs = num_pair_gemms(CF_SPLITS)
    emul = analyze_cell({
        "cell": f"while0/dot0 x{CF_TRIPS}, pallas_int8_{CF_SPLITS}",
        "flops": CF_TRIPS * 2 * m * n * k * pairs,
        "int8_flops": CF_TRIPS * 2 * m * n * k * pairs,
        "hbm_bytes": CF_TRIPS * (CF_SPLITS * (m * k + k * n) + 8 * m * n)},
        H100_PEAKS)
    fp64 = analyze_cell({
        "cell": f"while0/dot0 x{CF_TRIPS}, FP64",
        "flops": CF_TRIPS * 2 * m * n * k,
        "hbm_bytes": CF_TRIPS * 8 * (m * k + k * n + m * n)}, H100_PEAKS)
    emul_ms, fp64_ms = event_ms(loop), event_ms(_cf_loop)
    print(f"[roofline] {emul.cell}: bound {emul.bound_s * 1e3:.4f} ms "
          f"({emul.dominant}; compute {emul.compute_s * 1e3:.4f}, memory "
          f"{emul.memory_s * 1e3:.4f}), measured {emul_ms:.3f} ms "
          f"({emul.bound_s * 1e3 / emul_ms:.3f} of the bound); {fp64.cell}: "
          f"bound {fp64.bound_s * 1e3:.4f} ms ({fp64.dominant}), measured "
          f"{fp64_ms:.3f} ms ({fp64.bound_s * 1e3 / fp64_ms:.3f})")
    if emul_ms < emul.bound_s * 1e3 or fp64_ms < fp64.bound_s * 1e3:
        fail("control flow: a measured time is under its roofline bound")
    print(f"[cf] phase {time.perf_counter() - t0:.1f} s")
    return launches


# F6 and F7 on the card (phase_entry_points): each torch entry point
# and einsum form that offload once missed or refused, beside a form the
# port handled before, at the MuST widths.  (name, program, the same
# product in an earlier form, operand keys.)
ENTRY_SPLITS = 6
ENTRY_BATCH = 2
ENTRY_LADDER_FACTOR = 8.0
ENTRY_FORMS = [
    ("tensordot", lambda a, b: torch.tensordot(a, b, 1),
     lambda a, b: torch.matmul(a, b), "ab"),
    ("tensordot dims", lambda a, b: torch.tensordot(a, b, ([1], [0])),
     lambda a, b: a @ b, "ab"),
    ("linalg.matmul", torch.linalg.matmul, torch.matmul, "ab"),
    ("inner", torch.inner, lambda a, b: torch.matmul(a, b.mT), "ab"),
    ("linalg.multi_dot", lambda a, b, c: torch.linalg.multi_dot([a, b, c]),
     lambda a, b, c: torch.einsum("ab,bc,cd->ad", a, b, c), "abc"),
    ("chain_matmul", torch.chain_matmul,
     lambda a, b, c: torch.einsum("ab,bc,cd->ad", a, b, c), "abc"),
    ("baddbmm", torch.baddbmm, lambda x, p, q: x + torch.bmm(p, q), "Xpq"),
    ("addbmm", torch.addbmm,
     lambda x, p, q: x + torch.einsum("bij,bjk->ik", p, q), "xpq"),
    ("addmm_", lambda x, a, b: x.clone().addmm_(a, b),
     lambda x, a, b: x + a @ b, "xab"),
    ("baddbmm_", lambda x, p, q: x.clone().baddbmm_(p, q),
     lambda x, p, q: x + p @ q, "Xpq"),
    ("addbmm_", lambda x, p, q: x.clone().addbmm_(p, q),
     lambda x, p, q: x + torch.einsum("bij,bjk->ik", p, q), "xpq"),
    ("einsum ...ij,...jk->...ik",
     lambda p, q: torch.einsum("...ij,...jk->...ik", p, q), torch.matmul,
     "pq"),
    ("einsum bij,bjk", lambda p, q: torch.einsum("bij,bjk", p, q),
     lambda p, q: torch.einsum("bij,bjk->ik", p, q), "pq"),
]
# The vector forms and the repeated index: one site each, gated by size.
ENTRY_GATED = [
    ("mv", torch.mv, "av"), ("dot", torch.dot, "vv"),
    ("vdot", torch.vdot, "vv"), ("addmv", torch.addmv, "vav"),
    ("addmv_", lambda v, a, w: v.clone().addmv_(a, w), "vav"),
    ("linalg.vecdot", torch.linalg.vecdot, "ab"),
    ("einsum bii,bij->bj", lambda p, q: torch.einsum("bii,bij->bj", p, q),
     "pq"),
]


def phase_entry_points(errs, ladder, n=4096):
    """F6 and F7 on the card: every torch entry point and einsum form
    the offload once missed (F6) or refused (F7), in float64 through
    pallas_int8_6 (K1) at the MuST widths (n^2 operands, batched ones
    ``ENTRY_BATCH`` deep), ``min_dim`` at its default.

    K1 is held bitwise against its plain version at the two shapes the
    phase adds ((n, n, n) and addbmm's (n, 2n, n)).  Per form, with the
    counters zeroed just before and read just after: K1's launches equal
    its offloaded sites' batch x mult and the hook's executions their
    mult; its result equals, to the bit, the same product in a form the
    port handled before; its error against native FP64 (normalized by
    the product of |operands|) is within ``ENTRY_LADDER_FACTOR`` of the
    n^2 ladder's s = 6 reading ``ladder[3]``.  The gated forms' sites
    are held by name and gate reason, with no launch.  Returns K1's
    launches over the offloaded forms."""
    from collections import Counter

    from repro_torch.core import PrecisionPolicy, offload
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    phase_k1_train_shapes(errs, [(n, n, n), (n, ENTRY_BATCH * n, n)],
                          s=ENTRY_SPLITS, tag="entry")
    gen = np.random.default_rng(1)
    ops_ = {key: torch.from_numpy(gen.standard_normal(shape)).cuda()
            for key, shape in (("a", (n, n)), ("b", (n, n)), ("c", (n, n)),
                               ("x", (n, n)), ("v", (n,)),
                               ("p", (ENTRY_BATCH, n, n)),
                               ("q", (ENTRY_BATCH, n, n)),
                               ("X", (ENTRY_BATCH, n, n)))}
    policy = PrecisionPolicy(backend="pallas_int8",
                             default_splits=ENTRY_SPLITS)
    limit = ENTRY_LADDER_FACTOR * ladder[3]
    total = Counter()
    rows = []
    for name, form, earlier, keys in ENTRY_FORMS:
        args = [ops_[key] for key in keys]
        hooked = Counter()
        prog = offload(form, policy,
                       on_site_event=lambda p: hooked.update([p["site"]]))
        on = [site for site in prog.sites(*args) if site.offloaded]
        want = sum(site.batch * site.mult for site in on)
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        out = prog(*args)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        total.update(launches)
        same = offload(earlier, policy)(*args)
        exact = form(*args)
        mag = form(*[t.abs() for t in args])
        rel = float(((out - exact).abs() / mag).max())
        rows.append(f"{name}: sites "
                    f"{[(s.name, s.m, s.k, s.n, s.batch) for s in on]}, K1 "
                    f"{launches['split_gemm']}, hook {sum(hooked.values())}"
                    f", error {rel:.3e}")
        print(f"[entry] {rows[-1]}", flush=True)
        if (not on or launches["split_gemm"] != want
                or sum(launches.values()) != want
                or sum(hooked.values()) != sum(s.mult for s in on)):
            fail(f"entry point {name}: K1 launches {launches}, hook "
                 f"{dict(hooked)} against the sites {on}")
        if not torch.equal(out, same):
            fail(f"entry point {name}: result differs from the earlier "
                 "form's bits")
        if not rel <= limit:
            fail(f"entry point {name}: error {rel:.3e} against FP64 over "
                 f"{ENTRY_LADDER_FACTOR} x the {n}^2 ladder's s=6 "
                 f"{ladder[3]:.3e}")
    gate = f"min(m,k,n)=1 < min_dim={policy.min_dim}"
    for name, form, keys in ENTRY_GATED:
        args = [ops_[key] for key in keys]
        prog = offload(form, policy)
        sites = [(s.name, s.offloaded, s.reason) for s in prog.sites(*args)]
        for key in ops.LAUNCHES:
            ops.LAUNCHES[key] = 0
        prog(*args)
        torch.cuda.synchronize()
        print(f"[entry] {name}: sites {sites}, K1 "
              f"{ops.LAUNCHES['split_gemm']}")
        if sites != [("dot0", False, gate)] or any(ops.LAUNCHES.values()):
            fail(f"entry point {name}: sites {sites} (want one gated "
                 f"dot0: {gate}), launches {dict(ops.LAUNCHES)}")
    print(f"[entry] {len(ENTRY_FORMS)} offloaded forms bitwise equal to "
          f"their earlier forms, errors within {limit:.3e}; "
          f"{len(ENTRY_GATED)} gated forms named and gated as the "
          f"reference; K1 {total['split_gemm']} launches; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {key: total[key] for key in ops.LAUNCHES}


EXAMPLES_DIR = os.path.join(ROOT, "build", "examples_smoke")
EXAMPLES_TIMEOUT = 600
# The full-width CLI's batch: 4 prompts of 16 tokens, one prefill wave
# of 64 rows; --min-dim at those rows puts K1 on its projections.
CLI_WAVE_ROWS = 4 * 16


def _example(*argv, timeout=EXAMPLES_TIMEOUT):
    """One example or ``python -m`` module, from ``EXAMPLES_DIR`` in a
    process of its own: its stdout and stderr together; fails on a
    nonzero exit."""
    cmd = [sys.executable] + [os.path.join(ROOT, "examples", a)
                              if a.endswith(".py") else a for a in argv]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=EXAMPLES_DIR, env=env, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          timeout=timeout)
    print(f"[examples] {' '.join(argv)}: exit {done.returncode} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if done.returncode:
        fail(f"{' '.join(argv)} exited {done.returncode}:\n"
             f"{done.stdout[-4000:]}")
    return done.stdout


def _gates(text, what, *present, absent=()):
    for want in present:
        if want not in text:
            fail(f"{what}: {want!r} not printed:\n{text[-4000:]}")
    for bad in absent:
        if bad in text:
            fail(f"{what}: {bad!r} printed:\n{text[-4000:]}")


def _live_scrape(argv):
    """Start the serve example with ``--metrics-port 0``, scrape its
    ``/metrics`` once decoding is done (the hold message), and wait for
    it to finish; returns (scraped series, its output)."""
    import queue
    import threading

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", argv[0])]
        + list(argv[1:]), cwd=EXAMPLES_DIR, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout] and None,
        daemon=True)
    reader.start()
    seen, url, series = [], None, None
    deadline = time.monotonic() + EXAMPLES_TIMEOUT
    try:
        while series is None:
            try:
                line = lines.get(timeout=max(deadline - time.monotonic(),
                                             0.1))
            except queue.Empty:
                fail(f"live scrape: no hold message:\n{''.join(seen)}")
            seen.append(line)
            if "live metrics: " in line:
                url = line.split("live metrics: ")[1].strip()
                url = url[:-len("/metrics")]
            if "holding /metrics" in line:
                if url is None:
                    fail(f"live scrape: no URL printed:\n{''.join(seen)}")
                series = _scrape(url)
        proc.wait(timeout=EXAMPLES_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=30)
    while not lines.empty():
        seen.append(lines.get())
    if proc.returncode:
        fail(f"live scrape: the server exited {proc.returncode}:\n"
             f"{''.join(seen)[-4000:]}")
    return series, "".join(seen)


def _k1_site_execs(directory):
    """Per run under ``directory`` (``events-NNNN.jsonl``), the K1
    executions its telemetry recorded: the ``mult`` of each
    ``site_exec`` event on the ``pallas_int8`` backend, summed."""
    runs = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("events-"):
            with open(os.path.join(directory, name)) as f:
                events = [json.loads(line) for line in f]
            runs.append(sum(e["mult"] for e in events
                            if e.get("type") == "site_exec"
                            and e.get("backend") == "pallas_int8"))
    return runs


def phase_examples(errs, served):
    """The examples workflow (``.github/workflows/examples.yml``) through
    the port's examples, each a process of its own on the card, in
    ``EXAMPLES_DIR``, held to the workflow's gates; then the full-width
    CLI, the quickstart and the MuST study.

    Tiny preset: train 4 steps (``fp64_int8_4``), serve that checkpoint;
    tune 2 batches into a plan, train 4 steps and serve under it; serve
    twice with ``--splits 6 --min-dim 64 --warm-cache-dir`` (the prefill
    wave's 64 rows: K1 held bitwise at the wave's shapes first, and each
    run's telemetry holding the K1 executions the site report predicts),
    then ``obs report --check --expect-cache-hit`` (the port's warm start
    re-checks decisions, so the restart counts through
    ``disk_decisions_hit``); a served run under the same flags with its
    live ``/metrics`` scraped for ``serve_ttft``, ``transform_cache`` and
    ``slo_burn_rate``; ``obs report --all --check`` and ``export`` over
    the plan lineage.  The obs CLI runs in this process (``_obs_cli``).

    Full width: ``python -m repro_torch.launch.serve``'s ``build`` and
    ``run`` (its ``main``, the runner wrapped in CUDA events between the
    two) serve SmolLM-360M from phase_train's step-4 checkpoint with
    ``--splits 6 --min-dim 64`` (its one wave's rows): K1 held bitwise
    at the wave's shapes first, its launches (counters zeroed just
    before, read just after) equal to the site report's prediction, its
    streams equal to an in-process ``Engine``'s on the same parameters
    and policy, its tokens/s printed beside phase 6's.  Then ``torch_quickstart.py``
    (the ladder strictly falling for s = 3..9) and
    ``torch_must_greens_function.py --n 384 --block 96 --energies 9``
    (``max_real`` falling with the splits, the error peak at the
    energies nearest E_f).  Returns K1's launches of the full-width run."""
    import contextlib
    import io
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import PrecisionPolicy, site_report
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import Model
    from repro_torch.serve import Engine, Request

    t0 = time.perf_counter()
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    os.makedirs(EXAMPLES_DIR)
    plan_dir = "runs/ckpt/torch_lm_tiny_plan"
    out = _example("torch_train_lm.py", "--steps", "4", "--backend",
                   "fp64_int8_4", "--preset", "tiny")
    _gates(out, "train", "[train_lm] OK: loss improved")
    out = _example("torch_serve_lm.py", "--preset", "tiny")
    _gates(out, "serve", "loading checkpoint step 4", "[serve] OK",
           absent=("restore failed",))
    out = _example("torch_train_lm.py", "--preset", "tiny", "--tune", "2",
                   "--plan", "runs/plans/tiny.json", "--ckpt-dir", plan_dir)
    _gates(out, "tune", "INT8 GEMMs per step")
    for path in ("runs/plans/tiny.json", "runs/plans/tiny.tiles.json"):
        if not os.path.getsize(os.path.join(EXAMPLES_DIR, path)):
            fail(f"tune: {path} is empty")
    out = _example("torch_train_lm.py", "--steps", "4", "--preset", "tiny",
                   "--plan", "runs/plans/tiny.json", "--ckpt-dir", plan_dir)
    _gates(out, "train under the plan", "[train_lm] OK")
    out = _example("torch_serve_lm.py", "--preset", "tiny", "--plan",
                   "runs/plans/tiny.json", "--ckpt-dir", plan_dir)
    _gates(out, "serve under the plan", "precision plan",
           "loading checkpoint step 4", "[serve] OK",
           absent=("restore failed",))
    # --min-dim at the tiny prefill wave's 64 rows: K1 on its
    # projections (decode ticks, 4 rows, stay gated).
    tiny = Model(get_config("tiny"), device="cpu", seed=0)
    wave_sites = [site for site in Engine(
        tiny, tiny.params, batch_slots=4, max_len=512,
        policy=PrecisionPolicy(backend="pallas_int8", default_splits=6,
                               min_dim=CLI_WAVE_ROWS)).prefill_sites(4, 16)
        if site.offloaded]
    phase_k1_train_shapes(errs, sorted({(s_.m, s_.k, s_.n)
                                        for s_ in wave_sites}),
                          s=6, tag="examples")
    per_run = sum(site.mult for site in wave_sites)
    del tiny
    warm = ["--preset", "tiny", "--splits", "6", "--min-dim",
            str(CLI_WAVE_ROWS), "--max-new-tokens", "8",
            "--warm-cache-dir", "runs/serve-cache", "--ckpt-dir", plan_dir]
    for _ in range(2):
        out = _example("torch_serve_lm.py", *warm, "--metrics-dir",
                       "runs/serve-restart/metrics")
        _gates(out, "serve restart", "[serve] OK")
    restart = os.path.join(EXAMPLES_DIR, "runs/serve-restart/metrics")
    execs = _k1_site_execs(restart)
    print(f"[examples] warm restart: K1 executions per run {execs} "
          f"(telemetry), {per_run} predicted from the site report")
    if execs != [per_run] * 2 or per_run == 0:
        fail(f"warm restart: K1 executions {execs} != {per_run} per run")
    code, text = _obs_cli("report", restart, "--check", "--expect-cache-hit")
    if code:
        fail(f"obs report --check --expect-cache-hit exited {code}:\n{text}")
    series, out = _live_scrape(
        ["torch_serve_lm.py"] + warm
        + ["--metrics-dir", "runs/serve-live/metrics", "--latency-target-s",
           "120", "--scheduler-policy", "edf", "--metrics-port", "0",
           "--hold-metrics-s", "3"])
    _gates(out, "live serve", "[serve] OK")
    execs = _k1_site_execs(os.path.join(EXAMPLES_DIR,
                                        "runs/serve-live/metrics"))
    if execs != [per_run]:
        fail(f"live serve: K1 executions {execs} != [{per_run}]")
    names = {name for name, _ in series}
    for want in ("serve_ttft", "transform_cache", "slo_burn_rate"):
        if not any(name.startswith(want) for name in names):
            fail(f"/metrics carries no {want} series: {sorted(names)}")
    lineage = os.path.join(EXAMPLES_DIR, plan_dir, "metrics")
    trace = os.path.join(EXAMPLES_DIR, "trace.json")
    for argv in (("report", lineage, "--all", "--check"),
                 ("export", lineage, "--all", "-o", trace)):
        code, text = _obs_cli(*argv)
        if code:
            fail(f"obs {' '.join(argv)} exited {code}:\n{text}")
    if not os.path.getsize(trace):
        fail("obs export wrote an empty trace")
    print(f"[examples] tiny workflow: every gate held; /metrics "
          f"{sorted(n for n in names if n.startswith(('serve_ttft', 'transform_cache', 'slo_burn_rate')))}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # Full width: the CLI serves phase_train's checkpoint.
    t1 = time.perf_counter()
    cfg = get_config("smollm_360m")
    kn = serve_gemm_shapes(cfg)
    phase_k1_train_shapes(errs, [(CLI_WAVE_ROWS, k, n) for k, n in kn],
                          s=6, tag="examples")
    argv = ["--arch", "smollm_360m", "--splits", "6", "--min-dim",
            str(CLI_WAVE_ROWS), "--ckpt-dir", SERVE_CKPT_DIR,
            "--metrics-dir", "none"]
    text = io.StringIO()
    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    with contextlib.redirect_stdout(text):
        args, eng, reqs = serve_cli.build(argv, device="cuda")
        cli = _timed_runner(eng.runner)
        done = serve_cli.run(args, eng, reqs)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(text.getvalue(), end="")
    _gates(text.getvalue(), "full-width serve", "loading checkpoint step 4",
           "[serve] OK", absent=("restore failed",))
    policy = eng.policy
    if cli["waves"] != [(4, 16)]:
        fail(f"full-width serve: waves {cli['waves']}, expected one of "
             "(4, 16)")
    per_wave = sum(site.mult for rows, width in cli["waves"]
                   for site in eng.prefill_sites(rows, width)
                   if site.offloaded)
    with torch.no_grad():
        decode_sites = site_report(eng.model.decode_step_paged, policy)(
            eng.params, eng.cache,
            torch.zeros(4, dtype=torch.int32, device="cuda"),
            torch.ones(4, dtype=torch.bool, device="cuda"))
    per_tick = sum(site.mult for site in decode_sites if site.offloaded)
    predicted = per_wave + per_tick * cli["ticks"]
    print(f"[examples] full-width CLI: K1 launches {launches['split_gemm']}"
          f", predicted {predicted} from the site report ({per_wave} a "
          f"wave of {CLI_WAVE_ROWS} rows, {per_tick} a tick x "
          f"{cli['ticks']} ticks)")
    if launches != {"split_gemm": predicted, "split_gemm_fused": 0,
                    "split_gemm_v1": 0, "gather_pairs_kmajor": 0} \
            or predicted == 0:
        fail(f"full-width CLI launches {launches} != predicted {predicted}")
    again = Engine(eng.model, eng.params, batch_slots=4, max_len=512,
                   policy=policy)
    gen = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            gen.integers(1, cfg.vocab_size, 16)],
                    max_new_tokens=24, seed=i) for i in range(4)]
    again.run(reqs)
    if [r.out for r in reqs] != [r.out for r in done]:
        fail("full-width CLI streams differ from an in-process Engine's")
    rec = served["rec"]
    print(f"[examples] full-width CLI: streams equal an in-process "
          f"Engine's for 4 of 4; prefill {cli['prefill_tokens']} tokens "
          f"{cli['prefill_tokens'] / (cli['prefill_ms'] / 1e3):.1f} tok/s, "
          f"decode {cli['decode_tokens']} tokens "
          f"{cli['decode_tokens'] / (cli['decode_ms'] / 1e3):.1f} tok/s "
          f"(CUDA events; phase 6: prefill "
          f"{rec['prefill_tokens'] / (rec['prefill_ms'] / 1e3):.1f}, decode "
          f"{rec['decode_tokens'] / (rec['decode_ms'] / 1e3):.1f} tok/s); "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    del again, eng, done
    shutil.rmtree(SERVE_CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # The studies.
    out = _example("torch_quickstart.py")
    _gates(out, "quickstart", "[quickstart] OK")
    ladder = [float(x) for x in re.findall(
        r"fp64_int8_\d\s+(\S+)\n", out)][:7]
    if len(ladder) != 7 or not all(b < a for a, b in zip(ladder, ladder[1:])):
        fail(f"quickstart ladder {ladder} does not fall strictly")
    must_dir = os.path.join(EXAMPLES_DIR, "runs", "must_torch")
    out = _example("torch_must_greens_function.py", "--n", "384",
                   "--block", "96", "--energies", "9", "--splits", "3",
                   "6", "9", "--outdir", must_dir)
    table = [line.split(",") for line in open(
        os.path.join(must_dir, "table1.csv")).read().split()[1:]]
    worst = [float(row[1]) for row in table]
    if not worst[0] > worst[1] > worst[2]:
        fail(f"MuST example max_real does not fall with s: {worst}")
    fig = [line.split(",") for line in open(
        os.path.join(must_dir, "fig1.csv")).read().split()[1:]]
    for mode in ("fp64_int8_3", "fp64_int8_6"):
        rows_ = [(float(r[1]), float(r[3])) for r in fig if r[0] == mode]
        dist = [abs(re_z - FERMI) for re_z, _ in rows_]
        peak = max(range(len(rows_)), key=lambda i: rows_[i][1])
        if dist[peak] > min(dist) + 1e-4:
            fail(f"MuST example {mode} error peaks at E="
                 f"{rows_[peak][0]}, not nearest E_f")
    print(f"[examples] quickstart ladder {ladder}; MuST n=384 max_real "
          f"{worst} (s = 3, 6, 9), peaks nearest E_f; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    return launches


def phase_init():
    """Seeded parameters (``repro_torch.models.prng``) on the card against
    the CPU, to the bit, for the ``tiny`` config at two seeds, and the
    full-width SmolLM-360M init's time on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import checkpoint

    cfg = get_config("tiny")
    differ = 0
    for seed in (0, 2 ** 31 + 5):
        cpu = checkpoint.tree_flatten(Model(cfg, device="cpu",
                                            seed=seed).params)
        card = checkpoint.tree_flatten(Model(cfg, device="cuda",
                                             seed=seed).params)
        differ += sum(int((a.view(torch.int32) != b.cpu().view(
            torch.int32)).sum()) for a, b in zip(cpu, card))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = Model(get_config("smollm_360m"), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"[init] tiny params (seeds 0, 2**31+5) card vs CPU: {differ} "
          f"elements differ; full-width SmolLM-360M init on the card "
          f"{init_s:.2f} s ({full.cfg.num_params():,} parameters)")
    if differ:
        fail(f"seeded parameters differ between the card and the CPU in "
             f"{differ} elements")
    del full


def phase_pow2(n=1 << 20, seed=11):
    """``_pow2_scale`` on the card against the CPU, to the bit, at ``n``
    random float64 amax values spread over the whole exponent range
    (subnormals included: a uniformly drawn biased exponent, 0 to 2046,
    and random mantissa bits), as rows of one."""
    from repro_torch.core.ozaki import _pow2_scale

    gen = np.random.default_rng(seed)
    bits = (gen.integers(0, 2047, n, dtype=np.int64) << 52) | \
        gen.integers(0, 1 << 52, n, dtype=np.int64)
    x = torch.from_numpy(bits.view(np.float64).reshape(-1, 1).copy())
    on_card = _pow2_scale(x.cuda(), 1).cpu()
    differ = int((on_card.view(torch.int64)
                  != _pow2_scale(x, 1).view(torch.int64)).sum())
    sub = int((x.abs() < torch.finfo(torch.float64).tiny).sum())
    print(f"[kernels] _pow2_scale card vs CPU at {n} random amax values "
          f"(exponents 2**-1074 to 2**1023, {sub} subnormal): {differ} "
          "differ")
    if differ:
        fail(f"_pow2_scale differs between the card and the CPU at {differ} "
             "inputs")


def bound(ops_count, nbytes):
    """Least time on the card in ms, through
    ``repro_torch.analysis.roofline`` at ``H100_PEAKS``: int8 ops at the
    INT8 peak against bytes at the HBM rate, the larger, and which one
    it is."""
    from repro_torch.analysis.roofline import analyze_cell

    cell = analyze_cell({"flops": ops_count, "int8_flops": ops_count,
                         "hbm_bytes": nbytes})
    return cell.bound_s * 1e3, ("operations" if cell.dominant == "compute"
                                else "bytes")


def phase_k1_timings(errs, launches, shapes):
    """K1 at ``k1_timed_shapes()``: event-timed through the k-major entry
    the main paths call, its device time (``device_ms``), its bound (int8 ops
    2*m*n*k*P against bytes s*(m*k + k*n) + 8*m*n), the FP64
    torch.matmul it stands in for, the P pair products as torch._int_mm,
    and its plain version.  Returns its JSON rows."""
    from repro_torch.core.ozaki import num_pair_gemms, slice_matrix
    from repro_torch.kernels import ops, tile_model

    gen = np.random.default_rng(2)
    saved = dict(ops.LAUNCHES)
    rows = []
    for (m, k, n), s in shapes:
        a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
        b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
        pairs = num_pair_gemms(s)
        bk = tile_model.select_tiles(m, k, n, s).block_k
        plan = tile_model.k1_plan(m, k, n, s, bk)
        a_sl, _ = slice_matrix(a, s, axis=1)
        b_t, _ = slice_matrix(b.mT, s, axis=1)
        ia = [a_sl[i].contiguous() for i in range(s)]
        ib = [b_t[j].T.contiguous() for j in range(s)]
        ii, jj = tile_model.pair_schedule(s)

        def kernel():
            return ops.split_gemm_kmajor(a_sl, b_t, s, block_k=bk)

        ms = timed(kernel, 50)
        dev_ms = device_ms(kernel)
        if dev_ms is None:
            fail(f"K1's device time at {(m, k, n, s)} is not in its trace")
        library_ms = timed(lambda: a @ b, 20)
        int_mm_ms = timed(lambda: [torch._int_mm(ia[i], ib[j])
                                   for i, j in zip(ii, jj)], 10)
        ops_count = 2 * m * n * k * pairs
        bound_ms, bound_by = bound(ops_count, s * (m * k + k * n) + 8 * m * n)
        plain_ms = timed(lambda: ops.split_gemm_kmajor_plain(
            a_sl, b_t, s, block_k=bk), 3)
        print(f"[time] split_gemm (K1) at (m,k,n)=({m},{k},{n}) s={s} "
              f"{plan_label(plan)}: {ms:.4f} ms (kernel on the device "
              f"{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), f64 torch.matmul "
              f"{library_ms:.4f} ms, {pairs} torch._int_mm {int_mm_ms:.4f} "
              f"ms, {ops_count / ms / 1e9:.1f} int8 TOPS", flush=True)
        rows.append({
            "name": "split_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/split_gemm.cu",
            "replaces": "src/repro/kernels/ops.py:186",
            "launches": launches["split_gemm"],
            "max_abs_err": errs["split_gemm"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": [m, k, n, s], "device_ms": dev_ms,
            "int_mm_ms": int_mm_ms})
    ops.LAUNCHES.update(saved)
    return rows


def phase_timings(errs, launches, m=256, k=256, n=4096):
    """K2 and K3 (with its gather) at the MuST shape for s in SPLITS;
    the JSON rows are s = 6's.  Bounds as ``bound``, over the bytes each
    function must move."""
    from repro_torch.core.ozaki import num_pair_gemms, slice_matrix
    from repro_torch.kernels import ops, slicing, tile_model

    gen = np.random.default_rng(2)
    a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
    b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
    ah, al, _ = slicing.to_operand_pair(a, axis=1)
    bh, bl, _ = slicing.to_operand_pair(b, axis=0)
    saved = dict(ops.LAUNCHES)

    library_ms = timed(lambda: a @ b, 20)
    rows = []
    for s in SPLITS:
        pairs = num_pair_gemms(s)
        bk = tile_model.select_tiles(m, k, n, s).block_k
        a_sl, _ = slice_matrix(a, s, axis=1)
        b_sl, _ = slice_matrix(b, s, axis=0)
        ia = [a_sl[i].contiguous() for i in range(s)]
        ib = [b_sl[j].contiguous() for j in range(s)]
        ii, jj = tile_model.pair_schedule(s)
        int_mm_ms = timed(lambda: [torch._int_mm(ia[i], ib[j])
                                   for i, j in zip(ii, jj)], 10)
        ops_count = 2 * m * n * k * pairs
        layer = m * k + k * n
        specs = [
            ("split_gemm_fused", "src/repro/kernels/ops.py:252",
             lambda: ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk),
             lambda: ops.split_gemm_fused_plain(ah, al, bh, bl, s,
                                                block_k=bk),
             8 * layer + 8 * m * n),
            # K3 reads the P gathered pair copies and the weight array; the
            # timed call includes the wrapper's gather, as the reference's.
            ("split_gemm_v1", "src/repro/kernels/ops.py:315",
             lambda: ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk),
             lambda: ops.split_gemm_v1_plain(a_sl, b_sl, s, block_k=bk),
             pairs * layer + 4 * pairs + 8 * m * n),
        ]
        for name, replaces, kernel, plain, nbytes in specs:
            ms = timed(kernel, 50)
            dev_ms = device_ms(kernel)
            bound_ms, bound_by = bound(ops_count, nbytes)
            plain_ms = timed(plain, 5)
            print(f"[time] {name} at (m,k,n)=({m},{k},{n}) s={s}: "
                  f"{ms:.4f} ms (kernel on the device {fmt_ms(dev_ms)}), "
                  f"plain "
                  + (f"{plain_ms:.4f} ms" if plain_ms else "not timed")
                  + f", bound {bound_ms:.4f} ms ({bound_by}), f64 "
                  f"torch.matmul {library_ms:.4f} ms, {pairs} torch._int_mm "
                  f"{int_mm_ms:.4f} ms, {ops_count / ms / 1e9:.1f} int8 TOPS")
            if s == 6:
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/split_gemm.cu",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms})
        # K3 split in two: its kernel alone on gathered copies, and the
        # gather (P copies written, the s slice layers they come from
        # read).
        copies = ops.gather_pairs_kmajor(a_sl, b_sl, s)
        alone_ms = timed(lambda: ops.split_gemm_v1_pairs(*copies,
                                                         block_k=bk), 50)
        alone_bound, alone_by = bound(ops_count,
                                      pairs * layer + 4 * pairs + 8 * m * n)
        gather = lambda: ops.gather_pairs_kmajor(a_sl, b_sl, s)  # noqa: E731
        gather_ms = timed(gather, 50)
        gather_dev = device_ms(gather)
        gather_bound, _ = bound(0, pairs * layer + s * layer)
        print(f"[time] split_gemm_v1 at s={s}: kernel alone {alone_ms:.4f} "
              f"ms (bound {alone_bound:.4f} ms, {alone_by}), "
              f"gather_pairs_kmajor {gather_ms:.4f} ms (kernel on the "
              f"device {fmt_ms(gather_dev)}; bound {gather_bound:.4f} ms, "
              f"bytes)")
        if s == 6:
            rows.append({
                "name": "gather_pairs_kmajor", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/split_gemm.cu",
                "replaces": "src/repro/kernels/ops.py:330",
                "launches": launches["gather_pairs_kmajor"],
                "max_abs_err": errs["gather_pairs_kmajor"], "ms": gather_ms,
                "plain_ms": timed(lambda: ops.gather_pairs_kmajor_plain(
                    a_sl, b_sl, s), 20),
                "bound_ms": gather_bound, "bound_by": "bytes",
                "library_ms": None})
    t = tile_model.traffic(m, k, n, 6)
    print(f"[time] traffic at s=6: slice_read_bytes_v1 "
          f"{t.slice_read_bytes_v1}, slice_read_bytes_v2 "
          f"{t.slice_read_bytes_v2}, read_reduction {t.read_reduction}")
    for key, val in saved.items():
        ops.LAUNCHES[key] = val
    return rows


def k1_timed_shapes():
    """((m, k, n), s) at which K1 is timed: the MuST block GEMMs at
    their smallest and largest N for s in SPLITS, and the LM's prefill
    GEMMs (m a full 2 x 256 wave, every (k, n) of SmolLM-360M) at s=6."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm_360m")
    kn = serve_gemm_shapes(cfg)
    train = [shape for shape in train_gemm_shapes(cfg, 512)
             if shape[0] != 512 or shape[1:] not in kn]
    return ([((256, 256, nn), s) for nn in (256, 4096) for s in SPLITS]
            + [((512, k, n), 6) for k, n in kn]
            + [(shape, TRAIN_SPLITS) for shape in train])


def k1_plans_sweep():
    """--k1-plans: K1 under every plan ``tile_model.k1_plans`` gives at
    the timed shapes, each held bitwise against its plain version and
    timed (CUDA events, and ``device_ms``)."""
    from repro_torch.core.ozaki import slice_matrix
    from repro_torch.kernels import ops, tile_model

    phase_card()
    gen = np.random.default_rng(5)
    failed = []
    for (m, k, n), s in k1_timed_shapes():
        a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
        b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
        a_sl, _ = slice_matrix(a, s, axis=1)
        b_t, _ = slice_matrix(b.mT, s, axis=1)
        if not b_t.is_contiguous():
            fail(f"k-major slices of B not contiguous at {(k, n, s)}")
        bk = tile_model.select_tiles(m, k, n, s).block_k
        want = ops.split_gemm_kmajor_plain(a_sl, b_t, s, block_k=bk)
        rule = tile_model.k1_plan(m, k, n, s, bk)
        for plan in tile_model.k1_plans(m, k, n, s, bk):
            def run(plan=plan):
                return ops.split_gemm_kmajor(a_sl, b_t, s, block_k=bk,
                                             plan=plan)
            try:
                check("split_gemm", run(), want, {}, (m, k, n, s))
            except SystemExit as exc:
                failed.append(f"{plan_label(plan)}: {exc}")
                print(f"[k1-plans] {failed[-1]}", flush=True)
                continue
            ms = timed(run, 30)
            dev = device_ms(run)
            print(f"[k1-plans] ({m},{k},{n}) s={s} {plan_label(plan)}"
                  f"{' (rule)' if plan == rule else ''}: {ms:.4f} ms, "
                  f"device {fmt_ms(dev)}, {plan.ctas} CTAs", flush=True)
    if failed:
        fail(f"{len(failed)} K1 plans differ from the plain version")
    print("[k1-plans] every plan bitwise equal to the plain version")


# One --fused-ab run, in its checkout; uses only what the parent and
# the change both offer (the MuST app, K2's wrapper and its preamble).
_FUSED_AB_RUN = """
import sys, time
import numpy as np, torch
sys.path.insert(0, "src")
from torch.profiler import ProfilerActivity, profile
from repro_torch.apps import must
from repro_torch.kernels import ops, slicing

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = np.random.default_rng(2)
a = torch.from_numpy(gen.standard_normal((256, 256))).cuda()
b = torch.from_numpy(gen.standard_normal((256, 4096))).cuda()
ah, al, _ = slicing.to_operand_pair(a, axis=1)
bh, bl, _ = slicing.to_operand_pair(b, axis=0)
k2 = lambda: ops.split_gemm_fused(ah, al, bh, bl, 6, block_k=256)
for _ in range(3):
    k2()
torch.cuda.synchronize()
start = torch.cuda.Event(enable_timing=True)
stop = torch.cuda.Event(enable_timing=True)
start.record()
for _ in range(50):
    k2()
stop.record()
torch.cuda.synchronize()
k2_ms = start.elapsed_time(stop) / 50

cfg = must.MustConfig(n=4096, block=256, n_energies=9)
system = must.build_system(cfg)
mode = "pallas_int8_6:fused"
t0 = time.perf_counter()
must.run_contour(cfg, mode, system)
torch.cuda.synchronize()
contour_s = time.perf_counter() - t0

h = torch.as_tensor(system["H"], device="cuda")
m_mat = complex(0.72 + 1j * cfg.eta) * torch.eye(
    4096, dtype=torch.complex128, device="cuda") - h
gemm = must._make_gemm(mode)
must._blocked_inverse(m_mat, 256, gemm)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    must._blocked_inverse(m_mat, 256, gemm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
events = prof.key_averages()
busy = sum(e.self_device_time_total for e in events) / 1e6
fused = [e for e in events if "split_gemm_fused" in e.key]
k2_s = sum(e.self_device_time_total for e in fused) / 1e6
print(f"[fused-ab] k2_ms={k2_ms:.4f} contour_s={contour_s:.2f} "
      f"energy_wall_s={wall:.3f} busy_s={busy:.3f} k2_s={k2_s:.3f} "
      f"k2_launches={sum(e.count for e in fused)}")
"""


# One --k1-ab run, in its checkout; uses only what the parent and the
# change both offer (K1's wrapper, the MuST app, the serve engine and
# this script's timed and _smollm).
_K1_AB_RUN = """
import sys, time
import numpy as np, torch
sys.path[:0] = ["src", "."]
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.apps import must
from repro_torch.core import PrecisionPolicy, offload
from repro_torch.core.ozaki import slice_matrix
from repro_torch.kernels import ops, tile_model
from repro_torch.serve import Engine, Request

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def k1_profile(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if "split_gemm_kernel" in e.key]
    return (sum(e.self_device_time_total for e in found) / 1e3,
            sum(e.count for e in found))


def host_us(fn, calls):
    # Host microseconds per call over `calls` calls with no synchronize
    # between them (the card runs behind).
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


out = []
gen = np.random.default_rng(2)
shapes = ([((256, 256, nn), s) for nn in (256, 4096) for s in (3, 6, 9)]
          + [((512, k, n), 6) for k, n in ((960, 960), (960, 320),
                                           (960, 2560), (2560, 960))])
for (m, k, n), s in shapes:
    a = torch.from_numpy(gen.standard_normal((m, k))).cuda()
    b = torch.from_numpy(gen.standard_normal((k, n))).cuda()
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    if hasattr(ops, "split_gemm_kmajor"):
        b_t, _ = slice_matrix(b.mT, s, axis=1)
        run = lambda: ops.split_gemm_kmajor(a_sl, b_t, s, block_k=bk)
    else:
        b_sl, _ = slice_matrix(b, s, axis=0)
        run = lambda: ops.split_gemm(a_sl, b_sl, s, block_k=bk)
    ms = cs.timed(run, 30)
    dev, count = k1_profile(lambda: [run() for _ in range(20)])
    tag = f"k1_{m}_{k}_{n}_s{s}"
    out.append(f"{tag}_ms={ms:.4f} {tag}_device_ms={dev / count:.4f} "
               f"{tag}_host_us={host_us(run, 200):.2f}")
    if m == 256:   # the MuST GEMM, slicing included
        gemm = lambda: ops.ozaki_matmul(a, b, s)
        out.append(f"ozaki_{m}_{k}_{n}_s{s}_host_us="
                   f"{host_us(gemm, 100):.2f}")

cfg = must.MustConfig(n=4096, block=256, n_energies=9)
system = must.build_system(cfg)
t0 = time.perf_counter()
must.run_contour(cfg, "pallas_int8_6", system)
torch.cuda.synchronize()
out.append(f"contour_s={time.perf_counter() - t0:.2f}")

model = cs._smollm("float32", 3)
policy = PrecisionPolicy(backend="pallas_int8", default_splits=6)
eng = Engine(model, model.params, policy=policy, kv_layout="paged",
             batch_slots=4, max_len=1024, block_size=16, chunk_tokens=256,
             chunk_token_budget=512)
eng.run([Request(prompt=list(range(1, 300)), max_new_tokens=2)])
rows, width = 2, 256
table = torch.as_tensor(np.tile(eng.kv._table[:1], (rows, 1)),
                        device="cuda")
args = (model.params, eng.cache["k"], eng.cache["v"], table,
        torch.ones((rows, width), dtype=torch.int32, device="cuda"),
        torch.zeros(rows, dtype=torch.int32, device="cuda"),
        torch.full((rows,), width, dtype=torch.int32, device="cuda"))
wave = offload(model.prefill_chunk_paged, policy)
with torch.no_grad():
    wave(*args)
    torch.cuda.synchronize()
    k1_ms, count = k1_profile(lambda: wave(*args))
out.append(f"wave_k1_ms={k1_ms:.2f} wave_k1_launches={count}")
print("[k1-ab] " + " ".join(out))
"""


def ab(script, tag, parent, change, pairs=2):
    """Alternate ``script`` in two checkouts on this card: pair i runs
    PARENT then CHANGE, pair i + 1 CHANGE then PARENT, each in a process
    of its own from its checkout's root; print every run's
    ``[tag] key=value ...`` line and each key's median per checkout."""
    import statistics

    if not torch.cuda.is_available():
        raise SystemExit(f"chip_smoke: no CUDA device; --{tag} runs only "
                         "on the card")
    readings = {}   # (checkout, key) -> [value]
    for i in range(int(pairs)):
        order = [("parent", parent), ("change", change)]
        for name, root in (order if i % 2 == 0 else order[::-1]):
            proc = subprocess.run([sys.executable, "-c", script],
                                  cwd=root, capture_output=True, text=True,
                                  timeout=900)
            found = re.search(rf"\[{tag}\] (.*)", proc.stdout)
            if proc.returncode != 0 or not found:
                fail(f"--{tag}: {name} run {i} failed:\n"
                     f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            print(f"[{tag}] pair {i} {name}: {found.group(1)}", flush=True)
            for key, val in re.findall(r"(\w+)=([\d.]+)", found.group(1)):
                readings.setdefault((name, key), []).append(float(val))
    for (name, key), vals in sorted(readings.items(),
                                    key=lambda kv: (kv[0][1], kv[0][0])):
        print(f"[{tag}] median {name} {key}: "
              f"{statistics.median(vals):.4f} over {vals}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    from repro_torch.configs import get_config

    phase_card()
    errs = {}
    phase_init()
    checked_kn = phase_kernels_vs_plain(errs)
    phase_pow2()
    phase_k1_plans(errs)
    ladder = phase_ladder()
    launches = phase_must()
    phase_profile("pallas_int8_6")
    phase_profile("pallas_int8_6:fused")
    v1_launches = phase_v1_ab(errs)
    serve_launches, served = phase_serve(checked_kn)
    served["launches"] = serve_launches["split_gemm"]
    torch.cuda.empty_cache()
    phase_lm_ladder()
    torch.cuda.empty_cache()
    train_launches, trained = phase_train(errs)
    torch.cuda.empty_cache()
    shard_launches, shard_shapes = phase_shard(errs, trained)
    torch.cuda.empty_cache()
    serve_shard_launches, serve_shard_shapes = phase_serve_shard(
        errs, served, shard_shapes)
    torch.cuda.empty_cache()
    mesh_launches, mesh_shapes = phase_mesh_large(
        errs, set(train_gemm_shapes(get_config("smollm_360m"), 512))
        | set(shard_shapes))
    torch.cuda.empty_cache()
    tune_launches, tune_pairs = phase_tune(errs, trained)
    torch.cuda.empty_cache()
    obs_launches = phase_obs(served, trained)
    torch.cuda.empty_cache()
    warm_launches = phase_warm_start(served)
    torch.cuda.empty_cache()
    cf_launches = phase_control_flow()
    torch.cuda.empty_cache()
    entry_launches = phase_entry_points(errs, ladder)
    torch.cuda.empty_cache()
    example_launches = phase_examples(errs, served)
    torch.cuda.empty_cache()
    # Launch counts per kernel: the main paths' runs (MuST, serve, train,
    # the train and serve meshes' ranks, reduced_100m on one device and
    # its tp=8 ranks, the tune phase's plan-driven
    # train and serve, both again with telemetry on, the warm-started
    # serve and the control-flow program) and K3's A/B path, each read
    # with the counters zeroed before it.
    total = {key: launches[key] + serve_launches[key] + v1_launches[key]
             + train_launches[key] + shard_launches[key]
             + serve_shard_launches[key] + mesh_launches[key]
             + tune_launches[key]
             + obs_launches[key] + warm_launches[key] + cf_launches[key]
             + entry_launches[key] + example_launches[key]
             for key in launches}
    print(f"[launches] MuST {launches}, serve {serve_launches}, "
          f"train {train_launches}, shard ranks {shard_launches}, "
          f"serve-shard ranks {serve_shard_launches}, big-mesh runs "
          f"{mesh_launches}, tune "
          f"{tune_launches}, obs "
          f"{obs_launches}, warm start {warm_launches}, control flow "
          f"{cf_launches}, entry points {entry_launches}, full-width CLI "
          f"{example_launches}, v1 A/B {v1_launches}")
    shapes = k1_timed_shapes()
    shapes += [pair for pair in tune_pairs if pair not in shapes][:3]
    shapes += [(shape, TRAIN_SPLITS) for shape in shard_shapes
               if (shape, TRAIN_SPLITS) not in shapes]
    # The tp=8 ranks' per-shard GEMMs of reduced_100m.
    shapes += [(shape, TRAIN_SPLITS) for shape in mesh_shapes
               if (shape, TRAIN_SPLITS) not in shapes]
    # The serve tp=5 ranks' per-shard GEMMs at the 3-row waves' m (768).
    shapes += [(shape, TRAIN_SPLITS) for shape in serve_shard_shapes
               if shape[0] == 768 and shape[1:] in SERVE_TP5_KN
               and (shape, TRAIN_SPLITS) not in shapes]
    # The entry points' new shapes and the CLI's waves: full width, and
    # the tiny examples' served in their own processes.
    shapes += [((4096, 4096, 4096), ENTRY_SPLITS),
               ((4096, ENTRY_BATCH * 4096, 4096), ENTRY_SPLITS)]
    shapes += [((CLI_WAVE_ROWS, k, n), 6) for arch in ("smollm_360m", "tiny")
               for k, n in serve_gemm_shapes(get_config(arch))]
    rows = (phase_k1_timings(errs, total, shapes)
            + phase_timings(errs, total))
    print(json.dumps({"kernels": rows}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fused-ab"]:
        ab(_FUSED_AB_RUN, "fused-ab", *sys.argv[2:])
    elif sys.argv[1:2] == ["--k1-ab"]:
        ab(_K1_AB_RUN, "k1-ab", *sys.argv[2:])
    elif sys.argv[1:2] == ["--k1-plans"]:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; --k1-plans runs "
                             "only on the card")
        k1_plans_sweep()
    else:
        main()
