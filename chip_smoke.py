"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an
H100 for the numbers in PERF.md).  The script builds the split-GEMM
kernels from ``src/repro_torch/kernels/csrc`` with nvcc, then:

1. prints the card's name and power limit and the kernels' build;
2. holds K1, K2 and K3 bitwise (hi and lo, tolerance 0) against their
   plain PyTorch versions on the card, and K3 against K1, at the listed
   shapes and split counts, K2 from f32 and from f64 sources; and K1
   and K3 so at the GEMM shapes the serve phase gives K1 (every
   projection and MLP (k, n) of SmolLM-360M, m a full and a ragged
   wave);
3. runs the accuracy ladder at 4096^2 in float64 through
   ``pallas_int8_s`` for s = 3..9;
4. runs the MuST Green's-function contour (n=4096, block=256, 9
   energies) through ``dgemm`` and the kernel modes — one main path —
   with the launch counters zeroed just before and read just after,
   and checks the Table-1 ladder, the Figure-1 peak and the launch
   counts; then profiles one energy point of it for the device's busy
   share;
5. runs K3's path, the reference's v1/v2 A/B check: K3 against K1 at
   the MuST shape for s = 3, 6, 9, counters zeroed before and read
   after, with the traffic figures of ``tile_model.traffic``;
6. serves SmolLM-360M at full width (32 layers, random weights from a
   seed) through ``repro_torch.serve.Engine`` — the other main path —
   natively (``dgemm``) and through ``pallas_int8_6``: prefill and
   decode tokens/s on the card's clock, K1's launch count against the
   count the site report predicts, paged == dense greedy tokens, one
   emulated prefill wave profiled for the device's idle share, and the
   float64 LM's prefill logits ladder for s = 3..9, once as the model
   computes (softmax and SwiGLU gate in float32, as the reference) and
   once with those float32 stages raised to float64, where the ladder
   shows the emulated GEMMs' own error;
7. times each kernel, its plain version, its bound and the library
   call it stands in for at the MuST shape (256, 256, 4096), s=6;
8. prints one JSON line describing every ported kernel, the card line,
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
SPLITS = (3, 6, 9)
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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")


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
        for s in SPLITS:
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
                    got3 = ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk)
                    want3 = ops.split_gemm_v1_plain(a_sl, b_sl, s,
                                                    block_k=bk)
                    check("split_gemm_v1", got3, want3, errs, (m, k, n, s))
                    check("split_gemm_v1 vs split_gemm", got3, got, {},
                          (m, k, n, s))
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
          f"(K2 from f32 and f64 sources)")

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
    torch.cuda.synchronize()
    print(f"[kernels] K1 and K3 bitwise equal to their plain versions and "
          f"K3 to K1 at SmolLM-360M's GEMM shapes: m in (512, 221) x "
          f"(k, n) in {kn} x s in {SPLITS}")

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
                "split_gemm_v1": 0}
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
                    "split_gemm_v1": 3}:
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
    record they fill (device ms, real tokens, wave shapes, ticks)."""
    rec = {"prefill_ms": 0.0, "decode_ms": 0.0, "prefill_tokens": 0,
           "decode_tokens": 0, "waves": [], "ticks": 0}
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
        if res is not None:
            rec["prefill_ms"] += start.elapsed_time(stop)
            rec["prefill_tokens"] += res.real_tokens
            rec["waves"].append((res.rows, res.width))
        return res

    def timed_tick(next_token, active, reqs):
        start, stop = events()
        start.record()
        out = tick(next_token, active, reqs)
        stop.record()
        stop.synchronize()
        rec["decode_ms"] += start.elapsed_time(stop)
        rec["decode_tokens"] += int(active.sum())
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

    def serve(pol, layout="paged", reqs_prompts=prompts, new=max_new):
        eng = Engine(model, model.params, policy=pol, kv_layout=layout,
                     **engine_kw)
        rec = _timed_runner(eng.runner)
        reqs = [Request(prompt=p, max_new_tokens=new)
                for p in reqs_prompts]
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
                    "split_gemm_v1": 0} or predicted == 0:
        fail(f"serve launch counts {launches} != predicted {predicted}")
    same = sum(a == b for a, b in zip(toks_native, toks_emul))
    print(f"[serve] dgemm and pallas_int8_{splits} greedy streams equal for "
          f"{same} of {n_requests} requests")

    _, toks_dense, _ = serve(policy, layout="dense")
    if toks_dense != toks_emul:
        fail("paged and dense greedy tokens differ under "
             f"pallas_int8_{splits}")
    print(f"[serve] paged == dense: identical greedy tokens for all "
          f"{n_requests} requests under pallas_int8_{splits}")

    _profile_wave(eng, policy)
    del eng
    return launches


def _profile_wave(eng, policy, rows=2, width=256):
    """Device busy share of one emulated prefill wave."""
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
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy <= 0:
        print("[serve] no device time in the trace: idle share not "
              "measured")
        return
    print(f"[serve] one emulated prefill wave ({rows}x{width} tokens): "
          f"wall {wall:.3f} s (profiled), device busy {busy:.3f} s, idle "
          f"share {1 - busy / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"[serve]   {e.key[:70]}: "
              f"{e.self_device_time_total / 1e3:.1f} ms over {e.count} calls")


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
        # K3 reads the P gathered pair copies and the weight array; the
        # timed call includes the wrapper's gather, as the reference's.
        ("split_gemm_v1", "src/repro/kernels/ops.py:315",
         lambda: ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk),
         lambda: ops.split_gemm_v1_plain(a_sl, b_sl, s, block_k=bk),
         pairs * (m * k + k * n) + 4 * pairs + 8 * m * n),
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
    gather_ms = timed(lambda: ops.gather_pairs(a_sl, b_sl, s), 20)
    t = tile_model.traffic(m, k, n, s)
    print(f"[time] split_gemm_v1's gather_pairs alone {gather_ms:.4f} ms; "
          f"traffic slice_read_bytes_v1 {t.slice_read_bytes_v1}, "
          f"slice_read_bytes_v2 {t.slice_read_bytes_v2}, read_reduction "
          f"{t.read_reduction}")
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
    checked_kn = phase_kernels_vs_plain(errs)
    phase_ladder()
    launches = phase_must()
    phase_profile()
    v1_launches = phase_v1_ab(errs)
    serve_launches = phase_serve(checked_kn)
    torch.cuda.empty_cache()
    phase_lm_ladder()
    torch.cuda.empty_cache()
    # Launch counts per kernel: the main paths' runs (MuST and serve)
    # and K3's A/B path, each read with the counters zeroed before it.
    total = {key: launches[key] + serve_launches[key] + v1_launches[key]
             for key in launches}
    print(f"[launches] MuST {launches}, serve {serve_launches}, "
          f"v1 A/B {v1_launches}")
    rows = phase_timings(errs, total)
    print(json.dumps({"kernels": rows}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
