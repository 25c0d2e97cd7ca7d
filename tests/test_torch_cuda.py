"""The CUDA split-GEMM kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips.  The file
imports neither jax nor the reference package, so it also runs on a
machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import get_backend
from repro_torch.core.ozaki import slice_matrix
from repro_torch.kernels import ops, slicing, tile_model

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


def _operands(m, k, n, seed, dtype):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((m, k))).to("cuda", dtype),
            torch.from_numpy(rng.standard_normal((k, n))).to("cuda", dtype))


def _bitwise(got, want):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(got, want))


@pytest.mark.parametrize("num_splits", [3, 9])
@pytest.mark.parametrize("m,k,n", [(37, 130, 51), (100, 1100, 60),
                                   (128, 256, 640)])
def test_k1_bitwise_against_plain(m, k, n, num_splits):
    a, b = _operands(m, k, n, 3, torch.float64)
    s = num_splits
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_sl, _ = slice_matrix(b, s, axis=0)
    before = ops.LAUNCHES["split_gemm"]
    got = ops.split_gemm(a_sl, b_sl, s, block_k=bk)
    assert ops.LAUNCHES["split_gemm"] == before + 1
    assert _bitwise(got, ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk))


@pytest.mark.parametrize("num_splits", [3, 6, 9])
@pytest.mark.parametrize("m,k,n", [(512, 960, 320), (221, 960, 960),
                                   (512, 960, 2560), (221, 2560, 960)])
def test_k1_bitwise_at_the_lm_shapes(m, k, n, num_splits):
    # SmolLM-360M's prefill GEMMs: m a full and a ragged wave, (k, n)
    # the k/v, q/o, gate/up and down projections.
    a, b = _operands(m, k, n, 7, torch.float64)
    s = num_splits
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_sl, _ = slice_matrix(b, s, axis=0)
    got = ops.split_gemm(a_sl, b_sl, s, block_k=bk)
    assert _bitwise(got, ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk))


# K1's shapes on the main paths: the MuST block GEMMs (one k-tile),
# SmolLM-360M's prefill GEMMs at a full and a ragged wave (two and five
# k-tiles), and ragged and tiny ones (k not a multiple of 16).
K1_SHAPES = ([(256, 256, n) for n in (256, 512, 2048, 4096)]
             + [(m, k, n) for m in (512, 221)
                for k, n in ((960, 960), (960, 320), (960, 2560),
                             (2560, 960))]
             + [(37, 130, 51), (1, 129, 1), (100, 1100, 60)])


@pytest.mark.parametrize("num_splits", [1, 2, 3, 6, 9, 14, 16])
@pytest.mark.parametrize("m,k,n", K1_SHAPES)
def test_k1_bitwise_under_every_plan(m, k, n, num_splits):
    a, b = _operands(m, k, n, 13, torch.float64)
    s = num_splits
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_sl, _ = slice_matrix(b, s, axis=0)
    b_t, _ = slice_matrix(b.mT, s, axis=1)
    assert b_t.is_contiguous()
    assert torch.equal(b_t, b_sl.transpose(1, 2))
    want = ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk)
    plans = tile_model.k1_plans(m, k, n, s, bk)
    assert tile_model.k1_plan(m, k, n, s, bk) in plans
    for plan in plans:
        before = ops.LAUNCHES["split_gemm"]
        got = ops.split_gemm_kmajor(a_sl, b_t, s, block_k=bk, plan=plan)
        assert ops.LAUNCHES["split_gemm"] == before + 1
        assert _bitwise(got, want), plan
        assert _bitwise(ops.split_gemm(a_sl, b_sl, s, block_k=bk,
                                       plan=plan), want), plan


# The train step's backward GEMMs at SmolLM-360M's width (512 tokens):
# dW (n, 512, k), whose k-tile is the token axis, and dX (512, n, k),
# with the head's (49152, 512, 960) and (512, 49152, 960).
K1_TRAIN_SHAPES = [(960, 512, 960), (320, 512, 960), (2560, 512, 960),
                   (960, 512, 2560), (512, 320, 960), (49152, 512, 960),
                   (512, 49152, 960)]


@pytest.mark.parametrize("m,k,n", K1_TRAIN_SHAPES)
def test_k1_bitwise_at_the_train_backward_shapes(m, k, n):
    a, b = _operands(m, k, n, 17, torch.float32)
    s = 6
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_t, _ = slice_matrix(b.mT, s, axis=1)
    got = ops.split_gemm_kmajor(a_sl, b_t, s, block_k=bk)
    assert _bitwise(got, ops.split_gemm_kmajor_plain(a_sl, b_t, s,
                                                     block_k=bk))


def test_emulated_train_step_is_deterministic_on_card():
    # Two runs of one emulated step (SmolLM-360M's width and vocabulary,
    # two layers) from the same state give the same bits: the card
    # computes nothing in a run-dependent order.
    from repro_torch.configs import get_config
    from repro_torch.core import PrecisionPolicy, offload
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import Model
    from repro_torch.train import AdamW, SyntheticText
    from repro_torch.train.checkpoint import tree_flatten

    cfg = get_config("smollm_360m").replace(num_layers=2)
    model = Model(cfg, device="cuda", seed=0)
    params = model.params
    opt = AdamW(lr=3e-3)
    batch = torch.as_tensor(SyntheticText(cfg.vocab_size, 128, 4).batch(0),
                            device="cuda")
    step = offload(build_train_step(model, opt), PrecisionPolicy(
        backend="pallas_int8_6"))
    state = opt.init(params)
    # The first step from a zero head moves it; the second depends on
    # every gradient.
    params, state, _ = step(params, state, batch)
    runs = [tree_flatten(step(params, state, batch)) for _ in range(2)]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_k1_reads_each_calls_operands():
    # The launcher encodes a tensor map once per shape and gives each
    # call's copy that call's address: alternate two operand sets of
    # one shape (and a third of another) and hold every result.
    shape, s = (256, 256, 512), 6
    cases = []
    for seed, (m, k, n) in ((21, shape), (22, shape), (23, (64, 256, 512))):
        a, b = _operands(m, k, n, seed, torch.float64)
        a_sl, _ = slice_matrix(a, s, axis=1)
        b_t, _ = slice_matrix(b.mT, s, axis=1)
        cases.append((a_sl, b_t, ops.split_gemm_kmajor_plain(
            a_sl.cpu(), b_t.cpu(), s, block_k=256)))
    for _ in range(2):
        for a_sl, b_t, want in cases:
            got = ops.split_gemm_kmajor(a_sl, b_t, s, block_k=256)
            assert _bitwise(tuple(x.cpu() for x in got), want)


def test_k1_refuses_a_plan_it_cannot_take():
    a_sl = torch.zeros((6, 512, 960), dtype=torch.int8, device="cuda")
    b_t = torch.zeros((6, 320, 960), dtype=torch.int8, device="cuda")
    resident = tile_model.k1_plan(256, 256, 4096, 6)
    with pytest.raises(ValueError):
        ops.split_gemm_kmajor(a_sl, b_t, 6, block_k=512, plan=resident)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("m,k,n", [(256, 256, 4096), (512, 960, 320),
                                   (37, 130, 51)])
def test_ozaki_matmul_on_card_equals_cpu(m, k, n, fuse):
    # The unfused route slices B k-major on the card (its _pow2_scale's
    # log runs there) and launches K1 through split_gemm_kmajor.
    a, b = _operands(m, k, n, 14, torch.float64)
    got = ops.ozaki_matmul(a, b, num_splits=6, fuse_slicing=fuse)
    want = ops.ozaki_matmul(a.cpu(), b.cpu(), num_splits=6,
                            fuse_slicing=fuse)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("num_splits", [3, 6, 9])
@pytest.mark.parametrize("m,k,n", [(37, 130, 51), (100, 1100, 60)])
def test_k3_bitwise_against_plain_and_k1(m, k, n, num_splits):
    a, b = _operands(m, k, n, 6, torch.float64)
    s = num_splits
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_sl, _ = slice_matrix(b, s, axis=0)
    before = ops.LAUNCHES["split_gemm_v1"]
    got = ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk)
    assert ops.LAUNCHES["split_gemm_v1"] == before + 1
    assert _bitwise(got, ops.split_gemm_v1_plain(a_sl, b_sl, s, block_k=bk))
    assert _bitwise(got, ops.split_gemm(a_sl, b_sl, s, block_k=bk))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,k,n", [(37, 130, 51), (100, 1100, 60)])
def test_k2_bitwise_against_plain(m, k, n, dtype):
    a, b = _operands(m, k, n, 4, dtype)
    s = 6
    bk = tile_model.select_tiles(m, k, n, s, fused=True).block_k
    ah, al, _ = slicing.to_operand_pair(a, axis=1)
    bh, bl, _ = slicing.to_operand_pair(b, axis=0)
    got = ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk)
    want = ops.split_gemm_fused_plain(ah, al, bh, bl, s, block_k=bk)
    assert _bitwise(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_splits", [3, 6, 9])
@pytest.mark.parametrize("m,k,n", [(512, 960, 320), (221, 960, 960),
                                   (512, 960, 2560), (221, 2560, 960)])
def test_k2_bitwise_at_the_lm_shapes(m, k, n, num_splits, dtype):
    # Two and five k-tiles: K2's pair groups hold a partial per k-tile.
    a, b = _operands(m, k, n, 8, dtype)
    s = num_splits
    bk = tile_model.select_tiles(m, k, n, s, fused=True).block_k
    ah, al, _ = slicing.to_operand_pair(a, axis=1)
    bh, bl, _ = slicing.to_operand_pair(b, axis=0)
    before = ops.LAUNCHES["split_gemm_fused"]
    got = ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk)
    assert ops.LAUNCHES["split_gemm_fused"] == before + 1
    want = ops.split_gemm_fused_plain(ah, al, bh, bl, s, block_k=bk)
    assert _bitwise(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_splits", [1, 2, 14, 16])
@pytest.mark.parametrize("m,k,n", [(256, 256, 4096), (100, 1100, 60)])
def test_k2_bitwise_at_few_and_many_splits(m, k, n, num_splits, dtype):
    # s = 1 and 2 make one short group; 14 and 16 several groups of
    # the most pairs the held partials allow.
    a, b = _operands(m, k, n, 9, dtype)
    s = num_splits
    bk = tile_model.select_tiles(m, k, n, s, fused=True).block_k
    ah, al, _ = slicing.to_operand_pair(a, axis=1)
    bh, bl, _ = slicing.to_operand_pair(b, axis=0)
    got = ops.split_gemm_fused(ah, al, bh, bl, s, block_k=bk)
    want = ops.split_gemm_fused_plain(ah, al, bh, bl, s, block_k=bk)
    assert _bitwise(got, want)


@pytest.mark.parametrize("num_splits", [3, 6])
def test_k2_bitwise_where_slicing_rounds_ties(num_splits):
    # Dyadic operands with few bits: the slicing recurrence meets exact
    # halves, where rint's ties-to-even must hold.
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(-4096, 4097, (64, 256)) / 2.0 ** 7)
    b = torch.from_numpy(rng.integers(-4096, 4097, (256, 96)) / 2.0 ** 13)
    s = num_splits
    ah, al, _ = slicing.to_operand_pair(a.cuda(), axis=1)
    bh, bl, _ = slicing.to_operand_pair(b.cuda(), axis=0)
    got = ops.split_gemm_fused(ah, al, bh, bl, s, block_k=256)
    want = ops.split_gemm_fused_plain(ah, al, bh, bl, s, block_k=256)
    assert _bitwise(got, want)


@pytest.mark.parametrize("m,k,n", [(256, 256, 4096), (37, 130, 51)])
def test_k3_kernel_alone_on_gathered_copies(m, k, n):
    a, b = _operands(m, k, n, 10, torch.float64)
    s = 6
    bk = tile_model.select_tiles(m, k, n, s).block_k
    a_sl, _ = slice_matrix(a, s, axis=1)
    b_sl, _ = slice_matrix(b, s, axis=0)
    copies = ops.gather_pairs_kmajor(a_sl, b_sl, s)
    got = ops.split_gemm_v1_pairs(*copies, block_k=bk)
    assert _bitwise(got, ops.split_gemm_v1(a_sl, b_sl, s, block_k=bk))
    assert _bitwise(got, ops.split_gemm_plain(a_sl, b_sl, s, block_k=bk))


@pytest.mark.parametrize("s,m,k,n", [(6, 256, 256, 4096), (3, 37, 130, 51),
                                     (9, 1, 129, 1), (4, 70, 96, 80)])
def test_gather_kernel_equals_plain(s, m, k, n):
    # Aligned, ragged and tiny slice stacks.
    rng = np.random.default_rng(12)
    a_sl = torch.from_numpy(rng.integers(-64, 65, (s, m, k),
                                         dtype=np.int8)).cuda()
    b_sl = torch.from_numpy(rng.integers(-64, 65, (s, k, n),
                                         dtype=np.int8)).cuda()
    before = ops.LAUNCHES["gather_pairs_kmajor"]
    got = ops.gather_pairs_kmajor(a_sl, b_sl, s)
    assert ops.LAUNCHES["gather_pairs_kmajor"] == before + 1
    want = ops.gather_pairs_kmajor_plain(a_sl, b_sl, s)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_backend_on_card_equals_backend_on_cpu():
    a, b = _operands(96, 200, 80, 5, torch.float64)
    for spec in ("pallas_int8_6", "pallas_int8_6:fused", "fp64_int8_6"):
        gemm = get_backend(spec)
        on_card = gemm(a, b).cpu()
        on_cpu = gemm(a.cpu(), b.cpu())
        assert torch.equal(on_card, on_cpu), spec


def test_wrapper_rejects_mixed_devices():
    a_sl = torch.zeros((3, 8, 16), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):
        ops.split_gemm(a_sl, torch.zeros((3, 16, 8), dtype=torch.int8), 3)


def test_paged_view_has_the_dense_strides_on_card():
    # The paged attention operand must reach the einsum with the dense
    # buffer's strides (and values), or cuBLAS may sum in another order
    # and paged != dense by an ulp.
    from repro_torch.models.lm import _paged_view

    L, KV, bs, d, nb, B = 1, 2, 16, 32, 4, 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = torch.randn((B * nb + 1, KV, bs, d), generator=gen,
                       device="cuda")
    attend = torch.arange(1, B * nb + 1, device="cuda").reshape(B, nb)
    dense = torch.stack([torch.cat([pool[attend[b, j]] for j in range(nb)],
                                   dim=1) for b in range(B)])
    want = torch.movedim(dense, 1, 2)
    got = _paged_view(pool, attend, d)
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


def test_paged_programs_bitwise_equal_dense_on_card():
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import PagedKVCache

    cfg = get_config("tiny")
    model = Model(cfg, device="cuda", seed=1)
    with torch.no_grad():
        model.lm_head.normal_(0.0, 0.1)
    B, T, S = 2, 40, 64
    tokens = torch.randint(1, cfg.vocab_size, (B, T), device="cuda",
                           dtype=torch.int32)
    lengths = torch.tensor([T, T - 7], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        _, dense = model.prefill(model.params, tokens, lengths, S)
        kv = PagedKVCache(model, batch_slots=B, max_len=S, block_size=16)
        for slot in range(B):
            kv.ensure(slot, int(lengths[slot]))
        cache = kv.sync_table(kv.init_cache())
        _, _, paged = model.prefill_chunk_paged(
            model.params, cache["k"], cache["v"], cache["block_table"],
            tokens, torch.zeros(B, dtype=torch.int32, device="cuda"),
            lengths)
    assert torch.equal(paged, dense)


def test_pow2_scale_card_equals_cpu_across_exponents():
    # Every slice starts at _pow2_scale: random amax values over the whole
    # float64 exponent range, subnormals included, card == CPU bitwise.
    from repro_torch.core.ozaki import _pow2_scale

    gen = np.random.default_rng(11)
    n = 1 << 20
    bits = (gen.integers(0, 2047, n, dtype=np.int64) << 52) | \
        gen.integers(0, 1 << 52, n, dtype=np.int64)
    x = torch.from_numpy(bits.view(np.float64).reshape(-1, 1).copy())
    assert (x.abs() < torch.finfo(torch.float64).tiny).any()
    assert torch.equal(_pow2_scale(x.cuda(), 1).cpu().view(torch.int64),
                       _pow2_scale(x, 1).view(torch.int64))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_seeded_init_card_equals_cpu(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train.checkpoint import tree_flatten

    cfg = get_config("tiny")
    cpu = tree_flatten(Model(cfg, device="cpu", seed=seed).params)
    card = tree_flatten(Model(cfg, device="cuda", seed=seed).params)
    for a, b in zip(cpu, card):
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.parametrize("m,k,n", [(512, 960, 2560), (256, 256, 4096)])
def test_site_hook_adds_no_synchronization(m, k, n):
    # An emulated GEMM with the telemetry hook issues no synchronizing
    # call (the hook's payload is built on the host), and the hook fires
    # once per K1 launch, in a scan of two iterations too.
    from repro_torch.core import PrecisionPolicy, offload, scan
    from repro_torch.obs import Registry

    a, b = _operands(m, k, n, 5, torch.float32)
    xs = torch.stack(_operands(k, k, k, 6, torch.float32))
    reg = Registry()

    def hook(payload):
        reg.counter("site_exec", site=payload["site"]).inc()

    fn = offload(lambda a, b, xs: (a @ b, scan(lambda c, x: (c @ x, None),
                                               a, xs)[0]),
                 PrecisionPolicy(backend="pallas_int8_6"),
                 on_site_event=hook)
    fn(a, b, xs)   # warm: K1's plan and tensor maps
    before = ops.LAUNCHES["split_gemm"]
    fired = sum(s["value"] for s in reg.snapshot())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(a, b, xs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = ops.LAUNCHES["split_gemm"] - before
    counts = {s["labels"]["site"]: s["value"] for s in reg.snapshot()}
    assert launched == 3
    assert sum(counts.values()) - fired == launched
    assert counts == {"dot0": 2, "scan0/dot0": 4}


@pytest.mark.parametrize("pred", [True, False])
def test_control_flow_program_launches_k1_per_executed_site(pred):
    # A while loop of 3 trips, a cond and a 3-operand einsum through
    # pallas_int8_6: K1 launches once per executed site, which is what
    # the hook counts; a user autograd.Function's product launches none.
    from collections import Counter

    from repro_torch.core import PrecisionPolicy, cond, offload, while_loop

    class Opaque(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, y):
            return x @ y

        @staticmethod
        def backward(ctx, g):
            return None, None

    x, y0 = _operands(256, 256, 256, 7, torch.float64)
    a, w = _operands(256, 128, 256, 8, torch.float64)
    b, c = _operands(128, 128, 512, 9, torch.float64)

    def program(pred, x, y0, a, b, c, w):
        y = while_loop(lambda v: v[0] < 3,
                       lambda v: (v[0] + 1, (v[1] @ x) / 16.0), (0, y0))[1]
        z = cond(pred, lambda t: t @ w, lambda t: (2.0 * t) @ w, a)
        e = torch.einsum("ij,jk,kl->il", a, b, c)
        return y, z, e, Opaque.apply(a, w)

    hooked = Counter()
    fn = offload(program, PrecisionPolicy(backend="pallas_int8_6"),
                 on_site_event=lambda p: hooked.update([p["site"]]))
    names = [s.name for s in fn.sites(pred, x, y0, a, b, c, w)]
    assert names == ["while0/dot0", "cond1/br0/dot0", "cond1/br1/dot0",
                     "dot0", "dot1"]
    before = ops.LAUNCHES["split_gemm"]
    out = fn(pred, x, y0, a, b, c, w)
    torch.cuda.synchronize()
    taken = f"cond1/br{int(pred)}/dot0"
    assert hooked == Counter({"while0/dot0": 3, taken: 1, "dot0": 1,
                              "dot1": 1})
    assert ops.LAUNCHES["split_gemm"] - before == 6
    assert torch.equal(out[3], a @ w)


def test_gloo_reduces_cuda_tensors_of_ranks_sharing_a_card():
    # The mesh's ranks on one card talk over gloo, which must have been
    # built with CUDA support: an all-reduce and a bucketed mean.
    import torch_shard_workers as workers
    from repro_torch.shard.launch import spawn

    ranks = spawn(workers.cuda_gloo, 2, device="cuda", timeout=120)
    for got in ranks:
        if torch.cuda.device_count() == 1:
            assert got["backend"] == "gloo"
        assert got["device"].startswith("cuda")
        assert np.array_equal(got["sum"], np.full(1000, 3.0))
        assert np.array_equal(got["a"], np.arange(10.0) * 1.5)
        assert np.array_equal(got["b"], np.ones((3, 3)))
