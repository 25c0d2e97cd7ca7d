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
