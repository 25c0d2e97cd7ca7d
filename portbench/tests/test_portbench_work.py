"""The work counted from shapes: K1's bounds, the LM's emulated GEMMs
and model FLOPs."""

from collections import Counter

import pytest
import torch
from conftest import TINY_LM

from portbench.work import lm, split_gemm
from portbench.work.peaks import HBM_BYTES_PER_S, INT8_OPS_PER_S


def test_bounds_pick_the_larger():
    m = k = n = 256
    assert split_gemm.k1_bound_s([(m, k, n)], 6) == pytest.approx(
        max(2 * m * k * n * 21 / INT8_OPS_PER_S,
            (6 * (m * k + k * n) + 8 * m * n) / HBM_BYTES_PER_S))
    # A small product is bound by its bytes.
    assert split_gemm.k1_bound_s([(64, 128, 64)], 6) == pytest.approx(
        (6 * (64 * 128 + 128 * 64) + 8 * 64 * 64) / HBM_BYTES_PER_S)
    assert split_gemm.splits_of("pallas_int8_6:fused") == 6


def test_smollm_counts():
    shape = lm.LMShape(vocab=49152, layers=32, d=960, heads=15, kv_heads=5,
                       head_dim=64, d_ff=2560, tied=True)
    assert shape.num_params() == 361_821_120
    fwd = 2 * 2048 * (shape.layer_matmul_params() + 960 * 49152)
    attn = 4 * 960 * 32 * 2048 * 2049 / 2
    assert lm.train_flops(shape, 1, 2048) == pytest.approx(3 * (fwd + attn))
    assert lm.train_flops(shape, 1, 2048) == pytest.approx(5.22e12,
                                                           rel=2e-3)
    gemms = lm.emulated(lm.train_gemms(shape, 1, 2048), 128)
    assert sum(gemms.values()) == 32 * 7 * 3 + 3


@pytest.mark.parametrize("tied", [True, False])
def test_train_gemms_match_site_report(tied):
    """The emulated GEMMs counted from the config are the offloaded
    sites of the port's train step, on the tiny preset.  Autograd
    computes some weight gradients transposed, (n, k, m) for (m, k, n),
    which changes neither the operations nor the bytes: shapes are
    compared with m and n in order of size."""
    from repro_torch.core import PrecisionPolicy, offload
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import Model
    from repro_torch.train import AdamW

    from portbench import inputs
    from portbench.drivers.lm_train import program_config
    from portbench.traffic.generate import synthetic_text

    config = dict(TINY_LM, name="tiny", rope_theta=10000.0,
                  rms_norm_eps=1e-5, dtype="float32",
                  tie_word_embeddings=tied)
    shape = lm.LMShape.from_config(config)
    model = Model(program_config(config), device="cpu")
    params = inputs.lm_params(shape, 3, "cpu")
    opt = AdamW(lr=3e-3)
    step = offload(build_train_step(model, opt),
                   PrecisionPolicy(backend="pallas_int8_6", min_dim=128,
                                   default_splits=6))
    batch = torch.as_tensor(synthetic_text(512, 128, 2, 3, 0))
    sites = step.sites(params, opt.init(params), batch)
    def canonical(m, k, n):
        return min(m, n), k, max(m, n)

    got, want = Counter(), Counter()
    for s in sites:
        if s.offloaded:
            got[canonical(s.m, s.k, s.n)] += max(s.batch, 1) * s.mult
    for dims, count in lm.emulated(lm.train_gemms(shape, 2, 128),
                                    128).items():
        want[canonical(*dims)] += count
    assert got == want
