"""Port parity: seeded parameters (``repro_torch.models.prng``) against
``jax.random`` and the reference's ``init_params``.

Every comparison here is bitwise: the threefry words, the uniform
draws, XLA-CPU's float32 ``erf_inv`` over every value a normal draw can
feed it, and the parameters of a model made from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.models import Model as ModelRef
from repro_torch.configs import get_config
from repro_torch.models import Model, prng
from repro_torch.train.checkpoint import tree_flatten
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

SEEDS = [0, 1, 2 ** 31 + 5, 12345678901, -3]
SHAPES = [(1,), (7,), (3, 5), (64, 33), (2, 17, 9), (1000,)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert list(prng.prng_key(seed)) == np.asarray(key).tolist()
    for num in (1, 2, 3, 8):
        want = np.asarray(jax.random.split(key, num)).tolist()
        assert [list(k) for k in prng.split(prng.prng_key(seed), num)] \
            == want
    # A split of a split: the keys the reference's layers would use.
    sub = jax.random.split(jax.random.split(key, 8)[5], 3)
    mine = prng.split(prng.split(prng.prng_key(seed), 8)[5], 3)
    assert [list(k) for k in mine] == np.asarray(sub).tolist()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_normal_equal_jax(seed, shape):
    key = jax.random.split(jax.random.PRNGKey(seed), 4)[2]
    mine = prng.split(prng.prng_key(seed), 4)[2]
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    assert np.array_equal(prng.random_bits(mine, shape).numpy(),
                          bits.astype(np.int64))
    assert same_bits(jax.random.normal(key, shape, jnp.float32),
                     prng.normal(mine, shape))


@pytest.mark.parametrize("quarter", range(4))
def test_erf_inv_equals_xla_on_every_uniform_draw(quarter):
    # The uniform draw feeding erf_inv takes exactly 2**23 values,
    # u = (4i - 2**24 + 1) * 2**-24; each quarter test holds 2**21 of
    # them bitwise (tolerance 0: the float32 log1p and polynomial are
    # XLA-CPU's, every fused multiply-add exact).
    i = np.arange(quarter << 21, (quarter + 1) << 21, dtype=np.int64)
    u = ((4 * i - 2 ** 24 + 1).astype(np.float64) * 2.0 ** -24).astype(
        np.float32)
    want = jax.jit(jax.lax.erf_inv)(jnp.asarray(u))
    assert same_bits(want, prng.erf_inv(torch.from_numpy(u)))


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0], dtype=torch.float32)
    want = jax.lax.erf_inv(jnp.asarray(x.numpy()))
    assert same_bits(want, prng.erf_inv(x))


NARROW = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=192, vocab_size=160)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("over", [{}, NARROW], ids=["tiny", "narrow"])
def test_model_init_equals_reference(over, dtype, seed):
    o = dict(over, dtype=dtype, param_dtype=dtype)
    want = ModelRef(get_config_ref("tiny").replace(**o)).init_params(
        jax.random.PRNGKey(seed))
    got = Model(get_config("tiny").replace(**o), device="cpu",
                seed=seed).params
    leaves = jax.tree_util.tree_leaves(want)
    assert len(leaves) == len(tree_flatten(got)) == 12
    for a, b in zip(leaves, tree_flatten(got)):
        assert same_bits(a, b)


def test_bfloat16_params_round_as_the_reference():
    o = dict(NARROW, param_dtype="bfloat16")
    want = ModelRef(get_config_ref("tiny").replace(**o)).init_params(
        jax.random.PRNGKey(4))
    got = Model(get_config("tiny").replace(**o), device="cpu",
                seed=4).params
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_flatten(got)):
        assert b.dtype == torch.bfloat16
        assert np.asarray(a).view(np.uint16).tobytes() == \
            b.view(torch.int16).numpy().tobytes()
