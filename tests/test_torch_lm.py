"""Port parity: repro_torch.models.Model against repro.models.Model.

The reference's parameters (seeded, with a random LM head) are carried
into the port with ``params_from_reference``; both packages then run
the same programs on the same seeded numpy inputs on the CPU.

Tolerances, relative to the largest value of the output compared:

* float32 model: 2e-5 (measured gap about 1.2e-6);
* float64 model: 1e-6 (measured gap about 1.7e-7) for every output
  downstream of the first attention softmax.  The reference runs the
  attention softmax and the SwiGLU gate in float32 even for a float64
  model (``src/repro/models/lm.py:88-91`` and ``:231-232``), and XLA's
  float32 ``exp`` is its own polynomial, which torch's does not
  reproduce, so the two agree only to float32 rounding from there on.
* Layer 0's K/V cache rows (embedding, RMSNorm, the K/V projections
  and RoPE, ahead of any softmax): 1e-13 at float64 (measured 5e-16)
  and 1e-6 at float32 (measured 2.3e-7).

Every output compared must also have the model's dtype.

Site reports (names, operand shapes, extents, decisions, trip counts)
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LMConfig as LMConfigRef
from repro.core import PrecisionPolicy as PolicyRef
from repro.core import site_report as site_report_ref
from repro.models import Model as ModelRef
from repro.serve import PagedKVCache as PagedRef
from repro_torch.configs import LMConfig, available_configs, get_config
from repro_torch.core import PrecisionPolicy, site_report
from repro_torch.models import Model, params_from_reference
from repro_torch.serve import PagedKVCache
from torch_parity import reference_config

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

ARCH = dict(vocab_size=256, num_layers=2, d_model=128, num_heads=4,
            num_kv_heads=2, head_dim=32, d_ff=256)
TOL = {"float32": 2e-5, "float64": 1e-6}
PURE_TOL = {"float32": 1e-6, "float64": 1e-13}


@pytest.fixture(scope="module", params=["float64", "float32"])
def pair(request):
    dt = request.param
    kw = dict(ARCH, name=f"parity_{dt}", dtype=dt, param_dtype=dt)
    ref = ModelRef(LMConfigRef(**kw))
    params = ref.init_params(jax.random.PRNGKey(0))
    params["lm_head"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), params["lm_head"].shape,
        dtype=params["lm_head"].dtype)
    port = Model(LMConfig(**kw), device="cpu")
    port.load_params(params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return dt, ref, params, port


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        1, ARCH["vocab_size"], shape).astype(np.int32)


def _close(dt, ref, port, tol=TOL):
    assert np.asarray(ref).dtype == np.dtype(dt)
    assert port.dtype == getattr(torch, dt)
    r = np.asarray(ref, np.float64)
    t = port.detach().numpy().astype(np.float64)
    assert r.shape == t.shape
    gap = np.abs(r - t).max() / np.abs(r).max()
    assert gap < tol[dt], gap


def _close_cache(dt, ref, port):
    """Layer 0 (no softmax upstream) at PURE_TOL, the rest at TOL."""
    _close(dt, ref[0], port[0], PURE_TOL)
    _close(dt, ref[1:], port[1:])


def _records(sites):
    return [(s.name, tuple(s.lhs_shape), tuple(s.rhs_shape), s.offloaded,
             s.eligible, s.splits, s.reason, s.m, s.k, s.n, s.batch,
             s.mult, s.backend) for s in sites]


class TestPrograms:
    def test_apply(self, pair):
        dt, ref, params, port = pair
        tok = _tokens((2, 24), 0)
        _close(dt, ref.apply(params, jnp.asarray(tok)),
               port.apply(port.params, torch.from_numpy(tok)))

    def test_prefill_then_decode(self, pair):
        dt, ref, params, port = pair
        tok = _tokens((2, 20), 1)
        lens = np.array([20, 13], np.int32)
        cr, lr = ref.prefill(params, jnp.asarray(tok), jnp.asarray(lens),
                             32)
        ct, lt = port.prefill(port.params, torch.from_numpy(tok),
                              torch.from_numpy(lens), 32)
        _close(dt, lr, lt)
        _close_cache(dt, cr["k"], ct["k"])
        _close_cache(dt, cr["v"], ct["v"])
        assert ct["length"].tolist() == np.asarray(cr["length"]).tolist()
        nxt = np.array([7, 9], np.int32)
        for step in range(3):
            act = np.array([True, step != 1])
            cr, lr = ref.decode_step(params, cr, jnp.asarray(nxt),
                                     jnp.asarray(act))
            ct, lt = port.decode_step(port.params, ct,
                                      torch.from_numpy(nxt),
                                      torch.from_numpy(act))
            _close(dt, lr, lt)
            assert ct["length"].tolist() == \
                np.asarray(cr["length"]).tolist()

    def test_prefill_chunk(self, pair):
        dt, ref, params, port = pair
        tok = _tokens((2, 8), 2)
        start = np.array([0, 5], np.int32)
        piece = np.array([8, 3], np.int32)
        cache = ref.init_cache(2, 32)
        kr, vr, lr = ref.prefill_chunk(
            params, cache["k"], cache["v"], jnp.asarray(tok),
            jnp.asarray(start), jnp.asarray(piece))
        tcache = port.init_cache(2, 32)
        kt, vt, lt = port.prefill_chunk(
            port.params, tcache["k"], tcache["v"], torch.from_numpy(tok),
            torch.from_numpy(start), torch.from_numpy(piece))
        _close(dt, lr, lt)
        _close_cache(dt, kr, kt)
        _close_cache(dt, vr, vt)

    def test_paged_chunk_and_decode(self, pair):
        dt, ref, params, port = pair
        B, T, S, bs = 2, 12, 32, 8
        kv_r = PagedRef(ref, batch_slots=B, max_len=S, block_size=bs)
        kv_t = PagedKVCache(port, batch_slots=B, max_len=S, block_size=bs)
        lens = [T, T - 4]
        for kv in (kv_r, kv_t):
            for slot in range(B):
                kv.ensure(slot, lens[slot])
        cr = kv_r.sync_table(kv_r.init_cache())
        ct = kv_t.sync_table(kv_t.init_cache())
        assert np.array_equal(np.asarray(cr["block_table"]),
                              ct["block_table"].numpy())
        tok = _tokens((B, T), 3)
        zeros = np.zeros((B,), np.int32)
        piece = np.array(lens, np.int32)
        kr, vr, lr = ref.prefill_chunk_paged(
            params, cr["k"], cr["v"], cr["block_table"], jnp.asarray(tok),
            jnp.asarray(zeros), jnp.asarray(piece))
        kt, vt, lt = port.prefill_chunk_paged(
            port.params, ct["k"], ct["v"], ct["block_table"],
            torch.from_numpy(tok), torch.from_numpy(zeros),
            torch.from_numpy(piece))
        _close(dt, lr, lt)
        _close_cache(dt, kr, kt)
        _close_cache(dt, vr, vt)
        cr = dict(cr, k=kr, v=vr, length=jnp.asarray(piece))
        ct = dict(ct, k=kt, v=vt, length=torch.from_numpy(piece))
        nxt = np.array([3, 4], np.int32)
        act = np.array([True, True])
        for _ in range(2):
            for kv, cache in ((kv_r, cr), (kv_t, ct)):
                for slot in range(B):
                    kv.ensure(slot, int(np.asarray(cache["length"])[slot])
                              + 1)
            cr, ct = kv_r.sync_table(cr), kv_t.sync_table(ct)
            cr, lr = ref.decode_step_paged(params, cr, jnp.asarray(nxt),
                                           jnp.asarray(act))
            ct, lt = port.decode_step_paged(port.params, ct,
                                            torch.from_numpy(nxt),
                                            torch.from_numpy(act))
            _close(dt, lr, lt)

    def test_cache_programs_write_in_place(self, pair):
        # The port's programs write the cache they are given and return
        # it (the reference returns new arrays); the values are those
        # of a fresh copy run through the same program.
        dt, _, _, port = pair
        tok = torch.from_numpy(_tokens((2, 8), 6))
        start = torch.tensor([0, 3], dtype=torch.int32)
        piece = torch.tensor([8, 5], dtype=torch.int32)
        cache = port.init_cache(2, 32)
        k0, v0 = cache["k"].clone(), cache["v"].clone()
        k, v, logits = port.prefill_chunk(port.params, cache["k"],
                                          cache["v"], tok, start, piece)
        assert k is cache["k"] and v is cache["v"]
        k2, v2, logits2 = port.prefill_chunk(port.params, k0, v0, tok,
                                             start, piece)
        assert torch.equal(k, k2) and torch.equal(v, v2)
        assert torch.equal(logits, logits2)
        assert k.abs().sum() > 0
        dec, _ = port.decode_step(port.params, dict(cache, length=piece),
                                  tok[:, 0], torch.ones(2, dtype=torch.bool))
        assert dec["k"] is cache["k"] and dec["v"] is cache["v"]

    def test_greedy(self, pair):
        _, ref, _, port = pair
        logits = np.random.default_rng(4).standard_normal((3, 50))
        assert port.greedy(torch.from_numpy(logits)).tolist() == \
            np.asarray(ref.greedy(jnp.asarray(logits))).tolist()


class TestSiteReports:
    @pytest.mark.parametrize("min_dim", [128, 32])
    def test_serving_programs(self, pair, min_dim):
        # min_dim=32 also offloads the attention einsums (k = head_dim).
        dt, ref, params, port = pair
        B, T, S, bs = 2, 64, 128, 16
        kw = dict(backend="pallas_int8", default_splits=4,
                  min_dim=min_dim)
        p_ref, p_port = PolicyRef(**kw), PrecisionPolicy(**kw)
        tok = _tokens((B, T), 5)
        start = np.zeros((B,), np.int32)
        piece = np.array([T, T - 9], np.int32)
        kv_r = PagedRef(ref, batch_slots=B, max_len=S, block_size=bs)
        kv_t = PagedKVCache(port, batch_slots=B, max_len=S, block_size=bs)
        cr, ct = kv_r.init_cache(), kv_t.init_cache()
        r = site_report_ref(ref.prefill_chunk_paged, p_ref)(
            params, cr["k"], cr["v"], cr["block_table"], jnp.asarray(tok),
            jnp.asarray(start), jnp.asarray(piece))
        t = site_report(port.prefill_chunk_paged, p_port)(
            port.params, ct["k"], ct["v"], ct["block_table"],
            torch.from_numpy(tok), torch.from_numpy(start),
            torch.from_numpy(piece))
        assert _records(t) == _records(r)
        assert [s.name for s in t][:2] == ["scan0/dot0", "scan0/dot1"]
        assert all(s.mult == ARCH["num_layers"] for s in t[:-1])

        act = np.ones((B,), bool)
        nxt = np.array([1, 2], np.int32)
        cr = dict(cr, length=jnp.asarray(piece))
        ct = dict(ct, length=torch.from_numpy(piece))
        r = site_report_ref(ref.decode_step_paged, p_ref)(
            params, cr, jnp.asarray(nxt), jnp.asarray(act))
        t = site_report(port.decode_step_paged, p_port)(
            port.params, ct, torch.from_numpy(nxt), torch.from_numpy(act))
        assert _records(t) == _records(r)
        assert not any(s.offloaded for s in t)   # m = slots < min_dim

        lens = np.array([T, T - 3], np.int32)
        r = site_report_ref(lambda p, x, n: ref.prefill(p, x, n, S),
                            p_ref)(params, jnp.asarray(tok),
                                   jnp.asarray(lens))
        t = site_report(lambda p, x, n: port.prefill(p, x, n, S),
                        p_port)(port.params, torch.from_numpy(tok),
                                torch.from_numpy(lens))
        assert _records(t) == _records(r)


class TestConfigs:
    def test_presets_equal_the_reference(self):
        # The port adds presets of its own (the expert model's) and keys
        # the reference lacks (layer kinds, YaRN, experts): every
        # reference preset is there, equal on the reference's keys, with
        # the port's own keys at their dense defaults.
        from repro.configs import available_configs as names_ref
        from repro.configs import get_config as get_ref
        assert set(names_ref()) <= set(available_configs())
        dense = LMConfig()
        for name in names_ref():
            port, want = vars(get_config(name)), vars(get_ref(name))
            assert {k: port[k] for k in want} == want
            assert {k: v for k, v in port.items() if k not in want} == {
                k: v for k, v in vars(dense).items() if k not in want}
            assert get_config(name).num_params() == \
                get_ref(name).num_params()
        assert {n for n in available_configs() if n not in names_ref()} == {
            n for n in available_configs() if get_config(n).num_experts}

    def test_init_shapes_and_zero_head(self):
        cfg = get_config("tiny")
        port = Model(cfg, device="cpu", seed=3)
        ref = ModelRef(reference_config(cfg))
        shapes = jax.tree_util.tree_map(
            lambda a: tuple(a.shape), ref.init_params(jax.random.PRNGKey(0)))
        got = {k: (tuple(v.shape) if k != "blocks" else
                   {b: tuple(w.shape) for b, w in v.items()})
               for k, v in port.params.items()}
        assert got == shapes
        assert not port.params["lm_head"].any()
        assert sum(p.numel() for p in port.parameters()) == cfg.num_params()
