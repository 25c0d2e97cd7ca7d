"""Port parity: the offload's decision cache against the reference's
transform cache (``tests/test_intercept.py::TestTransformCacheLRU`` and
the persisted ``<key>.json`` decisions).

An eager program has no jaxpr, so the port caches each input
signature's site decisions: the LRU counts must be the reference's,
a program that branches in Python under one signature must never run
on a stale decision, and the persisted bytes must be the reference's
``_sites_bytes`` for the same decisions.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.core import PrecisionPolicy as PolicyRef
from repro.models import Model as ModelRef
from repro.serve import Engine as EngineRef
from repro.serve import Request as RequestRef
from repro_torch.configs import get_config
from repro_torch.core import (OFFLOAD_CACHE_SIZE, CacheInfo, PrecisionPolicy,
                              offload, site_report)
from repro_torch.models import Model, params_from_reference
from repro_torch.serve import Engine, Request

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)


def _solver(a, b):
    x = torch.tanh(a @ b)
    for _ in range(2):
        x = x @ b / torch.linalg.norm(x)
    return torch.sum(x)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((192, 192)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((192, 192)).astype(np.float32))
    return a, b


class TestTransformCacheLRU:
    """The reference's four tests, with its counts."""

    def test_cache_info_counts(self, operands):
        a, b = operands
        pol = PrecisionPolicy(default_splits=4, min_dim=64)
        w = offload(_solver, pol)
        assert w.cache_info() == (0, 0, 64, 0)
        w(a, b)
        w(a, b)
        w(a[:96], b)
        info = w.cache_info()
        assert (info.hits, info.misses, info.currsize) == (1, 2, 2)
        assert info.maxsize == 64 == OFFLOAD_CACHE_SIZE
        assert isinstance(info, CacheInfo)
        w.cache_clear()
        assert w.cache_info() == (0, 0, 64, 0)

    def test_signature_churn_is_bounded(self, operands):
        _, b = operands
        w = offload(lambda a, b: a @ b, PrecisionPolicy(min_dim=64),
                    cache_size=4)
        for rows in range(64, 64 + 10):
            w(torch.ones((rows, 192)), b)
        info = w.cache_info()
        assert info.currsize == 4 and info.misses == 10

    def test_eviction_is_least_recently_used(self, operands):
        _, b = operands
        w = offload(lambda a, b: a @ b, PrecisionPolicy(min_dim=64),
                    cache_size=2)
        a64, a80, a96 = (torch.ones((r, 192)) for r in (64, 80, 96))
        w(a64, b)
        w(a80, b)
        w(a64, b)   # refresh a64: a80 is now the LRU entry
        w(a96, b)   # evicts a80
        assert w.cache_info().currsize == 2
        w(a64, b)   # still cached
        assert w.cache_info().hits == 2
        w(a80, b)   # was evicted -> decided again
        assert w.cache_info().misses == 4

    def test_rejects_senseless_cache_size(self):
        with pytest.raises(ValueError, match="cache_size"):
            offload(lambda x: x, cache_size=0)

    def test_counts_equal_the_reference(self, operands):
        a, b = operands
        calls = [(a, b), (a, b), (a[:96], b), (a, b), (a[:80], b)]
        ref = offload_ref_counts(calls)
        w = offload(_solver, PrecisionPolicy(default_splits=4, min_dim=64),
                    cache_size=2)
        for args in calls:
            w(*args)
        assert tuple(w.cache_info()) == ref


def offload_ref_counts(calls):
    from repro.core import offload as offload_ref

    def solver(a, b):
        x = jnp.tanh(a @ b)
        for _ in range(2):
            x = x @ b / jnp.linalg.norm(x)
        return jnp.sum(x)

    w = offload_ref(solver, PolicyRef(default_splits=4, min_dim=64),
                    cache_size=2)
    for a, b in calls:
        w(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    return tuple(w.cache_info())


class TestDecisionReuse:
    def test_hit_takes_the_entry_and_sites_run_nothing(self, operands):
        a, b = operands
        runs = [0]

        def f(a, b):
            runs[0] += 1
            return (a @ b).sum()

        w = offload(f, PrecisionPolicy(default_splits=4, min_dim=64))
        first = w.sites(a, b)       # a miss: one report-mode run
        assert runs[0] == 1
        w(a, b)                     # a hit: the entry's records
        assert w.sites(a, b) is first and runs[0] == 2
        assert tuple(w.cache_info()) == (2, 1, 64, 1)

    def test_python_branch_never_gets_a_stale_decision(self):
        # One signature (a Python bool is only its type), two programs:
        # the second call's dot0 has other extents and a third product.
        a = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (192, 160)))
        b = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (160, 192)))

        def f(flag, a, b):
            if flag:
                return a @ b
            return (b @ a) @ (b @ a)

        pol = PrecisionPolicy(default_splits=4, min_dim=64,
                              backend="fp64_int8_4")
        w = offload(f, pol)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            w(True, a, b)
        with pytest.warns(UserWarning, match="deciding afresh"):
            got = w(False, a, b)
        assert tuple(w.cache_info())[:2] == (0, 2)
        want = [(s.name, s.m, s.k, s.n) for s in
                site_report(f, pol)(False, a, b)]
        assert [(s.name, s.m, s.k, s.n) for s in w.sites(False, a, b)] \
            == want == [("dot0", 160, 192, 160), ("dot1", 160, 192, 160),
                        ("dot2", 160, 160, 160)]
        # The value is the offloaded program's, site by site.
        ba = offload(lambda b, a: b @ a, pol)(b, a)
        assert torch.equal(got, offload(lambda x: x @ x, pol)(ba))
        # The entry now describes the False program: a hit, no warning.
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            w(False, a, b)
        assert tuple(w.cache_info())[:2] == (2, 2)

    def test_requires_grad_flip_is_a_new_signature(self, operands):
        a, b = operands

        def f(a, b):
            y = (a @ b).sum()
            if y.requires_grad:
                return torch.autograd.grad(y, a)[0]
            return y

        w = offload(f, PrecisionPolicy(default_splits=4, min_dim=64))
        w(a, b)
        g = w(a.clone().requires_grad_(), b)
        assert tuple(w.cache_info())[:2] == (0, 2)
        names = [s.name for s in w.sites(a.clone().requires_grad_(), b)]
        assert names == ["dot0", "dot1"]      # the lhs cotangent site
        assert [s.name for s in w.sites(a, b)] == ["dot0"]
        assert g.shape == a.shape


def _tiny_pair(arch="tiny", **over):
    cfg_ref = get_config_ref(arch).replace(**over)
    ref = ModelRef(cfg_ref)
    params = ref.init_params(jax.random.PRNGKey(0))
    params["lm_head"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), params["lm_head"].shape, dtype=jnp.float32)
    port = Model(get_config(arch).replace(**over), device="cpu")
    port.load_params(params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return ref, params, port


def _decision_files(directory):
    return {name: (directory / name).read_bytes()
            for name in sorted(os.listdir(directory))
            if name.endswith(".json")}


class TestPersistedDecisions:
    @pytest.mark.parametrize("backend", ["fp64_int8", "pallas_int8"])
    def test_tiny_lm_prefill_bytes_equal_the_reference(self, tmp_path,
                                                       backend):
        """The tiny LM served through both engines with a warm cache:
        each persisted decision set is the reference's, field by field;
        the kernel family's ``tiles`` are the H100's by design."""
        ref, params, port = _tiny_pair(num_layers=2)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 256, n).tolist() for n in (130, 70, 140)]
        kw = dict(batch_slots=2, max_len=256, chunk_tokens=128)
        pol = dict(backend=backend, default_splits=4)
        EngineRef(ref, params, policy=PolicyRef(**pol),
                  warm_cache_dir=str(tmp_path / "ref"), **kw).run(
            [RequestRef(prompt=p, max_new_tokens=3) for p in prompts])
        Engine(port, port.params, policy=PrecisionPolicy(**pol),
               warm_cache_dir=tmp_path / "port", **kw).run(
            [Request(prompt=p, max_new_tokens=3) for p in prompts])

        def records(directory):
            out = []
            for raw in _decision_files(directory).values():
                sites = json.loads(raw)
                out.append((raw, sites))
            return out

        got, want = records(tmp_path / "port"), records(tmp_path / "ref")
        assert len(got) == len(want) >= 3   # prefill shapes and decode
        offloaded = 0
        for (raw_t, sites_t) in got:
            tiles = [s["tiles"] for s in sites_t]
            for s in sites_t:
                s["tiles"] = None
            match = [w for w in want if w[1] and len(w[1]) == len(sites_t)
                     and [dict(x, tiles=None) for x in w[1]] == sites_t]
            assert match, sites_t
            raw_r, sites_r = match[0]
            offloaded += sum(s["offloaded"] for s in sites_t)
            # The reference's bytes once its tiles stand in for ours.
            for s, r in zip(sites_t, sites_r):
                s["tiles"] = r["tiles"]
            assert json.dumps(sites_t, sort_keys=True,
                              separators=(",", ":")).encode() == raw_r
            if backend == "fp64_int8":
                assert raw_t == raw_r
            # A tile pick wherever the reference has one, with its keys.
            assert [None if t is None else sorted(t) for t in tiles] == \
                [None if r["tiles"] is None else sorted(r["tiles"])
                 for r in sites_r]
        assert offloaded > 0

    def test_restart_reads_back_identical_bytes(self, tmp_path,
                                                operands):
        a, b = operands
        pol = PrecisionPolicy(default_splits=4, min_dim=64)
        events = []
        cold = offload(_solver, pol, persist_dir=tmp_path,
                       fn_label="solver", on_cache_event=events.append)
        cold(a, b)
        cold(a, b)
        assert tuple(cold.persist_info()) == (0, 0, 1, str(tmp_path))
        files = _decision_files(tmp_path)
        warm = offload(_solver, pol, persist_dir=tmp_path,
                       fn_label="solver", on_cache_event=events.append)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out = warm(a, b)
        assert tuple(warm.persist_info())[:3] == (0, 1, 0)
        assert events == ["miss", "disk_decisions_hit"]
        assert _decision_files(tmp_path) == files
        assert torch.equal(out, offload(_solver, pol)(a, b))
        # Another label is another entry.
        offload(_solver, pol, persist_dir=tmp_path, fn_label="other")(a, b)
        assert len(_decision_files(tmp_path)) == 2

    def test_corrupt_file_warns_and_decides_again(self, tmp_path,
                                                  operands):
        a, b = operands
        pol = PrecisionPolicy(default_splits=4, min_dim=64)
        offload(_solver, pol, persist_dir=tmp_path, fn_label="s")(a, b)
        (name, good), = _decision_files(tmp_path).items()
        (tmp_path / name).write_bytes(b"{not json")
        w = offload(_solver, pol, persist_dir=tmp_path, fn_label="s")
        with pytest.warns(UserWarning, match="unreadable"):
            w(a, b)
        assert tuple(w.persist_info())[:3] == (0, 0, 1)
        assert (tmp_path / name).read_bytes() == good
        # Well-formed but other decisions: warned and overwritten.
        other = json.loads(good)
        other[0]["splits"] = 9
        (tmp_path / name).write_bytes(json.dumps(
            other, sort_keys=True, separators=(",", ":")).encode())
        w = offload(_solver, pol, persist_dir=tmp_path, fn_label="s")
        with pytest.warns(UserWarning, match="do not match"):
            w(a, b)
        assert tuple(w.persist_info())[:3] == (0, 1, 0)
        assert (tmp_path / name).read_bytes() == good

    def test_bytes_equal_the_reference_on_a_plain_program(self, tmp_path):
        from repro.core import offload as offload_ref

        x = np.random.default_rng(4).standard_normal((160, 144))
        y = np.random.default_rng(5).standard_normal((144, 200))
        kw = dict(default_splits=5, min_dim=128,
                  site_backends={"dot1": "dgemm"})
        offload_ref(lambda x, y: (x @ y) @ y.T, PolicyRef(**kw),
                    persist_dir=tmp_path / "ref", fn_label="f")(
            jnp.asarray(x), jnp.asarray(y))
        out = offload(lambda x, y: (x @ y) @ y.T, PrecisionPolicy(**kw),
                      persist_dir=tmp_path / "port", fn_label="f")(
            torch.from_numpy(x), torch.from_numpy(y))
        assert list(_decision_files(tmp_path / "port").values()) == \
            list(_decision_files(tmp_path / "ref").values())
        # dot0 is emulated (bitwise), the demoted dot1 each library's
        # own float64 matmul.
        ref = offload_ref(lambda x, y: x @ y, PolicyRef(
            default_splits=5, min_dim=128))(
            jnp.asarray(x), jnp.asarray(y))
        want = np.asarray(ref) @ y.T
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
