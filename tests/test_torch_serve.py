"""Port parity: repro_torch.serve.Engine against repro.serve.Engine, and
the reference's own serving bars held on the port.

Both engines get the same parameters (carried with
``params_from_reference``) and the same requests; under the policy
``pallas_int8_4`` every prefill wave of at least 128 tokens runs its
projection and MLP GEMMs through the split-GEMM kernel's plain version,
bitwise equal to the reference's Pallas kernel, so greedy and sampled
tokens must be identical.  The port's own bars are the reference's
(``tests/test_serve.py``, ``tests/test_serve_paged.py``): batched ==
sequential, paged == dense, chunked == unchunked, fifo/edf order,
named validation errors, EOS eviction and clean slot reuse.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LMConfig as LMConfigRef
from repro.core import PrecisionPolicy as PolicyRef
from repro.models import Model as ModelRef
from repro.serve import Engine as EngineRef
from repro.serve import Request as RequestRef
from repro_torch.configs import LMConfig
from repro_torch.core import PrecisionPolicy
from repro_torch.models import Model, params_from_reference
from repro_torch.serve import (Engine, PagedKVCache, Request,
                               SamplingParamError, Scheduler)

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

SMALL = dict(name="test_serve", vocab_size=128, num_layers=1, d_model=64,
             num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128)
# Wide enough that prefill waves of >= 128 tokens offload at min_dim=128.
WIDE = dict(name="test_serve_wide", vocab_size=128, num_layers=2,
            d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
            d_ff=256)


def _pair(arch, eos_id=None):
    ref = ModelRef(LMConfigRef(**arch, eos_id=eos_id))
    params = ref.init_params(jax.random.PRNGKey(0))
    params["lm_head"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), params["lm_head"].shape, dtype=jnp.float32)
    port = Model(LMConfig(**arch, eos_id=eos_id), device="cpu")
    port.load_params(params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    return ref, params, port


@pytest.fixture(scope="module")
def small():
    return _pair(SMALL)[2]


@pytest.fixture(scope="module")
def wide():
    return _pair(WIDE)


def _prompts(lengths, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lengths]


def _reqs(prompts, max_new=6, **kw):
    return [Request(prompt=p, max_new_tokens=max_new, **kw)
            for p in prompts]


def _run(model, prompts, max_new=6, **kw):
    return [r.out for r in Engine(model, model.params, **kw).run(
        _reqs(prompts, max_new))]


class TestAgainstReference:
    @pytest.mark.parametrize("layout", ["paged", "dense"])
    def test_same_tokens_greedy_and_sampled(self, wide, layout):
        ref, params, port = wide
        prompts = _prompts([70, 140, 33, 200, 9], seed=21)
        kw = dict(batch_slots=3, max_len=256, kv_layout=layout,
                  chunk_tokens=64, chunk_token_budget=160)
        pol = dict(backend="pallas_int8", default_splits=4)

        def reqs(cls):
            return [cls(prompt=p, max_new_tokens=5,
                        temperature=0.8 if i % 2 else 0.0, seed=i)
                    for i, p in enumerate(prompts)]

        got = Engine(port, port.params, policy=PrecisionPolicy(**pol),
                     **kw)
        want = EngineRef(ref, params, policy=PolicyRef(**pol), **kw).run(
            reqs(RequestRef))
        assert [r.out for r in got.run(reqs(Request))] == \
            [r.out for r in want]
        # The kernel path ran: the 192-token waves offload.
        sites = got.prefill_sites(rows=3, width=64)
        assert sum(s.offloaded for s in sites) == 5

    def test_prefill_sites_match_reference(self, wide):
        ref, params, port = wide
        pol = dict(backend="pallas_int8", default_splits=4)
        kw = dict(batch_slots=2, max_len=128)
        t = Engine(port, port.params, policy=PrecisionPolicy(**pol),
                   **kw).prefill_sites(rows=2, width=64)
        r = EngineRef(ref, params, policy=PolicyRef(**pol),
                      **kw).prefill_sites(rows=2, width=64)
        assert [(s.name, s.offloaded, s.m, s.k, s.n, s.mult) for s in t] \
            == [(s.name, s.offloaded, s.m, s.k, s.n, s.mult) for s in r]


class TestEngine:
    def test_mixed_lengths_match_sequential(self, small):
        prompts = _prompts([3, 7, 12, 16])
        batched = _run(small, prompts, 8, batch_slots=4, max_len=64)
        for out, prompt in zip(batched, prompts):
            assert out == _run(small, [prompt], 8, batch_slots=1,
                               max_len=64)[0]

    def test_queue_longer_than_slots(self, small):
        prompts = _prompts([4, 5, 6, 7, 8], seed=1)
        reqs = _reqs(prompts, 5)
        done = Engine(small, small.params, batch_slots=2,
                      max_len=64).run(reqs)
        assert done is reqs
        assert all(r.done and len(r.out) == 5 for r in done)
        for req, prompt in zip(done, prompts):
            assert req.out == _run(small, [prompt], 5, batch_slots=1,
                                   max_len=64)[0]

    def test_eos_evicts_early(self):
        prompt = _prompts([6], seed=2)[0]
        first = _run(_pair(SMALL)[2], [prompt], 20, batch_slots=1,
                     max_len=64)[0][0]
        eos_model = _pair(SMALL, eos_id=first)[2]
        assert _run(eos_model, [prompt], 20, batch_slots=1,
                    max_len=64) == [[first]]

    def test_rejects_bad_requests(self, small):
        eng = Engine(small, small.params, batch_slots=1, max_len=16)
        with pytest.raises(ValueError, match="exceeds max_len"):
            eng.run([Request(prompt=_prompts([12], seed=3)[0],
                             max_new_tokens=8)])
        with pytest.raises(ValueError, match="empty prompt"):
            eng.run([Request(prompt=[], max_new_tokens=2)])
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.run([Request(prompt=[1, 2], max_new_tokens=0)])
        for kw in (dict(temperature=-0.5),
                   dict(temperature=1.0, seed="abc"),
                   dict(latency_target_s=0.0)):
            with pytest.raises(SamplingParamError):
                eng.run([Request(prompt=[1, 2], max_new_tokens=2, **kw)])

    def test_slot_reuse_is_clean(self, small):
        prompt = _prompts([9], seed=4)[0]
        eng = Engine(small, small.params, batch_slots=1, max_len=64)
        eng.run(_reqs([_prompts([14], seed=5)[0]]))
        second, = eng.run(_reqs([prompt]))
        assert second.out == _run(small, [prompt], batch_slots=1,
                                  max_len=64)[0]

    def test_plan_at_startup_matches_unplanned_tokens(self, small):
        """The reference's test: the engine loads a (loss-calibrated)
        precision plan at startup and serves under it in subset mode;
        at solved split counts the emulation error is far below
        greedy-argmax resolution, so the tokens match exactly."""
        from repro_torch.tune import Calibrator, solve_plan

        batch = torch.from_numpy(np.random.default_rng(9).integers(
            1, SMALL["vocab_size"], (2, 33)).astype(np.int32))
        cal = Calibrator(small.loss, PrecisionPolicy(default_splits=6,
                                                     min_dim=32))
        cal.run(small.params, batch)
        plan = solve_plan(cal.result(), budget=1e-9)

        prompts = _prompts([5, 9, 16, 12], seed=6)
        planned = Engine(small, small.params, batch_slots=4, max_len=64,
                         plan=plan)
        assert planned.plan is plan
        psites = planned.prefill_sites(rows=4, width=16)
        assert sum(s.offloaded for s in psites) > 0
        splits = plan.site_splits()
        assert all(s.splits == splits[s.name] for s in psites
                   if s.offloaded)
        with warnings.catch_warnings():
            warnings.simplefilter("error")   # subset mode: no warning
            got = [r.out for r in planned.run(_reqs(prompts))]
        assert got == _run(small, prompts, batch_slots=4, max_len=64)

    def test_not_ported_options_raise(self, small):
        # metrics and metrics_port are ported (tests/test_torch_obs*.py),
        # warm_cache_dir too (TestWarmStart); a mesh still raises,
        # naming its item (sharded serving).
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            Engine(small, small.params, mesh=object())


class TestPagedAndChunked:
    def test_paged_tokens_equal_dense(self, small):
        prompts = _prompts([3, 17, 9, 31, 12, 24, 5, 16], seed=11)
        kw = dict(batch_slots=4, max_len=64)
        assert _run(small, prompts, kv_layout="paged", block_size=16,
                    **kw) == _run(small, prompts, kv_layout="dense", **kw)

    def test_paged_programs_bitwise_equal_dense(self, small):
        B, T, S, bs = 2, 16, 64, 16
        tokens = torch.from_numpy(
            np.random.default_rng(3).integers(1, 128, (B, T)).astype(
                np.int32))
        lengths = torch.tensor([T, T - 5], dtype=torch.int32)
        p = small.params
        dense, dl = small.prefill(p, tokens, lengths, S)
        kv = PagedKVCache(small, batch_slots=B, max_len=S, block_size=bs)
        for slot in range(B):
            kv.ensure(slot, int(lengths[slot]))
        cache = kv.sync_table(kv.init_cache())
        k, v, pl = small.prefill_chunk_paged(
            p, cache["k"], cache["v"], cache["block_table"], tokens,
            torch.zeros(B, dtype=torch.int32), lengths)
        assert torch.equal(pl, dl)
        paged = dict(cache, k=k, v=v, length=lengths)
        dense = dict(dense, length=lengths)
        nxt_p = nxt_d = small.greedy(pl)
        active = torch.ones(B, dtype=torch.bool)
        for _ in range(6):
            for slot in range(B):
                kv.ensure(slot, int(paged["length"][slot]) + 1)
            paged = kv.sync_table(paged)
            paged, lp = small.decode_step_paged(p, paged, nxt_p, active)
            dense, ld = small.decode_step(p, dense, nxt_d, active)
            assert torch.equal(lp, ld)
            nxt_p, nxt_d = small.greedy(lp), small.greedy(ld)

    def test_chunked_tokens_equal_unchunked(self, small):
        prompts = _prompts([5, 19, 33, 12], seed=8)
        for layout in ("paged", "dense"):
            kw = dict(batch_slots=2, max_len=64, kv_layout=layout)
            assert _run(small, prompts, **kw) == _run(
                small, prompts, chunk_tokens=4, chunk_token_budget=8,
                **kw), layout

    def test_chunked_prefill_bitwise(self, small):
        T, S = 16, 64
        tokens = torch.from_numpy(
            np.random.default_rng(13).integers(1, 128, (1, T)).astype(
                np.int32))
        _, want = small.prefill(small.params, tokens,
                                torch.tensor([T], dtype=torch.int32), S)
        cache = small.init_cache(1, S)
        k, v = cache["k"], cache["v"]
        for pos in range(0, T, 4):
            k, v, got = small.prefill_chunk(
                small.params, k, v, tokens[:, pos:pos + 4],
                torch.tensor([pos], dtype=torch.int32),
                torch.tensor([4], dtype=torch.int32))
        assert torch.equal(got, want)

    def test_packing_and_block_accounting(self, small):
        lengths = [3, 30, 5, 28]
        eng = Engine(small, small.params, batch_slots=4, max_len=64,
                     chunk_tokens=8, chunk_token_budget=16)
        eng.run(_reqs(_prompts(lengths, seed=9), max_new=2))
        assert eng.runner.real_tokens_total == sum(lengths)
        assert eng.runner.padded_tokens_total < 4 * 32
        assert eng.runner.waves_total > 1
        stats = eng.kv.stats()
        assert 0 < stats["allocated_hwm"] < stats["dense_equivalent_blocks"]
        assert stats["allocated_blocks"] == 0

    def test_prefill_sites_leave_the_cache_alone(self, wide):
        # The programs write the cache in place; the site report's run
        # may write only the trash block, never a slot's blocks.
        port = wide[2]
        eng = Engine(port, port.params, batch_slots=2, max_len=256,
                     policy=PrecisionPolicy(backend="pallas_int8",
                                            default_splits=4))
        eng.kv.ensure(0, 40)
        eng.runner.cache = eng.kv.sync_table(eng.runner.cache)
        for key in ("k", "v"):
            eng.cache[key].normal_(generator=torch.Generator().manual_seed(
                0))
        before = {key: eng.cache[key].clone() for key in ("k", "v")}
        assert any(s.offloaded for s in eng.prefill_sites(2, 128))
        keep = [b for b in range(eng.kv.num_blocks_total)
                if b not in eng.kv._trash]
        for key in ("k", "v"):
            assert torch.equal(eng.cache[key][:, keep],
                               before[key][:, keep]), key

    def test_block_size_must_divide_max_len(self, small):
        with pytest.raises(ValueError, match="multiple of block_size"):
            Engine(small, small.params, batch_slots=1, max_len=60,
                   block_size=16)


class TestSampling:
    def test_temperature_zero_is_greedy(self, small):
        prompts = _prompts([7, 9], seed=14)
        eng = Engine(small, small.params, batch_slots=2, max_len=64)
        explicit = eng.run(_reqs(prompts, temperature=0.0, seed=123))
        assert [r.out for r in explicit] == _run(small, prompts,
                                                 batch_slots=2, max_len=64)

    def test_sampled_request_deterministic_across_batching(self, small):
        prompt = _prompts([9], seed=15)[0]

        def sampled(seed):
            return Request(prompt=prompt, max_new_tokens=6,
                           temperature=0.8, seed=seed)

        solo, = Engine(small, small.params, batch_slots=1,
                       max_len=64).run([sampled(42)])
        batched = Engine(small, small.params, batch_slots=4,
                         max_len=64).run(
            [sampled(42)] + _reqs(_prompts([5, 11, 7], seed=16)))
        assert batched[0].out == solo.out
        other, = Engine(small, small.params, batch_slots=1,
                        max_len=64).run([sampled(43)])
        assert other.out != solo.out


class TestScheduler:
    def test_edf_orders_by_deadline(self):
        sched = Scheduler(max_len=64, policy="edf")
        slow = Request(prompt=[1], max_new_tokens=1)
        fast = Request(prompt=[2], max_new_tokens=1, latency_target_s=0.01)
        mid = Request(prompt=[3], max_new_tokens=1, latency_target_s=5.0)
        sched.submit([slow, mid, fast], now=100.0)
        placed = sched.admit([0, 1, 2], lambda s, r: True)
        assert [r for _, r in placed] == [fast, mid, slow]
        assert placed[0][0] == 0

    def test_fifo_and_head_of_line(self):
        sched = Scheduler(max_len=64, policy="fifo")
        reqs = [Request(prompt=[i], max_new_tokens=1,
                        latency_target_s=9.0 - i) for i in range(3)]
        sched.submit(reqs, now=1.0)
        assert [r for _, r in sched.admit([0, 1, 2], lambda s, r: True)] \
            == reqs
        big, little = (Request(prompt=[1], max_new_tokens=1),
                       Request(prompt=[2], max_new_tokens=1))
        sched.submit([big, little], now=2.0)
        assert sched.admit([0], lambda s, r: r is not big) == []
        assert sched.pending == 2


class TestKVCacheManager:
    def test_reservation_and_determinism(self, small):
        kv = PagedKVCache(small, batch_slots=2, max_len=64, block_size=16,
                          num_blocks=4)
        kv.reserve(0, 30, 30)
        assert not kv.can_reserve(1, prompt_len=4, max_new=4)
        kv.ensure(0, 60)
        kv.release(0)
        assert kv.can_reserve(1, prompt_len=4, max_new=4)

        def trace():
            kv = PagedKVCache(small, batch_slots=2, max_len=64,
                              block_size=16)
            kv.ensure(0, 20)
            kv.ensure(1, 40)
            kv.release(0)
            kv.ensure(1, 50)
            kv.ensure(0, 10)
            return kv._table.copy()
        assert (trace() == trace()).all()
        kv = PagedKVCache(small, batch_slots=2, max_len=64, block_size=16,
                          num_blocks=2)
        with pytest.raises(ValueError, match="raise num_blocks"):
            kv.reserve(0, 40, 20)


class TestWarmStart:
    """The reference's ``tests/test_serve_paged.py::TestWarmStart`` on
    the same model (its weights carried over)."""

    def _run_once(self, model, warm_dir, metrics_dir, prompts):
        """One serve 'process': a fresh engine, fresh decision caches
        (they live on the engine's offload wrappers)."""
        from repro_torch.obs import MetricsRun

        pol = PrecisionPolicy(default_splits=6, min_dim=32)
        with MetricsRun(metrics_dir) as run:
            eng = Engine(model, model.params, batch_slots=2, max_len=64,
                         policy=pol, warm_cache_dir=warm_dir, metrics=run)
            out = [r.out for r in eng.run(_reqs(prompts, max_new=4))]
            info = eng.runner._prefill_wrapped.persist_info()
            dinfo = eng.runner._decode_wrapped.persist_info()
        return out, info, dinfo

    def test_restart_reuses_persisted_transforms(self, small, tmp_path):
        """Kill-and-restart: the second process reads byte-identical
        decisions back from disk and decides nothing anew."""
        import json
        import os

        warm = tmp_path / "warm"
        prompts = _prompts([5, 9, 13], seed=17)
        out1, info1, dinfo1 = self._run_once(small, warm, tmp_path / "m1",
                                             prompts)
        assert info1.disk_misses > 0       # cold start wrote entries
        files1 = {f: (warm / f).read_bytes()
                  for f in os.listdir(warm) if f.endswith(".json")}
        assert files1

        out2, info2, dinfo2 = self._run_once(small, warm, tmp_path / "m2",
                                             prompts)
        assert out2 == out1
        # Every entry came from disk; an eager program has no exported
        # program to restore, so they are decisions-only hits.
        assert info2.disk_misses == 0
        assert info2.disk_hits + info2.disk_decisions_hits > 0
        assert info2.disk_hits == 0
        assert dinfo2.disk_misses == 0
        files2 = {f: (warm / f).read_bytes()
                  for f in os.listdir(warm) if f.endswith(".json")}
        assert files2 == files1
        for raw in files2.values():
            json.loads(raw)  # stays valid JSON
        assert out1 == _run(small, prompts, max_new=4, batch_slots=2,
                            max_len=64, policy=PrecisionPolicy(
                                default_splits=6, min_dim=32))

    def test_directory_ignored_without_a_policy(self, small, tmp_path):
        warm = tmp_path / "warm"
        eng = Engine(small, small.params, batch_slots=2, max_len=64,
                     warm_cache_dir=warm)
        assert eng.runner._prefill_wrapped is None
        eng.run(_reqs(_prompts([5, 9], seed=19), max_new=2))
        assert not warm.exists()

    def test_obs_check_gates_on_cache_hit(self, small, tmp_path):
        """``obs report --check --expect-cache-hit`` passes on the warm
        run and fails on the cold one."""
        import io

        from repro_torch.obs.cli import main as obs_main

        warm = tmp_path / "warm"
        prompts = _prompts([6, 10], seed=18)
        self._run_once(small, warm, tmp_path / "m1", prompts)
        self._run_once(small, warm, tmp_path / "m2", prompts)
        buf = io.StringIO()
        # Cold run: sites executed but nothing came from disk.
        assert obs_main(["report", str(tmp_path / "m1"), "--check",
                         "--expect-cache-hit"], out=buf) == 1
        assert "CHECK FAIL" in buf.getvalue()
        buf = io.StringIO()
        # Warm run: the live hook still counts the executions and the
        # decisions resolved from disk.
        assert obs_main(["report", str(tmp_path / "m2"), "--check",
                         "--expect-cache-hit"], out=buf) == 0, \
            buf.getvalue()
        assert "CHECK OK" in buf.getvalue()
