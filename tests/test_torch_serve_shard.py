"""Sharded serving: the port's ``Engine(mesh=)`` on meshes of processes
against its single device and the reference's single-device engine.

The reference's bars (``tests/test_shard.py::TestShardedServe``,
``tests/test_serve_paged.py::test_tokens_identical_dp_tp_mesh``) on its
configs, weights and prompt seeds, with the LM head drawn from a seeded
normal instead of the reference's zero head (which decodes token 0
whatever the mesh does): the streams at dp=2, dp=4×tp=2 and dp=2×tp=2
(paged and dense) equal the port's single device and the reference's,
natively in float64 and through ``PrecisionPolicy(default_splits=6,
min_dim=32)``.  The ranks are gloo processes on the CPU (rank functions
in ``tests/torch_shard_workers.py``, one spawn per mesh, each bounded
by a join timeout).  Beyond the reference: what each rank's cache
holds and that the ranks' caches reassemble into the single device's,
the size gate deciding on the rank's rows, a single-device plan
matching by name, EDF order and enqueue stamps across ranks, and each
rank's ``site_exec`` against its own waves.
"""

import os

import jax
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
from repro_torch.models import Model
from repro_torch.serve import Engine
from repro_torch.shard import Mesh
from repro_torch.shard.launch import spawn
from repro_torch.tune import Calibrator, solve_plan

import torch_shard_workers as workers

torch.set_num_threads(1)

JOIN_TIMEOUT = 240

# tests/test_shard.py:38-47 and tests/test_serve_paged.py:26.
_F64 = dict(name="shard_f64", vocab_size=128, num_layers=1, d_model=64,
            num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
            dtype="float64", param_dtype="float64")
_TP_F64 = dict(name="tp_f64", vocab_size=128, num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               dtype="float64", param_dtype="float64")
_TP_CFG = dict(name="test_paged_tp", vocab_size=128, num_layers=2,
               d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
               d_ff=128, dtype="float64", param_dtype="float64")
CFGS = {"f64": (_F64, 0), "tp_f64": (_TP_F64, 0), "tp_cfg": (_TP_CFG, 2)}

HEAD_SEED = 1

POLICIES = {"native": None,
            "emulated": dict(default_splits=6, min_dim=32)}


def _head(name):
    return workers.lm_head(LMConfig(**CFGS[name][0]), HEAD_SEED)


def _requests(name):
    """The reference's prompts: rng 42 (dp=8 test), 43 (dp=4×tp=2 test)
    and 21 (the paged dp=2×tp=2 test)."""
    if name == "f64":
        rng = np.random.default_rng(42)
        return [dict(prompt=[int(t) for t in rng.integers(1, 128, int(n))],
                     max_new_tokens=8) for n in rng.integers(3, 20, 10)]
    if name == "tp_f64":
        rng = np.random.default_rng(43)
        return [dict(prompt=[int(t) for t in rng.integers(1, 128, int(n))],
                     max_new_tokens=8) for n in rng.integers(3, 20, 8)]
    rng = np.random.default_rng(21)
    return [dict(prompt=[int(t) for t in rng.integers(1, 128, n)],
                 max_new_tokens=6) for n in [3, 14, 7, 22, 11, 18, 5, 9]]


# Engine geometry of each reference test.
GEOMETRY = {"f64": dict(batch_slots=8, max_len=64),
            "tp_f64": dict(batch_slots=8, max_len=64),
            "tp_cfg": dict(batch_slots=4, max_len=64)}

# The gate case: two 20-token prompts in two slots, one per dp group.
# The single device's first wave has m = 40 >= min_dim 32 and offloads;
# each dp=2 rank runs m = 20 and stays native.
GATE_REQS = [dict(prompt=list(range(1, 21)), max_new_tokens=2),
             dict(prompt=list(range(21, 41)), max_new_tokens=2)]
GATE_KW = dict(batch_slots=2, max_len=64)

# EDF: ten requests, most with deadlines, for four slots, admitted as
# slots free.
_TARGETS = (5.0, 1.0, 3.0, None, 2.0)
EDF = [dict(prompt=[int(t) for t in np.random.default_rng(30 + i).integers(
    1, 128, 4 + 3 * i)], max_new_tokens=3 + i % 3,
    latency_target_s=(None if _TARGETS[i % 5] is None
                      else _TARGETS[i % 5] + i)) for i in range(10)]
EDF_KW = dict(batch_slots=4, max_len=64, scheduler_policy="edf")


def _serve_task(name, layout="paged", policy="native", **kw):
    arch, seed = CFGS[name]
    return ("serve", dict(cfg=LMConfig(**arch), seed=seed,
                          requests=_requests(name), head_seed=HEAD_SEED,
                          policy=POLICIES[policy], kv_layout=layout,
                          **GEOMETRY[name], **kw))


def _plan():
    """A single-device plan of TP_CFG's loss (calibrated as
    tests/test_torch_serve.py's plan test does)."""
    model = _port_model("tp_cfg")
    batch = torch.from_numpy(np.random.default_rng(9).integers(
        1, 128, (2, 33)).astype(np.int32))
    cal = Calibrator(model.loss, PrecisionPolicy(default_splits=6,
                                                 min_dim=32))
    cal.run(model.params, batch)
    return solve_plan(cal.result(), budget=1e-9)


@pytest.fixture(scope="module")
def plan():
    return _plan()


def _tasks_dp2():
    return [
        _serve_task("f64", probe=[(2, 8)]),
        _serve_task("f64", policy="emulated", probe=[(2, 8)]),
        _serve_task("f64", layout="dense"),
        ("serve", dict(cfg=LMConfig(**_F64), seed=0, head_seed=HEAD_SEED,
                       requests=GATE_REQS, policy=POLICIES["emulated"],
                       probe=[(1, 20)], **GATE_KW)),
        ("serve", dict(cfg=LMConfig(**_F64), seed=0, head_seed=HEAD_SEED,
                       requests=EDF, **EDF_KW)),
        ("serve_errors", dict(cfg=LMConfig(**_F64), spec="dp=2",
                              batch_slots=3)),
    ]


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    metrics = str(tmp_path_factory.mktemp("dp2_metrics"))
    tasks = _tasks_dp2()
    for _, kw in tasks:
        kw.setdefault("spec", "dp=2")
    tasks[1][1]["metrics_dir"] = metrics
    tasks[1][1]["warm_cache_dir"] = metrics + "_warm"
    tasks[3][1]["metrics_dir"] = metrics + "_gate"
    ranks = spawn(workers.run_tasks, 2, (tasks,), device="cpu",
                  timeout=JOIN_TIMEOUT)
    return dict(zip(["native", "emulated", "dense", "gate", "edf",
                     "errors"], zip(*ranks)), warm=metrics + "_warm")


@pytest.fixture(scope="module")
def dp4_tp2():
    tasks = [_serve_task("tp_f64", spec="dp=4,tp=2"),
             _serve_task("tp_f64", spec="dp=4,tp=2", policy="emulated")]
    ranks = spawn(workers.run_tasks, 8, (tasks,), device="cpu",
                  timeout=JOIN_TIMEOUT)
    return dict(zip(["native", "emulated"], zip(*ranks)))


@pytest.fixture(scope="module")
def dp2_tp2(plan):
    keys, tasks = [], []
    for layout in ("paged", "dense"):
        for policy in POLICIES:
            keys.append((layout, policy))
            tasks.append(_serve_task("tp_cfg", layout, policy,
                                     spec="dp=2,tp=2"))
    keys.append("plan")
    tasks.append(("serve", dict(
        cfg=LMConfig(**_TP_CFG), seed=2, head_seed=HEAD_SEED,
        requests=_requests("tp_cfg"), plan=plan, probe=[(2, 16)],
        spec="dp=2,tp=2", **GEOMETRY["tp_cfg"])))
    ranks = spawn(workers.run_tasks, 4, (tasks,), device="cpu",
                  timeout=JOIN_TIMEOUT)
    return dict(zip(keys, zip(*ranks)))


# -- the single devices ---------------------------------------------------


def _port_model(name):
    arch, seed = CFGS[name]
    model = Model(LMConfig(**arch), device="cpu", seed=seed)
    with torch.no_grad():
        model.lm_head.copy_(torch.from_numpy(_head(name)))
    return model


_RUNS: dict = {}


def _once(fn):
    """``fn``'s result per argument list, computed once per module (the
    engines are deterministic; several tests read one run)."""
    def cached(*args, **kw):
        key = (fn.__name__, repr(args), repr(sorted(kw.items())))
        if key not in _RUNS:
            _RUNS[key] = fn(*args, **kw)
        return _RUNS[key]
    return cached


@_once
def _single(name, layout="paged", policy="native", requests=None,
            plan=None, **kw):
    """The port's single device: (engine, streams, watch record);
    ``kw`` the engine's geometry and scheduler (default the reference
    test's geometry)."""
    model = _port_model(name)
    pol = POLICIES[policy]
    eng = Engine(model, model.params, kv_layout=layout, plan=plan,
                 policy=None if pol is None else PrecisionPolicy(**pol),
                 **(kw or GEOMETRY[name]))
    reqs = workers.make_requests(requests or _requests(name))
    rec = workers.watch(eng, reqs)
    eng.run(reqs)
    return eng, [r.out for r in reqs], rec


@_once
def _reference(name, layout="paged", policy="native"):
    """The reference's single-device engine on the same weights."""
    arch, seed = CFGS[name]
    model = ModelRef(LMConfigRef(**arch))
    params = model.init_params(jax.random.PRNGKey(seed))
    params["lm_head"] = _head(name)
    pol = POLICIES[policy]
    eng = EngineRef(model, params, kv_layout=layout,
                    policy=None if pol is None else PolicyRef(**pol),
                    **GEOMETRY[name])
    return [r.out for r in eng.run([RequestRef(**r)
                                    for r in _requests(name)])]


def _streams(ranks):
    return [r["tokens"] for r in ranks]


def _assert_same_streams(ranks, want):
    for r in ranks:
        assert r["tokens"] == want, r["coords"]


# -- the reference's bars -------------------------------------------------


class TestTokens:
    @pytest.mark.parametrize("policy", list(POLICIES))
    def test_dp2_equals_single_device(self, dp2, policy):
        want = _single("f64", policy=policy)[1]
        assert want == _reference("f64", policy=policy)
        assert any(t != 0 for out in want for t in out)
        _assert_same_streams(dp2[policy], want)

    def test_dp2_dense_equals_single_device(self, dp2):
        _assert_same_streams(dp2["dense"], _single("f64", "dense")[1])

    @pytest.mark.parametrize("policy", list(POLICIES))
    def test_dp4_tp2_equals_single_device(self, dp4_tp2, policy):
        want = _single("tp_f64", policy=policy)[1]
        assert want == _reference("tp_f64", policy=policy)
        _assert_same_streams(dp4_tp2[policy], want)

    @pytest.mark.parametrize("layout", ["paged", "dense"])
    @pytest.mark.parametrize("policy", list(POLICIES))
    def test_dp2_tp2_paged_and_dense_equal_single_device(
            self, dp2_tp2, layout, policy):
        want = _single("tp_cfg", "dense", policy)[1]
        assert want == _reference("tp_cfg", "dense", policy)
        _assert_same_streams(dp2_tp2[(layout, policy)], want)

    def test_slots_must_divide_mesh(self, dp2):
        for message in dp2["errors"]:
            assert "not divisible by the data-parallel extent dp=2" \
                in message
        # A mesh object alone (no process group) refuses before any
        # collective, as the reference refuses 6 slots at dp=8.
        model = _port_model("f64")
        with pytest.raises(ValueError, match="divisible"):
            Engine(model, model.params, batch_slots=6,
                   mesh=Mesh({"dp": 8}))


# -- the caches -----------------------------------------------------------


class TestCaches:
    def test_dp_ranks_hold_their_slots(self, dp2):
        per_group = 8 * 64 // 16 // 2
        for g, r in enumerate(dp2["native"]):
            assert r["local_slots"] == list(range(4 * g, 4 * g + 4))
            # The group's block range: its data blocks and its trash.
            assert r["k_shape"] == (1, per_group + 1, 1, 16, 32)
            assert r["length_shape"] == (4,)
        for g, r in enumerate(dp2["dense"]):
            assert r["k_shape"] == (1, 4, 1, 64, 32)

    def test_tp_ranks_hold_their_kv_heads(self, dp4_tp2, dp2_tp2):
        for r in dp4_tp2["native"]:
            # 8 slots over dp=4: 2 a group, 2 x 4 blocks + the trash;
            # 2 kv heads over tp=2.
            assert r["k_shape"] == (2, 9, 1, 16, 16)
            assert r["local_slots"] == [2 * r["coords"]["dp"],
                                        2 * r["coords"]["dp"] + 1]
            assert r["wq_shape"] == (2, 64, 32)
        for r in dp2_tp2[("dense", "native")]:
            assert r["k_shape"] == (2, 2, 1, 64, 16)

    @staticmethod
    def _reassembled(ranks):
        """The ranks' snapshots, kv heads concatenated in tp order."""
        tp = max(r["coords"].get("tp", 0) for r in ranks) + 1
        out = {}
        for key in set().union(*(r["snapshots"] for r in ranks)):
            owners = sorted((r for r in ranks if key in r["snapshots"]),
                            key=lambda r: r["coords"].get("tp", 0))
            assert len(owners) == tp
            out[key] = tuple(np.concatenate(
                [r["snapshots"][key][i] for r in owners], axis=1)
                for i in range(2))
        return out

    @pytest.mark.parametrize("layout", ["paged", "dense"])
    def test_dp2_caches_reassemble_bitwise(self, dp2, layout):
        want = _single("f64", layout)[2]["snapshots"]
        got = self._reassembled(dp2["native" if layout == "paged"
                                    else "dense"])
        assert sorted(got) == sorted(want) and len(want) == 10
        for key, (k, v) in want.items():
            assert np.array_equal(got[key][0], k), key
            assert np.array_equal(got[key][1], v), key

    @pytest.mark.parametrize("layout", ["paged", "dense"])
    def test_dp2_tp2_caches_reassemble(self, dp2_tp2, layout):
        # Layer 0's K/V are column-parallel products of the replicated
        # input: bitwise.  Layer 1's input passed the row-parallel wo
        # and w_down, whose tp all-reduce sums in another order: 1e-13.
        want = _single("tp_cfg", layout)[2]["snapshots"]
        got = self._reassembled(dp2_tp2[(layout, "native")])
        assert sorted(got) == sorted(want) and len(want) == 8
        for key, kv in want.items():
            for g, w in zip(got[key], kv):
                assert np.array_equal(g[0], w[0]), key
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-13)


# -- beyond the reference -------------------------------------------------


class TestRanks:
    def test_every_rank_returns_every_stream(self, dp2, dp4_tp2):
        for ranks in (dp2["native"], dp2["edf"], dp4_tp2["emulated"]):
            assert all(s == ranks[0]["tokens"] for s in _streams(ranks))

    def test_gate_decides_on_the_rank_rows(self, dp2):
        single, want, rec = _single("f64", policy="emulated",
                                    requests=GATE_REQS, **GATE_KW)
        assert rec["waves"] == [(2, 20)]
        names = [s.name for s in single.prefill_sites(2, 20)]
        assert sum(s.offloaded for s in single.prefill_sites(2, 20)) == 7
        for r in dp2["gate"]:
            assert r["waves"] == [(1, 20)]
            sites = r["sites"][(1, 20)]
            assert [s["name"] for s in sites] == names
            assert not any(s["offloaded"] for s in sites)
            assert all(s["reason"] == "min(m,k,n)=20 < min_dim=32"
                       for s in sites if s["m"] == 20)
            assert r["site_exec"] == 0
            assert r["tokens"] == want

    def test_site_exec_counts_the_rank_waves(self, dp2):
        # Decode ticks run m = 4 slots a rank, under the gate: every
        # execution is a prefill wave's.
        for r in dp2["emulated"]:
            per_shape = {shape: sum(s["mult"] for s in sites
                                    if s["offloaded"])
                         for shape, sites in r["wave_sites"].items()}
            want = sum(per_shape[shape] for shape in r["waves"])
            assert r["site_exec"] == want > 0

    def test_plan_matches_by_single_device_names(self, dp2_tp2, plan):
        single = _single("tp_cfg", plan=plan)[0].prefill_sites(2, 16)
        splits = plan.site_splits()
        for r in dp2_tp2["plan"]:
            sites = r["sites"][(2, 16)]
            assert [s["name"] for s in sites] == [s.name for s in single]
            on = [s for s in sites if s["offloaded"]]
            assert on and all(s["spmd"] == "" for s in sites)
            # k and v: 16 columns a shard, under the gate on the rank.
            assert {s["name"] for s in on} < {s.name for s in single
                                              if s.offloaded}
            assert r["tokens"] == _single("tp_cfg", plan=plan)[1]
        assert all(s.splits == splits[s.name] for s in single
                   if s.offloaded)

    def test_warm_cache_dir_ignored_under_a_mesh(self, dp2):
        # The emulated dp=2 run was given one; nothing was persisted.
        assert not os.path.exists(dp2["warm"])

    def test_edf_admits_alike_on_every_rank(self, dp2):
        _, want, rec = _single("f64", requests=EDF, **EDF_KW)
        r0, r1 = dp2["edf"]
        assert r0["admitted"] == r1["admitted"] == rec["admitted"]
        assert r0["stamps"] == r1["stamps"]
        assert len(set(r0["stamps"])) == 1
        assert r0["tokens"] == want
