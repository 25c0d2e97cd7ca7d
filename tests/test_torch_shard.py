"""The port's meshes (``repro_torch.shard``) against the reference's.

The helpers' results and messages, the LM axis rules and the gradient
bucketing are compared in this process.  Sharded execution runs in
spawned gloo ranks on the CPU (rank functions in
``tests/torch_shard_workers.py``, each spawn bounded by a join timeout):
two ranks (``dp=2`` and ``dp=1,tp=2``) and eight (``dp=4,tp=2``).  The
native float64 runs are held to the reference's native sharded run on
its 8 virtual devices and to the port's single device within 1e-10; the
emulated runs, which the reference cannot run on this jax (its offload
of a ``shard_map`` body fails, ROADMAP section 3), to the documented
contract: ``shmap0/`` plus the single-device names, the same offloaded
count at ``dp``, ``spmd`` in every site, and the single device's losses
within 1e-10 and parameters within 1e-9 at s = 9 with the f64
accumulator (2e-6 and 1e-4 at s = 4, the reference's stated bars).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as PRef

from repro.configs import LMConfig as LMConfigRef
from repro.configs import get_config as get_config_ref
from repro.launch.train import build_sharded_train_step as sharded_ref
from repro.launch.train import build_train_step as single_ref
from repro.models import Model as ModelRef
from repro.shard import bucket_stats as bucket_stats_ref
from repro.shard import build_mesh as build_mesh_ref
from repro.shard import data_parallel_sharding as dp_sharding_ref
from repro.shard import lm_param_specs as lm_param_specs_ref
from repro.shard import parse_mesh_spec as parse_mesh_spec_ref
from repro.shard import specs_to_rules as specs_to_rules_ref
from repro.shard import train_mesh_setup as train_mesh_setup_ref
from repro.shard import train_state_specs as train_state_specs_ref
from repro.shard.collectives import bucket_indices as bucket_indices_ref
from repro.train import AdamW as AdamWRef
from repro.train import SyntheticText as SyntheticTextRef
from repro_torch.configs import LMConfig, get_config
from repro_torch.core import PrecisionPolicy, offload, site_report, spmd_scope
from repro_torch.launch.train import build_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model
from repro_torch.shard import (Mesh, PartitionSpec,
                               bucket_indices, bucket_stats, build_mesh,
                               data_parallel_sharding, flatten_specs,
                               lm_param_specs,
                               parse_mesh_spec, reduce_gradients,
                               shard_batch, shard_block, specs_to_rules,
                               train_mesh_setup, train_state_specs)
from repro_torch.shard.launch import spawn
from repro_torch.train import AdamW, SyntheticText
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.tune.cli import main as tune_main

import torch_shard_workers as workers

JOIN_TIMEOUT = 120

_F64 = dict(name="shard_f64", vocab_size=128, num_layers=1, d_model=64,
            num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
            dtype="float64", param_dtype="float64")
_TP_F64 = dict(name="tp_f64", vocab_size=128, num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
               dtype="float64", param_dtype="float64")
F64, TP_F64 = LMConfig(**_F64), LMConfig(**_TP_F64)
F64_REF, TP_F64_REF = LMConfigRef(**_F64), LMConfigRef(**_TP_F64)
STEPS = 4


def _emulated(spec):
    # The reference's bars are for its jnp Ozaki path with the f64
    # accumulator, fp64_int8_s (the kernel family always folds in df32).
    # A pinned spec runs at its own count; the policy names it too, so
    # the site report shows the count that runs.
    return dict(backend=spec, default_splits=int(spec.rsplit("_", 1)[1]),
                min_dim=32, accumulator="f64")


# -- the port's single device and the reference's sharded runs ----------


def _single(cfg, steps=STEPS, backend=""):
    """The port's single-device run: losses and final parameters."""
    model = Model(cfg, device="cpu", seed=0)
    opt = AdamW(lr=3e-3)
    data = SyntheticText(cfg.vocab_size, workers.SEQ_LEN, workers.BATCH,
                         seed=0)
    step = build_train_step(model, opt)
    params = model.params
    state = opt.init(params)
    sites = []
    if backend:
        s = int(backend.rsplit("_", 1)[1])
        step = offload(step, PrecisionPolicy(
            backend=backend, default_splits=s, min_dim=32,
            accumulator="f64"))
        sites = step.sites(params, state, torch.as_tensor(data.batch(0)))
    losses = []
    for i in range(steps):
        params, state, loss = step(params, state,
                                   torch.as_tensor(data.batch(i)))
        losses.append(float(loss))
    return losses, [x.numpy() for x in tree_flatten(params)], sites


def _reference(spec):
    """The reference's native run of TP_F64, sharded over ``spec`` on
    its virtual devices (``""``: one device): losses and final (global)
    parameters."""
    model = ModelRef(TP_F64_REF)
    opt = AdamWRef(lr=3e-3)
    data = SyntheticTextRef(TP_F64_REF.vocab_size, workers.SEQ_LEN,
                            workers.BATCH, seed=0)
    p = model.init_params(jax.random.PRNGKey(0))
    o = opt.init(p)
    if spec:
        mesh, bsh, (p, o), _ = train_mesh_setup_ref(
            spec, workers.BATCH, TP_F64_REF, (p, o))
        step = jax.jit(sharded_ref(model, opt, mesh))
    else:
        bsh, step = None, jax.jit(single_ref(model, opt))
    losses = []
    for i in range(STEPS):
        batch = jnp.asarray(data.batch(i))
        p, o, loss = step(p, o, batch if bsh is None
                          else jax.device_put(batch, bsh))
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(p)]


@pytest.fixture(scope="module")
def single():
    return {"native": _single(TP_F64),
            "tp_s9": _single(TP_F64, backend="fp64_int8_9"),
            "s9": _single(F64, backend="fp64_int8_9"),
            "s4": _single(F64, backend="fp64_int8_4"),
            "pallas_s9": _single(F64, backend="pallas_int8_9")}


@pytest.fixture(scope="module")
def reference():
    return {spec: _reference(spec)
            for spec in ("", "dp=4,tp=2", "dp=1,tp=2", "dp=2")}


# -- spawned ranks --------------------------------------------------------


def _train(cfg, spec, **kw):
    return ("train", dict(cfg=cfg, spec=spec, steps=STEPS, **kw))


TWO = {
    "collectives": ("collectives", dict(spec="dp=2", seed=5,
                                        bucket_bytes=1 << 20)),
    "collectives_small": ("collectives", dict(spec="dp=2", seed=6,
                                              bucket_bytes=64)),
    "replicated": ("replicated", dict(spec="dp=2")),
    "errors": ("setup_errors", dict(cfg=F64, global_batch=8)),
    "dp2": _train(TP_F64, "dp=2"),
    "dp2_blocking": _train(TP_F64, "dp=2", grad_reduce="blocking"),
    "dp2_ppermute": _train(TP_F64, "dp=2", grad_reduce="ppermute"),
    "dp2_s9": _train(F64, "dp=2", **_emulated("fp64_int8_9")),
    "dp2_s4": _train(F64, "dp=2", **_emulated("fp64_int8_4")),
    "dp2_pallas_s9": _train(F64, "dp=2", **_emulated("pallas_int8_9")),
    "tp2": _train(TP_F64, "dp=1,tp=2"),
    "stale": ("stale_plan", dict(cfg=get_config("tiny"), spec="dp=1,tp=2")),
}
EIGHT = {
    "collectives": ("collectives", dict(spec="dp=4,tp=2", seed=7,
                                        bucket_bytes=1 << 20)),
    "dp4tp2": _train(TP_F64, "dp=4,tp=2"),
    "dp4tp2_blocking": _train(TP_F64, "dp=4,tp=2", grad_reduce="blocking"),
    "dp4tp2_ppermute": _train(TP_F64, "dp=4,tp=2", grad_reduce="ppermute"),
    "dp4tp2_s9": _train(TP_F64, "dp=4,tp=2", **_emulated("fp64_int8_9")),
}


def _run(tasks, world):
    names = list(tasks)
    per_rank = spawn(workers.run_tasks, world, ([tasks[n] for n in names],),
                     device="cpu", timeout=JOIN_TIMEOUT)
    return {n: [rank[i] for rank in per_rank] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def two():
    return _run(TWO, 2)


@pytest.fixture(scope="module")
def eight():
    return _run(EIGHT, 8)


def _global_params(results):
    return workers.global_params(results, TP_F64)


def _close(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# -- this process ------------------------------------------------------


class TestMeshHelpers:
    def test_parse_mesh_spec(self):
        for spec in ("dp=8", "dp=4,tp=2", "tp=2,dp=4"):
            assert parse_mesh_spec(spec) == parse_mesh_spec_ref(spec)

    @pytest.mark.parametrize("bad", ["", "dp", "dp=x", "dp=0",
                                     "dp=2,dp=2"])
    def test_parse_rejects_with_the_reference_message(self, bad):
        with pytest.raises(ValueError) as ref:
            parse_mesh_spec_ref(bad)
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(bad)
        assert str(got.value) == str(ref.value)

    def test_one_position_needs_no_group(self):
        mesh = build_mesh("dp=1")
        assert mesh.size == 1 and mesh.axis_names == ("dp",)
        assert mesh.group is None and mesh.coords == {"dp": 0}

    def test_too_few_ranks_names_the_recipe(self):
        with pytest.raises(ValueError, match="needs 2 processes") as e:
            build_mesh("dp=2")
        assert "torchrun" in str(e.value) and "--mesh" in str(e.value)
        with pytest.raises(SystemExit, match="needs 4 processes"):
            train_mesh_setup("dp=2,tp=2", 4, TP_F64)

    def test_data_parallel_sharding_is_the_references(self):
        mesh = Mesh({"dp": 8})
        rep, dp = data_parallel_sharding(mesh)
        rep_ref, dp_ref = dp_sharding_ref(build_mesh_ref("dp=8"))
        assert (rep, dp) == (rep_ref.spec, dp_ref.spec)
        with pytest.raises(ValueError) as ref:
            dp_sharding_ref(build_mesh_ref("dp=8"), axis="tp")
        with pytest.raises(ValueError) as got:
            data_parallel_sharding(mesh, axis="tp")
        assert str(got.value) == str(ref.value)

    def test_unknown_axis_message_is_the_references(self):
        with pytest.raises(SystemExit) as ref:
            train_mesh_setup_ref("pp=2", 4)
        with pytest.raises(SystemExit) as got:
            train_mesh_setup("pp=2", 4)
        assert str(got.value) == str(ref.value)

    def test_shard_batch_takes_the_ranks_rows(self):
        batch = torch.arange(16 * 3, dtype=torch.float64).reshape(16, 3)
        rows = [shard_batch(batch, Mesh({"dp": 8}, rank=r))
                for r in range(8)]
        assert torch.equal(torch.cat(rows), batch)
        with pytest.raises(ValueError) as ref:
            jax_mesh = build_mesh_ref("dp=8")
            from repro.shard import shard_batch as shard_batch_ref
            shard_batch_ref(jnp.ones((9, 2)), jax_mesh)
        with pytest.raises(ValueError) as got:
            shard_batch(torch.ones(9, 2), Mesh({"dp": 8}))
        assert str(got.value) == str(ref.value)

    def test_mesh_coordinates_are_dp_major(self):
        coords = [Mesh({"dp": 4, "tp": 2}, rank=r).coords for r in range(8)]
        assert coords[1] == {"dp": 0, "tp": 1}
        assert coords[2] == {"dp": 1, "tp": 0}
        # The reference's device grid: device r at the same position.
        grid = build_mesh_ref("dp=4,tp=2").devices
        for r, c in enumerate(coords):
            assert grid[c["dp"], c["tp"]].id == r


class TestRules:
    @pytest.mark.parametrize("name", ["tiny", "tp_f64", "tied"])
    def test_specs_and_rules_are_the_references(self, name):
        if name == "tp_f64":
            cfg, ref_cfg = TP_F64, TP_F64_REF
        else:
            cfg, ref_cfg = get_config("tiny"), get_config_ref("tiny")
            if name == "tied":
                cfg = cfg.replace(tie_embeddings=True)
                ref_cfg = ref_cfg.replace(tie_embeddings=True)

        def plain(tree):
            if isinstance(tree, dict):
                return {k: plain(v) for k, v in tree.items()}
            if isinstance(tree, (PartitionSpec, PRef)):
                return tuple(tree)
            return tuple(plain(v) for v in tree)

        assert plain(lm_param_specs(cfg)) == plain(lm_param_specs_ref(ref_cfg))
        assert (plain(train_state_specs(cfg))
                == plain(train_state_specs_ref(ref_cfg)))
        model = Model(cfg, device="cpu", seed=0)
        ref_params = ModelRef(ref_cfg).init_params(jax.random.PRNGKey(0))
        state = (model.params, AdamW().init(model.params))
        ref_state = (ref_params, AdamWRef().init(ref_params))
        assert (specs_to_rules(train_state_specs(cfg), state)
                == specs_to_rules_ref(train_state_specs_ref(ref_cfg),
                                      ref_state))

    def test_blocks_are_the_references_placement(self):
        # Each rank's block equals the shard the reference places on the
        # device at its mesh position.
        model = ModelRef(TP_F64_REF)
        params = model.init_params(jax.random.PRNGKey(0))
        state = (params, AdamWRef().init(params))
        mesh_ref, _, placed, _ = train_mesh_setup_ref(
            "dp=2,tp=2", 4, TP_F64_REF, state)
        specs = flatten_specs(train_state_specs(TP_F64))
        full = [torch.from_numpy(np.asarray(x))
                for x in jax.tree_util.tree_leaves(state)]
        where = {d.id: (i, j) for (i, j), d in
                 np.ndenumerate(mesh_ref.devices)}
        for leaf, spec, x in zip(jax.tree_util.tree_leaves(placed), specs,
                                 full):
            for shard in leaf.addressable_shards:
                i, j = where[shard.device.id]
                mesh = Mesh({"dp": 2, "tp": 2}, rank=2 * i + j)
                got = shard_block(x, spec, mesh)
                assert np.asarray(shard.data).tobytes() == \
                    got.numpy().tobytes()


class TestBuckets:
    @pytest.mark.parametrize("bucket_bytes", [1600, 64 << 10, 4 << 20])
    def test_bucketing_is_the_references(self, bucket_bytes):
        leaves = [np.zeros(n, np.float64) for n in (100, 100, 300, 50)]
        assert (bucket_indices(leaves, bucket_bytes)
                == bucket_indices_ref(leaves, bucket_bytes))
        params = Model(TP_F64, device="cpu", seed=0).params
        ref_params = ModelRef(TP_F64_REF).init_params(jax.random.PRNGKey(0))
        assert (bucket_stats(params, bucket_bytes)
                == bucket_stats_ref(ref_params, bucket_bytes))

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="bucketed"):
            reduce_gradients({"g": torch.ones(3)}, "dp", 2, mode="avg",
                             mesh=Mesh({"dp": 2}))

    def test_unbound_axis_is_named(self):
        with pytest.raises(ValueError, match="spmd_scope"):
            reduce_gradients({"g": torch.ones(3)}, "dp", 1)


class TestSpmdScope:
    def test_sites_take_the_scope_and_the_mesh(self):
        # One rank's view of dp=1: the step's names gain shmap0/, every
        # site carries the mesh, flops count every shard.
        mesh = Mesh({"dp": 1, "tp": 1})
        a = torch.randn(64, 160, dtype=torch.float64)
        b = torch.randn(160, 160, dtype=torch.float64)

        def f(a, b):
            with spmd_scope(mesh):
                return torch.tanh(a @ b) @ b

        pol = PrecisionPolicy(default_splits=8, min_dim=32)
        sites = site_report(f, pol)(a, b)
        assert [s.name for s in sites] == ["shmap0/dot0", "shmap0/dot1"]
        assert all(s.spmd == "dp=1,tp=1" for s in sites)
        assert "[dp=1,tp=1]" in repr(sites[0])

    def test_mesh_shape_is_part_of_the_cache_key(self):
        a = torch.randn(64, 160, dtype=torch.float64)
        b = torch.randn(160, 160, dtype=torch.float64)
        pol = PrecisionPolicy(default_splits=8, min_dim=32)
        seen = []
        for shape in ({"dp": 1}, {"dp": 1, "tp": 1}):
            mesh = Mesh(shape)

            def f(a, b):
                with spmd_scope(mesh):
                    return a @ b
            f.spmd_axes = mesh.spmd_axes
            wrapped = offload(f, pol)
            wrapped(a, b)
            seen.append(wrapped.sites(a, b)[0].spmd)
        assert seen == ["dp=1", "dp=1,tp=1"]


# -- spawned ranks ------------------------------------------------------


class TestCollectives:
    @pytest.mark.parametrize("task", ["collectives", "collectives_small"])
    def test_bucketed_is_the_per_leaf_mean_bitwise_at_dp2(self, two, task):
        for rank in two[task]:
            for got, want in zip(rank["bucketed"], rank["mean"]):
                assert got.tobytes() == want.tobytes()
            for got, want in zip(rank["blocking"], rank["mean"]):
                assert got.tobytes() == want.tobytes()
            _close(rank["ring"], rank["mean"], 1e-9)
        # Every rank holds the same bits.
        assert all(a.tobytes() == b.tobytes() for a, b in
                   zip(two[task][0]["bucketed"], two[task][1]["bucketed"]))

    def test_dp4_bound_and_replicas(self, eight):
        # At dp=4 gloo's chunking may add a bucket's element in another
        # order than the element alone; the gap is rounding (measured 0
        # on this data), and every rank of a dp group gets the same bits.
        ranks = eight["collectives"]
        for tp in (0, 1):
            group = ranks[tp::2]   # one dp group: ranks sharing tp
            exact = [np.mean(np.stack([r["inputs"][i] for r in group]),
                             axis=0) for i in range(3)]
            for rank in group:
                _close(rank["bucketed"], rank["mean"], 1e-15)
                _close(rank["bucketed"], exact, 1e-15)
                _close(rank["ring"], rank["mean"], 1e-9)
            for r in group[1:]:
                assert all(a.tobytes() == b.tobytes() for a, b in
                           zip(r["bucketed"], group[0]["bucketed"]))

    def test_replicate_broadcasts_rank_zero(self, two):
        with pytest.raises(SystemExit) as ref:
            from repro.shard import data_parallel_setup as setup_ref
            setup_ref("dp=2", 3)
        for rank in two["replicated"]:
            for got in (rank["got"], rank["setup"]):
                assert np.array_equal(got[1], np.zeros(3))
                assert int(got[0]) == 7
            assert rank["batch_spec"] == ("dp",)
            assert rank["message"] == str(ref.value)

    def test_setup_messages_are_the_references(self, two):
        with pytest.raises(SystemExit) as batch:
            train_mesh_setup_ref("dp=2", 9, F64_REF)
        with pytest.raises(SystemExit) as tp:
            train_mesh_setup_ref("dp=1,tp=2", 8, F64_REF)
        for rank in two["errors"]:
            assert rank["batch"] == str(batch.value)
            assert rank["tp"] == str(tp.value)
            assert rank["axis_names"] == ["dp", "tp"]
        assert [r["coords"] for r in two["errors"]] == [
            {"dp": 0, "tp": 0}, {"dp": 1, "tp": 0}]


class TestNativeTrain:
    """float64 TP_F64 over 4 steps: the port's sharded run against the
    port's single device (``atol``), and against the reference's native
    sharded run as far as the two single devices agree.

    The model is float64 but for its float32 softmax and gate, where
    XLA's ``exp`` is not torch's (ROADMAP section 3): one device of each
    package already differs by about 2.4e-8 in the loss and 2.1e-5 in
    the parameters after 4 AdamW steps.  So the port's sharded run is
    held to within that single-device gap plus ``atol`` of the
    reference's sharded run, element by element, and the reference's
    sharded run to its own single device within ``atol``.
    """

    @pytest.mark.parametrize("task,spec,atol", [
        ("dp2", "dp=2", 1e-10), ("dp2_blocking", "dp=2", 1e-10),
        ("dp2_ppermute", "dp=2", 1e-9), ("tp2", "dp=1,tp=2", 1e-10)])
    def test_two_ranks(self, two, single, reference, task, spec, atol):
        self._check(two[task], spec, single, reference, atol)

    @pytest.mark.parametrize("task,atol", [
        ("dp4tp2", 1e-10), ("dp4tp2_blocking", 1e-10),
        ("dp4tp2_ppermute", 1e-9)])
    def test_dp4_tp2(self, eight, single, reference, task, atol):
        self._check(eight[task], "dp=4,tp=2", single, reference, atol)

    @staticmethod
    def _check(results, spec, single, reference, atol):
        ref_losses, ref_params = reference[spec]
        ref1_losses, ref1_params = reference[""]
        losses, params, _ = single["native"]
        got = _global_params(results)
        np.testing.assert_allclose(ref_losses, ref1_losses, rtol=0,
                                   atol=1e-10)
        _close(ref_params, ref1_params, 1e-10)
        gap = np.abs(np.subtract(losses, ref1_losses)) + atol
        for r in results:
            np.testing.assert_allclose(r["losses"], losses, rtol=0,
                                       atol=atol)
            assert np.all(np.abs(np.subtract(r["losses"], ref_losses))
                          <= gap)
        _close(got, params, atol)
        for g, want, p1, r1 in zip(got, ref_params, params, ref1_params):
            assert np.all(np.abs(g - want) <= np.abs(p1 - r1) + atol)
        # Every rank of a dp group holds the same bits, but for the ring,
        # whose ranks add in their own orders.
        for r in results[1:]:
            if r["coords"]["tp"] == results[0]["coords"]["tp"]:
                if atol < 1e-9:
                    assert all(a.tobytes() == b.tobytes() for a, b in
                               zip(r["params"], results[0]["params"]))
                else:
                    _close(r["params"], results[0]["params"], atol)


class TestEmulatedTrain:
    """The documented contract of the emulated sharded step."""

    @pytest.mark.parametrize("task,base,atol,param_atol", [
        ("dp2_s9", "s9", 1e-10, 1e-9), ("dp2_s4", "s4", 2e-6, 1e-4),
        ("dp2_pallas_s9", "pallas_s9", 1e-10, 1e-9)])
    def test_dp2_matches_single_device(self, two, single, task, base,
                                       atol, param_atol):
        losses, params, sites = single[base]
        for r in two[task]:
            np.testing.assert_allclose(r["losses"], losses, rtol=0,
                                       atol=atol)
            _close(r["params"], params, param_atol)
            # Same sites, one extra path segment: the shard scope.
            assert [s["name"] for s in r["sites"]] == [
                "shmap0/" + s.name for s in sites]
            n_on = sum(s["offloaded"] for s in r["sites"])
            assert n_on == sum(s.offloaded for s in sites) > 0
            on = [s for s in r["sites"] if s["offloaded"]]
            assert all(s["spmd"] == "dp=2,tp=1" for s in on)
            assert all("[dp=2,tp=1]" in s["repr"] for s in on)

    def test_dp4_tp2_matches_single_device(self, eight, single):
        losses, params, sites = single["tp_s9"]
        results = eight["dp4tp2_s9"]
        got = _global_params(results)
        _close(got, params, 1e-9)
        for r in results:
            np.testing.assert_allclose(r["losses"], losses, rtol=0,
                                       atol=1e-10)
            # The tp all-reduce Functions are opaque: no site beyond the
            # single device's, each under the mesh.
            assert [s["name"] for s in r["sites"]] == [
                "shmap0/" + s.name for s in sites]
            on = [s for s in r["sites"] if s["offloaded"]]
            assert on and all(s["spmd"] == "dp=4,tp=2" for s in on)
            assert all("[dp=4,tp=2]" in s["repr"] for s in on)

    def test_min_dim_gates_per_shard_shape(self, eight, single):
        # k and v project to kv_dim/tp = 16 columns per shard: gated
        # native under tp where the single device offloads them.
        _, _, sites = single["tp_s9"]
        single_on = {s.name: s.offloaded for s in sites}
        for r in eight["dp4tp2_s9"]:
            by_name = {s["name"]: s for s in r["sites"]}
            for j in (1, 2):
                s = by_name[f"shmap0/scan0/dot{j}"]
                assert single_on[f"scan0/dot{j}"]
                assert not s["offloaded"] and s["n"] == 16
                assert "min(m,k,n)=16" in s["reason"]

    def test_single_device_step_plan_is_stale_under_tp(self, two):
        for msg in two["stale"]:
            assert msg is not None and msg.startswith("PlanStaleError")


class TestTrainerCLI:
    def test_mesh_trains_as_one_process(self, tmp_path):
        argv = ["--arch", "tiny", "--steps", "4", "--seq-len", "32",
                "--global-batch", "4", "--metrics-dir", "none",
                "--backend", "pallas_int8_4", "--min-dim", "32",
                "--log-every", "10"]
        single = train_main(argv + ["--ckpt-dir", str(tmp_path / "a")],
                            device="cpu")
        report = {}
        got = train_main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--mesh", "dp=2,tp=2"], device="cpu",
                         report=report, timeout=JOIN_TIMEOUT)
        np.testing.assert_allclose(got, single, rtol=1e-5)
        assert len(report["ranks"]) == 4
        for rank in report["ranks"]:
            names = [s.name for s in rank["sites"]]
            assert names and all(n.startswith("shmap0/") for n in names)
            # The hook fires once per product, scan iterations each.
            per_step = sum(s.mult for s in rank["sites"] if s.offloaded)
            assert rank["site_exec"] == 4 * per_step > 0
        assert (tmp_path / "b" / "step_00000004" / "manifest.json").is_file()

    def test_rank_zero_writes_the_telemetry(self, tmp_path):
        # Every rank runs the numerics check (it runs the step and its
        # collectives); rank 0 alone writes the run.
        report = {}
        train_main(["--arch", "tiny", "--steps", "2", "--seq-len", "32",
                    "--global-batch", "4", "--backend", "pallas_int8_4",
                    "--min-dim", "32", "--numerics-every", "1",
                    "--metrics-dir", str(tmp_path / "m"), "--mesh", "dp=2",
                    "--ckpt-dir", str(tmp_path / "c")], device="cpu",
                   report=report, timeout=JOIN_TIMEOUT)
        assert sorted(p.name for p in (tmp_path / "m").iterdir()) == [
            "events-0000.jsonl"]
        events = [json.loads(line) for line in
                  (tmp_path / "m" / "events-0000.jsonl").read_text()
                  .splitlines()]
        kinds = [e["type"] for e in events]
        assert kinds.count("numerics") == 2 and kinds.count("step") == 2
        decl = [e for e in events if e["type"] == "site_decl"]
        assert decl and all(e["spmd_axes"] == [["dp", 2], ["tp", 1]]
                            for e in decl)


class TestTuneCLI:
    def test_dp2_loss_plan_is_the_single_device_plan(self, tmp_path):
        # The per-shard statistics are MAX-shared over the mesh and every
        # plan field is mesh-invariant: the artifacts match byte for byte.
        argv = ["--arch", "tiny", "--device", "cpu", "--target", "loss",
                "--seq-len", "64", "--global-batch", "8", "--min-dim", "64"]
        single = tune_main(argv + ["--plan", str(tmp_path / "one.json")])
        sharded = tune_main(argv + ["--plan", str(tmp_path / "dp2.json"),
                                    "--mesh", "dp=2"],
                            timeout=JOIN_TIMEOUT)
        assert sharded == single
        for suffix in (".json", ".tiles.json"):
            assert ((tmp_path / f"one{suffix}").read_bytes()
                    == (tmp_path / f"dp2{suffix}").read_bytes())
