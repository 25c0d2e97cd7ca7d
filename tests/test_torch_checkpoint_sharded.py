"""The port's sharded checkpoints against the reference's layout.

A checkpoint written by either package restores in the other bit for
bit, and the two write equal manifests for equal states.  Every layout
the reference refuses (partial shard set, tampered or missing manifest,
another architecture) the port refuses.  Through the trainer, on
spawned gloo ranks (each bounded by a join timeout): a kill-and-resume
at ``dp=2,tp=2`` is bit-identical, every rank of the first dp row
writes its own shard, the reference restores what the ranks wrote, and
a lineage resumes on another mesh and on one device.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LMConfig as LMConfigRef
from repro.models import Model as ModelRef
from repro.shard import build_mesh as build_mesh_ref
from repro.shard import train_state_specs as train_state_specs_ref
from repro.train import AdamW as AdamWRef
from repro.train import checkpoint as checkpoint_ref
from repro_torch.configs import LMConfig, get_config
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model
from repro_torch.shard import train_state_specs
from repro_torch.train import AdamW, CheckpointError, checkpoint
from repro_torch.train.checkpoint import tree_flatten, tree_unflatten
from torch_parity import reference_config, same_bits

JOIN_TIMEOUT = 120

_CFG = dict(name="ckpt_tp_f64", vocab_size=128, num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
            dtype="float64", param_dtype="float64")
CFG, CFG_REF = LMConfig(**_CFG), LMConfigRef(**_CFG)
MESH = {"dp": 2, "tp": 2}
META = {"plan_fingerprint": None, "backend": "pallas_int8_4"}


@pytest.fixture(scope="module")
def states():
    """One state in both packages: the seeded parameters (equal by
    construction) and AdamW moments filled from one seeded draw."""
    params = Model(CFG, device="cpu", seed=0).params
    state = (params, AdamW().init(params))
    rng = np.random.default_rng(3)
    leaves = [torch.from_numpy(rng.standard_normal(tuple(x.shape))
                               .astype(x.numpy().dtype))
              if x.ndim else x.clone() for x in tree_flatten(state)]
    port = tree_unflatten(state, leaves)
    ref_params = ModelRef(CFG_REF).init_params(jax.random.PRNGKey(0))
    ref_like = (ref_params, AdamWRef().init(ref_params))
    _, treedef = jax.tree_util.tree_flatten(ref_like)
    ref = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x.numpy()) for x in leaves])
    return port, ref


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


class TestAgainstReference:
    def test_reference_written_restores_bitwise(self, tmp_path, states):
        port, ref = states
        checkpoint_ref.save_sharded(tmp_path, 3, ref,
                                    train_state_specs_ref(CFG_REF),
                                    build_mesh_ref("dp=2,tp=2"), meta=META)
        assert checkpoint.latest_step(tmp_path) == 3
        assert checkpoint.load_meta(tmp_path, 3) == META
        got = checkpoint.restore(tmp_path, 3, port)
        for a, b in zip(jax.tree_util.tree_leaves(ref), tree_flatten(got)):
            assert same_bits(a, b)

    def test_port_written_restores_in_the_reference(self, tmp_path, states):
        port, ref = states
        path = checkpoint.save_sharded(tmp_path / "port", 3, port,
                                       train_state_specs(CFG), MESH,
                                       meta=META)
        assert checkpoint_ref.latest_step(tmp_path / "port") == 3
        assert checkpoint_ref.load_meta(tmp_path / "port", 3) == META
        like = jax.tree_util.tree_map(jnp.zeros_like, ref)
        got = checkpoint_ref.restore(tmp_path / "port", 3, like)
        for a, b in zip(jax.tree_util.tree_leaves(got), tree_flatten(port)):
            assert same_bits(a, b)
        ref_path = checkpoint_ref.save_sharded(
            tmp_path / "ref", 3, ref, train_state_specs_ref(CFG_REF),
            build_mesh_ref("dp=2,tp=2"), meta=META)
        assert _manifest(path) == _manifest(ref_path)
        assert ((path / "manifest.json").read_bytes()
                == (ref_path / "manifest.json").read_bytes())
        for name in _manifest(path)["shards"]:
            with np.load(path / name) as a, np.load(ref_path / name) as b:
                assert a.files == b.files
                for key in a.files:
                    assert same_bits(b[key], a[key])


class TestShardedLayout:
    def test_roundtrip_and_manifest(self, tmp_path, states):
        port, _ = states
        path = checkpoint.save_sharded(tmp_path, 3, port,
                                       train_state_specs(CFG), MESH,
                                       meta={"k": "v"})
        assert path.name == "step_00000003"
        man = _manifest(path)
        assert man["format"] == "repro-sharded-ckpt"
        assert man["mesh"] == MESH
        assert man["shard_axis"] == "tp" and man["num_shards"] == 2
        assert sorted(f.name for f in path.glob("shard_*.npz")) \
            == man["shards"]
        leaves = tree_flatten(port)
        assert all(len(r) == leaf.ndim for r, leaf in
                   zip(man["axis_rules"], leaves))
        assert {a for r in man["axis_rules"] for a in r if a} == {"tp"}
        assert checkpoint.load_meta(tmp_path, 3) == {"k": "v"}
        like = tree_unflatten(port, [torch.zeros_like(x) for x in leaves])
        got = checkpoint.restore(tmp_path, 3, like)
        for a, b in zip(tree_flatten(got), leaves):
            assert torch.equal(a, b)

    def test_replicated_leaves_stored_once(self, tmp_path, states):
        port, _ = states
        path = checkpoint.save_sharded(tmp_path, 1, port,
                                       train_state_specs(CFG), MESH)
        with np.load(path / "shard_00001_of_00002.npz") as s1:
            n_sharded = len(s1.files)
        with np.load(path / "shard_00000_of_00002.npz") as s0:
            n_all = len(s0.files)
        assert 0 < n_sharded < n_all == len(tree_flatten(port))

    def test_partial_shard_set_refused(self, tmp_path, states):
        port, _ = states
        path = checkpoint.save_sharded(tmp_path, 2, port,
                                       train_state_specs(CFG), MESH)
        (path / "shard_00001_of_00002.npz").unlink()
        with pytest.raises(CheckpointError, match="partial shard set"):
            checkpoint.restore(tmp_path, 2, port)

    def test_tampered_manifest_refused(self, tmp_path, states):
        port, _ = states
        path = checkpoint.save_sharded(tmp_path, 2, port,
                                       train_state_specs(CFG), MESH)
        man = _manifest(path)
        man["num_shards"] = 4
        (path / "manifest.json").write_text(json.dumps(man))
        with pytest.raises(CheckpointError, match="fingerprint"):
            checkpoint.restore(tmp_path, 2, port)

    def test_missing_manifest_refused(self, tmp_path, states):
        port, _ = states
        path = checkpoint.save_sharded(tmp_path, 2, port,
                                       train_state_specs(CFG), MESH)
        (path / "manifest.json").unlink()
        assert checkpoint.latest_step(tmp_path) is None
        with pytest.raises(CheckpointError, match="manifest"):
            checkpoint.restore(tmp_path, 2, port)

    def test_architecture_mismatch_refused(self, tmp_path, states):
        port, _ = states
        checkpoint.save_sharded(tmp_path, 2, port, train_state_specs(CFG),
                                MESH)
        with pytest.raises(CheckpointError, match="leaves"):
            checkpoint.restore(tmp_path, 2, {"just": torch.ones(3)})

    def test_stranded_tmp_dir_invisible_and_cleaned(self, tmp_path, states):
        port, _ = states
        tmp = tmp_path / "step_00000005.tmp"
        tmp.mkdir()
        (tmp / "shard_00000_of_00002.npz").write_bytes(b"garbage")
        assert checkpoint.latest_step(tmp_path) is None
        path = checkpoint.save_sharded(tmp_path, 5, port,
                                       train_state_specs(CFG), MESH)
        assert not tmp.exists() and path.is_dir()
        assert checkpoint.latest_step(tmp_path) == 5


def _train(ckpt_dir, steps, mesh=None):
    argv = ["--device", "cpu", "--arch", "tiny", "--steps", str(steps),
            "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "2",
            "--log-every", "10", "--metrics-dir", "none",
            "--ckpt-dir", str(ckpt_dir)]
    return train_main(argv + (["--mesh", mesh] if mesh else []),
                      timeout=JOIN_TIMEOUT)


@pytest.fixture(scope="module")
def lineages(tmp_path_factory):
    """Trainer runs on spawned ranks: ``a`` 0 -> 4 and ``b`` 0 -> 2 -> 4
    at dp=2,tp=2; ``c`` (b's step 2) resumed to 4 at dp=1,tp=2."""
    root = tmp_path_factory.mktemp("lineages")
    a, b, c, d = (root / x for x in "abcd")
    out = {"a": _train(a, 4, "dp=2,tp=2"), "b2": _train(b, 2, "dp=2,tp=2")}
    shutil.copytree(b, c)
    shutil.copytree(b, d)
    out["b4"] = _train(b, 4, "dp=2,tp=2")
    out["c4"] = _train(c, 4, "dp=1,tp=2")
    out["dirs"] = dict(a=a, b=b, c=c, d=d)
    return out


class TestTrainLoopIntegration:
    def test_kill_and_resume_bit_identical(self, lineages):
        assert len(lineages["a"]) == 4
        assert len(lineages["b2"]) == 2 and len(lineages["b4"]) == 2
        da, db = (lineages["dirs"][x] / "step_00000004" for x in "ab")
        assert _manifest(da) == _manifest(db)
        for name in ("shard_00000_of_00002.npz",
                     "shard_00001_of_00002.npz"):
            with np.load(da / name) as fa, np.load(db / name) as fb:
                assert fa.files == fb.files
                for key in fa.files:
                    assert fa[key].tobytes() == fb[key].tobytes()
        assert lineages["a"][2:] == lineages["b4"]

    def test_ranks_write_what_the_reference_restores(self, lineages):
        # The ranks' files (each tp rank of the first dp row wrote its
        # own shard) restore in the reference to the state the port
        # restores, bit for bit.
        d = lineages["dirs"]["a"]
        model = ModelRef(reference_config(get_config("tiny")))
        params = model.init_params(jax.random.PRNGKey(0))
        ref = checkpoint_ref.restore(d, 4, (params,
                                            AdamWRef().init(params)))
        port_params = Model(get_config("tiny"), device="cpu").params
        port = checkpoint.restore(d, 4, (port_params,
                                         AdamW().init(port_params)))
        for a, b in zip(jax.tree_util.tree_leaves(ref), tree_flatten(port)):
            assert same_bits(a, b)

    def test_restore_onto_different_mesh(self, lineages):
        man = _manifest(lineages["dirs"]["c"] / "step_00000004")
        assert man["mesh"] == {"dp": 1, "tp": 2}
        assert len(lineages["c4"]) == 2
        np.testing.assert_allclose(lineages["c4"], lineages["b4"],
                                   rtol=1e-5)

    def test_restore_onto_single_device(self, lineages):
        d = lineages["dirs"]["d"]
        losses = _train(d, 4)
        assert len(losses) == 2  # resumed at 2, ran 2 more
        np.testing.assert_allclose(losses, lineages["b4"], rtol=1e-5)
        # The single-device continuation writes the plain npz layout.
        assert (d / "step_00000004.npz").is_file()
        assert checkpoint.latest_step(d) == 4
