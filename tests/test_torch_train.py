"""Port parity: the training path (data, AdamW, checkpoints, loss and
its gradients, the train step, ``launch.train.main``) against the
reference's.

Where the reference is bitwise (the synthetic batches, a float64 AdamW
update, checkpoint round trips, kill-and-resume) the port is held to
the bit; the model's loss, gradients and train step agree to the
float32 islands' rounding (ROADMAP section 3), each within the
tolerance stated beside it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_ref
from repro.core import PrecisionPolicy as PolicyRef
from repro.core import offload as offload_ref
from repro.launch.train import build_train_step as build_train_step_ref
from repro.launch.train import main as train_main_ref
from repro.models import Model as ModelRef
from repro.train import AdamW as AdamWRef
from repro.train import SyntheticText as SyntheticTextRef
from repro.train import checkpoint as checkpoint_ref
from repro_torch.configs import get_config
from repro_torch.core import PrecisionPolicy, offload
from repro_torch.launch.train import build_train_step
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, params_from_reference
from repro_torch.train import AdamW, CheckpointError, SyntheticText, checkpoint
from repro_torch.train.checkpoint import tree_flatten
from repro_torch.tune import PrecisionPlan
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

# The tiny LM of the parity tests: 2 layers, d 64, d_ff 192, vocab 160.
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=192, vocab_size=160)

# Overrides for driving the trainers' CLI at test scale (the
# reference's own tests/test_train.py sizes).
_CLI_OVERRIDES = json.dumps({
    "num_layers": 1, "d_model": 64, "num_heads": 2, "num_kv_heads": 1,
    "head_dim": 32, "d_ff": 128, "vocab_size": 128})


def _cli(steps, ckpt_dir, ckpt_every=3):
    return ["--arch", "tiny", "--overrides", _CLI_OVERRIDES,
            "--steps", str(steps), "--seq-len", "16",
            "--global-batch", "2", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", str(ckpt_every), "--log-every", "100"]


def _tiny_models(dtype="float32"):
    """The reference model and params (head drawn from a seeded normal,
    so the gradients are not all zero) and the port model."""
    over = dict(TINY, dtype=dtype, param_dtype=dtype)
    ref = ModelRef(get_config_ref("tiny").replace(**over))
    params = ref.init_params(jax.random.PRNGKey(0))
    head = np.random.default_rng(1).standard_normal(
        params["lm_head"].shape) * 0.1
    params["lm_head"] = jnp.asarray(head, params["lm_head"].dtype)
    port = Model(get_config("tiny").replace(**over), device="cpu")
    return ref, params, port


def _port_params(params_ref):
    return params_from_reference(
        jax.tree_util.tree_map(np.asarray, params_ref), "cpu")


def _batch(seq=24, batch=4):
    return SyntheticTextRef(TINY["vocab_size"], seq, batch).batch(0)


def _max_rel(ref, port):
    r = np.asarray(ref)
    return float(np.abs(r - port.detach().numpy()).max()
                 / max(np.abs(r).max(), 1e-300))


class TestSyntheticText:
    @pytest.mark.parametrize("vocab,seq,batch,seed,step", [
        (128, 16, 4, 0, 0), (128, 16, 4, 7, 3), (49152, 128, 4, 0, 5),
        (160, 24, 4, 3, 1000), (9, 5, 1, 11, 2)])
    def test_batches_byte_identical(self, vocab, seq, batch, seed, step):
        got = SyntheticText(vocab, seq, batch, seed=seed).batch(step)
        want = SyntheticTextRef(vocab, seq, batch, seed=seed).batch(step)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()

    @pytest.mark.parametrize("vocab", [8, 3])
    def test_same_errors(self, vocab):
        with pytest.raises(ValueError) as ref:
            SyntheticTextRef(vocab, 16, 2)
        with pytest.raises(ValueError) as port:
            SyntheticText(vocab, 16, 2)
        assert str(port.value) == str(ref.value)

    def test_deterministic_per_step(self):
        d = SyntheticText(128, 16, 4, seed=7)
        np.testing.assert_array_equal(d.batch(3), d.batch(3))
        assert not np.array_equal(d.batch(3), d.batch(4))
        assert not np.array_equal(d.batch(3),
                                  SyntheticText(128, 16, 4, seed=8).batch(3))

    def test_anchor_skews_marginal(self):
        b = SyntheticText(128, 64, 8, seed=0).batch(0)
        assert b.shape == (8, 65) and b.dtype == np.int32
        assert b.min() >= 0 and b.max() < 128
        assert (b == 0).mean() > 0.1


def _adam_trees(rng, dtype):
    """Nested params and a gradient maker, entries spread over decades
    so that every term of the update decides some bits."""
    def arr(shape, lo, hi):
        return (rng.standard_normal(shape)
                * 10.0 ** rng.integers(lo, hi, shape)).astype(dtype)

    params = {"blocks": {"w": arr((3, 17, 9), -2, 3)}, "b": arr((7,), -2, 3),
              "e": arr((11, 5), -1, 1)}

    def grads():
        return {"blocks": {"w": arr((3, 17, 9), -3, 3)},
                "b": arr((7,), -3, 3), "e": arr((11, 5), -3, 3)}
    return params, grads


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v))) for k, v in tree.items()}


class TestAdamW:
    @pytest.mark.parametrize("weight_decay", [0.01, 0.0, 0.1])
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_update_bitwise_against_reference(self, dtype, weight_decay):
        # Tolerance 0 at float64 and at float32: the port follows the
        # reference's compiled arithmetic term by term (fmas, the
        # rewritten division, glibc pow/powf, a correctly rounded sqrt).
        rng = np.random.default_rng(4)
        params, grads = _adam_trees(rng, dtype)
        ref, port = (AdamWRef(lr=3e-3, weight_decay=weight_decay),
                     AdamW(lr=3e-3, weight_decay=weight_decay))
        p_ref = jax.tree_util.tree_map(jnp.asarray, params)
        s_ref = ref.init(p_ref)
        p_port = _torch_tree(params)
        s_port = port.init(p_port)
        update_ref = jax.jit(ref.update)
        for _ in range(12):
            g = grads()
            p_ref, s_ref = update_ref(jax.tree_util.tree_map(jnp.asarray, g),
                                      p_ref, s_ref)
            p_port, s_port = port.update(_torch_tree(g), p_port, s_port)
        for a, b in zip(jax.tree_util.tree_leaves((p_ref, s_ref)),
                        tree_flatten((p_port, s_port))):
            assert same_bits(a, b)

    @pytest.mark.parametrize("dtype,acc", [(torch.float32, torch.float32),
                                           (torch.float64, torch.float64),
                                           (torch.bfloat16, torch.float32)])
    def test_init_state_and_accumulation_dtype(self, dtype, acc):
        state = AdamW().init({"w": torch.ones((4, 4), dtype=dtype),
                              "n": {"b": torch.zeros((3,), dtype=dtype)}})
        assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
        assert int(state["step"]) == 0
        for key in ("mu", "nu"):
            assert state[key]["w"].dtype == acc
            assert state[key]["n"]["b"].dtype == acc
            assert not state[key]["w"].any()

    def test_update_moves_params_counts_and_keeps_arguments(self):
        opt = AdamW(lr=1e-2)
        params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
        state = opt.init(params)
        grads = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
        p2, s2 = opt.update(grads, params, state)
        p3, s3 = opt.update(grads, p2, s2)
        assert int(s2["step"]) == 1 and int(s3["step"]) == 2
        assert not torch.allclose(p2["w"], params["w"])
        assert p2["w"].dtype == params["w"].dtype
        assert torch.equal(params["w"], torch.ones((4, 4)))
        assert int(state["step"]) == 0 and not state["mu"]["w"].any()

    def test_weight_decay_alone_shrinks_params(self):
        # Zero gradients: the update is the decoupled decay alone,
        # p * (1 - lr * wd) up to rounding.
        opt = AdamW(lr=0.1, weight_decay=0.5)
        params = {"w": torch.full((3,), 2.0, dtype=torch.float64)}
        p2, _ = opt.update({"w": torch.zeros(3, dtype=torch.float64)},
                           params, opt.init(params))
        torch.testing.assert_close(p2["w"], torch.full(
            (3,), 1.9, dtype=torch.float64), rtol=0, atol=1e-15)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)), "b": {"c": torch.arange(4, dtype=torch.int32)}}


def _assert_trees_bit_identical(a, b):
    la, lb = tree_flatten(a), tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


class TestCheckpoint:
    def test_roundtrip_bit_identical(self, tmp_path):
        tree = _tree(0)
        checkpoint.save(tmp_path, 10, tree)
        _assert_trees_bit_identical(tree,
                                    checkpoint.restore(tmp_path, 10, tree))

    def test_latest_step(self, tmp_path):
        assert checkpoint.latest_step(tmp_path / "absent") is None
        tree = {"x": torch.zeros((2,))}
        checkpoint.save(tmp_path, 3, tree)
        checkpoint.save(tmp_path, 12, tree)
        assert checkpoint.latest_step(tmp_path) == 12

    def test_latest_step_ignores_stranded_tmp(self, tmp_path):
        tree = {"x": torch.zeros((2,))}
        checkpoint.save(tmp_path, 4, tree)
        (tmp_path / "step_00000009.npz.tmp").write_bytes(b"partial")
        assert checkpoint.latest_step(tmp_path) == 4
        only_tmp = tmp_path / "only_tmp"
        only_tmp.mkdir()
        (only_tmp / "step_00000002.npz.tmp").write_bytes(b"partial")
        assert checkpoint.latest_step(only_tmp) is None

    def test_save_overwrites_stranded_tmp(self, tmp_path):
        tree = {"x": torch.arange(3, dtype=torch.float32)}
        (tmp_path / "step_00000004.npz.tmp").write_bytes(b"partial")
        checkpoint.save(tmp_path, 4, tree)
        assert not (tmp_path / "step_00000004.npz.tmp").exists()
        _assert_trees_bit_identical(tree,
                                    checkpoint.restore(tmp_path, 4, tree))

    def test_missing_step_raises(self, tmp_path):
        with pytest.raises(CheckpointError, match="no checkpoint"):
            checkpoint.restore(tmp_path, 1, {"x": torch.zeros((2,))})

    def test_structure_mismatch_raises(self, tmp_path):
        checkpoint.save(tmp_path, 1, {"x": torch.zeros((2,))})
        with pytest.raises(CheckpointError, match="expected"):
            checkpoint.restore(tmp_path, 1, {"x": torch.zeros((3,))})
        with pytest.raises(CheckpointError, match="expected"):
            checkpoint.restore(tmp_path, 1,
                               {"x": torch.zeros((2,), dtype=torch.float64)})
        with pytest.raises(CheckpointError, match="leaves"):
            checkpoint.restore(tmp_path, 1, {"x": torch.zeros((2,)),
                                             "y": torch.zeros((2,))})

    def test_meta_roundtrip_and_restore_ignores_it(self, tmp_path):
        tree = {"x": torch.arange(3, dtype=torch.float32)}
        meta = {"plan_fingerprint": "sha256:abc", "backend": None}
        checkpoint.save(tmp_path, 2, tree, meta=meta)
        assert checkpoint.load_meta(tmp_path, 2) == meta
        _assert_trees_bit_identical(tree,
                                    checkpoint.restore(tmp_path, 2, tree))

    def test_meta_absent_is_empty(self, tmp_path):
        checkpoint.save(tmp_path, 1, {"x": torch.zeros((2,))})
        assert checkpoint.load_meta(tmp_path, 1) == {}
        with pytest.raises(CheckpointError, match="no checkpoint"):
            checkpoint.load_meta(tmp_path, 9)

    def test_flatten_order_is_the_references(self):
        _, params, _ = _tiny_models()
        state = AdamWRef().init(params)
        tree = (params, state)
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]]
        port = (_port_params(params), AdamW().init(_port_params(params)))
        leaves = tree_flatten(port)
        ref_leaves = jax.tree_util.tree_leaves(tree)
        assert len(leaves) == len(ref_leaves) == len(paths)
        for path, a, b in zip(paths, ref_leaves, leaves):
            assert tuple(a.shape) == tuple(b.shape), path

    def test_reference_checkpoint_restores_in_the_port(self, tmp_path):
        _, params, _ = _tiny_models("float64")
        ref_state = AdamWRef().init(params)
        ref_state["mu"] = jax.tree_util.tree_map(lambda x: x + 0.5,
                                                 ref_state["mu"])
        meta = {"plan_fingerprint": None, "backend": "fp64_int8_4",
                "plan_path": None}
        checkpoint_ref.save(tmp_path, 7, (params, ref_state), meta=meta)
        like = (_port_params(params), AdamW().init(_port_params(params)))
        got = checkpoint.restore(tmp_path, 7, like)
        for a, b in zip(jax.tree_util.tree_leaves((params, ref_state)),
                        tree_flatten(got)):
            assert same_bits(a, b)
        assert checkpoint.load_meta(tmp_path, 7) == meta
        assert checkpoint.latest_step(tmp_path) == 7

    def test_port_checkpoint_restores_in_the_reference(self, tmp_path):
        _, params, _ = _tiny_models()
        port = _port_params(params)
        state = AdamW().init(port)
        state["nu"]["embed"] += 0.25
        meta = {"plan_fingerprint": None, "backend": None,
                "plan_path": None}
        checkpoint.save(tmp_path, 3, (port, state), meta=meta)
        like = (params, AdamWRef().init(params))
        got = checkpoint_ref.restore(tmp_path, 3, like)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        tree_flatten((port, state))):
            assert same_bits(a, b)
        assert checkpoint_ref.load_meta(tmp_path, 3) == meta
        assert checkpoint_ref.latest_step(tmp_path) == 3

    def test_sharded_layout_is_not_ported(self, tmp_path):
        # The sharded layout is ported now (tests/test_torch_checkpoint_
        # sharded.py): a step directory with a manifest counts as a step,
        # and one whose manifest is not the layout's is refused.
        step_dir = tmp_path / "step_00000005"
        step_dir.mkdir()
        (step_dir / "manifest.json").write_text("{}")
        assert checkpoint.latest_step(tmp_path) == 5
        with pytest.raises(CheckpointError, match="manifest"):
            checkpoint.restore(tmp_path, 5, {"x": torch.zeros(2)})
        with pytest.raises(CheckpointError, match="manifest"):
            checkpoint.load_meta(tmp_path, 5)


def _with_grad(params):
    return {k: (_with_grad(v) if isinstance(v, dict)
                else v.clone().requires_grad_()) for k, v in params.items()}


class TestLoss:
    # Tolerances (relative to the largest magnitude): the loss agrees to
    # float32 rounding at float32 and, bounded by the float32 softmax
    # and gate (ROADMAP section 3), to 1e-7 at float64; every gradient
    # leaf to 1e-5 (float32) and 2e-6 (float64).
    @pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
        ("float32", 1e-6, 1e-5), ("float64", 1e-7, 2e-6)])
    def test_loss_and_gradients_match_reference(self, dtype, loss_tol,
                                                grad_tol):
        ref, params, port = _tiny_models(dtype)
        batch = _batch()
        loss_ref, grads_ref = jax.value_and_grad(ref.loss)(
            params, jnp.asarray(batch))
        leaves = _with_grad(_port_params(params))
        loss = port.loss(leaves, torch.from_numpy(batch))
        assert loss.dtype == getattr(torch, dtype) and loss.ndim == 0
        grads = torch.autograd.grad(loss, tree_flatten(leaves))
        assert _max_rel(loss_ref, loss) < loss_tol
        for a, b in zip(jax.tree_util.tree_leaves(grads_ref), grads):
            assert _max_rel(a, b) < grad_tol

    def test_initial_loss_is_log_vocab(self):
        # Zero-initialized head: uniform logits, loss log(vocab).
        port = Model(get_config("tiny").replace(**TINY), device="cpu")
        loss = port.loss(port.params, torch.from_numpy(_batch()))
        assert float(loss) == pytest.approx(np.log(TINY["vocab_size"]),
                                            rel=1e-6)

    def test_stacked_leaves_get_one_gradient_each(self):
        # The scan unbinds each stacked block leaf once: its gradient
        # is one (L, ...) tensor equal to the per-layer slices'.
        _, params, port = _tiny_models("float64")
        leaves = _with_grad(_port_params(params))
        loss = port.loss(leaves, torch.from_numpy(_batch()))
        (g,) = torch.autograd.grad(loss, [leaves["blocks"]["wq"]])
        assert g.shape == leaves["blocks"]["wq"].shape
        assert bool(g[0].any()) and bool(g[1].any())


class TestTrainStep:
    @pytest.mark.parametrize("backend", ["pallas_int8_4", "fp64_int8_4"])
    def test_emulated_step_matches_reference(self, backend):
        # The reference's Pallas kernel in interpret mode against the
        # port's plain K1 (pallas_int8_4), and the two f64-accumulator
        # engines (fp64_int8_4), both at float32: the loss within 1e-6
        # relative, every updated parameter within 2e-5 absolute (an
        # Adam step is lr * sign-like, so a cotangent near zero moves a
        # parameter by a fraction of lr = 3e-3 on rounding alone).
        ref, params, port = _tiny_models()
        batch = _batch()
        pol_ref = PolicyRef(backend=backend, min_dim=16)
        p_ref, s_ref, loss_ref = offload_ref(
            build_train_step_ref(ref, AdamWRef(lr=3e-3)), pol_ref)(
            params, AdamWRef().init(params), jnp.asarray(batch))
        p0 = _port_params(params)
        step = offload(build_train_step(port, AdamW(lr=3e-3)),
                       PrecisionPolicy(backend=backend, min_dim=16))
        p_port, s_port, loss = step(p0, AdamW().init(p0),
                                    torch.from_numpy(batch))
        assert _max_rel(loss_ref, loss) < 1e-6
        for a, b in zip(jax.tree_util.tree_leaves(p_ref),
                        tree_flatten(p_port)):
            assert float(np.abs(np.asarray(a) - b.numpy()).max()) < 2e-5
        assert int(s_port["step"]) == int(s_ref["step"]) == 1

    def _setup(self):
        ref, params, port = _tiny_models()
        p0 = _port_params(params)
        return port, p0, AdamW().init(p0), torch.from_numpy(_batch(32))

    def test_sites_cover_forward_and_backward_scans(self):
        port, params, state, batch = self._setup()
        pol = PrecisionPolicy(backend="fp64_int8_4", min_dim=32)
        sites = offload(build_train_step(port, AdamW(lr=3e-3)),
                        pol).sites(params, state, batch)
        on = [s for s in sites if s.offloaded]
        assert len(on) >= 10
        prefixes = {s.name.split("/")[0] for s in on if "/" in s.name}
        assert prefixes == {"scan0", "scan1"}, prefixes

    def test_emulated_step_matches_native(self):
        # The reference's bound (tests/test_train.py): loss within 1e-4,
        # params within 5e-4, i.e. the backward GEMMs were emulated
        # correctly, not skipped.
        port, params, state, batch = self._setup()
        step = build_train_step(port, AdamW(lr=3e-3))
        p_n, _, loss_n = step(params, state, batch)
        p_e, _, loss_e = offload(step, PrecisionPolicy(
            backend="fp64_int8_4", min_dim=32))(params, state, batch)
        assert float(loss_e) == pytest.approx(float(loss_n), abs=1e-4)
        for a, b in zip(tree_flatten(p_e), tree_flatten(p_n)):
            torch.testing.assert_close(a, b, rtol=0, atol=5e-4)

    def test_training_reduces_loss(self):
        port = Model(get_config("tiny").replace(**TINY), device="cpu")
        opt = AdamW(lr=3e-3)
        params = {k: (v if not isinstance(v, dict) else dict(v))
                  for k, v in port.params.items()}
        state = opt.init(params)
        data = SyntheticText(TINY["vocab_size"], 32, 4, seed=0)
        step = build_train_step(port, opt)
        losses = []
        for i in range(8):
            params, state, loss = step(params, state,
                                       torch.from_numpy(data.batch(i)))
            losses.append(float(loss))
        assert losses[-1] < losses[0]
        assert losses[0] == pytest.approx(np.log(TINY["vocab_size"]),
                                          rel=1e-5)


class TestMain:
    def test_kill_and_resume_bit_identical(self, tmp_path):
        """3 steps + resume to 6 == uninterrupted 6, to the byte."""
        dir_a, dir_b = tmp_path / "a", tmp_path / "b"
        train_main(_cli(6, dir_a), device="cpu")
        losses_first = train_main(_cli(3, dir_b), device="cpu")
        losses_resumed = train_main(_cli(6, dir_b), device="cpu")
        assert len(losses_first) == 3 and len(losses_resumed) == 3
        assert checkpoint.latest_step(dir_a) == 6
        assert checkpoint.latest_step(dir_b) == 6
        assert ((dir_a / "step_00000006.npz").read_bytes()
                == (dir_b / "step_00000006.npz").read_bytes())

    def test_resume_past_target_is_noop(self, tmp_path):
        d = tmp_path / "c"
        train_main(_cli(2, d, ckpt_every=10), device="cpu")
        assert train_main(_cli(2, d, ckpt_every=10), device="cpu") == []

    # These flags were refused before the mesh was ported; each is taken
    # now: a mesh trains (or tunes) on its ranks, the reduce flags are
    # the mesh's and leave a one-process run as it was.
    @pytest.mark.parametrize("flags,ranks", [
        (["--mesh", "dp=2"], 2), (["--grad-reduce", "ppermute"], 1),
        (["--bucket-mb", "2"], 1),
        (["--tune", "1", "--plan", "{tmp}/p.json", "--mesh", "dp=2"], 2)])
    def test_unported_flags_raise(self, tmp_path, flags, ranks):
        flags = [f.format(tmp=tmp_path) for f in flags]
        report = {}
        losses = train_main(_cli(1, tmp_path) + flags, device="cpu",
                            report=report, timeout=120)
        assert len(report.get("ranks", [report])) == ranks
        if "--tune" in flags:
            assert losses == [] and (tmp_path / "p.json").is_file()
            assert checkpoint.latest_step(tmp_path) is None
        else:
            assert len(losses) == 1
            assert checkpoint.latest_step(tmp_path) == 1

    @pytest.mark.parametrize("flags", [
        ["--metrics-dir", "{tmp}/m"], ["--metrics-port", "0"],
        ["--metrics-push-url", "http://127.0.0.1:1/push"]])
    def test_telemetry_flags_are_taken(self, tmp_path, flags):
        # Telemetry is ported: the flags train and record a run (a push
        # to an address nobody answers is logged, as the reference does,
        # and training goes on).
        flags = [f.format(tmp=tmp_path) for f in flags]
        report = {}
        assert len(train_main(_cli(1, tmp_path / "c") + flags,
                              device="cpu", report=report)) == 1
        assert checkpoint.latest_step(tmp_path / "c") == 1
        metrics = (tmp_path / "m" if "--metrics-dir" in flags
                   else tmp_path / "c" / "metrics")
        assert report["metrics_dir"] == str(metrics)
        assert (metrics / "events-0000.jsonl").is_file()

    def test_backend_offloads_forward_and_backward(self, tmp_path):
        report = {}
        losses = train_main(_cli(2, tmp_path) + [
            "--backend", "pallas_int8_4", "--min-dim", "32"], device="cpu",
            report=report)
        assert len(losses) == 2 and len(report["step_ms"]) == 2
        on = [s.name for s in report["sites"] if s.offloaded]
        assert any(n.startswith("scan0/") for n in on)
        assert any(n.startswith("scan1/") for n in on)
        assert all(s.splits == 4 for s in report["sites"] if s.offloaded)
        assert report["int8_gemms_per_step"] == 10 * sum(
            s.batch * s.mult for s in report["sites"] if s.offloaded)
        assert checkpoint.load_meta(tmp_path, 2) == {
            "plan_fingerprint": None, "backend": "pallas_int8_4",
            "plan_path": None}

    def test_resume_enforces_plan_fingerprint(self, tmp_path):
        """The reference's test: a checkpoint lineage pins its precision
        plan; resuming under another configuration stops, unless
        ``--allow-plan-change``."""
        d = tmp_path / "planned"
        plan_path = tmp_path / "plan.json"
        tune_args = _cli(2, d) + ["--tune", "1", "--plan", str(plan_path),
                                  "--min-dim", "32"]
        assert train_main(tune_args, device="cpu") == []  # calibrate only
        assert plan_path.exists() and (tmp_path / "plan.tiles.json").exists()
        assert checkpoint.latest_step(d) is None   # tune never trains

        plan_cli = _cli(2, d) + ["--plan", str(plan_path)]
        report = {}
        losses = train_main(plan_cli, device="cpu", report=report)
        assert len(losses) == 2
        meta = checkpoint.load_meta(d, 2)
        plan = PrecisionPlan.load(plan_path)
        assert meta == {"plan_fingerprint": plan.fingerprint,
                        "backend": None, "plan_path": str(plan_path)}
        # The step ran under the plan's per-site split counts.
        solved = plan.site_splits()
        assert {s.name: s.splits for s in report["sites"]
                if s.offloaded} == solved

        with pytest.raises(SystemExit, match="precision plan"):
            train_main(_cli(4, d), device="cpu")
        bare = tmp_path / "bare"
        train_main(_cli(2, bare), device="cpu")
        with pytest.raises(SystemExit, match="precision plan"):
            train_main(_cli(4, bare) + ["--plan", str(plan_path)],
                       device="cpu")
        assert len(train_main(_cli(4, d) + ["--plan", str(plan_path)],
                              device="cpu")) == 2
        assert len(train_main(_cli(4, bare) +
                              ["--plan", str(plan_path),
                               "--allow-plan-change"], device="cpu")) == 2
        assert checkpoint.load_meta(bare, 4)["plan_fingerprint"] == \
            plan.fingerprint

    def test_tune_requires_plan_and_excludes_backend(self, tmp_path):
        with pytest.raises(SystemExit, match="--plan"):
            train_main(_cli(2, tmp_path) + ["--tune", "1"], device="cpu")
        with pytest.raises(SystemExit, match="one"):
            train_main(_cli(2, tmp_path) +
                       ["--plan", "p.json", "--backend", "fp64_int8_4"],
                       device="cpu")

    def test_tune_with_a_pinned_backend_probes_there(self, tmp_path):
        plan_path = tmp_path / "p.json"
        train_main(_cli(2, tmp_path) + [
            "--tune", "1", "--plan", str(plan_path), "--backend",
            "pallas_int8_4", "--min-dim", "32"], device="cpu")
        plan = PrecisionPlan.load(plan_path)
        assert plan.backend == "pallas_int8" and plan.probe_splits == 4
        assert (tmp_path / "p.tiles.json").exists()
        assert all(s.tiles is not None for s in plan.sites)

    def test_reference_plan_trains_in_the_port(self, tmp_path):
        # A plan written by ``python -m repro.tune`` (its own flags:
        # the tiny preset, 4 x 128 tokens) loads in the port, validates
        # against the port's train-step sites and trains.
        from repro.tune.cli import main as tune_main_ref

        plan_path = tmp_path / "ref_plan.json"
        tune_main_ref(["--arch", "tiny", "--plan", str(plan_path)])
        plan = PrecisionPlan.load(plan_path)
        port = Model(get_config("tiny"), device="cpu", seed=0)
        opt = AdamW(lr=3e-3)
        batch = torch.from_numpy(SyntheticText(512, 128, 4).batch(0))
        sites = offload(build_train_step(port, opt),
                        PrecisionPolicy.from_plan(plan)).sites(
            port.params, opt.init(port.params), batch)
        plan.validate_sites(sites)
        report = {}
        losses = train_main(["--arch", "tiny", "--steps", "1",
                             "--ckpt-dir", str(tmp_path / "ckpt"),
                             "--plan", str(plan_path)], device="cpu",
                            report=report)
        assert len(losses) == 1 and np.isfinite(losses[0])
        assert report["int8_gemms_per_step"] > 0

    def test_same_seed_trains_as_the_reference(self, tmp_path):
        # F1: from one --seed both trainers start from the same weights,
        # with no parameter hand-over: the losses agree to float32
        # rounding (relative 1e-5, test_resumes_a_reference_lineage's
        # bound), the step-1 gradients leaf by leaf to TestLoss's float32
        # bound (1e-5 of each leaf's largest entry).
        for seed in (0, 5):
            want = train_main_ref(_cli(3, tmp_path / f"ref{seed}") +
                                  ["--metrics-dir", "none", "--seed",
                                   str(seed)])
            got = train_main(_cli(3, tmp_path / f"port{seed}") +
                             ["--seed", str(seed)], device="cpu")
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        over = json.loads(_CLI_OVERRIDES)
        ref = ModelRef(get_config_ref("tiny").replace(**over))
        params_ref = ref.init_params(jax.random.PRNGKey(5))
        batch = SyntheticTextRef(over["vocab_size"], 16, 2, seed=5).batch(0)
        _, grads_ref = jax.value_and_grad(ref.loss)(params_ref,
                                                    jnp.asarray(batch))
        port = Model(get_config("tiny").replace(**over), device="cpu",
                     seed=5)
        leaves = _with_grad(port.params)
        loss = port.loss(leaves, torch.from_numpy(batch))
        grads = torch.autograd.grad(loss, tree_flatten(leaves))
        for a, b in zip(jax.tree_util.tree_leaves(grads_ref), grads):
            if not np.asarray(a).any():   # blocks under the zero head
                assert not b.any()
            else:
                assert _max_rel(a, b) < 1e-5

    def test_resumes_a_reference_lineage(self, tmp_path):
        # The reference trains 2 steps, the port resumes to 4; its
        # steps 3-4 match the reference's uninterrupted run to float32
        # rounding (relative 1e-5): the checkpoint carries the weights
        # and the optimizer state across.
        whole = train_main_ref(_cli(4, tmp_path / "ref") +
                               ["--metrics-dir", "none"])
        train_main_ref(_cli(2, tmp_path / "mixed") +
                       ["--metrics-dir", "none"])
        resumed = train_main(_cli(4, tmp_path / "mixed"), device="cpu")
        assert len(resumed) == 2
        np.testing.assert_allclose(resumed, whole[2:], rtol=1e-5, atol=0)
        with np.load(tmp_path / "ref" / "step_00000004.npz") as a, \
                np.load(tmp_path / "mixed" / "step_00000004.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            last = max(k for k in b.files if k.startswith("leaf_"))
            assert int(b[last]) == 4   # opt_state["step"], the last leaf
