"""The port's big-mesh tier (counterpart of ``tests/test_mesh_large.py``).

The two extreme 2-D meshes of 32 positions: dp=16×tp=2, the dp-heavy
corner (16-way gradient bucketing, one batch row a rank), and dp=4×tp=8,
the tp-heavy corner (8-way splits of every projection, one kv head a
rank).  Both must equal the port's single-device step within 1e-10 in
the loss and 1e-9 in the parameters over 4 steps, natively at float64
and under ``fp64_int8_9`` with the f64 accumulator.

All four runs share one spawn of 32 gloo ranks on the CPU (rank
functions in ``tests/torch_shard_workers.py``), each run building its
mesh anew over the same ranks; the spawn has a join timeout of its
own.  Unlike the reference's tier, which needs 32 virtual devices
(``XLA_FLAGS``) and skips on the default 8, nothing here needs a flag.

The reference's native sharded run takes 32 virtual devices, which
this process cannot have (``tests/conftest.py`` gives jax 8 before any
test runs): it runs in a child process whose environment sets
``XLA_FLAGS`` before jax is imported, and returns its losses and
global parameters through an ``.npz`` file.  The native runs are held
to it by ``tests/test_torch_shard.py``'s rule (the float32 softmax and
gate keep one device of each package apart, ROADMAP section 3).  The
reference's emulated sharded run fails on this jax (its offload of a
``shard_map`` body, ROADMAP section 3), so the emulated runs are held
to the documented contract: ``shmap0/`` plus the single device's
names, ``spmd`` in every offloaded site, the single device's losses
and parameters.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LMConfig as LMConfigRef
from repro.core import PrecisionPolicy as PrecisionPolicyRef
from repro.core import offload as offload_ref
from repro.launch.train import build_train_step as single_ref
from repro.models import Model as ModelRef
from repro.train import AdamW as AdamWRef
from repro.train import SyntheticText as SyntheticTextRef
from repro_torch.configs import LMConfig
from repro_torch.core import PrecisionPolicy, offload
from repro_torch.launch.train import build_train_step
from repro_torch.models import Model
from repro_torch.shard.launch import spawn
from repro_torch.train import AdamW, SyntheticText
from repro_torch.train.checkpoint import tree_flatten

import torch_shard_workers as workers

# tp=8 must divide num_heads, num_kv_heads and d_ff: the reference
# tier's model, 8 full-attention heads.
_CFG = dict(name="mesh_large_f64", vocab_size=128, num_layers=2,
            d_model=64, num_heads=8, num_kv_heads=8, head_dim=8, d_ff=256,
            dtype="float64", param_dtype="float64")
CFG, CFG_REF = LMConfig(**_CFG), LMConfigRef(**_CFG)
STEPS, BATCH, SEQ = 4, 16, 32
LR = 3e-3
WORLD = 32
SPECS = ("dp=16,tp=2", "dp=4,tp=8")
BACKENDS = ("", "fp64_int8_9")
_EMULATED = dict(backend="fp64_int8_9", default_splits=9, min_dim=32,
                 accumulator="f64")
# The join timeout of the one 32-rank spawn: it took about 45 s alone
# and 74 s beside the port's other test files under -n 6.
JOIN_TIMEOUT = 300
REFERENCE_TIMEOUT = 300
# How far the two packages' single devices may drift apart on this
# config over STEPS steps (the float32 softmax and gate, ROADMAP section
# 3), natively and emulated alike: measured 9.48e-10 in the loss (step 3)
# and 4.57e-6 in a parameter element (Adam's step normalises a gradient
# gap of that rounding up to the update's scale); a wrong gradient moves
# a parameter by about lr = 3e-3.
SINGLE_LOSS_GAP = 1e-8
SINGLE_PARAM_GAP = 2e-5
SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def _policy(backend):
    return dict(_EMULATED) if backend else {}


# -- the single devices ----------------------------------------------------


@pytest.fixture(scope="module")
def single():
    """The port's single device, natively and emulated: losses, final
    parameters and the site report."""
    runs = {}
    data = SyntheticText(CFG.vocab_size, SEQ, BATCH, seed=0)
    for backend in BACKENDS:
        model = Model(CFG, device="cpu", seed=0)
        opt = AdamW(lr=LR)
        step = build_train_step(model, opt)
        params = model.params
        state = opt.init(params)
        sites = []
        if backend:
            step = offload(step, PrecisionPolicy(**_EMULATED))
            sites = step.sites(params, state, torch.as_tensor(data.batch(0)))
        losses = []
        for i in range(STEPS):
            params, state, loss = step(params, state,
                                       torch.as_tensor(data.batch(i)))
            losses.append(float(loss))
        runs[backend] = (losses, [x.numpy() for x in tree_flatten(params)],
                         sites)
    return runs


@pytest.fixture(scope="module")
def reference_single():
    """The reference's single device under ``jax.jit``, natively and
    under ``offload``, as its tier runs it: losses and parameters."""
    model = ModelRef(CFG_REF)
    opt = AdamWRef(lr=LR)
    data = SyntheticTextRef(CFG_REF.vocab_size, SEQ, BATCH, seed=0)
    params = model.init_params(jax.random.PRNGKey(0))
    runs = {}
    for backend in BACKENDS:
        step = single_ref(model, opt)
        if backend:
            step = offload_ref(step, PrecisionPolicyRef(
                backend=backend, min_dim=32, accumulator="f64"))
        step = jax.jit(step)
        p, o = params, opt.init(params)
        losses = []
        for i in range(STEPS):
            p, o, loss = step(p, o, jnp.asarray(data.batch(i)))
            losses.append(float(loss))
        runs[backend] = (losses,
                         [np.asarray(x) for x in jax.tree_util.tree_leaves(p)])
    return runs


# The reference's native sharded runs on 32 virtual devices, in a child
# process: argv is the config (JSON), the specs, STEPS, BATCH, SEQ, LR and
# the output path.
_REFERENCE_MESHES = """
import json
import sys

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from repro.configs import LMConfig
from repro.launch.train import build_sharded_train_step
from repro.models import Model
from repro.shard import train_mesh_setup
from repro.train import AdamW, SyntheticText

cfg = LMConfig(**json.loads(sys.argv[1]))
specs = sys.argv[2].split(";")
steps, batch, seq = map(int, sys.argv[3:6])
lr, path = float(sys.argv[6]), sys.argv[7]
assert jax.device_count() == 32, jax.device_count()
model = Model(cfg)
opt = AdamW(lr=lr)
data = SyntheticText(cfg.vocab_size, seq, batch, seed=0)
params = model.init_params(jax.random.PRNGKey(0))
out = {}
for spec in specs:
    mesh, bsh, (p, o), _ = train_mesh_setup(spec, batch, cfg,
                                            (params, opt.init(params)))
    step = jax.jit(build_sharded_train_step(model, opt, mesh))
    losses = []
    for i in range(steps):
        p, o, loss = step(p, o, jax.device_put(jnp.asarray(data.batch(i)),
                                               bsh))
        losses.append(float(loss))
    out[spec + "/losses"] = np.asarray(losses)
    for j, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        out[f"{spec}/param{j}"] = np.asarray(leaf)
np.savez(path, **out)
"""


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's native run of each spec on 32 virtual devices:
    losses and global parameters, per spec."""
    path = tmp_path_factory.mktemp("mesh_large") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        [f for f in env.get("XLA_FLAGS", "").split()
         if "xla_force_host_platform_device_count" not in f]
        + ["--xla_force_host_platform_device_count=32"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    done = subprocess.run(
        [sys.executable, "-c", _REFERENCE_MESHES, json.dumps(_CFG),
         ";".join(SPECS), str(STEPS), str(BATCH), str(SEQ), str(LR),
         str(path)], env=env, capture_output=True, text=True,
        timeout=REFERENCE_TIMEOUT)
    assert done.returncode == 0, done.stderr[-4000:]
    got = np.load(path)
    n = len([k for k in got.files if k.startswith(SPECS[0] + "/param")])
    return {spec: (got[spec + "/losses"].tolist(),
                   [got[f"{spec}/param{j}"] for j in range(n)])
            for spec in SPECS}


# -- the 32 ranks ----------------------------------------------------------


@pytest.fixture(scope="module")
def ranks():
    """One spawn of 32 gloo ranks running the four tasks in order: each
    spec natively and emulated.  Per (spec, backend), every rank's
    result in rank order."""
    keys = [(spec, backend) for spec in SPECS for backend in BACKENDS]
    tasks = [("train", dict(cfg=CFG, spec=spec, steps=STEPS, batch=BATCH,
                            seq_len=SEQ, lr=LR, **_policy(backend)))
             for spec, backend in keys]
    per_rank = spawn(workers.run_tasks, WORLD, (tasks,), device="cpu",
                     timeout=JOIN_TIMEOUT)
    return {key: [rank[i] for rank in per_rank]
            for i, key in enumerate(keys)}


def _global_params(results):
    return workers.global_params(results, CFG)


def _close(got, want, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _single_gap(single, reference_single, backend):
    """The port's single device against the reference's, held to
    ``SINGLE_LOSS_GAP`` and ``SINGLE_PARAM_GAP``: the per-step loss gaps
    and the per-leaf parameter gaps."""
    losses, params, _ = single[backend]
    ref_losses, ref_params = reference_single[backend]
    gap = np.abs(np.subtract(losses, ref_losses))
    assert np.all(gap <= SINGLE_LOSS_GAP), gap
    _close(params, ref_params, SINGLE_PARAM_GAP)
    return gap, [np.abs(p - r) for p, r in zip(params, ref_params)]


# -- tests -------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS, ids=["native", "fp64_int8_9"])
@pytest.mark.parametrize("spec", SPECS)
def test_big_mesh_matches_single_device(ranks, single, reference_single,
                                        spec, backend):
    losses, params, _ = single[backend]
    ref_losses, _ = reference_single[backend]
    results = ranks[spec, backend]
    assert len(results) == WORLD
    assert sorted((r["coords"]["dp"], r["coords"]["tp"]) for r in results) \
        == sorted((d, t) for d in range(int(spec[3:spec.index(",")]))
                  for t in range(int(spec.rsplit("=", 1)[1])))
    # The reference's bar: the port's single device within 1e-10 ...
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=1e-10)
    got = _global_params(results)
    _close(got, params, 1e-9)
    # ... and through it the reference's single device, whose gap to the
    # port's is bounded.
    _single_gap(single, reference_single, backend)
    for r in results:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=0,
                                   atol=SINGLE_LOSS_GAP + 1e-10)
    _close(got, reference_single[backend][1], SINGLE_PARAM_GAP + 1e-9)


@pytest.mark.parametrize("spec", SPECS)
def test_native_against_reference(ranks, single, reference_single,
                                  reference_sharded, spec):
    # tests/test_torch_shard.py::TestNativeTrain._check's rule, with the
    # single-device gap it allows bounded.
    atol = 1e-10
    ref_losses, ref_params = reference_sharded[spec]
    ref1_losses, ref1_params = reference_single[""]
    results = ranks[spec, ""]
    np.testing.assert_allclose(ref_losses, ref1_losses, rtol=0, atol=atol)
    _close(ref_params, ref1_params, atol)
    loss_gap, param_gaps = _single_gap(single, reference_single, "")
    for r in results:
        assert np.all(np.abs(np.subtract(r["losses"], ref_losses))
                      <= loss_gap + atol)
    got = _global_params(results)
    assert len(got) == len(ref_params)
    for g, want, gap in zip(got, ref_params, param_gaps):
        assert np.all(np.abs(g - want) <= gap + atol)


@pytest.mark.parametrize("spec", SPECS)
def test_emulated_sites(ranks, single, spec):
    _, _, sites = single["fp64_int8_9"]
    for r in ranks[spec, "fp64_int8_9"]:
        assert [s["name"] for s in r["sites"]] == [
            "shmap0/" + s.name for s in sites]
        on = [s for s in r["sites"] if s["offloaded"]]
        assert on
        assert all(s["spmd"] == spec for s in on)
        assert all(f"[{spec}]" in s["repr"] for s in on)


# The forward projections of the single device's step, by site name.
_ATTENTION = {"q": "scan0/dot0", "k": "scan0/dot1", "v": "scan0/dot2",
              "o": "scan0/dot5"}
_MLP = {"gate": "scan0/dot6", "up": "scan0/dot7", "down": "scan0/dot8"}


def test_tp8_gates_per_shard_shape(ranks, single):
    # At tp=8 q, k and v project to 64/8 = 8 columns a shard and o reads
    # 8 rows: under min_dim=32 where the single device offloads them.
    # gate, up and down keep 256/8 = 32 a shard and stay offloaded, as
    # do their cotangents.
    _, _, sites = single["fp64_int8_9"]
    single_on = {s.name: s.offloaded for s in sites}
    for name in list(_ATTENTION.values()) + list(_MLP.values()):
        assert single_on[name]
    for r in ranks["dp=4,tp=8", "fp64_int8_9"]:
        by_name = {s["name"]: s for s in r["sites"]}
        for proj, name in _ATTENTION.items():
            s = by_name["shmap0/" + name]
            assert not s["offloaded"], proj
            assert min(s["m"], s["k"], s["n"]) == 8, proj
            assert "min(m,k,n)=8" in s["reason"], proj
        for proj, name in _MLP.items():
            s = by_name["shmap0/" + name]
            assert s["offloaded"], proj
            assert s["m"] == BATCH // 4 * SEQ
            assert (s["k"], s["n"]) == ((32, 64) if proj == "down"
                                        else (64, 32)), proj
        # Every site at 8 a shard is gated, every other site of the
        # single device's offloaded set stays offloaded.
        for s in r["sites"]:
            narrow = min(s["m"], s["k"], s["n"]) == 8
            assert s["offloaded"] == (not narrow
                                      and single_on[s["name"][7:]]), s


@pytest.mark.parametrize("spec", SPECS)
def test_dp_group_bits_equal(ranks, spec):
    # The ranks of a dp group (one tp coordinate) hold the bucketed mean:
    # the same bits, and the same losses.
    for backend in BACKENDS:
        results = ranks[spec, backend]
        groups = {}
        for r in results:
            groups.setdefault(r["coords"]["tp"], []).append(r)
        dp = int(spec[3:spec.index(",")])
        assert sorted(len(g) for g in groups.values()) == [dp] * len(groups)
        for group in groups.values():
            first = group[0]
            for r in group[1:]:
                assert r["losses"] == first["losses"]
                assert all(a.tobytes() == b.tobytes() for a, b in
                           zip(r["params"], first["params"]))
