"""Rank functions of the port's multi-process tests (not a test module).

Spawned ranks unpickle their function by module name, so these live in a
module that imports torch and the port only: a ``test_*.py`` module would
bring jax and the reference package into every rank.  Each rank runs the
same list of tasks in the same order (their collectives must meet) and
returns one picklable result per task: numpy arrays, numbers, strings.
"""

import numpy as np
import torch

from repro_torch.core import PrecisionPolicy, offload
from repro_torch.launch.train import (build_sharded_train_step,
                                      build_train_step)
from repro_torch.models import Model
from repro_torch.shard import (build_mesh, bucketed_psum,
                               data_parallel_setup, reduce_gradients,
                               replicate, ring_all_reduce, shard_batch,
                               train_mesh_setup)
from repro_torch.train import AdamW, SyntheticText, checkpoint
from repro_torch.tune import Calibrator, PlanStaleError, solve_plan

SEQ_LEN = 32
BATCH = 8


def _np(tree):
    return [x.detach().cpu().numpy() for x in checkpoint.tree_flatten(tree)]


def run_tasks(tasks):
    """Run ``tasks``, ``[(name, kwargs), ...]``, on this rank in order.

    One intra-op thread: the tests run beside other test processes, and
    these ranks' tensors are small."""
    torch.set_num_threads(1)
    return [TASKS[name](**kwargs) for name, kwargs in tasks]


def collectives(spec, seed, bucket_bytes):
    """Each rank's random float64 tree reduced over ``dp`` by every
    strategy; the per-leaf mean (one all-reduce per leaf, then the
    division) is the reference."""
    mesh = build_mesh(spec)
    n = mesh.shape["dp"]
    rng = np.random.default_rng(seed + mesh.rank)
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 16))),
            "b": torch.from_numpy(rng.standard_normal((8, 4))),
            "c": torch.from_numpy(rng.standard_normal((3, 5, 7)))}
    mean = {}
    for key, x in tree.items():
        x = x.clone()
        torch.distributed.all_reduce(x, group=mesh.groups["dp"])
        mean[key] = x / n
    bucketed = bucketed_psum(tree, "dp", bucket_bytes, mean_size=n,
                             mesh=mesh)
    blocking = reduce_gradients(tree, "dp", n, mode="blocking", mesh=mesh)
    ring = ring_all_reduce(tree, "dp", n, mean=True, mesh=mesh)
    return {"inputs": _np(tree), "mean": _np(mean), "bucketed": _np(bucketed),
            "blocking": _np(blocking), "ring": _np(ring)}


def replicated(spec):
    """Each rank's own tensor, then :func:`replicate`'s and
    :func:`data_parallel_setup`'s results, and the latter's message for
    a batch the mesh does not divide."""
    mesh = build_mesh(spec)
    mine = {"w": torch.full((3,), float(mesh.rank)), "s": torch.tensor(7)}
    _, batch_spec, setup = data_parallel_setup(spec, 8, mine)
    try:
        data_parallel_setup(spec, 3)
        message = None
    except SystemExit as e:
        message = str(e)
    return {"mine": _np(mine), "got": _np(replicate(mine, mesh)),
            "setup": _np(setup), "batch_spec": tuple(batch_spec),
            "message": message}


def setup_errors(cfg, global_batch):
    """The SystemExit messages of ``train_mesh_setup`` in a group of this
    size, and the canonical axis order."""
    world = torch.distributed.get_world_size()
    out = {}
    for label, spec, batch in (("batch", f"dp={world}", global_batch + 1),
                               ("tp", f"dp=1,tp={world}", global_batch)):
        try:
            train_mesh_setup(spec, batch, cfg)
        except SystemExit as e:
            out[label] = str(e)
    mesh = train_mesh_setup(f"tp=1,dp={world}", global_batch, cfg)[0]
    out["axis_names"] = list(mesh.axis_names)
    out["coords"] = dict(mesh.coords)
    return out


def _site_info(sites):
    return [{"name": s.name, "offloaded": bool(s.offloaded),
             "reason": s.reason, "spmd": s.spmd, "repr": repr(s),
             "m": s.m, "k": s.k, "n": s.n} for s in sites]


def train(cfg, spec, steps, grad_reduce="bucketed", backend="",
          default_splits=6, min_dim=32, accumulator="f64", lr=3e-3,
          bucket_bytes=None):
    """``steps`` steps of the sharded train step of ``cfg`` (seed 0) on
    this rank, natively or under ``backend``: the losses, this rank's
    coordinates, its final parameter blocks and the site report."""
    model = Model(cfg, device="cpu", seed=0)
    opt = AdamW(lr=lr)
    data = SyntheticText(cfg.vocab_size, SEQ_LEN, BATCH, seed=0)
    params = model.params
    mesh, _, (params, state), _ = train_mesh_setup(
        spec, BATCH, cfg, (params, opt.init(params)))
    kw = {} if bucket_bytes is None else {"bucket_bytes": bucket_bytes}
    step = build_sharded_train_step(model, opt, mesh,
                                    grad_reduce=grad_reduce, **kw)
    sites = []
    if backend:
        step = offload(step, PrecisionPolicy(
            backend=backend, default_splits=default_splits,
            min_dim=min_dim, accumulator=accumulator))
        sites = step.sites(params, state, shard_batch(
            torch.as_tensor(data.batch(0)), mesh, "dp"))
    losses = []
    for i in range(steps):
        batch = shard_batch(torch.as_tensor(data.batch(i)), mesh, "dp")
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return {"losses": losses, "coords": dict(mesh.coords),
            "params": _np(params), "sites": _site_info(sites)}


def stale_plan(cfg, spec):
    """A ``--target step`` plan calibrated on one device, applied to the
    sharded step of ``spec``: the error it raises, or None."""
    model = Model(cfg, device="cpu", seed=0)
    opt = AdamW(lr=3e-3)
    params = model.params
    state = opt.init(params)
    batch = torch.as_tensor(
        SyntheticText(cfg.vocab_size, 64, BATCH, seed=0).batch(0))
    pol = PrecisionPolicy(default_splits=6, min_dim=64)
    cal = Calibrator(build_train_step(model, opt), pol)
    cal.run(params, state, batch)
    plan = solve_plan(cal.result())
    mesh, _, (p2, o2), _ = train_mesh_setup(spec, BATCH, cfg,
                                            (params, state))
    sharded = build_sharded_train_step(model, opt, mesh)
    try:
        offload(sharded, plan=plan).sites(p2, o2,
                                          shard_batch(batch, mesh, "dp"))
    except PlanStaleError as e:
        return type(e).__name__ + ": " + str(e)
    return None


def cuda_gloo():
    """Two ranks on the card: an all-reduce of CUDA tensors and one
    bucketed mean, over the backend the topology picks."""
    from repro_torch.shard.launch import rank_device

    mesh = build_mesh("dp=2")
    dev = rank_device("cuda")
    x = torch.full((1000,), float(mesh.rank + 1), device=dev)
    torch.distributed.all_reduce(x, group=mesh.groups["dp"])
    tree = {"a": torch.arange(10.0, device=dev) * (mesh.rank + 1),
            "b": torch.ones(3, 3, device=dev)}
    out = bucketed_psum(tree, "dp", mean_size=2, mesh=mesh)
    return {"backend": torch.distributed.get_backend(),
            "device": str(out["a"].device), "sum": x.cpu().numpy(),
            "a": out["a"].cpu().numpy(), "b": out["b"].cpu().numpy()}


TASKS = {"collectives": collectives, "replicated": replicated,
         "setup_errors": setup_errors,
         "train": train, "stale_plan": stale_plan}
