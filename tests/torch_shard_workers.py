"""Rank functions of the port's multi-process tests (not a test module).

Spawned ranks unpickle their function by module name, so these live in a
module that imports torch and the port only: a ``test_*.py`` module would
bring jax and the reference package into every rank.  Each rank runs the
same list of tasks in the same order (their collectives must meet) and
returns one picklable result per task: numpy arrays, numbers, strings.
"""

import os

import numpy as np
import torch

from repro_torch.core import PrecisionPolicy, offload
from repro_torch.launch.train import (build_sharded_train_step,
                                      build_train_step)
from repro_torch.models import Model
from repro_torch.shard import (assemble_state, build_mesh, bucketed_psum,
                               data_parallel_setup, reduce_gradients,
                               replicate, ring_all_reduce, shard_batch,
                               train_mesh_setup, train_state_specs)
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
             "m": s.m, "k": s.k, "n": s.n, "mult": s.mult,
             "splits": s.splits} for s in sites]


def train(cfg, spec, steps, grad_reduce="bucketed", backend="",
          default_splits=6, min_dim=32, accumulator="f64", lr=3e-3,
          bucket_bytes=None, batch=BATCH, seq_len=SEQ_LEN):
    """``steps`` steps of the sharded train step of ``cfg`` (seed 0) on
    this rank, ``batch`` rows of ``seq_len`` tokens a step over the
    mesh, natively or under ``backend``: the losses, this rank's
    coordinates, its final parameter blocks and the site report."""
    model = Model(cfg, device="cpu", seed=0)
    opt = AdamW(lr=lr)
    data = SyntheticText(cfg.vocab_size, seq_len, batch, seed=0)
    params = model.params
    mesh, _, (params, state), _ = train_mesh_setup(
        spec, batch, cfg, (params, opt.init(params)))
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
        rows = shard_batch(torch.as_tensor(data.batch(i)), mesh, "dp")
        params, state, loss = step(params, state, rows)
        losses.append(float(loss))
    return {"losses": losses, "coords": dict(mesh.coords),
            "params": _np(params), "sites": _site_info(sites)}


def global_params(results, cfg):
    """The global parameters of ``cfg`` from the :func:`train` results of
    every rank: the blocks of the tp ranks of the first dp row, in tp
    order, assembled (runs in the test process)."""
    row = sorted((r for r in results if r["coords"]["dp"] == 0),
                 key=lambda r: r["coords"].get("tp", 0))
    like = Model(cfg, device="cpu", seed=0).params
    trees = [checkpoint.tree_unflatten(
        like, [torch.from_numpy(x) for x in r["params"]]) for r in row]
    return [np.asarray(x) for x in checkpoint.tree_flatten(
        assemble_state(trees, train_state_specs(cfg)[0]))]


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


def slot_kv(eng, slot):
    """Slot ``slot``'s cached K and V on this rank, ``(L, KV, length,
    head_dim)`` each as numpy, read through its block table (paged) or
    its row of the rectangle (dense)."""
    runner, kv = eng.runner, eng.kv
    n = int(runner._len[slot])

    def take(buf):
        if runner.layout == "paged":
            blocks = [b - kv._base for b in kv._mapped[slot]]
            got = buf[:, blocks].permute(0, 2, 1, 3, 4)
            got = got.reshape(got.shape[0], got.shape[1], -1, got.shape[4])
        else:
            got = buf[:, runner._local[slot]]
        return got[:, :, :n].detach().cpu().numpy().copy()

    return take(eng.cache["k"]), take(eng.cache["v"])


def watch(eng, reqs):
    """Record what ``eng`` does while it serves ``reqs``: the shapes of
    the waves this process runs, the admissions ``(slot, request
    index)`` in order, and, numbered by their order over every slot,
    the K/V of each of this process's slots just before it is released."""
    rec = {"waves": [], "admitted": [], "released": 0, "snapshots": {}}
    runner, kv = eng.runner, eng.kv
    index = {id(r): i for i, r in enumerate(reqs)}
    wave, enqueue, release = (runner.prefill_wave, runner.enqueue_prefill,
                              kv.release)

    def recorded_wave():
        res = wave()
        if res is not None and res.rows:
            rec["waves"].append((res.rows, res.width))
        return res

    def recorded_enqueue(slot, req):
        rec["admitted"].append((slot, index[id(req)]))
        enqueue(slot, req)

    def recorded_release(slot):
        if slot in runner._local:
            rec["snapshots"][(rec["released"], slot)] = slot_kv(eng, slot)
        rec["released"] += 1
        release(slot)

    runner.prefill_wave = recorded_wave
    runner.enqueue_prefill = recorded_enqueue
    kv.release = recorded_release
    return rec


def lm_head(cfg, seed):
    """A seeded LM head for ``cfg`` (0.1 x standard normal, float64), made
    in the rank: an array in the spawn arguments would grow each rank's
    start-up message past a pipe's buffer and start the ranks one by
    one."""
    return 0.1 * np.random.default_rng(seed).standard_normal(
        (cfg.d_model, cfg.vocab_size))


def make_requests(requests):
    from repro_torch.serve import Request

    return [Request(**r) for r in requests]


def serve(cfg, spec, seed, requests, head_seed=None, policy=None,
          plan=None, metrics_dir=None, probe=(), **engine_kw):
    """Serve ``requests`` (Request fields) with ``Engine(mesh=)`` on this
    rank: the model of ``cfg`` from ``seed`` with the LM head of
    :func:`lm_head` from ``head_seed``, under
    ``policy`` (PrecisionPolicy fields) or ``plan``, with a MetricsRun of
    its own under ``metrics_dir``.  Returns the streams, the mesh
    coordinates, the cache's shapes and local slots, :func:`watch`'s
    record, the enqueue stamps, the prefill sites at each ``(rows,
    width)`` of ``probe`` and, after the run, at each wave shape it ran
    (in the order first run, which the tp ranks of a group share), and
    the run's ``site_exec`` total."""
    from repro_torch.obs import MetricsRun
    from repro_torch.serve import Engine

    mesh = build_mesh(spec)
    model = Model(cfg, device="cpu", seed=seed)
    if head_seed is not None:
        with torch.no_grad():
            model.lm_head.copy_(torch.from_numpy(lm_head(cfg, head_seed)))
    run = (None if metrics_dir is None else MetricsRun(
        os.path.join(metrics_dir, f"rank{mesh.rank}")))
    eng = Engine(model, model.params, mesh=mesh, plan=plan,
                 policy=None if policy is None else PrecisionPolicy(
                     **policy), metrics=run, **engine_kw)
    reqs = make_requests(requests)
    rec = watch(eng, reqs)
    eng.run(reqs)
    out = {"tokens": [r.out for r in reqs], "coords": dict(mesh.coords),
           "k_shape": tuple(eng.cache["k"].shape),
           "length_shape": tuple(eng.cache["length"].shape),
           "local_slots": eng.kv.local_slots.tolist(),
           "wq_shape": tuple(eng.params["blocks"]["wq"].shape),
           "stamps": [eng.scheduler.t_enqueue(r) for r in reqs],
           "sites": {shape: _site_info(eng.prefill_sites(*shape))
                     for shape in probe}, **rec}
    out["wave_sites"] = {
        shape: _site_info(eng.prefill_sites(*shape))
        for shape in dict.fromkeys(rec["waves"])}
    if run is not None:
        out["site_exec"] = sum(m["value"] for m in run.registry.snapshot()
                               if m["name"] == "site_exec")
        run.close()
    return out


def serve_errors(cfg, spec, batch_slots):
    """The message of ``Engine(mesh=)`` for ``batch_slots`` slots."""
    from repro_torch.serve import Engine

    model = Model(cfg, device="cpu", seed=0)
    try:
        Engine(model, model.params, batch_slots=batch_slots,
               mesh=build_mesh(spec))
    except ValueError as e:
        return str(e)
    return None


TASKS = {"collectives": collectives, "replicated": replicated,
         "setup_errors": setup_errors,
         "train": train, "stale_plan": stale_plan, "serve": serve,
         "serve_errors": serve_errors}
