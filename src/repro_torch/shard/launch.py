"""Starting the ranks of a mesh: one process per mesh position.

An entry point given ``--mesh`` calls :func:`run_on_mesh`.  Inside a
process group that already exists (a rank started here, or one a caller
set up) it runs in place.  Under ``torchrun`` (``RANK`` and
``WORLD_SIZE`` in the environment) it joins that group.  Otherwise it
starts the ranks itself: :func:`spawn` runs them as
``torch.multiprocessing`` processes (the ``spawn`` start method) that
meet through a ``file://`` rendezvous in a temporary directory, and the
caller gets every rank's result.

Backend.  On the CPU the group is ``gloo``.  On CUDA it is ``nccl``
when each rank has a card of its own, and ``gloo`` over CUDA tensors
when ranks share a card (NCCL refuses two ranks on one device); the
tensors and every GEMM stay on the card either way.  The choice is
logged.  Gloo reduces and broadcasts CUDA tensors; its point-to-point
calls take CPU tensors only (:func:`repro_torch.shard.ring_all_reduce`
stages through the host there).

Failure.  :func:`spawn` polls its ranks: when one exits with an error,
it kills the others and raises with that rank's traceback; with
``timeout`` it kills them all once the time is up.  The process
group's own timeout is set to the same value, so a collective that
waits for a dead peer fails too.

Only torch is imported here, so a spawned rank that unpickles its
function from this module (or from the entry points) imports nothing
else.
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["choose_backend", "rank_device", "spawn", "run_on_mesh",
           "is_rank_zero", "mesh_ranks"]

#: The process group's timeout when the caller gives none (torch's own
#: default for gloo).
_DEFAULT_PG_TIMEOUT = datetime.timedelta(minutes=30)


def choose_backend(device_type: str, world: int) -> str:
    """``gloo`` on the CPU or when CUDA ranks share a card, ``nccl``
    when each CUDA rank has a card of its own."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: the CPU, or ``cuda:<rank mod cards>``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    rank = dist.get_rank() if dist.is_initialized() else 0
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def mesh_ranks(spec: str) -> int:
    """The number of ranks a ``--mesh`` spec needs; ``SystemExit`` (the
    CLIs' error) on a malformed spec."""
    from . import parse_mesh_spec

    try:
        return math.prod(parse_mesh_spec(spec).values())
    except ValueError as e:
        raise SystemExit(f"[shard] {e}") from None


def is_rank_zero() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _init(backend: str, rank: int, world: int, init_method: str,
          timeout: Optional[float]) -> None:
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=(datetime.timedelta(seconds=timeout) if timeout
                 else _DEFAULT_PG_TIMEOUT))


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               workdir: str, timeout: Optional[float], fn, args) -> None:
    if rank:
        # Rank 0 speaks for the job.
        os.environ["REPRO_LOG_LEVEL"] = "WARNING"
    if backend == "gloo" and not torch.cuda.is_available():
        # CPU ranks share the host's cores instead of each taking all.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        _init(backend, rank, world, init_method, timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(workdir, f"result_{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable, world: int, args=(), *, device=None,
          timeout: Optional[float] = None) -> List:
    """Run ``fn(*args)`` on ``world`` new ranks; their results in rank
    order.

    ``fn`` must be importable by name (a module-level function of a
    module the ranks can import).  ``device`` picks the backend
    (:func:`choose_backend`); ``fn`` finds its own card with
    :func:`rank_device`.  A rank that fails stops the others and raises
    ``RuntimeError`` with its traceback; ``timeout`` (seconds) bounds
    the whole run (``TimeoutError``).
    """
    dev = torch.device("cuda" if device is None else device)
    backend = choose_backend(dev.type, world)
    ctx = torch.multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    init_method = "file://" + os.path.join(workdir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, backend, init_method, workdir,
                               timeout, fn, args), daemon=True)
             for rank in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(workdir, failed[0],
                                            procs[failed[0]].exitcode))
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks of {getattr(fn, '__name__', fn)} did "
                    f"not finish within {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(workdir, failed[0],
                                        procs[failed[0]].exitcode))
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)


def _failure(workdir: str, rank: int, code) -> str:
    path = os.path.join(workdir, f"error_{rank}.txt")
    detail = ""
    if os.path.exists(path):
        with open(path) as f:
            detail = f.read()
    return f"rank {rank} failed (exit code {code}):\n{detail}"


def run_on_mesh(fn: Callable, world: int, args=(), *, device=None,
                timeout: Optional[float] = None, log=None) -> List:
    """``fn(*args)`` as every rank of a ``world``-rank job.

    In place when the job has one rank or a process group exists, and
    joining ``torchrun``'s group when its environment is set: then the
    list holds this process's result alone.  Else the ranks are started
    by :func:`spawn` and the list holds every rank's result in rank
    order.  The backend chosen is logged through ``log``.
    """
    if world == 1 or dist.is_initialized():
        return [fn(*args)]
    dev = torch.device("cuda" if device is None else device)
    backend = choose_backend(dev.type, world)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(
                f"[shard] the mesh needs {world} ranks but torchrun "
                f"started {os.environ['WORLD_SIZE']}")
        if log is not None:
            log.info(f"joining torchrun's {world} ranks over {backend}")
        if int(os.environ["RANK"]):
            os.environ["REPRO_LOG_LEVEL"] = "WARNING"
        _init(backend, int(os.environ["RANK"]), world, "env://", timeout)
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    if log is not None:
        cards = (f", {torch.cuda.device_count()} card(s)"
                 if dev.type == "cuda" else "")
        log.info(f"starting {world} ranks on {dev.type}{cards}: "
                 f"process group backend {backend}")
    return spawn(fn, world, args, device=device, timeout=timeout)
