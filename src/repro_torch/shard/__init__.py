"""Meshes of processes and the data- and tensor-parallel helpers.

Port of :mod:`repro.shard` on ``torch.distributed``.  A JAX mesh is one
controller over N devices; here a mesh is N processes, one rank per
mesh position, in one process group.  Each rank holds its own
:class:`Mesh`: the axis sizes, its coordinates and one process group
per axis (the ranks that differ from it on that axis alone).  The
training mesh is always dp-major, ``("dp", "tp")``, so adjacent ranks
form a tp group.  The ranks are started by the entry points
themselves (:mod:`repro_torch.shard.launch`): ``python -m
repro_torch.launch.train --mesh dp=2,tp=2`` is one command, as in the
reference; under ``torchrun`` they take ``RANK``/``WORLD_SIZE`` from
the environment.

Helpers:

* :func:`parse_mesh_spec` / :func:`build_mesh` — ``"dp=8"`` (or
  ``"dp=4,tp=2"``) to this rank's :class:`Mesh` over the process group;
* :func:`data_parallel_sharding` — the canonical placement specs,
  parameters replicated, the batch split on its leading axis;
* :func:`data_parallel_setup` / :func:`train_mesh_setup` — the CLIs'
  bring-up: axis names, the process budget, batch divisibility, tp
  divisibility, and the train state cut to this rank's blocks per the
  LM axis rules (:mod:`repro_torch.shard.rules`);
* :mod:`repro_torch.shard.collectives` — the bucketed and ring
  gradient all-reduce of the sharded train step;
* :func:`replicate` (a broadcast from rank 0) and :func:`shard_batch`
  (this rank's rows);
* the serve side (:class:`repro_torch.serve.Engine` given ``mesh=``):
  :func:`serve_dp_axis` (the slot axis), :func:`serve_mesh_setup` (the
  model's tp view and this rank's parameters), :func:`exchange_owned`
  (the sampled tokens over dp) and :func:`broadcast_scalar` (rank 0's
  enqueue stamp).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .collectives import (DEFAULT_BUCKET_BYTES, GRAD_REDUCE_MODES,
                          all_reduce_mean, bucket_indices, bucket_stats,
                          bucketed_psum, reduce_gradients, ring_all_reduce)
from .rules import (DP_AXIS, TP_AXIS, TRAIN_AXES, PartitionSpec, assemble,
                    assemble_state, flatten_specs, lm_param_specs,
                    rules_to_specs, shard_block, shard_state,
                    specs_to_rules, train_state_specs, validate_tp)

__all__ = [
    "Mesh", "parse_mesh_spec", "build_mesh", "data_parallel_sharding",
    "data_parallel_setup", "train_mesh_setup", "replicate", "shard_batch",
    "serve_dp_axis", "serve_mesh_setup", "exchange_owned",
    "broadcast_scalar",
    # repro_torch.shard.rules
    "DP_AXIS", "TP_AXIS", "TRAIN_AXES", "PartitionSpec", "validate_tp",
    "lm_param_specs", "train_state_specs", "specs_to_rules",
    "rules_to_specs", "flatten_specs", "shard_block", "shard_state",
    "assemble", "assemble_state",
    # repro_torch.shard.collectives
    "DEFAULT_BUCKET_BYTES", "GRAD_REDUCE_MODES", "bucket_indices",
    "bucket_stats", "bucketed_psum", "reduce_gradients", "ring_all_reduce",
    "all_reduce_mean",
]


class Mesh:
    """One rank's view of a mesh of processes.

    ``shape`` maps each axis name to its size, in mesh order;
    ``coords`` this rank's coordinate on each axis (row-major: the last
    axis varies fastest over the ranks); ``groups`` per axis the
    process group of the ranks that share every other coordinate
    (``None`` for an axis of size 1: it needs no collective), and
    ``group_ranks`` their global ranks in axis order; ``group`` spans
    the whole mesh (``None`` for a mesh of one rank).
    """

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 groups=None, group_ranks=None, group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.coords = {}
        rest = rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        self.coords = {name: self.coords[name] for name in self.axis_names}
        self.groups = dict(groups or {name: None for name in self.shape})
        self.group_ranks = dict(group_ranks or {
            name: [rank] for name in self.shape})
        self.group = group
        # One-time log notes per mesh (e.g. host staging).
        self.notes: set = set()

    @property
    def spmd_axes(self) -> Tuple[Tuple[str, int], ...]:
        """``((name, size), ...)``: what a site under this mesh records."""
        return tuple(self.shape.items())

    def describe(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.shape.items())

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over every rank of the mesh,
        into ``x`` (a host tensor visits the card under NCCL, which
        reduces CUDA tensors only)."""
        if self.group is None:
            return x
        y = _for_backend(x, self.group)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        if y is not x:
            x.copy_(y)
        return x

    def __repr__(self):
        return (f"Mesh({self.describe()}, rank={self.rank}, "
                f"coords={self.coords})")


def _for_backend(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, or its copy on this rank's card when ``group`` is NCCL's
    and ``x`` is a host tensor (NCCL reduces CUDA tensors only)."""
    if not x.is_cuda and dist.get_backend(group) == "nccl":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"dp=8"`` / ``"dp=4,tp=2"`` -> ``{"dp": 8}`` / ``{"dp": 4, "tp": 2}``.

    Axis order in the string is the mesh axis order.  Sizes must be
    positive integers; axis names must be unique.
    """
    axes: Dict[str, int] = {}
    for part in (spec or "").split(","):
        name, sep, size = part.strip().partition("=")
        if not sep or not name:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'axis=size[,...]' "
                "(e.g. 'dp=8')")
        if name in axes:
            raise ValueError(f"bad mesh spec {spec!r}: duplicate axis "
                             f"{name!r}")
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad mesh spec {spec!r}: size of "
                             f"{name!r} is not an integer") from None
        if n < 1:
            raise ValueError(f"bad mesh spec {spec!r}: size of "
                             f"{name!r} must be >= 1")
        axes[name] = n
    return axes


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(spec: str = "dp=1") -> Mesh:
    """This rank's :class:`Mesh` for ``spec`` over the process group.

    A mesh of one position needs no process group.  Otherwise the
    group's size must be the mesh's (one rank per position); every rank
    must call this, in the same order as its other group-creating calls,
    since each axis group is made by ``dist.new_group`` on every rank.
    Raises with the launch recipe when the group is too small.
    """
    axes = parse_mesh_spec(spec)
    need = math.prod(axes.values())
    world, rank = _world()
    if need == 1:
        return Mesh(axes)
    if need != world:
        raise ValueError(
            f"mesh {spec!r} needs {need} processes but the process group "
            f"has {world}; start one rank per mesh position: the "
            "repro_torch entry points given --mesh start them "
            "themselves, or run one under torchrun --nproc-per-node "
            f"{need}")
    names = list(axes)
    groups, group_ranks = {}, {}
    for ai, name in enumerate(names):
        if axes[name] == 1:
            groups[name] = None
            group_ranks[name] = [rank]
            continue
        others = [range(axes[n]) if i != ai else [None]
                  for i, n in enumerate(names)]
        for combo in itertools.product(*others):
            ranks = []
            for c in range(axes[name]):
                coords = list(combo)
                coords[ai] = c
                r = 0
                for n, x in zip(names, coords):
                    r = r * axes[n] + x
                ranks.append(r)
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name], group_ranks[name] = g, ranks
    return Mesh(axes, rank, groups, group_ranks, dist.group.WORLD)


def data_parallel_sharding(mesh: Mesh, axis: str | None = None
                           ) -> Tuple[PartitionSpec, PartitionSpec]:
    """The canonical data-parallel placement for ``(params, batch)``:
    ``(replicated, batch_spec)``, parameters and optimizer state
    replicated, the batch split over ``axis`` (default: the mesh's first
    axis) on its leading dimension."""
    axis = axis or mesh.axis_names[0]
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    return PartitionSpec(), PartitionSpec(axis)


def data_parallel_setup(spec: str, global_batch: int, state=None):
    """The CLI recipe: mesh, divisibility guard, replicated state.

    Builds the mesh, checks that ``global_batch`` divides by its size
    (a ragged shard would change the per-shard loss weighting),
    broadcasts ``state`` from rank 0 (:func:`replicate`) and returns
    ``(mesh, batch_spec, state)``.  Raises ``SystemExit`` on a
    non-dividing batch.
    """
    mesh = build_mesh(spec)
    if global_batch % mesh.size:
        raise SystemExit(
            f"global batch {global_batch} is not divisible by mesh "
            f"size {mesh.size} ({spec!r}); pass one (with a batch "
            "that divides) or drop the mesh")
    _, batch_spec = data_parallel_sharding(mesh)
    if state is not None:
        state = replicate(state, mesh)
    return mesh, batch_spec, state


def train_mesh_setup(spec: str, global_batch: int, cfg=None, state=None):
    """2-D ``dp``×``tp`` mesh bring-up for the train and tune CLIs.

    Validates up front, with the reference's messages: the axis names
    (:data:`TRAIN_AXES`), the process budget (:func:`build_mesh`), that
    ``global_batch`` divides by the ``dp`` extent (tp ranks all see the
    same rows), and with ``tp > 1`` that tp divides the config's head
    and hidden extents (:func:`validate_tp`).  The mesh is built
    dp-major whatever the order in ``spec``.

    ``state = (params, opt_state)``, the *global* state every rank
    holds alike (made from the same seed, or restored from the same
    checkpoint), comes back as this rank's blocks per the LM axis rules:
    tp-sharded projections cut to the rank's tp coordinate, everything
    else as it was.

    Returns ``(mesh, batch_spec, state, state_specs)``, ``state_specs``
    the ``(params, opt_state)`` spec tree (what the sharded checkpoint
    manifest records).  Raises ``SystemExit`` on a bad spec.
    """
    try:
        axes = parse_mesh_spec(spec)
    except ValueError as e:
        raise SystemExit(f"[shard] {e}") from None
    unknown = [a for a in axes if a not in TRAIN_AXES]
    if unknown:
        raise SystemExit(
            f"[shard] mesh {spec!r}: unknown axis name(s) "
            f"{', '.join(repr(a) for a in unknown)}; valid axes are "
            f"'{DP_AXIS}' (data parallel, splits the batch) and "
            f"'{TP_AXIS}' (tensor parallel, splits attention heads "
            "and the MLP hidden dim), e.g. --mesh dp=4,tp=2")
    dp = axes.get(DP_AXIS, 1)
    tp = axes.get(TP_AXIS, 1)
    canonical = f"{DP_AXIS}={dp},{TP_AXIS}={tp}"
    try:
        mesh = build_mesh(canonical)
    except ValueError as e:
        raise SystemExit(f"[shard] {e}") from None
    if global_batch % dp:
        raise SystemExit(
            f"[shard] global batch {global_batch} is not divisible by "
            f"the data-parallel extent dp={dp} ({spec!r}); tensor "
            "parallelism does not split the batch, so only dp counts")
    if tp > 1:
        if cfg is None:
            raise SystemExit(f"[shard] mesh {spec!r} has tp={tp} but "
                             "no model config to derive axis rules")
        try:
            validate_tp(cfg, tp)
        except ValueError as e:
            raise SystemExit(f"[shard] {e}") from None
    state_specs = None
    if cfg is not None:
        state_specs = train_state_specs(cfg)
        if tp == 1:
            state_specs = _replicated_like(state_specs)
    if state is not None and state_specs is not None and tp > 1:
        state = shard_state(state, state_specs, mesh)
    return mesh, PartitionSpec(DP_AXIS), state, state_specs


def _replicated_like(specs):
    if isinstance(specs, PartitionSpec):
        return PartitionSpec()
    if isinstance(specs, dict):
        return {k: _replicated_like(v) for k, v in specs.items()}
    return type(specs)(_replicated_like(v) for v in specs)


def replicate(tree, mesh: Mesh):
    """Every tensor leaf of ``tree`` as rank 0 of ``mesh`` holds it (a
    broadcast over the mesh, into new tensors)."""
    from ..train.checkpoint import tree_flatten, tree_unflatten

    out = []
    for x in tree_flatten(tree):
        x = x.clone()
        if mesh.group is not None:
            dist.broadcast(x, src=0, group=mesh.group)
        out.append(x)
    return tree_unflatten(tree, out)


def shard_batch(batch, mesh: Mesh, axis: str | None = None):
    """This rank's rows of ``batch`` (a tensor or a tree of them) along
    ``axis`` (default: the mesh's first axis).

    The leading extent must divide by the axis size: a ragged final
    shard would change the per-shard loss weighting, breaking the
    dp=N == single-device equivalence the tests hold.
    """
    from ..train.checkpoint import tree_flatten, tree_unflatten

    axis = axis or mesh.axis_names[0]
    size = mesh.shape[axis]
    leaves = tree_flatten(batch)
    lead = leaves[0].shape[0]
    if lead % size:
        raise ValueError(
            f"leading batch extent {lead} is not divisible by mesh "
            f"axis {axis!r} of size {size}")
    rows = lead // size
    at = mesh.coords[axis] * rows
    return tree_unflatten(batch, [x[at:at + rows] for x in leaves])


# -- the serve side ---------------------------------------------------


def serve_dp_axis(mesh: Mesh) -> Tuple[Optional[str], int]:
    """The axis a serve engine splits its slots over and its size: the
    mesh's first axis that is not ``tp``, as in the reference; ``(None,
    1)`` for a mesh of ``tp`` alone."""
    axis = next((a for a in mesh.axis_names if a != TP_AXIS), None)
    return axis, (1 if axis is None else mesh.shape[axis])


def serve_mesh_setup(mesh: Mesh, model, params):
    """``(model, params)`` as this rank serves them.

    With ``tp > 1``: :func:`validate_tp`, the model's tp view over the
    mesh's ``tp`` group and this rank's blocks of ``params`` (the global
    parameters every rank holds alike) per :func:`lm_param_specs`, the
    reference's ``device_put`` per the axis rules.  Otherwise the model
    as it is and ``params`` as rank 0 holds them (:func:`replicate`).
    """
    tp = mesh.shape.get(TP_AXIS, 1)
    if tp > 1:
        validate_tp(model.cfg, tp)
        return (model.tp_view(mesh.groups[TP_AXIS]),
                shard_state(params, lm_param_specs(model.cfg), mesh))
    return model, replicate(params, mesh)


def exchange_owned(values: np.ndarray, owned: np.ndarray, mesh: Mesh,
                   axis: Optional[str]) -> np.ndarray:
    """Every rank's ``owned`` entries of the non-negative integer vector
    ``values``, on every rank of ``axis``'s group.

    Each rank contributes the entries it owns and zeros elsewhere, and
    one sum all-reduce over the group assembles them: a host tensor
    under gloo (which moves CUDA tensors for all-reduce and broadcast
    only, and these values are on the host already), a CUDA tensor
    under NCCL.  The owners must partition the entries.  Every rank of
    the group must call it, the same number of times.
    """
    group = None if axis is None else mesh.groups.get(axis)
    if group is None:
        return values
    mine = torch.from_numpy(np.where(owned, values, 0).astype(np.int64))
    buf = _for_backend(mine, group)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy().astype(values.dtype)


def broadcast_scalar(value: float, mesh: Mesh) -> float:
    """Rank 0's ``value`` on every rank of ``mesh`` (a float64
    broadcast; every rank must call it)."""
    if mesh.group is None:
        return value
    buf = _for_backend(torch.tensor([value], dtype=torch.float64),
                       mesh.group)
    dist.broadcast(buf, src=0, group=mesh.group)
    return float(buf.cpu()[0])
