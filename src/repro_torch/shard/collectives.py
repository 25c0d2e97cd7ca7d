"""Gradient all-reduce strategies for the sharded train step.

Port of :mod:`repro.shard.collectives` on ``torch.distributed``.  An
axis name (``"dp"``) is resolved against a :class:`repro_torch.shard.Mesh`:
the ``mesh=`` argument, else the mesh of the enclosing
:func:`repro_torch.core.spmd_scope`, as the reference resolves it
against the enclosing ``shard_map``.  Each strategy keeps the math of a
per-leaf mean, a sum over the axis then one division by its size:

* :func:`bucketed_psum` — the default.  Gradient leaves are grouped
  greedily into byte-size buckets in flatten order, and each bucket is
  reduced with a *single* ``all_reduce`` over one flat buffer, so small
  leaves (norms) share a collective.  The port issues the buckets after
  ``torch.autograd.grad`` returns, one after the other without waiting
  in between; overlapping them with the backward (gradient hooks) is
  not done yet.
* :func:`ring_all_reduce` — ``--grad-reduce ppermute``: ``n - 1``
  neighbour hops with ``isend``/``irecv`` accumulate the sum around the
  ring.  Each rank adds in its own ring order, so the ranks agree only
  to rounding.  Gloo sends CPU tensors only; a CUDA leaf on a gloo
  group is staged through the host, which is logged once.

Summation order.  Gloo's ring all-reduce cuts a buffer into chunks by
size, and where an element falls decides the order in which the ranks'
values are added, so at ``n >= 3`` a bucket's element can round
differently from the same element reduced alone.  At ``n = 2`` the sum
is one commutative addition: bucketed equals the per-leaf mean bitwise
(``tests/test_torch_shard.py`` holds it so).  Every rank receives the
same bits from one all-reduce, so replicas never drift apart.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

__all__ = ["DEFAULT_BUCKET_BYTES", "GRAD_REDUCE_MODES", "bucket_indices",
           "bucket_stats", "bucketed_psum", "ring_all_reduce",
           "reduce_gradients", "all_reduce_mean"]

#: Default gradient bucket size (4 MiB), the reference's.
DEFAULT_BUCKET_BYTES = 4 << 20

GRAD_REDUCE_MODES = ("bucketed", "blocking", "ppermute")


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    import numpy as np
    return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize


def _leaves(tree) -> list:
    from ..train.checkpoint import tree_flatten
    return tree_flatten(tree)


def bucket_indices(leaves, bucket_bytes: int) -> List[List[int]]:
    """Greedy, order-preserving bucketing of flat leaves by byte size.

    A leaf larger than ``bucket_bytes`` gets a bucket of its own; a
    bucket boundary never splits a leaf.
    """
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, leaf in enumerate(leaves):
        nb = _nbytes(leaf)
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def bucket_stats(tree, bucket_bytes: int = DEFAULT_BUCKET_BYTES
                 ) -> Tuple[int, List[int]]:
    """``(bucket_count, bytes_per_all_reduce)`` for ``tree``'s leaves."""
    leaves = _leaves(tree)
    buckets = bucket_indices(leaves, bucket_bytes)
    return len(buckets), [sum(_nbytes(leaves[i]) for i in idx)
                          for idx in buckets]


def _mesh_axis(axis: str, mesh):
    if mesh is None:
        from ..core.intercept import spmd_mesh
        mesh = spmd_mesh()
    if mesh is None:
        raise ValueError(f"mesh axis {axis!r} is not bound: call inside "
                         "repro_torch.core.spmd_scope(mesh) or pass mesh=")
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    return mesh


def _reduce_flat(tensors, group, mean_size):
    """One all-reduce (sum) over the concatenation of ``tensors`` (one
    dtype), then the division; returns the reduced tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if group is not None:
        dist.all_reduce(flat, group=group)
    if mean_size:
        flat = flat / mean_size
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _reduce_buckets(leaves, buckets, group, mean_size):
    out = [None] * len(leaves)
    for idx in buckets:
        # One buffer per dtype in the bucket (a train state has one).
        by_dtype = {}
        for i in idx:
            by_dtype.setdefault(leaves[i].dtype, []).append(i)
        for same in by_dtype.values():
            for i, r in zip(same, _reduce_flat([leaves[i] for i in same],
                                               group, mean_size)):
                out[i] = r
    return out


def bucketed_psum(tree, axis: str, bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                  mean_size: int | None = None, *, mesh=None):
    """Reduce ``tree`` over ``axis`` with one all-reduce per bucket.

    With ``mean_size`` the sum is divided by it afterwards: a sum then a
    division, as a per-leaf mean is, so at two ranks the result is that
    mean's bits (module docstring).
    """
    from ..train.checkpoint import tree_unflatten

    mesh = _mesh_axis(axis, mesh)
    leaves = _leaves(tree)
    out = _reduce_buckets(leaves, bucket_indices(leaves, bucket_bytes),
                          mesh.groups.get(axis), mean_size)
    return tree_unflatten(tree, out)


def all_reduce_mean(x: torch.Tensor, axis: str, *, mesh=None):
    """The mean of ``x`` over ``axis`` (the reference's ``pmean``)."""
    mesh = _mesh_axis(axis, mesh)
    return _reduce_flat([x], mesh.groups.get(axis), mesh.shape[axis])[0]


def _exchange(x: torch.Tensor, nxt: int, prv: int, group,
              staged: bool) -> torch.Tensor:
    send = x.cpu() if staged else x.contiguous()
    recv = torch.empty_like(send)
    reqs = [dist.isend(send, nxt, group=group),
            dist.irecv(recv, prv, group=group)]
    for req in reqs:
        req.wait()
    return recv.to(x.device) if staged else recv


def ring_all_reduce(tree, axis: str, axis_size: int, mean: bool = False,
                    *, mesh=None):
    """Ring reduction over ``axis`` by ``isend``/``irecv`` hops.

    Every leaf takes ``axis_size - 1`` neighbour hops; each rank adds in
    its own ring order, so replicas agree only to rounding.  On a gloo
    group a CUDA leaf is staged through the host (gloo's point-to-point
    calls take CPU tensors only).
    """
    from ..obs.log import get_logger
    from ..train.checkpoint import tree_unflatten

    if axis_size < 1:
        raise ValueError(f"axis_size must be >= 1, got {axis_size}")
    if axis_size == 1:
        return tree_unflatten(tree, [x / 1 if mean else x
                                     for x in _leaves(tree)])
    mesh = _mesh_axis(axis, mesh)
    group = mesh.groups[axis]
    ranks = mesh.group_ranks[axis]
    me = ranks.index(mesh.rank)
    nxt, prv = ranks[(me + 1) % axis_size], ranks[(me - 1) % axis_size]
    gloo = dist.get_backend(group) == "gloo"
    out = []
    for x in _leaves(tree):
        staged = gloo and x.is_cuda
        if staged and "staged" not in mesh.notes:
            mesh.notes.add("staged")
            get_logger("shard").info(
                "ring all-reduce: gloo sends CPU tensors only, so each "
                "hop of a CUDA gradient is staged through the host")
        acc, cur = x, x
        for _ in range(axis_size - 1):
            cur = _exchange(cur, nxt, prv, group, staged)
            acc = acc + cur
        out.append(acc / axis_size if mean else acc)
    return tree_unflatten(tree, out)


def reduce_gradients(grads, axis: str, axis_size: int,
                     mode: str = "bucketed",
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES, *, mesh=None):
    """Mean-reduce a gradient tree over the data-parallel axis.

    ``mode``: ``bucketed`` (default; bit-identical to the per-leaf mean
    at two ranks), ``blocking`` (one all-reduce over every leaf after
    the whole backward: the reference's serialization, kept as its
    baseline), or ``ppermute`` (ring, replicas agree to rounding only).
    """
    if mode not in GRAD_REDUCE_MODES:
        raise ValueError(f"unknown gradient-reduce mode {mode!r}; "
                         f"expected one of {GRAD_REDUCE_MODES}")
    if mode == "ppermute":
        return ring_all_reduce(grads, axis, axis_size, mean=True, mesh=mesh)
    if mode == "blocking":
        bucket_bytes = sum(_nbytes(x) for x in _leaves(grads))
    return bucketed_psum(grads, axis, bucket_bytes, mean_size=axis_size,
                         mesh=mesh)
