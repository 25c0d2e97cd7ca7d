"""Automatic BLAS offload for eager PyTorch programs.

Port of :mod:`repro.core.intercept`.  The paper intercepts the BLAS
calls of an unmodified application at link time and redirects large
GEMMs to the INT8 emulation engine.  A torch program has no jaxpr; its
counterpart of link-time interception is a
:class:`torch.overrides.TorchFunctionMode` around the call:
:func:`offload` runs ``fn`` under a mode that catches every torch call
whose ``jnp`` counterpart lowers to ``dot_general``: ``torch.matmul`` /
``Tensor.__matmul__`` / ``Tensor.matmul`` / ``torch.linalg.matmul``,
``torch.mm``, ``torch.bmm``, ``torch.mv``, ``torch.dot``,
``torch.vdot``, ``torch.inner``, ``torch.tensordot``,
``torch.linalg.vecdot``, ``torch.addmm``, ``torch.addmv``,
``torch.baddbmm``, ``torch.addbmm`` (and the in-place ``addmm_``,
``addmv_``, ``baddbmm_``, ``addbmm_``, which write their ``self``),
``F.linear``, ``torch.einsum``, ``torch.linalg.multi_dot`` and
``torch.chain_matmul``.  ``torch.outer``, ``torch.kron`` and
``torch.addr`` are no sites (their ``jnp`` counterparts multiply), nor
is any call given ``out=``.

Each caught call is a *site*, named ``dot{i}`` in call order with the
counter reset per call of ``fn``.  For straight-line programs,
including Python loops (which JAX unrolls into the jaxpr), these are
the reference's names.  :func:`scan` is the port's ``jax.lax.scan``:
under an offload it opens a scope, so the sites of its body are named
``scan{i}/dot{j}`` — ``i`` counts the control-flow scopes of the
enclosing scope (the reference's one counter for scan, while and cond),
``j`` restarts per body, every iteration shares the names, and
``Site.mult`` is the trip count.  Rank-N operands are normalised the
way ``jnp.matmul`` lowers them to ``dot_general`` — broadcast batch axes of
one operand become free axes merged into M or N, size-1 batch axes are
squeezed, the others stay batch — and an ``einsum`` the way
``jnp.einsum`` lowers it (which operand becomes the ``dot_general``'s
left-hand side, batch axes in output order, contracted axes sorted), so
each site's ``m``/``k``/``n``/``batch``, its operand shapes and its
gates equal the reference's; the 2-D backend then runs over the merged
batch axis ``(B, M, K) @ (B, K, N)``.  An einsum of three or more
operands is split into pairwise contractions in the order
``jnp.einsum`` takes (opt_einsum's ``'auto'`` path, which is its
exhaustive ``'optimal'`` search up to four operands; the port keeps
its own copy of that search and uses it for any count, where
opt_einsum switches to branch-and-bound and greedy searches beyond
four), each contraction a site ``dot{j}``; an index summed out of one
operand alone is summed first, natively, as ``jnp.einsum`` does.  The
equation is read as ``jnp.einsum`` reads it (opt_einsum's parser): an
ellipsis stands for fresh indices, broadcast as numpy does; an implicit
output is the indices that appear once, sorted, after the ellipsis'; an
index repeated within one operand is its diagonal, taken before the
contraction (or its trace, when the index goes nowhere else).
``torch.linalg.multi_dot`` and ``chain_matmul`` are ``jnp.linalg.
multi_dot``'s einsum, so they take its order; ``torch.tensordot``,
``torch.inner`` and ``torch.linalg.vecdot`` are ``dot_general`` calls
with the dimension numbers ``jnp.tensordot``, ``jnp.inner`` and
``jnp.linalg.vecdot`` give, ``addbmm`` is ``x + jnp.einsum('bij,bjk->
ik', ...)`` (one site, ``k`` = b·j).  A site passes the reference's
dtype gate (floating or complex) and ``min_dim`` gate, honours
``site_splits`` / ``site_backends`` (``"dgemm"`` demotes it to
native), and unmatched override keys are handled per
``policy.on_unmatched_site``.

Backward GEMMs.  A gradient taken *inside* ``fn`` (``torch.autograd.grad``
in a train step, as the reference traces ``value_and_grad`` into its
jaxpr) makes each cotangent product a site of its own, with the
reference's names: a scope's forward products in reverse order, each
contributing first its rhs cotangent ``(g^T @ lhs)^T`` as the site
(n, m, k) and then its lhs cotangent ``g @ rhs^T`` as (m, n, k), an
operand that needs no gradient contributing none (lhs and rhs are the
``dot_general``'s, so an einsum's in ``jnp.einsum``'s order); ``batch``
and ``mult`` are the forward site's.  The top level's cotangents continue
its ``dot`` counter (a head ``dot0`` gives ``dot1``, ``dot2``); a
``scan{i}`` body's are named in a new scan scope numbered by the
parent's flow counter (``scan1/dot0`` ..), the forward dot ``j`` of
``D`` giving ``scan1/dot{2(D-1-j)}`` and ``scan1/dot{2(D-1-j)+1}``.
Each passes the gates on its own name (dtype, ``min_dim``,
``site_splits``, ``site_backends`` with ``dgemm`` demotion,
``on_unmatched_site``) and keys its own engine state; a forward site
gated out by dtype or size still yields its two records, offloaded
False, and keeps torch's native gradient.  :func:`site_report` lists
them too.  A gradient taken *after* ``fn`` returned runs both
cotangents through the forward site's engine and split count, as the
reference's ``custom_vjp`` does.  Each gradient pass inside ``fn``
(``torch.autograd.grad``, ``backward``) names its own cotangents, on
from the counters the earlier passes left, as a second ``jax.grad``
does; a product whose output does not reach the pass's outputs, or an
operand whose gradient leads to none of its inputs, gets no cotangent
site, as the reference's jaxpr has none.

Telemetry.  ``offload(..., on_site_event=handler)`` calls ``handler``
on the host with one payload dict per *execution* of an offloaded
site's GEMM — the reference's keys (site, backend, splits, shapes,
extents, flops, tiles; the dtype by its numpy name), built once per
site and call of ``fn`` when the site is decided, and handed over as a
copy.  The port is eager, so the hook fires where the product runs:
once per :func:`scan` iteration, and for each backward site once per
execution of its cotangent product, on autograd's device thread when
the tensors are on the card (handlers must be thread-safe, as
:class:`repro_torch.obs.MetricsRun`'s is).  It reads nothing from the
device, so it adds no synchronization.  Each such execution is also
one ``offload.site`` layer span (:mod:`repro_torch.obs.trace`) from
the site's routing to its output, when a tracer is active.  The
reference stages a zero-operand ``jax.debug.callback`` instead, which
under reverse-mode AD reports a loop-body site once per step (ROADMAP
section 3).  A gradient taken after ``fn`` returned runs through the
forward site's engine and fires nothing, as the reference's
``custom_vjp`` does.

Control flow.  :func:`cond`, :func:`switch` and :func:`while_loop` are
the port's ``jax.lax`` counterparts.  Under an offload a ``cond`` or
``switch`` opens ``cond{i}/br{b}/`` scopes on the flow counter
``scan`` uses (branch ``b`` is ``int(pred)`` for a ``cond``, so ``br0``
is the false branch) and runs only the branch the index selects; a
``while_loop`` names its body's products ``while{i}/dot{j}`` and its
predicate's ``while{i}/cond/dot{j}``, each with the enclosing ``mult``
(the trip count is not static), and the hook fires once per real
execution.  The reference lists every branch whatever the predicate,
so the decision set must hold the branches not taken too: each is run
once per input signature, natively and in report mode (no engine, no
hook), when the decision cache does not yet hold it, and a loop body
that never ran is run once so.  Branches must therefore be pure and
total, as ``lax.cond``'s contract makes them.  A tensor predicate is
read on the host: one synchronizing read per ``cond`` and per loop
test.  A gradient inside ``fn`` names a ``cond``'s cotangents in a new
``cond{i}/br{b}/`` scope of the backward, every branch's, as the
reference's transposed ``cond`` does.  The reference cannot
differentiate a ``while_loop`` in reverse; the port names such
cotangents in a new ``while{i}/`` scope.

Opaque calls.  A user :class:`torch.autograd.Function` is left opaque,
as the reference leaves ``custom_jvp``/``custom_vjp`` calls: products
inside its ``forward`` and ``backward`` are no sites and run natively,
so its gradient rule holds.  The mode recognises a product inside a
``forward`` by ``Function.apply`` on the stack between it and ``fn``
(a ``forward`` runs with grad disabled, so only such calls look); a
``backward`` runs where the mode is not active.

Decision cache.  An eager program has no jaxpr to cache, so
:func:`offload` caches each input signature's *site decisions* (the
:class:`Site` records, tile choices and engine bindings), least
recently used first out (``cache_size``, :data:`OFFLOAD_CACHE_SIZE`).
The key is the pytree structure of ``(args, kwargs)``, each tensor's
shape, dtype, device type and ``requires_grad``, each Python scalar's
type (weak, as the reference marks it) and the grad mode.  A call that
hits takes each site's decision from the entry by name and skips the
gates and the tile pick; the plan and the override keys are checked
once per entry.  An eager program may branch on Python values under one
signature, so a cached decision is applied only to a product whose
shapes, dtype and ``mult`` equal its record's; a call that meets
another product, or a site set other than the entry's, warns, decides
afresh, replaces the entry and counts a miss.  ``persist_dir`` writes
each entry's decisions as ``<key>.json`` in the reference's byte
encoding under the reference's content key (with the torch version and
the pytree spec); with no exported program to restore, a restarted
process decides afresh and byte-verifies against the file
(``disk_decisions_hit``; ``disk_hits`` stays 0), overwriting it with a
warning when they differ.  The reference's ``jit_entries`` and
``transform_jaxpr`` have no eager counterpart.

SPMD.  :func:`spmd_scope` is the port's ``shard_map`` body: each rank
of a mesh of processes runs the block on its own shard, and under an
offload the block is a ``shmap{i}/`` scope on the flow counter ``scan``,
``cond`` and ``while`` share, so a sharded train step's sites are
``shmap0/`` and the single-device step's names.  Every site inside
records the mesh's axes (``Site.spmd``, ``[dp=4,tp=2]`` in its
``repr``) and sees its per-shard extents, which are what the gates and
the tile pick read.  A gradient pass inside the block names its
cotangents in the block, as ``value_and_grad`` inside the reference's
body does.  Collectives are no sites.  The decision cache's key holds
the axes of the meshes a call runs under.  ``pmap`` has no torch
counterpart and is not ported.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import itertools
import json
import math
import os
import sys
import threading
import warnings
from collections import OrderedDict, namedtuple
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.autograd.graph import get_gradient_edge
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from ..obs.trace import span
from .backends import GemmBackend, get_backend
from .precision import PrecisionPolicy

__all__ = ["offload", "scan", "cond", "switch", "while_loop",
           "spmd_scope", "spmd_mesh", "site_report", "Site", "CacheInfo",
           "PersistInfo", "OFFLOAD_CACHE_SIZE"]

#: Default bound on each wrapper's decision cache: a serving loop meets
#: an open-ended stream of signatures (every wave shape is one), so the
#: cache evicts instead of growing.
OFFLOAD_CACHE_SIZE = 64

#: ``wrapped.cache_info()`` record, the shape of functools.lru_cache's.
CacheInfo = namedtuple("CacheInfo", ["hits", "misses", "maxsize",
                                     "currsize"])

#: ``wrapped.persist_info()`` record, the reference's: ``disk_hits``
#: counts entries restored with a runnable exported program, which an
#: eager program has none of, so it stays 0; ``disk_decisions_hits``
#: counts entries whose decisions were on disk and were byte-verified
#: against this process's; ``disk_misses`` entries decided fresh and
#: written out.
PersistInfo = namedtuple("PersistInfo", ["disk_hits",
                                         "disk_decisions_hits",
                                         "disk_misses", "directory"])

#: Part of the persisted key, as in the reference: a file of another
#: layout is never looked up.
_PERSIST_FORMAT = 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _hook_payload(site: "Site", default_backend: str) -> dict:
    """The hook's static payload for ``site``: the reference's keys."""
    return {
        "site": site.name,
        "backend": site.backend or default_backend,
        "splits": int(site.splits),
        "lhs_shape": list(site.lhs_shape),
        "rhs_shape": list(site.rhs_shape),
        "dtype": _dtype_name(site.dtype),
        "m": site.m, "k": site.k, "n": site.n,
        "batch": site.batch, "mult": site.mult,
        "spmd_axes": [list(ax) for ax in site.spmd_axes],
        "flops": site.flops,
        "tiles": dict(site.tiles) if site.tiles else None,
    }


def _site_payload(sites) -> list:
    """Site records as plain JSON data, the reference's fields (the
    persisted decision set)."""
    return [{"name": s.name, "lhs_shape": list(s.lhs_shape),
             "rhs_shape": list(s.rhs_shape), "dtype": _dtype_name(s.dtype),
             "offloaded": bool(s.offloaded), "splits": int(s.splits),
             "reason": s.reason, "m": int(s.m), "k": int(s.k),
             "n": int(s.n), "batch": int(s.batch), "mult": int(s.mult),
             "spmd_axes": [[a, int(x)] for a, x in s.spmd_axes],
             "backend": s.backend, "eligible": bool(s.eligible),
             "tiles": s.tiles} for s in sites]


def _sites_from_payload(payload: list) -> List["Site"]:
    sites = []
    for p in payload:
        dtype = getattr(torch, p["dtype"])
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"not a dtype: {p['dtype']!r}")
        sites.append(Site(
            p["name"], p["lhs_shape"], p["rhs_shape"], dtype,
            p["offloaded"], p["splits"], p["reason"], m=p["m"], k=p["k"],
            n=p["n"], batch=p["batch"], mult=p["mult"],
            spmd_axes=[tuple(a) for a in p["spmd_axes"]],
            backend=p["backend"], eligible=p["eligible"],
            tiles=p["tiles"]))
    return sites


def _sites_bytes(sites) -> bytes:
    """The reference's canonical bytes of a decision set: two processes
    that take the same decisions write identical files."""
    return json.dumps(_site_payload(sites), sort_keys=True,
                      separators=(",", ":")).encode()


def _signature(args, kwargs, spmd=()) -> tuple:
    """The decision cache's key: the pytree spec of ``(args, kwargs)``,
    per leaf its abstract value, the grad mode and the meshes ``spmd``.

    A tensor is its shape, dtype, device type and ``requires_grad``; a
    Python scalar its type, marked weak as the reference marks it;
    anything else its type.  ``requires_grad`` and the grad mode decide
    which backward sites a call has.  ``spmd`` holds the axes of the
    meshes the call runs under (:func:`_spmd_key`), so one signature
    under two meshes never shares an entry.
    """
    leaves, spec = tree_flatten((args, kwargs))
    sig = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), _dtype_name(x.dtype), False,
                        x.device.type, bool(x.requires_grad)))
        else:
            sig.append(((), type(x).__name__,
                        isinstance(x, (bool, int, float, complex))))
    return spec, tuple(sig), torch.is_grad_enabled(), spmd


def _spmd_key(fn) -> tuple:
    """The meshes a call of ``fn`` runs under: those of the
    :func:`spmd_scope` blocks around the call, and the one ``fn``
    declares it enters (its ``spmd_axes`` attribute, which the sharded
    train step carries)."""
    return (tuple(m.spmd_axes for m in _MESHES.stack),
            tuple(getattr(fn, "spmd_axes", ())))


def _persist_key(fn_label, key, policy, plan, hooked) -> str:
    """The reference's content address of one entry: the function's
    label, the input structure and signature, the policy, the plan's
    fingerprint, whether a hook rides along and the library version."""
    spec, sig, grad, spmd = key
    payload = {
        "format": _PERSIST_FORMAT,
        "fn": fn_label,
        "in_tree": str(spec),
        "signature": sig,
        "grad": grad,
        "policy": dataclasses.asdict(policy),
        "plan": getattr(plan, "fingerprint", None),
        "hooked": bool(hooked),
        "torch": torch.__version__,
    }
    if any(spmd):
        payload["spmd"] = spmd
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


class _DiskCache:
    """One directory of ``<key>.json`` decision files.  Writes are
    atomic (a temporary file, then a rename); a missing file is a miss."""

    def __init__(self, directory):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, f"{key}.json")

    def load(self, key: str):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            return None

    def store(self, key: str, raw: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, path)


class Site:
    """One discovered matmul site and the decision taken.

    The reference's record: operand shapes as ``dot_general`` sees them,
    the normalized extents ``m``/``k``/``n``/``batch``, the trip
    multiplicity ``mult`` (the product of the enclosing :func:`scan`
    lengths), the SPMD axes (none yet), the resolved ``backend`` spec,
    ``eligible`` (passed the dtype and size gates) and, for the kernel
    family, ``tiles``.
    """

    def __init__(self, name: str, lhs_shape, rhs_shape, dtype,
                 offloaded: bool, splits: int, reason: str, *,
                 m: int = 0, k: int = 0, n: int = 0, batch: int = 1,
                 mult: int = 1, spmd_axes=(), backend: str = "",
                 eligible: bool = False, tiles: dict | None = None):
        self.name = name
        self.lhs_shape = tuple(lhs_shape)
        self.rhs_shape = tuple(rhs_shape)
        self.dtype = dtype
        self.offloaded = offloaded
        self.splits = splits
        self.reason = reason
        self.m, self.k, self.n, self.batch = m, k, n, batch
        self.mult = mult
        self.spmd_axes = tuple(spmd_axes)
        self.backend = backend
        self.eligible = eligible
        self.tiles = dict(tiles) if tiles else None

    @property
    def flops(self) -> int:
        """``2*batch*m*k*n`` times multiplicity, shards and 4 if complex."""
        spmd = math.prod(s for _, s in self.spmd_axes)
        cplx = 4 if self.dtype.is_complex else 1
        return (2 * max(self.batch, 1) * self.m * self.k * self.n
                * self.mult * spmd * cplx)

    @property
    def spmd(self) -> str:
        """Mesh context, e.g. ``"dp=4,tp=2"`` (empty off-mesh)."""
        return ",".join(f"{name}={size}"
                        for name, size in self.spmd_axes)

    def __repr__(self):
        action = (f"offload splits={self.splits}" if self.offloaded
                  else f"native ({self.reason})")
        if self.tiles:
            action += (f" tiles={self.tiles['block_m']}x"
                       f"{self.tiles['block_n']}x{self.tiles['block_k']}")
        mesh = f" [{self.spmd}]" if self.spmd_axes else ""
        return (f"{self.name}{mesh}: {self.lhs_shape} @ "
                f"{self.rhs_shape} {_dtype_name(self.dtype)} -> {action}")


class _MatmulDims:
    """``jnp.matmul``'s lowering of ``lhs @ rhs`` to ``dot_general``.

    Leading batch positions are matched right-aligned: a position only
    one operand has, or where the other's size is 1, is a free axis of
    that operand (merged into M or N); a size-1 axis facing a larger one
    is squeezed; equal sizes are batch axes.  ``pack`` builds the
    ``(B, M, K)`` / ``(B, K, N)`` operands and ``unpack`` restores
    ``torch.matmul``'s output layout from ``(B, M, N)``.
    """

    swap = False   # the operands are packed in their own order

    def __init__(self, lhs_shape, rhs_shape):
        lhs_shape, rhs_shape = tuple(lhs_shape), tuple(rhs_shape)
        self.a_mat, self.b_mat = len(lhs_shape) > 1, len(rhs_shape) > 1
        a_batch = lhs_shape[:-2] if self.a_mat else ()
        b_batch = rhs_shape[:-2] if self.b_mat else ()
        nb = max(len(a_batch), len(b_batch))
        self.a_off, self.b_off = nb - len(a_batch), nb - len(b_batch)
        a_batch = (None,) * self.a_off + a_batch
        b_batch = (None,) * self.b_off + b_batch
        self.batch, self.a_other, self.b_other = [], [], []
        self.a_squeeze, self.b_squeeze = [], []
        for i, (ba, bb) in enumerate(zip(a_batch, b_batch)):
            if ba is None:
                self.b_other.append(i)
            elif bb is None:
                self.a_other.append(i)
            elif ba == 1:
                self.b_other.append(i)
                self.a_squeeze.append(i)
            elif bb == 1:
                self.a_other.append(i)
                self.b_squeeze.append(i)
            elif ba == bb:
                self.batch.append(i)
            else:
                raise ValueError(f"incompatible matmul shapes {lhs_shape} "
                                 f"and {rhs_shape}")
        self.nb = nb
        self.sizes = [ba if ba is not None else bb
                      for ba, bb in zip(a_batch, b_batch)]
        for i in self.b_other:
            self.sizes[i] = b_batch[i]
        self.k = lhs_shape[-1]
        self.m_mat = lhs_shape[-2] if self.a_mat else None
        self.n_mat = rhs_shape[-1] if self.b_mat else None
        self.lhs_shape = tuple(d for j, d in enumerate(lhs_shape)
                               if j + self.a_off not in self.a_squeeze
                               or j >= len(lhs_shape) - 2)
        self.rhs_shape = tuple(d for j, d in enumerate(rhs_shape)
                               if j + self.b_off not in self.b_squeeze
                               or j >= len(rhs_shape) - 2)
        self.B = math.prod(self.sizes[i] for i in self.batch)
        self.M = (math.prod(self.sizes[i] for i in self.a_other)
                  * (self.m_mat if self.a_mat else 1))
        self.N = (math.prod(self.sizes[i] for i in self.b_other)
                  * (self.n_mat if self.b_mat else 1))
        self.K = self.k

    @staticmethod
    def _squeeze(x, off, squeeze):
        """Drop ``x``'s squeezed batch axes; map positions to its dims."""
        nbatch = x.ndim - 2
        x = x[tuple(0 if j < nbatch and j + off in squeeze else slice(None)
                    for j in range(x.ndim))]
        kept = [j + off for j in range(nbatch) if j + off not in squeeze]
        return x, {p: d for d, p in enumerate(kept)}

    def pack(self, a, b):
        if self.a_mat:
            a, pos = self._squeeze(a, self.a_off, self.a_squeeze)
            a = a.permute(*[pos[i] for i in self.batch + self.a_other],
                          a.ndim - 2, a.ndim - 1)
        a3 = a.reshape(self.B, self.M, self.K)
        if self.b_mat:
            b, pos = self._squeeze(b, self.b_off, self.b_squeeze)
            b = b.permute(*[pos[i] for i in self.batch], b.ndim - 2,
                          *[pos[i] for i in self.b_other], b.ndim - 1)
        b3 = b.reshape(self.B, self.K, self.N)
        return a3, b3

    def unpack(self, y3):
        order = ([("p", i) for i in self.batch + self.a_other]
                 + ([("m",)] if self.a_mat else [])
                 + [("p", i) for i in self.b_other]
                 + ([("n",)] if self.b_mat else []))
        shape = [self.sizes[t[1]] if t[0] == "p"
                 else (self.m_mat if t[0] == "m" else self.n_mat)
                 for t in order]
        want = ([("p", i) for i in range(self.nb)]
                + ([("m",)] if self.a_mat else [])
                + ([("n",)] if self.b_mat else []))
        y = y3.reshape(shape)
        return y.permute([order.index(t) for t in want])


class _DotGeneralDims:
    """A ``dot_general`` with explicit dimension numbers, normalised as
    the reference's ``_DotDims``: batch axes (in batch-dim order) merge
    into ``B``, free and contracted axes (in their own order) into
    ``M``/``K``/``N``.  ``unpack`` gives the ``dot_general``'s output
    ``(batch, lhs free, rhs free)``, permuted by ``out_perm`` and
    reshaped to ``out_shape`` when the ``jnp`` function does so after.
    """

    swap = False   # the operands are packed in their own order

    def __init__(self, lhs_shape, rhs_shape, contract, batch=((), ()),
                 out_perm=None, out_shape=None):
        (lc, rc), (lb, rb) = contract, batch
        self.lhs_shape, self.rhs_shape = tuple(lhs_shape), tuple(rhs_shape)
        lfree = [d for d in range(len(lhs_shape)) if d not in lc + lb]
        rfree = [d for d in range(len(rhs_shape)) if d not in rc + rb]
        self.lperm = (*lb, *lfree, *lc)
        self.rperm = (*rb, *rc, *rfree)
        self.batch_shape = tuple(lhs_shape[d] for d in lb)
        self.m_shape = tuple(lhs_shape[d] for d in lfree)
        self.n_shape = tuple(rhs_shape[d] for d in rfree)
        self.B = math.prod(self.batch_shape)
        self.M = math.prod(self.m_shape)
        self.K = math.prod(lhs_shape[d] for d in lc)
        self.N = math.prod(self.n_shape)
        self.out_perm, self.out_shape = out_perm, out_shape

    def pack(self, a, b):
        a3 = a.permute(tuple(self.lperm)).reshape(self.B, self.M, self.K)
        b3 = b.permute(tuple(self.rperm)).reshape(self.B, self.K, self.N)
        return a3, b3

    def unpack(self, y3):
        y = y3.reshape(self.batch_shape + self.m_shape + self.n_shape)
        if self.out_perm is not None:
            y = y.permute(tuple(self.out_perm))
        return y if self.out_shape is None else y.reshape(self.out_shape)


def _diagonal(x, names: str, name: str, keep: bool):
    """``jnp.einsum``'s ``sum_repeats`` for one index of ``x`` (axes
    labelled ``names``): the diagonal over every axis ``name`` labels,
    standing where its last occurrence stood, or summed out when
    ``keep`` is false."""
    left = list(names)
    while left.count(name) > 1:
        i, j = [d for d, c in enumerate(left) if c == name][:2]
        x = torch.diagonal(x, dim1=i, dim2=j)   # appended last
        del left[j], left[i]
        left.append(name)
    if not keep:
        return x.sum(dim=-1)
    return x.movedim(-1, names.replace(name, "", names.count(name) - 1)
                     .index(name))


class _EinsumDims(_DotGeneralDims):
    """``jnp.einsum``'s lowering of one two-operand contraction to
    ``dot_general``.

    ``opt_einsum`` hands ``jnp.einsum`` the operands in reverse order,
    ``L`` = the second and ``R`` = the first.  A size-1 axis of ``L``
    facing a larger one in ``R`` is squeezed, then the same for ``R``
    against what is left of ``L``; an index summed out of one operand
    alone is summed there first (``L``'s, then ``R``'s, natively, as
    ``jnp.einsum``'s ``reduce_sum``); an index repeated within an
    operand is its diagonal (``L``'s, then ``R``'s: ``sum_repeats``),
    summed out when neither the output nor the other operand has it;
    contracted names are sorted, batch names follow the output, and the
    ``dot_general`` is ``R @ L`` when that yields the output names in
    order (batch, R's free, L's free), else ``L @ R``.  ``pack``
    reduces the operands and packs them as :class:`_DotGeneralDims`
    does; ``unpack`` is its, permuted to the einsum's output.
    """

    def __init__(self, equation: str, lhs_shape, rhs_shape):
        eq = equation.replace(" ", "")
        inputs, out = eq.split("->")
        names = inputs.split(",")
        # Keyed by torch operand index: 1 is L, 0 is R.
        ops_ = {1: (names[1], tuple(rhs_shape)),
                0: (names[0], tuple(lhs_shape))}
        self.steps = {0: [], 1: []}

        def drop(i, axes, kind):
            own, shape = ops_[i]
            if axes:
                self.steps[i].append((kind, axes))
            ops_[i] = ("".join(c for d, c in enumerate(own)
                               if d not in axes),
                       tuple(x for d, x in enumerate(shape)
                             if d not in axes))

        for i in (1, 0):
            own, shape = ops_[i]
            other, oshape = ops_[1 - i]
            drop(i, [d for d, c in enumerate(own)
                     if shape[d] == 1 and other.find(c) != -1
                     and oshape[other.find(c)] != 1], "squeeze")
        counts = {i: {c: ops_[i][0].count(c) for c in ops_[i][0]}
                  for i in (0, 1)}
        for i in (1, 0):
            own = ops_[i][0]
            drop(i, [d for d, c in enumerate(own)
                     if c not in out and counts[i][c] == 1
                     and c not in counts[1 - i]], "sum")
        for i in (1, 0):
            for c, count in counts[i].items():
                if count < 2:
                    continue
                own, shape = ops_[i]
                keep = c in out or c in ops_[1 - i][0]
                self.steps[i].append(("diagonal", (own, c, keep)))
                first = [d for d, x in enumerate(own) if x == c]
                gone = first if not keep else first[:-1]
                ops_[i] = ("".join(x for d, x in enumerate(own)
                                   if d not in gone),
                           tuple(x for d, x in enumerate(shape)
                                 if d not in gone))
        (ln, ls), (rn, rs) = ops_[1], ops_[0]
        contracted = sorted(c for c in set(ln) | set(rn) if c not in out)
        batch = [c for c in out if c in ln and c in rn]
        gone = set(batch) | set(contracted)
        l_rest = [c for c in ln if c not in gone]
        r_rest = [c for c in rn if c not in gone]
        # dot_general(R, L) when that lists the output in order, i.e.
        # the torch operands in their own order; else (L, R), swapped.
        self.swap = "".join(batch + r_rest + l_rest) != out
        if not self.swap:
            (ln, ls, l_rest), (rn, rs, r_rest) = ((rn, rs, r_rest),
                                                  (ln, ls, l_rest))
        got = batch + l_rest + r_rest
        super().__init__(
            ls, rs, (tuple(ln.index(c) for c in contracted),
                     tuple(rn.index(c) for c in contracted)),
            (tuple(ln.index(c) for c in batch),
             tuple(rn.index(c) for c in batch)),
            out_perm=[got.index(c) for c in out])

    def _reduce(self, x, i):
        """Operand ``i`` as the ``dot_general`` takes it."""
        for kind, arg in self.steps[i]:
            if kind == "squeeze":
                for d in reversed(arg):
                    x = x.squeeze(d)
            elif kind == "sum":
                x = x.sum(dim=arg)
            else:
                x = _diagonal(x, *arg)
        return x

    def pack(self, a, b):
        a, b = self._reduce(a, 0), self._reduce(b, 1)
        return super().pack(*((b, a) if self.swap else (a, b)))


def _flop_count(indices, inner: bool, terms: int, size) -> int:
    """opt_einsum's cost of one contraction over ``indices``."""
    return (math.prod(size[c] for c in indices)
            * (max(1, terms - 1) + (1 if inner else 0)))


def _optimal_path(inputs, output, size) -> list:
    """opt_einsum's ``'optimal'`` search (no memory limit, as
    ``jnp.einsum`` calls it), its sieve and its tie order kept: the
    cheapest sequence of pairwise contractions, in single-assignment
    ids."""
    best = {"flops": float("inf"), "path": (tuple(range(len(inputs))),)}
    cache = {}

    def descend(path, remaining, inputs, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(remaining, 2):
            if i > j:
                i, j = j, i
            key = (inputs[i], inputs[j])
            if key not in cache:
                either, shared = inputs[i] | inputs[j], inputs[i] & inputs[j]
                keep = frozenset.union(
                    output, *map(inputs.__getitem__, remaining - {i, j}))
                cache[key] = (either & keep,
                              _flop_count(either, bool(shared - keep), 2,
                                          size))
            k12, flops12 = cache[key]
            if flops + flops12 >= best["flops"]:
                continue
            descend(path + ((i, j),), remaining - {i, j} | {len(inputs)},
                    inputs + (k12,), flops + flops12)

    descend((), set(range(len(inputs))), tuple(inputs), 0)
    return best["path"]


def _ssa_to_linear(ssa_path) -> list:
    """opt_einsum's conversion of a single-assignment path to list
    positions."""
    n = sum(map(len, ssa_path)) - len(ssa_path) + 1
    ids, path, ssa = list(range(n)), [], n
    for scon in ssa_path:
        con = sorted(bisect.bisect_left(ids, x) for x in scon)
        for j in reversed(con):
            ids.pop(j)
        ids.append(ssa)
        path.append(tuple(con))
        ssa += 1
    return path


_SYMBOLS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _symbol(i: int) -> str:
    """opt_einsum's ``get_symbol``: the 52 letters, then unicode."""
    if i < 52:
        return _SYMBOLS[i]
    return chr(i + 2048) if i >= 55296 else chr(i + 140)


def _parse_einsum(equation: str, shapes):
    """opt_einsum's ``parse_einsum_input``, which ``jnp.einsum`` reads
    its equation with: each ``...`` becomes the last of as many unused
    symbols as the largest rank (right-aligned, so they broadcast as
    numpy does), and an implicit output is the ellipsis' symbols, then
    the indices that appear once, sorted.  Returns (input names, output
    names)."""
    eq = equation.replace(" ", "")
    inputs, arrow, out = eq.partition("->")
    names = inputs.split(",")
    if len(names) != len(shapes):
        raise ValueError(f"einsum {equation!r}: {len(names)} subscripts "
                         f"for {len(shapes)} operands")
    if "." in eq:
        used = set(eq) - set(".,->")
        fresh, i = [], 0
        while len(fresh) < max(len(sh) for sh in shapes):
            if _symbol(i) not in used:
                fresh.append(_symbol(i))
            i += 1
        longest = 0
        for num, (sub, shape) in enumerate(zip(names, shapes)):
            if "." not in sub:
                continue
            if sub.count(".") != 3 or sub.count("...") != 1:
                raise ValueError(f"einsum {equation!r}: invalid ellipsis")
            count = max(len(shape), 1) - (len(sub) - 3) if shape else 0
            if count < 0:
                raise ValueError(f"einsum {equation!r}: ellipsis lengths "
                                 "do not match")
            longest = max(longest, count)
            names[num] = sub.replace("...", "".join(fresh[len(fresh)
                                                          - count:])
                                     if count else "")
        ell = "".join(fresh[len(fresh) - longest:]) if longest else ""
        if arrow:
            out = out.replace("...", ell)
        else:
            joined = "".join(names)
            out = ell + "".join(sorted(c for c in set(joined) - set(ell)
                                       if joined.count(c) == 1))
    elif not arrow:
        joined = "".join(names)
        out = "".join(sorted(c for c in set(joined)
                             if joined.count(c) == 1))
    return names, out


def _einsum_steps(equation: str, shapes) -> list:
    """``jnp.einsum``'s pairwise contractions of an equation, read as
    :func:`_parse_einsum` reads it.

    Each step pops two list positions (the higher first), as
    opt_einsum's ``contract_path`` does, and appends their result; it
    is given as those positions and the two-operand equation over (the
    lower operand, the higher) that :class:`_EinsumDims` lowers.  The
    order is opt_einsum's ``'auto'`` path up to four operands (its
    ``'optimal'`` search) and that search beyond; an intermediate's
    indices follow their first appearance in the pair, the last step's
    are the output's.
    """
    names, out = _parse_einsum(equation, shapes)
    if any(len(n) != len(sh) for n, sh in zip(names, shapes)):
        raise ValueError(f"einsum {equation!r}: subscripts do not match "
                         f"the operands' ranks {[len(sh) for sh in shapes]}")
    size = {}
    for n, shape in zip(names, shapes):
        for c, d in zip(n, shape):
            if size.get(c, 1) == 1:
                size[c] = int(d)
    sets = [frozenset(n) for n in names]
    path = ([(0, 1)] if len(names) == 2 else
            _ssa_to_linear(_optimal_path(sets, frozenset(out), size)))
    steps = []
    for num, inds in enumerate(path):
        inds = tuple(sorted(inds, reverse=True))
        popped = [sets.pop(x) for x in inds]
        result = frozenset(out).union(*sets) & frozenset.union(*popped)
        sets.append(result)
        pair = [names.pop(x) for x in inds]
        if num == len(path) - 1:
            res = out
        else:
            joined = "".join(pair)
            res = "".join(sorted(result, key=joined.find))
        names.append(res)
        steps.append((inds, f"{pair[1]},{pair[0]}->{res}"))
    return steps


class _Scope:
    """A naming scope: the top level of ``fn``, a loop's body or
    predicate, or one branch of a ``cond``."""

    def __init__(self, prefix: str = "", mult: int = 1,
                 record: bool = True, spmd_axes=(), spmd_body=False):
        self.prefix = prefix
        self.mult = mult
        self.dots = 0        # dot{j} counter
        self.flows = 0       # scan/while/cond/shmap counter
        self.record = record   # False on a loop's later iterations
        self.spmd_axes = tuple(spmd_axes)   # the enclosing meshes' axes
        # An spmd_scope's body: a gradient pass inside it names its
        # cotangents in the body itself, as the top level does.
        self.spmd_body = spmd_body


class _Active(threading.local):
    """Offload modes running ``fn`` in this thread, innermost last;
    :func:`scan`, :func:`switch` and :func:`while_loop` open their
    scopes in the innermost (torch keeps its function-mode stack per
    thread too)."""

    def __init__(self):
        self.modes: List["_OffloadMode"] = []


_ACTIVE = _Active()


def _active():
    return _ACTIVE.modes[-1] if _ACTIVE.modes else None


def _stack(outs):
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {key: _stack([o[key] for o in outs]) for key in first}
    return type(first)(_stack(list(parts)) for parts in zip(*outs))


def _steps(xs, n):
    """The ``n`` per-step slices of ``xs`` along its leading axis.

    A tensor that takes a gradient is unbound once, so its backward
    stacks the steps' gradients in one go (a slice per step would add
    ``n`` zero-padded full-size gradients); any other is indexed per
    step, so its slices stay plain views that a body may write into.
    """
    if isinstance(xs, torch.Tensor):
        if xs.requires_grad and torch.is_grad_enabled():
            return list(torch.unbind(xs))
        return [xs[i] for i in range(n)]
    if isinstance(xs, dict):
        cols = {key: _steps(val, n) for key, val in xs.items()}
        return [{key: col[i] for key, col in cols.items()}
                for i in range(n)]
    cols = [_steps(x, n) for x in xs]
    return [type(xs)(col[i] for col in cols) for i in range(n)]


def _length(xs) -> int:
    if isinstance(xs, torch.Tensor):
        return xs.shape[0]
    vals = list(xs.values()) if isinstance(xs, dict) else list(xs)
    return _length(vals[0])


def scan(body, carry, xs):
    """``jax.lax.scan`` for eager torch: loop ``body`` over the leading
    axis of ``xs`` (a tensor, or a dict/tuple/list of them).

    ``body(carry, x) -> (carry, y)``; returns the last carry and the
    ``y`` of every step stacked along a new leading axis (``None`` if
    ``body`` returns no ``y``).  Under :func:`offload` or
    :func:`site_report` the loop is a naming scope: the body's sites
    are ``scan{i}/dot{j}``, shared by every iteration, with ``mult``
    multiplied by the trip count.
    """
    n = _length(xs)
    mode = _active()
    scope = None
    if mode is not None:
        parent = mode.scopes[-1]
        scope = _Scope(mode.open_flow("scan"), parent.mult * n,
                       parent.record, parent.spmd_axes)
        mode.scopes.append(scope)
    ys = []
    try:
        for i, x in enumerate(_steps(xs, n)):
            if scope is not None:
                scope.dots = scope.flows = 0
                scope.record = scope.record and i == 0
            carry, y = body(carry, x)
            ys.append(y)
    finally:
        if scope is not None:
            mode.scopes.pop()
    return carry, (_stack(ys) if ys else None)


def switch(index, branches, *operands):
    """``jax.lax.switch`` for eager torch: ``branches[index](*operands)``
    with ``index`` clamped into range (a tensor index is read on the
    host).

    Under :func:`offload` or :func:`site_report` it is a ``cond{i}``
    scope whose branch ``b`` names its sites ``cond{i}/br{b}/dot{j}``.
    Only the selected branch runs for its result, but the decision set
    lists every branch's sites, as the reference's does: a branch that
    is not selected is run once per input signature, natively and in
    report mode, unless the decision cache already holds it.  Branches
    must therefore be pure and total, ``lax.switch``'s contract.
    """
    branches = list(branches)
    index = min(max(int(index), 0), len(branches) - 1)
    mode = _active()
    if mode is None:
        return branches[index](*operands)
    return mode.run_switch(index, branches, operands)


def cond(pred, true_fn, false_fn, *operands):
    """``jax.lax.cond`` for eager torch: ``true_fn(*operands)`` if
    ``pred`` else ``false_fn(*operands)``.  A :func:`switch` over
    ``(false_fn, true_fn)``: branch ``br1`` is the true branch, and a
    tensor ``pred`` is read on the host (one synchronizing read)."""
    return switch(int(bool(pred)), (false_fn, true_fn), *operands)


def while_loop(cond_fun, body_fun, init_val):
    """``jax.lax.while_loop`` for eager torch: ``val = body_fun(val)``
    while ``cond_fun(val)`` (a tensor result is read on the host, one
    synchronizing read per test).

    Under :func:`offload` the body's sites are ``while{i}/dot{j}`` and
    the predicate's ``while{i}/cond/dot{j}``, shared by every iteration,
    each with the enclosing ``mult`` (the trip count is not static); the
    hook fires once per real execution.  A body that never runs is run
    once in report mode, so its sites are listed, as the reference's.
    """
    mode = _active()
    if mode is None:
        val = init_val
        while bool(cond_fun(val)):
            val = body_fun(val)
        return val
    return mode.run_while(cond_fun, body_fun, init_val)


class _Meshes:
    """The meshes of the :func:`spmd_scope` blocks running in this
    process, innermost last.  Process-wide, not per thread: a backward
    site runs on autograd's device thread and reads it there too."""

    def __init__(self):
        self.stack: list = []


_MESHES = _Meshes()


@contextlib.contextmanager
def spmd_scope(mesh):
    """Run the block as this rank's part of one SPMD program over
    ``mesh`` (a :class:`repro_torch.shard.Mesh`): the port's
    ``shard_map`` body.

    Under :func:`offload` or :func:`site_report` the block is a
    ``shmap{i}/`` scope on the flow counter ``scan``, ``cond`` and
    ``while`` share, and every site inside records ``mesh.spmd_axes``
    (``Site.spmd``, ``Site.flops`` times the mesh's size, ``[dp=2,tp=1]``
    in its ``repr``).  A gradient pass inside the block names its
    cotangents in the block, as ``value_and_grad`` inside a
    ``shard_map`` body does.  Collectives are no sites.  Anywhere, the
    block binds the mesh's axis names for
    :mod:`repro_torch.shard.collectives` (:func:`spmd_mesh`).
    """
    mode = _active()
    _MESHES.stack.append(mesh)
    try:
        if mode is None:
            yield mesh
        else:
            with mode.spmd(mesh):
                yield mesh
    finally:
        _MESHES.stack.pop()


def spmd_mesh():
    """The mesh of the innermost :func:`spmd_scope` running, or None."""
    return _MESHES.stack[-1] if _MESHES.stack else None


class _Call:
    """One caught call: its matmul operands, their lowering (``dims``,
    None for ``jnp.matmul``'s) and how to finish it, or an einsum's
    equation and operands."""

    def __init__(self, lhs, rhs, finish=None, equation=None,
                 operands=(), dims=None):
        self.lhs, self.rhs = lhs, rhs
        self.finish = finish or (lambda prod: prod)
        self.equation = equation    # set for an einsum
        self.operands = operands
        self.dims = dims


def _addmm_finish(inp, beta, alpha, inplace=False):
    """``beta * inp + alpha * prod``, written into ``inp`` for the
    in-place forms.  At ``beta == 0`` ``inp`` is not read, as torch
    does: NaN and Inf in it do not reach the result."""
    def finish(prod):
        if beta == 0:
            out = prod if alpha == 1 else alpha * prod
        elif beta == 1 and alpha == 1:
            out = prod + inp
        else:
            out = beta * inp + alpha * prod
        return inp.copy_(out) if inplace else out
    return finish


def _conj(x):
    """``jnp.conj`` as ``jnp.vdot`` applies it: complex operands only."""
    return torch.conj_physical(x) if x.is_complex() else x


def _tensordot_dims(a, b, dims) -> _DotGeneralDims | None:
    """``jnp.tensordot``'s dimension numbers for torch's ``dims``: an
    int contracts ``a``'s last axes with ``b``'s first, a pair of ints
    or of sequences names them."""
    if isinstance(dims, torch.Tensor):
        dims = dims.tolist()
    if isinstance(dims, int):
        lc, rc = range(a.ndim - dims, a.ndim), range(dims)
    elif isinstance(dims, (list, tuple)) and len(dims) == 2:
        lc, rc = ([d] if isinstance(d, int) else list(d) for d in dims)
        if len(lc) != len(rc):
            return None
    else:
        return None
    lc = tuple(d % a.ndim for d in lc)
    rc = tuple(d % b.ndim for d in rc)
    return _DotGeneralDims(a.shape, b.shape, (lc, rc))


def _vecdot_call(x, y, dim) -> _Call:
    """``jnp.linalg.vecdot``: the vector axis moved last, ``x``
    conjugated, and ``jnp.vectorize``'s batching of ``vdot``: size-1
    loop axes squeezed, a loop axis both operands have a batch axis of
    the ``dot_general``, one only one has a free axis of that operand,
    the output in the broadcast loop order."""
    x, y = _conj(x.movedim(dim, -1)), y.movedim(dim, -1)
    xl, yl = tuple(x.shape[:-1]), tuple(y.shape[:-1])
    shape = torch.broadcast_shapes(xl, yl)
    fill = len(shape)
    xs = (1,) * (fill - len(xl)) + xl
    ys = (1,) * (fill - len(yl)) + yl
    x = x.reshape(tuple(d for d in xl if d != 1) + x.shape[-1:])
    y = y.reshape(tuple(d for d in yl if d != 1) + y.shape[-1:])

    def axis(sizes, p):   # position p's axis in the squeezed operand
        return sum(1 for q in range(p) if sizes[q] != 1)

    batch = [p for p in range(fill) if xs[p] != 1 and ys[p] != 1]
    lfree = [p for p in range(fill) if xs[p] != 1 and ys[p] == 1]
    rfree = [p for p in range(fill) if xs[p] == 1 and ys[p] != 1]
    order = batch + lfree + rfree
    dims = _DotGeneralDims(
        x.shape, y.shape, ((x.ndim - 1,), (y.ndim - 1,)),
        (tuple(axis(xs, p) for p in batch),
         tuple(axis(ys, p) for p in batch)),
        out_perm=sorted(range(len(order)), key=order.__getitem__),
        out_shape=shape)
    return _Call(x, y, dims=dims)


def _chain_call(mats) -> _Call | None:
    """``jnp.linalg.multi_dot``: one einsum over the chain, a 1-D first
    or last operand keeping only its inner index, so the order is
    ``jnp.einsum``'s."""
    if len(mats) < 2 or not all(isinstance(t, torch.Tensor) for t in mats):
        return None
    axes = [[i, i + 1] for i in range(len(mats))]
    if mats[0].ndim == 1:
        axes[0] = axes[0][1:]
    if mats[-1].ndim == 1:
        axes[-1] = axes[-1][:1]
    labels = sorted({i for ax in axes for i in ax})
    sym = {i: _symbol(n) for n, i in enumerate(labels)}
    names = ["".join(sym[i] for i in ax) for ax in axes]
    joined = "".join(names)
    out = "".join(sorted(c for c in set(joined) if joined.count(c) == 1))
    return _Call(None, None, equation=",".join(names) + "->" + out,
                 operands=tuple(mats))


#: torch's matmul entry points whose ``jnp`` counterpart is
#: ``jnp.matmul``: two operands, no options.
_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
            torch.linalg.matmul, torch.mm, torch.Tensor.mm, torch.bmm,
            torch.Tensor.bmm, torch.mv, torch.Tensor.mv, torch.dot,
            torch.Tensor.dot)
#: ``input + mat1 @ mat2`` forms: (function, in place, lowered as
#: ``addbmm``'s einsum).
_ADDS = {torch.addmm: False, torch.Tensor.addmm: False,
         torch.Tensor.addmm_: True, torch.addmv: False,
         torch.Tensor.addmv: False, torch.Tensor.addmv_: True,
         torch.baddbmm: False, torch.Tensor.baddbmm: False,
         torch.Tensor.baddbmm_: True, torch.addbmm: False,
         torch.Tensor.addbmm: False, torch.Tensor.addbmm_: True}
_ADDBMMS = (torch.addbmm, torch.Tensor.addbmm, torch.Tensor.addbmm_)


def _parse_call(func, args, kwargs):
    """The matmul operands of a caught call, or None to run it natively."""
    if kwargs.get("out") is not None:
        return None
    kwargs = {key: val for key, val in kwargs.items() if key != "out"}
    if func is torch.einsum:
        if kwargs or not args or not isinstance(args[0], str):
            return None
        ops_ = args[1:]
        if len(ops_) == 1 and isinstance(ops_[0], (list, tuple)):
            ops_ = tuple(ops_[0])
        if len(ops_) < 2:
            return None
        return _Call(None, None, equation=args[0], operands=ops_)
    if func in _MATMULS:
        if len(args) != 2 or kwargs:
            return None
        return _Call(args[0], args[1])
    if func is torch.Tensor.__rmatmul__:
        return _Call(args[1], args[0]) if len(args) == 2 else None
    if func in (torch.vdot, torch.Tensor.vdot):
        if len(args) != 2 or kwargs:
            return None
        return _Call(_conj(args[0]).reshape(-1), args[1].reshape(-1))
    if func in (torch.inner, torch.Tensor.inner):
        if len(args) != 2 or kwargs or min(args[0].ndim, args[1].ndim) < 1:
            return None
        a, b = args
        return _Call(a, b, dims=_DotGeneralDims(
            a.shape, b.shape, ((a.ndim - 1,), (b.ndim - 1,))))
    if func is torch.tensordot:
        if len(args) < 2 or set(kwargs) - {"dims"}:
            return None
        a, b = args[:2]
        dims = _tensordot_dims(a, b, args[2] if len(args) > 2
                               else kwargs.get("dims", 2))
        return None if dims is None else _Call(a, b, dims=dims)
    if func is torch.linalg.vecdot:
        if len(args) != 2 or set(kwargs) - {"dim"}:
            return None
        return _vecdot_call(*args, kwargs.get("dim", -1))
    if func is torch.linalg.multi_dot:
        if len(args) != 1 or kwargs:
            return None
        return _chain_call(list(args[0]))
    if func is torch.chain_matmul:
        mats = list(args[0]) if len(args) == 1 and isinstance(
            args[0], (list, tuple)) else list(args)
        return None if kwargs else _chain_call(mats)
    if func in _ADDS:
        if len(args) != 3 or set(kwargs) - {"beta", "alpha"}:
            return None
        inp, m1, m2 = args
        finish = _addmm_finish(inp, kwargs.get("beta", 1),
                               kwargs.get("alpha", 1), _ADDS[func])
        dims = (_EinsumDims("bij,bjk->ik", m1.shape, m2.shape)
                if func in _ADDBMMS else None)
        return _Call(m1, m2, finish, dims=dims)
    if func is F.linear:
        inp = args[0] if args else kwargs.get("input")
        weight = args[1] if len(args) > 1 else kwargs.get("weight")
        bias = args[2] if len(args) > 2 else kwargs.get("bias")
        if weight is None or weight.ndim != 2:
            return None
        finish = None if bias is None else (lambda prod: prod + bias)
        return _Call(inp, weight.t(), finish)
    return None


def _tile_choice(backend_spec: str, m, k, n, splits, dtype):
    """Tile pick for kernel-family sites (None otherwise)."""
    if not backend_spec.startswith("pallas_int8"):
        return None
    from ..kernels import tile_model

    return tile_model.select_tiles(
        m, k, n, splits, dtype=dtype,
        fused=backend_spec.endswith(":fused")).summary()


def _classify(dims, dtype, policy: PrecisionPolicy, name: str,
              mult: int = 1, spmd_axes=()) -> Site:
    """Decide whether one matmul site gets offloaded."""
    m, k, n = dims.M, dims.K, dims.N
    geom = dict(m=m, k=k, n=n, batch=dims.B, mult=mult, spmd_axes=spmd_axes)

    def skip(reason, eligible=False, backend=""):
        return Site(name, dims.lhs_shape, dims.rhs_shape, dtype, False, 0,
                    reason, eligible=eligible, backend=backend, **geom)

    if not (dtype.is_floating_point or dtype.is_complex):
        return skip(f"dtype {_dtype_name(dtype)}")
    if min(m, k, n) < policy.min_dim:
        return skip(f"min(m,k,n)={min(m, k, n)} < min_dim={policy.min_dim}")
    backend = policy.backend_for(name)
    if backend == "dgemm":
        return skip("demoted to dgemm", eligible=True, backend=backend)
    splits = policy.splits_for(name)
    return Site(name, dims.lhs_shape, dims.rhs_shape, dtype, True, splits,
                "", eligible=True, backend=backend,
                tiles=_tile_choice(backend, m, k, n, splits, dtype), **geom)


def _check_overrides(policy: PrecisionPolicy, sites) -> None:
    """Surface ``site_splits``/``site_backends`` keys that match nothing."""
    mode = policy.on_unmatched_site
    if mode == "ignore" or not (policy.site_splits
                                or policy.site_backends):
        return
    if mode not in ("warn", "raise"):
        raise ValueError(
            f"on_unmatched_site must be 'warn', 'raise' or 'ignore', "
            f"got {mode!r}")
    names = [s.name for s in sites]
    unmatched = policy.unmatched_overrides(names)
    if not unmatched:
        return
    msg = (f"per-site override keys {unmatched} match no matmul site in "
           f"the traced function (sites: {sorted(names)}); they would "
           "silently have no effect")
    if mode == "raise":
        raise ValueError(msg)
    warnings.warn(msg, stacklevel=3)


def _batched(engine: GemmBackend, site: Site):
    """Run the 2-D ``engine`` over the merged batch axis of (B, ., .)."""
    def run(a3, b3, out_dtype):
        outs = [engine(a3[i], b3[i], out_dtype=out_dtype,
                       num_splits=site.splits, site=site.name)
                for i in range(a3.shape[0])]
        return torch.stack(outs)
    return run


def _postorder(roots) -> list:
    """The autograd nodes reachable from ``roots``, each after the
    nodes it leads to (its ``next_functions``)."""
    seen, order = set(), []
    stack = [(node, False) for node in roots]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
        elif node not in seen:
            seen.add(node)
            stack.append((node, True))
            stack.extend((nxt, False) for nxt, _ in node.next_functions
                         if nxt is not None and nxt not in seen)
    return order


#: The calls that start a gradient pass.
_GRAD_ENTRIES = (torch.autograd.grad, torch.autograd.backward,
                 torch.Tensor.backward)


def _grad_targets(func, args, kwargs):
    """(outputs, inputs) of a gradient call; inputs None for all leaves."""
    def seq(x):
        return None if x is None else (
            [x] if isinstance(x, torch.Tensor) else list(x))

    if func is torch.autograd.grad:
        outputs = args[0] if args else kwargs["outputs"]
        inputs = args[1] if len(args) > 1 else kwargs["inputs"]
    elif func is torch.autograd.backward:
        outputs = args[0] if args else kwargs["tensors"]
        inputs = kwargs.get("inputs", args[5] if len(args) > 5 else None)
    else:   # Tensor.backward(self, gradient, retain_graph, create_graph,
        outputs = args[0]   # inputs)
        inputs = kwargs.get("inputs", args[4] if len(args) > 4 else None)
    return seq(outputs), seq(inputs)


def _native(a3, b3, out_dtype):
    """A product that stays native (``out_dtype`` is its operands')."""
    return torch.matmul(a3, b3)


class _Dims:
    """The extents and operand shapes of one backward product."""

    def __init__(self, M, K, N, B, lhs_shape, rhs_shape):
        self.M, self.K, self.N, self.B = M, K, N, B
        self.lhs_shape, self.rhs_shape = tuple(lhs_shape), tuple(rhs_shape)


class _Product:
    """A forward product that takes a gradient: what its backward sites
    are made of, and which of its operands need a cotangent."""

    def __init__(self, dims, out_shape, dtype, mult, spmd_axes, needs):
        self.dims, self.out_shape = dims, tuple(out_shape)
        self.dtype, self.mult = dtype, mult
        self.spmd_axes = spmd_axes
        self.needs_lhs, self.needs_rhs = needs

    def cotangent(self, which: str) -> _Dims:
        """The rhs cotangent ``(g^T @ lhs)^T`` is the site (n, m, k),
        the lhs cotangent ``g @ rhs^T`` the site (m, n, k)."""
        d = self.dims
        if which == "rhs":
            return _Dims(d.N, d.M, d.K, d.B, self.out_shape, d.lhs_shape)
        return _Dims(d.M, d.N, d.K, d.B, self.out_shape, d.rhs_shape)


class _SiteMatmul(torch.autograd.Function):
    """Backend-routed product with the emulated backward.

    A gradient taken while ``fn`` runs (``torch.autograd.grad`` inside
    the offloaded function, as a train step takes it) computes each
    cotangent as a site of its own (:meth:`_OffloadMode.backward_sites`:
    its own name, gates, split count, backend and engine state); the
    rhs cotangent as ``(g^T @ lhs)^T``, the reference's orientation.  A
    gradient taken after ``fn`` returned runs both cotangents through
    the forward site's own engine and split count, as the reference's
    ``custom_vjp`` does.
    """

    @staticmethod
    def forward(ctx, a3, b3, run, out_dtype, mode, key):
        ctx.run, ctx.mode, ctx.key = run, mode, key
        ctx.save_for_backward(a3, b3)
        return run(a3, b3, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a3, b3 = ctx.saved_tensors
        need_l, need_r = ctx.needs_input_grad[:2]
        dl = dr = None
        # The backward's own products are never caught as new sites.
        with torch._C.DisableTorchFunction():
            mode = ctx.mode
            if mode.running:
                prefix, j = ctx.key
                sites = mode.backward_sites(prefix)
                # A cotangent the pass does not take has no site (its
                # operand leads to none of the pass's inputs).
                site_r, site_l = sites.get((j, "rhs")), sites.get((j, "lhs"))
                if need_r and site_r is not None:
                    dr = mode.run_site(site_r, g.transpose(1, 2), a3,
                                       b3.dtype).transpose(1, 2)
                if need_l and site_l is not None:
                    dl = mode.run_site(site_l, g, b3.transpose(1, 2),
                                       a3.dtype)
            else:
                if need_l:
                    dl = ctx.run(g, b3.transpose(1, 2), a3.dtype)
                if need_r:
                    dr = ctx.run(a3.transpose(1, 2), g, b3.dtype)
        return dl, dr, None, None, None, None


#: The frame of ``Function.apply``: a product under it, inside ``fn``,
#: is in a user ``autograd.Function``'s forward.
_FUNCTION_APPLY = torch.autograd.Function.apply.__func__.__code__


def _same_product(site: Site, dims, dtype, mult, spmd_axes) -> bool:
    """Whether ``site``'s record is the decision for this product."""
    return ((site.lhs_shape, site.rhs_shape, site.m, site.k, site.n,
             site.batch, site.mult, site.dtype, site.spmd_axes)
            == (tuple(dims.lhs_shape), tuple(dims.rhs_shape), dims.M,
                dims.K, dims.N, dims.B, mult, dtype, tuple(spmd_axes)))


class _Entry:
    """One signature's decisions: its sites in order, by name, and the
    branch and loop-body prefixes they cover (taken or not)."""

    __slots__ = ("sites", "by_name", "branches")

    def __init__(self, sites, branches):
        self.sites = sites
        self.by_name = {site.name: site for site in sites}
        self.branches = frozenset(branches)


class _OffloadMode(TorchFunctionMode):
    """Catches matmul calls, names them ``dot{i}``, routes the offloaded.

    ``known`` is the decision cache's entry for the call's signature:
    a product whose record it holds takes that decision, and a branch
    that does not run takes its sites from it.  ``stale`` is set when
    the call meets what the entry does not describe.
    """

    def __init__(self, policy: PrecisionPolicy, engine_for, execute: bool,
                 authoritative: bool = False, on_site_event=None,
                 known: _Entry | None = None):
        super().__init__()
        self.policy = policy
        self.on_site_event = on_site_event
        # Per site name: the hook's payload, built when it is decided.
        self.payloads: Dict[str, dict] = {}
        self.engine_for = engine_for
        self.execute = execute
        # The engine runs every eligible site, demoted ones too.
        self.authoritative = authoritative
        self.known = known
        self.stale = False
        self.sites: List[Site] = []
        # This call's decisions by name, and the branch and loop-body
        # prefixes they cover.
        self.decided: Dict[str, Site] = {}
        self.branches: set = set()
        self.scopes = [_Scope()]
        self.running = False
        self.frame = None
        # Program order of the recorded products and flows (a counter),
        # which orders each gradient pass's cotangent sites as the
        # reference's transposed program lists them.
        self.seq = 0
        self.prod_seq: Dict[tuple, int] = {}
        self.flow_seq: Dict[str, int] = {}
        self.sort_keys: Dict[str, tuple] = {}
        self.pass_no = 0
        # Per cond (its cond{i}/ prefix): the branches that did not run,
        # and the autograd nodes of their report-mode outputs.
        self.untaken_of: Dict[str, List[int]] = {}
        self.untaken_roots: list = []
        # Per forward scope prefix: its products that take a gradient
        # (by dot index), the backward scope their cotangents are named
        # in, and those cotangents' sites keyed (dot index, operand).
        self.products: Dict[str, List[_Product | None]] = {}
        self.backward_scopes: Dict[str, _Scope] = {"": self.scopes[0]}
        self.backward: Dict[str, Dict[tuple, Site]] = {}
        # Per product key (scope prefix, dot index): the autograd nodes of
        # each of its runs (output, packed lhs and rhs operand edges), and
        # for the current gradient pass the (lhs, rhs) cotangents it
        # takes, by product key (None: every product, forward needs).
        self.nodes: Dict[tuple, list] = {}
        self.pass_needs: Dict[tuple, tuple] | None = None

    def run(self, fn, args, kwargs):
        """``fn(*args, **kwargs)`` under this mode, as the innermost
        scope owner of :func:`scan`, :func:`switch` and
        :func:`while_loop`."""
        _ACTIVE.modes.append(self)
        self.running = True
        self.frame = sys._getframe()
        try:
            with self:
                return fn(*args, **kwargs)
        finally:
            self.running = False
            self.frame = None
            # The graph's nodes are not kept past fn.
            self.nodes.clear()
            self.untaken_roots.clear()
            _ACTIVE.modes.pop()

    def decisions(self) -> List[Site]:
        """This call's sites in the reference's order: discovery order,
        with each gradient pass's cotangent sites in reverse program
        order, a ``cond``'s branches in turn."""
        out, run = [], []
        for site in self.sites + [None]:
            key = None if site is None else self.sort_keys.get(site.name)
            if key is not None:
                run.append((key, len(run), site))
                continue
            out.extend(s for _, _, s in sorted(run))
            run = []
            if site is not None:
                out.append(site)
        return out

    def matches(self, entry: _Entry) -> bool:
        """Whether this call met exactly what ``entry`` describes."""
        return (not self.stale
                and {s.name for s in self.sites} == set(entry.by_name))

    # -- control-flow scopes ------------------------------------------

    def _next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def open_flow(self, kind: str) -> str:
        """Number a new scan, while or cond of the innermost scope."""
        parent = self.scopes[-1]
        prefix = f"{parent.prefix}{kind}{parent.flows}/"
        parent.flows += 1
        if parent.record:
            self.flow_seq.setdefault(prefix, self._next_seq())
        return prefix

    @contextlib.contextmanager
    def within(self, scope: _Scope):
        self.scopes.append(scope)
        try:
            yield scope
        finally:
            self.scopes.pop()

    def spmd(self, mesh):
        """The scope of an :func:`spmd_scope` body: ``shmap{i}/`` on the
        flow counter, every site inside carrying the mesh's axes."""
        parent = self.scopes[-1]
        return self.within(_Scope(
            self.open_flow("shmap"), parent.mult, parent.record,
            parent.spmd_axes + tuple(mesh.spmd_axes), spmd_body=True))

    def run_switch(self, index: int, branches, operands):
        """One ``cond``/``switch``: branch ``index`` runs, every other is
        recorded (:meth:`not_run`), and under grad its outputs name the
        cond's backward scope when their gradient arrives."""
        parent = self.scopes[-1]
        group = self.open_flow("cond")
        out = None
        for b, branch in enumerate(branches):
            scope = _Scope(f"{group}br{b}/", parent.mult, parent.record,
                           parent.spmd_axes)
            if b == index:
                with self.within(scope):
                    out = branch(*operands)
            elif parent.record:
                self.not_run(scope, branch, operands)
            if parent.record:
                self.branches.add(scope.prefix)
        if parent.record:
            self.untaken_of[group] = [b for b in range(len(branches))
                                      if b != index]
        if not torch.is_grad_enabled():
            return out
        taken = f"{group}br{index}/"

        def named(t):
            if not (isinstance(t, torch.Tensor) and t.requires_grad):
                return t
            with torch._C.DisableTorchFunction():
                t = t.view_as(t)   # a tensor of this call's, not fn's
            t.register_hook(self._names_backward_scope(taken))
            return t
        return tree_map(named, out)

    def run_while(self, cond_fun, body_fun, val):
        parent = self.scopes[-1]
        prefix = self.open_flow("while")
        test = _Scope(prefix + "cond/", parent.mult, parent.record,
                      parent.spmd_axes)
        body = _Scope(prefix, parent.mult, parent.record, parent.spmd_axes)
        ran = False
        while True:
            test.dots = test.flows = 0
            with self.within(test):
                go = bool(cond_fun(val))
            test.record = False
            if not go:
                break
            body.dots = body.flows = 0
            with self.within(body):
                val = body_fun(val)
            body.record = False
            ran = True
        if parent.record:
            if not ran:
                with torch.no_grad():
                    self.not_run(body, body_fun, (val,))
            self.branches.add(prefix)
        return val

    def not_run(self, scope: _Scope, fn, args) -> None:
        """Record the sites of a branch or loop body that does not run:
        from the cache's entry when it covers them, else by running
        ``fn`` natively in report mode (no engine, no hook)."""
        if self.known is not None and scope.prefix in self.known.branches:
            self._copy_known(scope.prefix)
            return
        if self.known is not None:
            self.stale = True
        execute, self.execute = self.execute, False
        try:
            with self.within(scope):
                out = fn(*args)
        finally:
            self.execute = execute
        if torch.is_grad_enabled():
            self.untaken_roots += [
                t.grad_fn for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.grad_fn is not None]

    def _copy_known(self, prefix: str) -> None:
        """Take the entry's sites under ``prefix`` as this call's."""
        for site in self.known.sites:
            if site.name.startswith(prefix) and site.name not in self.decided:
                self.decided[site.name] = site
                self.sites.append(site)
                self._note_payload(site)
        self.branches.add(prefix)

    def _in_function(self) -> bool:
        """Whether the caught call is inside a user ``autograd.Function``'s
        forward, which runs with grad disabled: ``Function.apply`` on
        the stack between here and :meth:`run`."""
        if torch.is_grad_enabled():
            return False
        frame = sys._getframe(2)
        while frame is not None and frame is not self.frame:
            if frame.f_code is _FUNCTION_APPLY:
                return True
            frame = frame.f_back
        return False

    # -- decisions ----------------------------------------------------

    def _decide(self, name: str, dims, dtype, mult, spmd_axes) -> Site:
        """The decision for one product: this call's or the entry's
        record under ``name`` when it describes the same product, else
        the gates and the tile pick."""
        site = self.decided.get(name)
        if site is None and self.known is not None:
            site = self.known.by_name.get(name)
        if site is None or not _same_product(site, dims, dtype, mult,
                                             spmd_axes):
            if self.known is not None:
                self.stale = True
            site = _classify(dims, dtype, self.policy, name, mult,
                             spmd_axes)
        self.decided[name] = site
        return site

    # -- gradient passes ----------------------------------------------

    def start_pass(self, outputs, inputs) -> None:
        """A gradient pass inside ``fn`` begins (``torch.autograd.grad``
        or ``backward``): name its cotangents afresh, as the reference's
        next ``jax.grad`` does, for the products it reaches.

        A product takes part when its output's node is reachable from
        the pass's ``outputs`` (or from a ``cond`` branch that did not
        run, whose cotangents the reference's transposed ``cond`` takes
        too); an operand's cotangent is taken when its gradient edge
        leads to one of ``inputs`` (to any leaf when ``inputs`` is
        None), which is what autograd executes.
        """
        order = _postorder([t.grad_fn for t in outputs
                            if t.grad_fn is not None] + self.untaken_roots)
        reach = set(order)
        if inputs is None:
            useful = {n for n in order
                      if type(n).__name__ == "AccumulateGrad"}
        else:
            useful = {get_gradient_edge(t).node for t in inputs}
        for node in order:   # children first
            if any(nxt in useful for nxt, _ in node.next_functions):
                useful.add(node)
        needs = {}
        for key, runs in self.nodes.items():
            for out, lhs, rhs in runs:
                if out in reach:
                    old = needs.get(key, (False, False))
                    needs[key] = (old[0] or lhs in useful,
                                  old[1] or rhs in useful)
        self.pass_needs = needs
        self.pass_no += 1
        self.backward_scopes = {s.prefix: s for s in self.scopes
                                if s is self.scopes[0] or s.spmd_body}
        self.backward = {}

    def _note_product(self, prefix, j, dims, out_shape, dtype, mult,
                      spmd_axes, needs, nodes):
        """Record forward dot ``j`` of scope ``prefix`` as taking a
        gradient (an operand needs one on some iteration), and this
        run's autograd ``nodes``."""
        self.nodes.setdefault((prefix, j), []).append(nodes)
        found = self.products.setdefault(prefix, [])
        found.extend([None] * (j + 1 - len(found)))
        if found[j] is None:
            found[j] = _Product(dims, out_shape, dtype, mult, spmd_axes,
                                needs)
        else:
            found[j].needs_lhs |= needs[0]
            found[j].needs_rhs |= needs[1]

    def _backward_scope(self, prefix: str) -> _Scope:
        """The scope the cotangents of forward scope ``prefix`` are named
        in: the top level for the top level; a scan, while or cond is a
        new flow of its parent's backward scope, numbered by its flow
        counter, and a cond's branch ``b`` is ``br{b}/`` under it."""
        scope = self.backward_scopes.get(prefix)
        if scope is not None:
            return scope
        head, _, last = prefix[:-1].rpartition("/")
        parent = self._backward_scope(head + "/" if head else "")
        if last.startswith("br") or last == "cond":
            scope = _Scope(f"{parent.prefix}{last}/")
        else:
            kind = last.rstrip("0123456789")
            scope = _Scope(f"{parent.prefix}{kind}{parent.flows}/")
            parent.flows += 1
        self.backward_scopes[prefix] = scope
        if last.startswith("br"):
            self.branches.add(scope.prefix)
        elif last.startswith("cond") and last != "cond":
            self._untaken_cotangents(prefix, scope)
        return scope

    def _untaken_cotangents(self, group: str, scope: _Scope) -> None:
        """The cotangent sites of a cond's branches that did not run, as
        its backward begins: the entry's when it covers them, else made
        from the branch's report-mode products."""
        for b in self.untaken_of.get(group, ()):
            bwd = f"{scope.prefix}br{b}/"
            if self.known is not None and bwd in self.known.branches:
                self._copy_known(bwd)
                continue
            if self.known is not None:
                self.stale = True
            self.backward_sites(f"{group}br{b}/")

    def _sort_key(self, prefix: str, j: int, which: str) -> tuple:
        """Where the cotangent site of forward dot ``j`` of ``prefix``
        stands in its pass: reverse program order at every level, a
        cond's branches in turn, the rhs cotangent first."""
        key, path = [], ""
        for part in prefix.split("/")[:-1]:
            path += part + "/"
            key.append(int(part[2:]) if part.startswith("br")
                       else -self.flow_seq.get(path, 0))
        key += [-self.prod_seq.get((prefix, j), 0), which == "lhs"]
        return self.pass_no, tuple(key)

    def backward_sites(self, prefix: str) -> Dict[tuple, Site]:
        """The cotangent sites of forward scope ``prefix``, made and
        recorded when its backward first runs.

        The reference's names for a ``value_and_grad`` program: the
        forward products in reverse order, each contributing its rhs
        cotangent (n, m, k) and then its lhs cotangent (m, n, k) where
        the pass takes it (:meth:`start_pass`), numbered on from the
        backward scope's dot counter (the top level's continues after
        its forward dots).  Each goes through the same gates as any
        site.
        """
        found = self.backward.get(prefix)
        if found is not None:
            return found
        scope = self._backward_scope(prefix)
        found = {}
        products = self.products.get(prefix, [])
        for j in reversed(range(len(products))):
            prod = products[j]
            if prod is None:
                continue
            needs = ((prod.needs_lhs, prod.needs_rhs)
                     if self.pass_needs is None
                     else self.pass_needs.get((prefix, j), (False, False)))
            for which, needed in (("rhs", needs[1]), ("lhs", needs[0])):
                if not needed:
                    continue
                site = self._decide(f"{scope.prefix}dot{scope.dots}",
                                    prod.cotangent(which), prod.dtype,
                                    prod.mult, prod.spmd_axes)
                scope.dots += 1
                self.sites.append(site)
                self.sort_keys[site.name] = self._sort_key(prefix, j, which)
                self._note_payload(site)
                found[(j, which)] = site
        self.backward[prefix] = found
        return found

    def _names_backward_scope(self, prefix: str):
        """A gradient hook that names ``prefix``'s backward scope when
        the gradient reaches it (a product that runs natively, or a
        cond's output): a backward inside ``fn`` then makes (and
        records) its cotangent sites."""
        def hook(grad):
            if self.running:
                with torch._C.DisableTorchFunction():
                    if prefix in self.products:
                        self.backward_sites(prefix)
                    else:
                        self._backward_scope(prefix)
        return hook

    # -- execution ----------------------------------------------------

    def _engine_runs(self, site: Site) -> bool:
        return site.offloaded or (self.authoritative and site.eligible)

    def _note_payload(self, site: Site) -> None:
        """Build the hook's payload for a newly decided site."""
        if (self.on_site_event is not None and site.offloaded
                and site.name not in self.payloads):
            self.payloads[site.name] = _hook_payload(site,
                                                     self.policy.backend)

    def _fire(self, site: Site) -> None:
        """One execution of an offloaded site: call the hook."""
        if self.on_site_event is not None and site.offloaded:
            self._note_payload(site)   # a site no earlier run recorded
            self.on_site_event(dict(self.payloads[site.name]))

    def run_site(self, site: Site, a3, b3, out_dtype):
        """One batched product through ``site``'s engine, or natively.

        A cotangent site is recorded from its product's first run.  A
        loop whose iterations give the product other extents (an
        expert's routed tokens differ from layer to layer) has the
        product of this run decided afresh on its own extents, as the
        forward product was, so the gates read what runs."""
        B, M, K = a3.shape
        N = b3.shape[2]
        if (site.m, site.k, site.n, max(site.batch, 1)) != (M, K, N, B):
            site = _classify(_Dims(M, K, N, B, a3.shape, b3.shape),
                             site.dtype, self.policy, site.name, site.mult,
                             site.spmd_axes)
        if self._engine_runs(site):
            with span("offload.site"):
                self._fire(site)
                return _batched(self.engine_for(site), site)(a3, b3,
                                                             out_dtype)
        return _native(a3, b3, out_dtype)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _GRAD_ENTRIES and self.running:
            self.start_pass(*_grad_targets(func, args, kwargs))
            return func(*args, **kwargs)
        call = _parse_call(func, args, kwargs)
        if call is None or self._in_function():
            return func(*args, **kwargs)
        if call.equation is not None:
            return self._einsum(call.equation, call.operands)
        return self._product(call.lhs, call.rhs, call.dims or _MatmulDims(
            call.lhs.shape, call.rhs.shape), call.finish,
            lambda: func(*args, **kwargs))

    def _einsum(self, equation: str, operands):
        """An einsum as ``jnp.einsum`` runs it: pairwise contractions,
        each a site."""
        ops = list(operands)
        for inds, eq in _einsum_steps(equation, [op.shape for op in ops]):
            high, low = ops.pop(inds[0]), ops.pop(inds[1])
            ops.append(self._product(
                low, high, _EinsumDims(eq, low.shape, high.shape), None,
                lambda low=low, high=high, eq=eq: torch.einsum(eq, low,
                                                               high)))
        return ops[0]

    def _product(self, lhs, rhs, dims, finish, native):
        """One site: decide it, run it through its engine or natively
        (``native()``), and note what its backward needs."""
        finish = finish or (lambda prod: prod)
        dtype = torch.promote_types(lhs.dtype, rhs.dtype)
        scope = self.scopes[-1]
        j = scope.dots
        scope.dots += 1
        site = self._decide(f"{scope.prefix}dot{j}", dims, dtype,
                            scope.mult, scope.spmd_axes)
        if scope.record:
            self.sites.append(site)
            self._note_payload(site)
            self.prod_seq.setdefault((scope.prefix, j), self._next_seq())
        grad = torch.is_grad_enabled()
        needs = (grad and lhs.requires_grad, grad and rhs.requires_grad)
        # In the packed operands' order, which the cotangent sites and
        # _SiteMatmul's needs_input_grad follow.
        if dims.swap:
            needs = needs[::-1]
        # A site demoted to dgemm may have cotangents that are not.
        engine = self._engine_runs(site)
        routed = self.execute and (engine or (
            any(needs) and site.backend == "dgemm"))
        if routed:
            # An execution through the engine is one offload.site span;
            # a dgemm site routed for its cotangents is none.
            with span("offload.site") if engine else contextlib.nullcontext():
                run = (_batched(self.engine_for(site), site) if engine
                       else _native)
                if engine:
                    self._fire(site)
                a3, b3 = dims.pack(lhs, rhs)
                y3 = _SiteMatmul.apply(a3, b3, run, dtype, self,
                                       (scope.prefix, j))
                node = y3.grad_fn
                y = dims.unpack(y3)
                out = finish(y)
        else:
            out = y = native()
            node = y.grad_fn
            if any(needs):
                y.register_hook(self._names_backward_scope(scope.prefix))
        if any(needs):
            edges = [get_gradient_edge(x).node if x.requires_grad else None
                     for x in (lhs, rhs)]
            if dims.swap:
                edges = edges[::-1]
            self._note_product(scope.prefix, j, dims, y.shape, dtype,
                               scope.mult, scope.spmd_axes, needs,
                               (node, *edges))
        return out


def offload(fn, policy: PrecisionPolicy | None = None, *,
            backend: GemmBackend | None = None, plan=None,
            plan_match: str = "strict", on_site_event=None,
            cache_size: int = OFFLOAD_CACHE_SIZE, persist_dir=None,
            fn_label: str | None = None, on_cache_event=None):
    """Wrap ``fn`` so its large matmuls run through the policy backend.

    Every call runs ``fn`` eagerly under the interception mode.  Sites
    on the policy's default spec share one backend instance (a stateful
    engine such as ``adaptive`` keeps its per-site cache across calls);
    a site routed to another spec by ``site_backends`` gets its own.
    The wrapper exposes ``wrapped.sites(*args, **kwargs)``: the
    :class:`Site` decisions for those inputs, the same records
    :func:`site_report` gives (from the cache when the signature is in
    it, which runs nothing; else from a native report-mode run, which
    fills the entry).

    Decisions are cached per input signature (module docstring), a
    ``cache_size``-bounded LRU: ``wrapped.cache_info()`` and
    ``wrapped.cache_clear()`` as the reference's.  ``persist_dir``
    keeps each entry's decisions on disk as ``<key>.json``, the
    reference's bytes under the reference's key (with the torch
    version); ``fn_label`` names the function in the key (default
    ``fn.__name__``: give lambdas a stable label), ``on_cache_event``
    is called with ``"miss"`` or ``"disk_decisions_hit"`` as entries
    resolve, and ``wrapped.persist_info()`` returns the tallies.  An
    eager program has no exported program to restore, so a restarted
    process decides afresh and checks the decisions against the file
    byte for byte (``disk_hits`` stays 0).

    ``backend`` injects the default engine instead of resolving
    ``policy.backend`` (the tuner's recording backend rides the same
    wrapper this way).  An engine whose ``intercepts_all_sites`` is true
    runs every *eligible* site, a demoted one too, whatever its spec;
    one with ``observe_sites`` is handed each call's decisions, a dict
    name -> :class:`Site` in discovery order, after the call.

    ``plan`` accepts a :class:`repro_torch.tune.PrecisionPlan`: with no
    ``policy`` its policy (``PrecisionPolicy.from_plan``) drives the
    offload.  With ``plan_match="strict"`` each new entry's site set is
    validated against the plan's fingerprint (``plan.validate_sites``),
    so a drifted program raises :class:`~repro_torch.tune.PlanStaleError`;
    an eager program is only known once it has run, so the error comes
    after the call, before its result is returned.  ``plan_match=
    "subset"`` applies the overlapping entries and ignores the rest
    (``on_unmatched_site="ignore"``), as a serve engine runs a
    train-calibrated plan.

    ``on_site_event`` is the telemetry hook (see the module docstring):
    a host callable given one payload dict per execution of an
    offloaded site, forward and backward —
    :meth:`repro_torch.obs.MetricsRun.site_event_handler` is one.  It
    fires on every call, cached or not.
    """
    if plan_match not in ("strict", "subset"):
        raise ValueError(f"plan_match must be 'strict' or 'subset', "
                         f"got {plan_match!r}")
    if cache_size < 1:
        raise ValueError(f"cache_size must be >= 1, got {cache_size}")
    if policy is None:
        policy = (PrecisionPolicy() if plan is None else
                  PrecisionPolicy.from_plan(
                      plan, **({"on_unmatched_site": "ignore"}
                               if plan_match == "subset" else {})))
    backend = backend or get_backend(policy.backend, policy=policy)
    engines: Dict[str, GemmBackend] = {policy.backend: backend}
    authoritative = getattr(backend, "intercepts_all_sites", False)
    observe = getattr(backend, "observe_sites", None)
    cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
    stats = {"hits": 0, "misses": 0}
    pstats = {"disk_hits": 0, "disk_decisions_hits": 0, "disk_misses": 0}
    disk = _DiskCache(persist_dir) if persist_dir is not None else None
    label = fn_label or getattr(fn, "__name__", "fn")

    def engine_for(site: Site) -> GemmBackend:
        if authoritative:
            return backend
        spec = site.backend or policy.backend
        if spec not in engines:
            engines[spec] = get_backend(spec, policy=policy)
        return engines[spec]

    def event(kind: str) -> None:
        if on_cache_event is not None:
            on_cache_event(kind)

    def persist(key, found: List[Site], replaced: bool) -> None:
        dkey = _persist_key(label, key, policy, plan,
                            on_site_event is not None)
        fresh = _sites_bytes(found)
        if replaced:
            disk.store(dkey, fresh)
            return
        raw = disk.load(dkey)
        if raw is not None:
            try:
                _sites_from_payload(json.loads(raw))
            except (ValueError, KeyError, TypeError, AttributeError) as exc:
                warnings.warn(f"persisted offload decisions {dkey}.json "
                              f"unreadable ({exc!r}); deciding afresh")
                raw = None
        if raw is None:
            pstats["disk_misses"] += 1
            event("miss")
            disk.store(dkey, fresh)
            return
        if raw != fresh:
            warnings.warn(f"persisted offload decisions {dkey}.json do "
                          "not match this process's; overwriting with "
                          "the fresh decisions")
            disk.store(dkey, fresh)
        pstats["disk_decisions_hits"] += 1
        event("disk_decisions_hit")

    def resolve(key, entry: _Entry | None, mode: _OffloadMode) -> List[Site]:
        """Count the call against the cache and return its decisions;
        a miss (or a stale entry) is checked, persisted and cached."""
        if entry is not None and mode.matches(entry):
            stats["hits"] += 1
            cache.move_to_end(key)
            return entry.sites
        if entry is not None:
            warnings.warn(
                f"offload({label}): the decisions cached for this input "
                "signature do not describe this call's products (a "
                "Python-level branch?); deciding afresh", stacklevel=3)
        stats["misses"] += 1
        found = mode.decisions()
        _check_overrides(policy, found)
        if plan is not None and plan_match == "strict":
            plan.validate_sites(found)
        if disk is not None:
            persist(key, found, replaced=entry is not None)
        cache[key] = _Entry(found, mode.branches)
        cache.move_to_end(key)
        while len(cache) > cache_size:
            cache.popitem(last=False)
        return found

    def wrapped(*args, **kwargs):
        key = _signature(args, kwargs, _spmd_key(fn))
        entry = cache.get(key)
        mode = _OffloadMode(policy, engine_for, execute=True,
                            authoritative=authoritative,
                            on_site_event=on_site_event, known=entry)
        out = mode.run(fn, args, kwargs)
        found = resolve(key, entry, mode)
        if observe is not None:
            observe({site.name: site for site in found})
        return out

    def sites(*args, **kwargs) -> List[Site]:
        key = _signature(args, kwargs, _spmd_key(fn))
        entry = cache.get(key)
        if entry is not None:
            stats["hits"] += 1
            cache.move_to_end(key)
            return entry.sites
        mode = _OffloadMode(policy, None, execute=False)
        mode.run(fn, args, kwargs)
        return resolve(key, None, mode)

    def cache_info() -> CacheInfo:
        return CacheInfo(stats["hits"], stats["misses"], cache_size,
                         len(cache))

    def cache_clear() -> None:
        cache.clear()
        stats["hits"] = stats["misses"] = 0

    def persist_info() -> PersistInfo:
        return PersistInfo(pstats["disk_hits"],
                           pstats["disk_decisions_hits"],
                           pstats["disk_misses"],
                           disk.directory if disk else None)

    wrapped.__name__ = f"offload({getattr(fn, '__name__', 'fn')})"
    wrapped.sites = sites
    wrapped.policy = policy
    wrapped.backend = backend
    wrapped.cache_info = cache_info
    wrapped.cache_clear = cache_clear
    wrapped.persist_info = persist_info
    return wrapped


def site_report(fn, policy: PrecisionPolicy | None = None):
    """Enumerate the matmul sites ``offload`` would route in ``fn``.

    Returns a function with ``fn``'s signature that runs ``fn`` natively
    under the interception mode and returns the :class:`Site` records
    instead of its result.  The names are the ones :func:`offload`
    uses, so they are valid ``PrecisionPolicy.site_splits`` keys.
    """
    policy = policy or PrecisionPolicy()

    def reporter(*args, **kwargs) -> List[Site]:
        mode = _OffloadMode(policy, None, execute=False)
        mode.run(fn, args, kwargs)
        return mode.decisions()

    reporter.__name__ = f"site_report({getattr(fn, '__name__', 'fn')})"
    return reporter
