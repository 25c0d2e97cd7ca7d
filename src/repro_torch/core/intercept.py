"""Automatic BLAS offload for eager PyTorch programs.

Port of :mod:`repro.core.intercept`.  The paper intercepts the BLAS
calls of an unmodified application at link time and redirects large
GEMMs to the INT8 emulation engine.  A torch program has no jaxpr; its
counterpart of link-time interception is a
:class:`torch.overrides.TorchFunctionMode` around the call:
:func:`offload` runs ``fn`` under a mode that catches every
``torch.matmul`` / ``Tensor.__matmul__`` / ``Tensor.matmul``,
``torch.mm``, ``torch.bmm``, ``torch.addmm``, ``F.linear`` and
two-operand ``torch.einsum`` call.

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
batch axis ``(B, M, K) @ (B, K, N)``.  A site passes the reference's
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

Not ported yet: ``cond``/``while``/``shard_map`` scopes,
``persist_dir`` and ``on_site_event`` (ROADMAP).
"""

from __future__ import annotations

import math
import threading
import warnings
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.autograd.graph import get_gradient_edge
from torch.overrides import TorchFunctionMode

from .backends import GemmBackend, get_backend
from .precision import PrecisionPolicy

__all__ = ["offload", "scan", "site_report", "Site"]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


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
        return y.permute(*[order.index(t) for t in want])


class _EinsumDims:
    """``jnp.einsum``'s lowering of a two-operand einsum to ``dot_general``.

    ``opt_einsum`` hands ``jnp.einsum`` the operands in reverse order,
    ``L`` = the second and ``R`` = the first.  A size-1 axis of ``L``
    facing a larger one in ``R`` is squeezed, then the same for ``R``
    against what is left of ``L``; contracted names are sorted, batch
    names follow the output, and the ``dot_general`` is ``R @ L`` when
    that yields the output names in order (batch, R's free, L's free),
    else ``L @ R``.  ``pack`` builds ``(B, M, K)`` / ``(B, K, N)`` and
    ``unpack`` the einsum's output from ``(B, M, N)``.
    """

    def __init__(self, equation: str, lhs_shape, rhs_shape):
        eq = equation.replace(" ", "")
        if "..." in eq or "->" not in eq:
            raise NotImplementedError(
                f"einsum {equation!r}: offload handles explicit "
                "two-operand equations without an ellipsis")
        inputs, out = eq.split("->")
        names = inputs.split(",")
        shapes = [tuple(lhs_shape), tuple(rhs_shape)]
        if len(names) != 2 or any(len(n) != len(set(n)) for n in names) \
                or any(len(n) != len(sh) for n, sh in zip(names, shapes)):
            raise NotImplementedError(
                f"einsum {equation!r}: offload handles two operands "
                "without repeated indices")
        # [L, R] = [second, first], as (name, shape) pairs.
        ops_ = [(names[1], shapes[1]), (names[0], shapes[0])]
        self.squeeze = {}
        for i in (0, 1):
            own, shape = ops_[i]
            other, oshape = ops_[1 - i]
            drop = [d for d, c in enumerate(own)
                    if shape[d] == 1 and other.find(c) != -1
                    and oshape[other.find(c)] != 1]
            self.squeeze[1 - i] = drop   # keyed by torch operand index
            ops_[i] = ("".join(c for d, c in enumerate(own)
                               if d not in drop),
                       tuple(x for d, x in enumerate(shape)
                             if d not in drop))
        (ln, ls), (rn, rs) = ops_
        contracted = sorted(c for c in set(ln) | set(rn) if c not in out)
        if any(c not in ln or c not in rn for c in contracted):
            raise NotImplementedError(
                f"einsum {equation!r}: an index summed out of one "
                "operand alone is not a matmul")
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
        size = dict(zip(ln, ls))
        size.update(zip(rn, rs))
        self.lhs_shape, self.rhs_shape = ls, rs
        self.lperm = [ln.index(c) for c in batch + l_rest + contracted]
        self.rperm = [rn.index(c) for c in batch + contracted + r_rest]
        self.batch_shape = tuple(size[c] for c in batch)
        self.m_shape = tuple(size[c] for c in l_rest)
        self.n_shape = tuple(size[c] for c in r_rest)
        self.B = math.prod(self.batch_shape)
        self.M = math.prod(self.m_shape)
        self.K = math.prod(size[c] for c in contracted)
        self.N = math.prod(self.n_shape)
        got = batch + l_rest + r_rest
        self.out_perm = [got.index(c) for c in out]

    def pack(self, a, b):
        for d in reversed(self.squeeze[0]):
            a = a.squeeze(d)
        for d in reversed(self.squeeze[1]):
            b = b.squeeze(d)
        if self.swap:
            a, b = b, a
        a3 = a.permute(*self.lperm).reshape(self.B, self.M, self.K)
        b3 = b.permute(*self.rperm).reshape(self.B, self.K, self.N)
        return a3, b3

    def unpack(self, y3):
        y = y3.reshape(self.batch_shape + self.m_shape + self.n_shape)
        return y.permute(*self.out_perm)


class _Scope:
    """A naming scope: the top level of ``fn`` or one :func:`scan` body."""

    def __init__(self, prefix: str = "", mult: int = 1):
        self.prefix = prefix
        self.mult = mult
        self.dots = 0        # dot{j} counter
        self.flows = 0       # scan/while/cond counter (the reference's)
        self.record = True   # False on a scan's later iterations


class _Active(threading.local):
    """Offload modes running ``fn`` in this thread, innermost last;
    :func:`scan` opens its scope in the innermost (torch keeps its
    function-mode stack per thread too)."""

    def __init__(self):
        self.modes: List["_OffloadMode"] = []


_ACTIVE = _Active()


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
    mode = _ACTIVE.modes[-1] if _ACTIVE.modes else None
    scope = None
    if mode is not None:
        parent = mode.scopes[-1]
        scope = _Scope(f"{parent.prefix}scan{parent.flows}/",
                       parent.mult * n)
        scope.record = parent.record
        parent.flows += 1
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


class _Call:
    """One caught call: its matmul operands and how to finish it."""

    def __init__(self, lhs, rhs, finish=None, equation=None):
        self.lhs, self.rhs = lhs, rhs
        self.finish = finish or (lambda prod: prod)
        self.equation = equation    # set for an einsum


def _addmm_finish(inp, beta, alpha):
    def finish(prod):
        if beta == 1 and alpha == 1:
            return prod + inp
        return beta * inp + alpha * prod
    return finish


def _parse_call(func, args, kwargs):
    """The matmul operands of a caught call, or None to run it natively."""
    if kwargs.get("out") is not None:
        return None
    if func is torch.einsum:
        if kwargs or not args or not isinstance(args[0], str):
            return None
        ops_ = args[1:]
        if len(ops_) == 1 and isinstance(ops_[0], (list, tuple)):
            ops_ = tuple(ops_[0])
        if len(ops_) != 2:
            return None
        return _Call(ops_[0], ops_[1], equation=args[0])
    if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm):
        if len(args) != 2 or kwargs:
            return None
        return _Call(args[0], args[1])
    if func is torch.Tensor.__rmatmul__:
        return _Call(args[1], args[0]) if len(args) == 2 else None
    if func in (torch.addmm, torch.Tensor.addmm):
        if len(args) != 3 or set(kwargs) - {"beta", "alpha"}:
            return None
        inp, m1, m2 = args
        return _Call(m1, m2, _addmm_finish(inp, kwargs.get("beta", 1),
                                           kwargs.get("alpha", 1)))
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
              mult: int = 1) -> Site:
    """Decide whether one matmul site gets offloaded."""
    m, k, n = dims.M, dims.K, dims.N
    geom = dict(m=m, k=k, n=n, batch=dims.B, mult=mult)

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

    def __init__(self, dims, out_shape, dtype, mult, needs):
        self.dims, self.out_shape = dims, tuple(out_shape)
        self.dtype, self.mult = dtype, mult
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


class _OffloadMode(TorchFunctionMode):
    """Catches matmul calls, names them ``dot{i}``, routes the offloaded."""

    def __init__(self, policy: PrecisionPolicy, engine_for, execute: bool,
                 authoritative: bool = False):
        super().__init__()
        self.policy = policy
        self.engine_for = engine_for
        self.execute = execute
        # The engine runs every eligible site, demoted ones too.
        self.authoritative = authoritative
        self.sites: List[Site] = []
        self.scopes = [_Scope()]
        self.running = False
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
        """``fn(*args, **kwargs)`` under this mode, as :func:`scan`'s
        innermost scope owner."""
        _ACTIVE.modes.append(self)
        self.running = True
        try:
            with self:
                return fn(*args, **kwargs)
        finally:
            self.running = False
            self.nodes.clear()   # the graph's nodes are not kept past fn
            _ACTIVE.modes.pop()

    def start_pass(self, outputs, inputs) -> None:
        """A gradient pass inside ``fn`` begins (``torch.autograd.grad``
        or ``backward``): name its cotangents afresh, as the reference's
        next ``jax.grad`` does, for the products it reaches.

        A product takes part when its output's node is reachable from
        the pass's ``outputs``; an operand's cotangent is taken when its
        gradient edge leads to one of ``inputs`` (to any leaf when
        ``inputs`` is None), which is what autograd executes.
        """
        order = _postorder(t.grad_fn for t in outputs
                           if t.grad_fn is not None)
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
        self.backward_scopes = {"": self.scopes[0]}
        self.backward = {}

    def _note_product(self, prefix, j, dims, out_shape, dtype, mult, needs,
                      nodes):
        """Record forward dot ``j`` of scope ``prefix`` as taking a
        gradient (an operand needs one on some iteration), and this
        run's autograd ``nodes``."""
        self.nodes.setdefault((prefix, j), []).append(nodes)
        found = self.products.setdefault(prefix, [])
        found.extend([None] * (j + 1 - len(found)))
        if found[j] is None:
            found[j] = _Product(dims, out_shape, dtype, mult, needs)
        else:
            found[j].needs_lhs |= needs[0]
            found[j].needs_rhs |= needs[1]

    def _backward_scope(self, prefix: str) -> _Scope:
        """The scope the cotangents of forward scope ``prefix`` are named
        in: the top level for the top level, else a new scan scope of
        the parent's backward scope, numbered by its flow counter."""
        scope = self.backward_scopes.get(prefix)
        if scope is None:
            parts = prefix.split("/")[:-1]
            parent = self._backward_scope(
                "/".join(parts[:-1]) + "/" if len(parts) > 1 else "")
            scope = _Scope(f"{parent.prefix}scan{parent.flows}/")
            parent.flows += 1
            self.backward_scopes[prefix] = scope
        return scope

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
                site = _classify(prod.cotangent(which), prod.dtype,
                                 self.policy,
                                 f"{scope.prefix}dot{scope.dots}",
                                 prod.mult)
                scope.dots += 1
                self.sites.append(site)
                found[(j, which)] = site
        self.backward[prefix] = found
        return found

    def _engine_runs(self, site: Site) -> bool:
        return site.offloaded or (self.authoritative and site.eligible)

    def run_site(self, site: Site, a3, b3, out_dtype):
        """One batched product through ``site``'s engine, or natively."""
        if self._engine_runs(site):
            return _batched(self.engine_for(site), site)(a3, b3, out_dtype)
        return _native(a3, b3, out_dtype)

    def _names_cotangents_of(self, prefix: str):
        """A gradient hook on a product that runs natively: its
        cotangents stay torch's own, but a backward inside ``fn`` still
        makes (and records) their sites."""
        def hook(grad):
            if self.running:
                with torch._C.DisableTorchFunction():
                    self.backward_sites(prefix)
        return hook

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _GRAD_ENTRIES and self.running:
            self.start_pass(*_grad_targets(func, args, kwargs))
            return func(*args, **kwargs)
        call = _parse_call(func, args, kwargs)
        if call is None:
            return func(*args, **kwargs)
        lhs, rhs = call.lhs, call.rhs
        dims = (_MatmulDims(lhs.shape, rhs.shape) if call.equation is None
                else _EinsumDims(call.equation, lhs.shape, rhs.shape))
        dtype = torch.promote_types(lhs.dtype, rhs.dtype)
        scope = self.scopes[-1]
        j = scope.dots
        site = _classify(dims, dtype, self.policy, f"{scope.prefix}dot{j}",
                         scope.mult)
        scope.dots += 1
        if scope.record:
            self.sites.append(site)
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
            run = _batched(self.engine_for(site), site) if engine else _native
            a3, b3 = dims.pack(lhs, rhs)
            y3 = _SiteMatmul.apply(a3, b3, run, dtype, self,
                                   (scope.prefix, j))
            node = y3.grad_fn
            y = dims.unpack(y3)
            out = call.finish(y)
        else:
            out = y = func(*args, **kwargs)
            node = y.grad_fn
            if any(needs):
                y.register_hook(self._names_cotangents_of(scope.prefix))
        if any(needs):
            edges = [get_gradient_edge(x).node if x.requires_grad else None
                     for x in (lhs, rhs)]
            if dims.swap:
                edges = edges[::-1]
            self._note_product(scope.prefix, j, dims, y.shape, dtype,
                               scope.mult, needs, (node, *edges))
        return out


def offload(fn, policy: PrecisionPolicy | None = None, *,
            backend: GemmBackend | None = None, plan=None,
            plan_match: str = "strict"):
    """Wrap ``fn`` so its large matmuls run through the policy backend.

    Every call runs ``fn`` eagerly under the interception mode.  Sites
    on the policy's default spec share one backend instance (a stateful
    engine such as ``adaptive`` keeps its per-site cache across calls);
    a site routed to another spec by ``site_backends`` gets its own.
    The wrapper exposes ``wrapped.sites(*args, **kwargs)``: the
    :class:`Site` decisions for those inputs, the same records
    :func:`site_report` gives.

    ``backend`` injects the default engine instead of resolving
    ``policy.backend`` (the tuner's recording backend rides the same
    wrapper this way).  An engine whose ``intercepts_all_sites`` is true
    runs every *eligible* site, a demoted one too, whatever its spec;
    one with ``observe_sites`` is handed each call's decisions, a dict
    name -> :class:`Site` in discovery order, after the call.

    ``plan`` accepts a :class:`repro_torch.tune.PrecisionPlan`: with no
    ``policy`` its policy (``PrecisionPolicy.from_plan``) drives the
    offload.  With ``plan_match="strict"`` each call's site set (and
    each ``sites`` report) is validated against the plan's fingerprint
    (``plan.validate_sites``), so a drifted program raises
    :class:`~repro_torch.tune.PlanStaleError`; an eager program is only
    known once it has run, so the error comes after the call, before
    its result is returned.  ``plan_match="subset"`` applies the
    overlapping entries and ignores the rest (``on_unmatched_site=
    "ignore"``), as a serve engine runs a train-calibrated plan.
    """
    if plan_match not in ("strict", "subset"):
        raise ValueError(f"plan_match must be 'strict' or 'subset', "
                         f"got {plan_match!r}")
    if policy is None:
        policy = (PrecisionPolicy() if plan is None else
                  PrecisionPolicy.from_plan(
                      plan, **({"on_unmatched_site": "ignore"}
                               if plan_match == "subset" else {})))
    backend = backend or get_backend(policy.backend, policy=policy)
    engines: Dict[str, GemmBackend] = {policy.backend: backend}
    authoritative = getattr(backend, "intercepts_all_sites", False)
    observe = getattr(backend, "observe_sites", None)

    def engine_for(site: Site) -> GemmBackend:
        if authoritative:
            return backend
        spec = site.backend or policy.backend
        if spec not in engines:
            engines[spec] = get_backend(spec, policy=policy)
        return engines[spec]

    def validate(found: List[Site]) -> None:
        if plan is not None and plan_match == "strict":
            plan.validate_sites(found)

    def wrapped(*args, **kwargs):
        mode = _OffloadMode(policy, engine_for, execute=True,
                            authoritative=authoritative)
        out = mode.run(fn, args, kwargs)
        _check_overrides(policy, mode.sites)
        validate(mode.sites)
        if observe is not None:
            observe({site.name: site for site in mode.sites})
        return out

    def sites(*args, **kwargs) -> List[Site]:
        found = site_report(fn, policy)(*args, **kwargs)
        _check_overrides(policy, found)
        validate(found)
        return found

    wrapped.__name__ = f"offload({getattr(fn, '__name__', 'fn')})"
    wrapped.sites = sites
    wrapped.policy = policy
    wrapped.backend = backend
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
        return mode.sites

    reporter.__name__ = f"site_report({getattr(fn, '__name__', 'fn')})"
    return reporter
