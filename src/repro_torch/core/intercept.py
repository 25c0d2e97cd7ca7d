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

Each offloaded site runs under a :class:`torch.autograd.Function` whose
backward computes ``dA = g @ B^T`` and ``dB = A^T @ g`` through the same
backend, as the reference's ``custom_vjp`` does.

Not ported yet: ``cond``/``while``/``shard_map`` scopes, ``plan=``,
``persist_dir`` and ``on_site_event`` (ROADMAP).
"""

from __future__ import annotations

import math
import threading
import warnings
from typing import Dict, List

import torch
import torch.nn.functional as F
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


def _slice(xs, i):
    if isinstance(xs, torch.Tensor):
        return xs[i]
    if isinstance(xs, dict):
        return {key: _slice(val, i) for key, val in xs.items()}
    return type(xs)(_slice(x, i) for x in xs)


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
        for i in range(n):
            if scope is not None:
                scope.dots = scope.flows = 0
                scope.record = scope.record and i == 0
            carry, y = body(carry, _slice(xs, i))
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


class _SiteMatmul(torch.autograd.Function):
    """Backend-routed product with the emulated backward."""

    @staticmethod
    def forward(ctx, a3, b3, run, out_dtype):
        ctx.run = run
        ctx.save_for_backward(a3, b3)
        return run(a3, b3, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a3, b3 = ctx.saved_tensors
        dl = dr = None
        # A gradient taken while an offload mode is active must not
        # count the backward's own products as new sites.
        with torch._C.DisableTorchFunction():
            if ctx.needs_input_grad[0]:
                dl = ctx.run(g, b3.transpose(1, 2), a3.dtype)
            if ctx.needs_input_grad[1]:
                dr = ctx.run(a3.transpose(1, 2), g, b3.dtype)
        return dl, dr, None, None


class _OffloadMode(TorchFunctionMode):
    """Catches matmul calls, names them ``dot{i}``, routes the offloaded."""

    def __init__(self, policy: PrecisionPolicy, engine_for, execute: bool):
        super().__init__()
        self.policy = policy
        self.engine_for = engine_for
        self.execute = execute
        self.sites: List[Site] = []
        self.scopes = [_Scope()]

    def run(self, fn, args, kwargs):
        """``fn(*args, **kwargs)`` under this mode, as :func:`scan`'s
        innermost scope owner."""
        _ACTIVE.modes.append(self)
        try:
            with self:
                return fn(*args, **kwargs)
        finally:
            _ACTIVE.modes.pop()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        call = _parse_call(func, args, kwargs)
        if call is None:
            return func(*args, **kwargs)
        lhs, rhs = call.lhs, call.rhs
        dims = (_MatmulDims(lhs.shape, rhs.shape) if call.equation is None
                else _EinsumDims(call.equation, lhs.shape, rhs.shape))
        dtype = torch.promote_types(lhs.dtype, rhs.dtype)
        scope = self.scopes[-1]
        site = _classify(dims, dtype, self.policy,
                         f"{scope.prefix}dot{scope.dots}", scope.mult)
        scope.dots += 1
        if scope.record:
            self.sites.append(site)
        if not (self.execute and site.offloaded):
            return func(*args, **kwargs)
        run = _batched(self.engine_for(site), site)
        a3, b3 = dims.pack(lhs, rhs)
        y3 = _SiteMatmul.apply(a3, b3, run, dtype)
        return call.finish(dims.unpack(y3))


def offload(fn, policy: PrecisionPolicy | None = None):
    """Wrap ``fn`` so its large matmuls run through the policy backend.

    Every call runs ``fn`` eagerly under the interception mode.  Sites
    on the policy's default spec share one backend instance (a stateful
    engine such as ``adaptive`` keeps its per-site cache across calls);
    a site routed to another spec by ``site_backends`` gets its own.
    The wrapper exposes ``wrapped.sites(*args, **kwargs)``: the
    :class:`Site` decisions for those inputs, the same records
    :func:`site_report` gives.
    """
    policy = policy or PrecisionPolicy()
    backend = get_backend(policy.backend, policy=policy)
    engines: Dict[str, GemmBackend] = {policy.backend: backend}

    def engine_for(site: Site) -> GemmBackend:
        spec = site.backend or policy.backend
        if spec not in engines:
            engines[spec] = get_backend(spec, policy=policy)
        return engines[spec]

    def wrapped(*args, **kwargs):
        mode = _OffloadMode(policy, engine_for, execute=True)
        out = mode.run(fn, args, kwargs)
        _check_overrides(policy, mode.sites)
        return out

    def sites(*args, **kwargs) -> List[Site]:
        return site_report(fn, policy)(*args, **kwargs)

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
