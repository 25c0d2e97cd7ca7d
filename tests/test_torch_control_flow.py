"""Port parity: control flow, opaque calls and n-operand einsums under
offload, against the reference's jaxpr transform.

The same program is written with ``jax.lax.cond``/``switch``/
``while_loop`` and ``jnp.einsum`` and with the port's ``cond``/
``switch``/``while_loop`` and ``torch.einsum``; the port's site report
must list the reference's names and extents (every branch, taken or
not; the cotangents of a ``cond`` in a backward scope of their own),
and offloaded values must be the reference's.  User
``torch.autograd.Function``s stay opaque, as the reference leaves
``custom_jvp``/``custom_vjp``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrecisionPolicy as PolicyRef
from repro.core import offload as offload_ref
from repro_torch.core import (PrecisionPolicy, cond, offload, scan,
                              site_report, switch, while_loop)
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)


def _arr(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


def _record(site):
    return (site.name, site.m, site.k, site.n, site.batch, site.mult,
            tuple(site.lhs_shape), tuple(site.rhs_shape), site.offloaded,
            site.splits)


def _both(f_jax, f_torch, args, grad=(), **pol):
    """The reference's and the port's site records for one program; a
    numpy argument goes to each as its own array (a tensor that
    requires grad when its position is in ``grad``)."""
    kw = {"default_splits": 4, "min_dim": 64, **pol}
    ref = offload_ref(f_jax, PolicyRef(**kw)).sites(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    port = offload(f_torch, PrecisionPolicy(**kw)).sites(
        *[torch.from_numpy(a).requires_grad_(i in grad)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)])
    return [_record(s) for s in ref], [_record(s) for s in port]


class TestControlFlowOffload:
    """The reference's ``TestControlFlowOffload`` cond and while tests."""

    def test_cond_branches_offloaded(self):
        a = _arr((144, 144), 8)

        def f(pred, a):
            return cond(pred, lambda x: x @ x, lambda x: x + 1.0, a)

        pol = PrecisionPolicy(default_splits=8, min_dim=128)
        wrapped = offload(f, pol)
        names = [s.name for s in wrapped.sites(True, torch.from_numpy(a))]
        assert names == ["cond0/br1/dot0"]
        ref = offload_ref(
            lambda p, a: jax.lax.cond(p, lambda x: x @ x,
                                      lambda x: x + 1.0, a),
            PolicyRef(default_splits=8, min_dim=128))
        for pred in (True, False):
            want = np.asarray(f(pred, torch.from_numpy(a)))
            got = wrapped(pred, torch.from_numpy(a))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
            assert same_bits(ref(pred, jnp.asarray(a)), got)

    def test_while_body_offloaded(self):
        a = _arr((144, 144), 9, 0.01)

        def f(a):
            def body(v):
                i, x = v
                return i + 1, x @ x

            return while_loop(lambda v: v[0] < 3, body, (0, a))[1]

        pol = PrecisionPolicy(default_splits=9, min_dim=128)
        wrapped = offload(f, pol)
        assert [s.name for s in wrapped.sites(torch.from_numpy(a))] == \
            ["while0/dot0"]
        want = f(torch.from_numpy(a)).numpy()
        got = wrapped(torch.from_numpy(a))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * max(1.0,
                                                    np.max(np.abs(want))))
        ref = offload_ref(
            lambda a: jax.lax.while_loop(
                lambda v: v[0] < 3, lambda v: (v[0] + 1, v[1] @ v[1]),
                (0, a))[1], PolicyRef(default_splits=9, min_dim=128))
        assert same_bits(ref(jnp.asarray(a)), got)

    def test_control_flow_runs_without_offload(self):
        assert cond(True, lambda x: x + 1, lambda x: x - 1, 1) == 2
        assert switch(7, [lambda: 0, lambda: 1]) == 1     # clamped
        assert switch(-1, [lambda: 0, lambda: 1]) == 0
        assert while_loop(lambda v: v < 5, lambda v: v + 2, 0) == 6
        assert cond(torch.tensor(False), lambda: "t", lambda: "f") == "f"


class _ZeroTangent(torch.autograd.Function):
    """``custom_jvp``'s zero-tangent rule as a Function."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.shapes = x.shape, y.shape
        return x @ y

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.zeros(s, dtype=g.dtype) for s in ctx.shapes)


class _ZeroVjp(torch.autograd.Function):
    """``custom_vjp``'s zero rule with residuals."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return x @ y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return torch.zeros_like(x), (x.T @ g) * 0.0


@pytest.fixture(scope="module")
def operands():
    return (torch.from_numpy(_arr((192, 192), 0).astype(np.float32)),
            torch.from_numpy(_arr((192, 192), 1).astype(np.float32)))


class TestCallPrimitiveBoundaries:
    """The reference's custom_jvp/custom_vjp tests, as
    ``torch.autograd.Function``s."""

    @pytest.mark.parametrize("fn", [_ZeroTangent, _ZeroVjp],
                             ids=["custom_jvp", "custom_vjp"])
    def test_custom_rule_preserved(self, operands, fn):
        a, b = operands

        def f(a, b):
            return torch.sum(fn.apply(a, b))

        pol = PrecisionPolicy(default_splits=3, min_dim=64)
        wrapped = offload(f, pol)
        assert wrapped.sites(a, b) == []   # opaque: no sites inside
        assert float(wrapped(a, b)) == float(f(a, b))
        ta = a.clone().requires_grad_()
        wrapped(ta, b).backward()
        assert float(ta.grad.abs().max()) == 0.0   # the zero rule held

    def test_rule_holds_under_a_gradient_inside_fn(self, operands):
        # The Function sits beside a routed product; a gradient taken
        # inside fn names the product's cotangent and none of the
        # Function's, whose rule gives zero.
        a, b = operands

        def f(a, b):
            loss = (_ZeroVjp.apply(a, b) + a @ b).sum()
            return torch.autograd.grad(loss, a)[0]

        pol = PrecisionPolicy(default_splits=3, min_dim=64,
                              backend="fp64_int8_3")
        wrapped = offload(f, pol)
        ta = a.clone().requires_grad_()
        assert [s.name for s in wrapped.sites(ta, b)] == ["dot0", "dot1"]
        got = wrapped(ta, b)
        plain = offload(lambda a, b: torch.autograd.grad(
            (a @ b).sum(), a)[0], pol)(ta, b)
        assert torch.equal(got, plain)

    def test_own_site_matmul_stays_routed(self, operands):
        a, b = operands
        pol = PrecisionPolicy(default_splits=3, min_dim=64)
        wrapped = offload(lambda a, b: a @ b, pol)
        assert [s.offloaded for s in wrapped.sites(a, b)] == [True]
        assert not torch.equal(wrapped(a, b), a @ b)   # s=3 is coarse


# -- names and extents against the reference, at run time ----------------

def _cond_grad_jax(p, a, w):
    def loss(a, w):
        y = jax.lax.cond(p, lambda a, w: a @ w, lambda a, w: (2 * a) @ w,
                         a, w)
        return jnp.sum(jnp.tanh(y))
    return jax.grad(loss, argnums=(0, 1))(a, w)


def _cond_grad_torch(p, a, w):
    y = cond(p, lambda a, w: a @ w, lambda a, w: (2 * a) @ w, a, w)
    return torch.autograd.grad(torch.tanh(y).sum(), (a, w))


def _cond_head_jax(p, a, w, w2):
    def loss(w):
        x = a @ w
        y = jax.lax.cond(p, lambda x: x @ w2,
                         lambda x: jnp.tanh(x) @ w2 * 2, x)
        return jnp.sum(y @ w)
    return jax.grad(loss)(w)


def _cond_head_torch(p, a, w, w2):
    x = a @ w
    y = cond(p, lambda x: x @ w2, lambda x: torch.tanh(x) @ w2 * 2, x)
    return torch.autograd.grad((y @ w).sum(), w)[0]


class TestNamesAgainstReference:
    @pytest.mark.parametrize("pred", [True, False])
    def test_cond_forward(self, pred):
        args = (pred, _arr((192, 128), 10), _arr((128, 256), 11))
        ref, port = _both(
            lambda p, a, w: jax.lax.cond(p, lambda a, w: a @ w,
                                         lambda a, w: (2 * a) @ w, a, w),
            lambda p, a, w: cond(p, lambda a, w: a @ w,
                                 lambda a, w: (2 * a) @ w, a, w), args)
        assert port == ref
        assert [r[0] for r in port] == ["cond0/br0/dot0", "cond0/br1/dot0"]

    @pytest.mark.parametrize("pred", [True, False])
    def test_cond_backward(self, pred):
        # Both branches' cotangents, in a backward cond scope of their
        # own, after the forward's; the top level's continue around it.
        args = (pred, _arr((192, 128), 12), _arr((128, 256), 13))
        ref, port = _both(_cond_grad_jax, _cond_grad_torch, args,
                          grad=(1, 2))
        assert port == ref
        assert [r[0] for r in port][2:] == [
            "cond1/br0/dot0", "cond1/br0/dot1", "cond1/br1/dot0",
            "cond1/br1/dot1"]
        args = (pred, _arr((192, 128), 14), _arr((128, 256), 15),
                _arr((256, 128), 16))
        ref, port = _both(_cond_head_jax, _cond_head_torch, args, grad=(2,))
        assert port == ref
        assert [r[0] for r in port] == [
            "dot0", "cond0/br0/dot0", "cond0/br1/dot0", "dot1", "dot2",
            "dot3", "cond1/br0/dot0", "cond1/br1/dot0", "dot4"]

    @pytest.mark.parametrize("pred", [True, False])
    def test_cond_gradient_values(self, pred):
        a, w = _arr((192, 128), 17), _arr((128, 256), 18)
        kw = dict(default_splits=5, min_dim=64, backend="fp64_int8_5")
        want = offload_ref(_cond_grad_jax, PolicyRef(**kw))(
            pred, jnp.asarray(a), jnp.asarray(w))
        got = offload(_cond_grad_torch, PrecisionPolicy(**kw))(
            pred, torch.from_numpy(a).requires_grad_(),
            torch.from_numpy(w).requires_grad_())
        for r, t in zip(want, got):
            assert same_bits(r, t)

    def test_cache_hit_takes_the_other_branch_from_the_entry(self):
        # The first call decides both branches (one run in report mode);
        # the second takes the other branch and hits: its untaken
        # branch's sites, forward and cotangent, come from the entry.
        a, w = _arr((192, 128), 21), _arr((128, 256), 22)
        kw = dict(default_splits=5, min_dim=64, backend="fp64_int8_5")
        wrapped = offload(_cond_grad_torch, PrecisionPolicy(**kw))
        ta = torch.from_numpy(a).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            first = wrapped(True, ta, tw)
            second = wrapped(False, ta, tw)
        assert tuple(wrapped.cache_info())[:2] == (1, 1)
        ref = offload_ref(_cond_grad_jax, PolicyRef(**kw))
        for pred, got in ((True, first), (False, second)):
            want = ref(pred, jnp.asarray(a), jnp.asarray(w))
            assert all(same_bits(r, t) for r, t in zip(want, got))
        assert [s.name for s in wrapped.sites(False, ta, tw)][2:] == [
            "cond1/br0/dot0", "cond1/br0/dot1", "cond1/br1/dot0",
            "cond1/br1/dot1"]

    @pytest.mark.parametrize("index", [0, 1, 2])
    def test_switch_three_branches(self, index):
        a, w = _arr((192, 128), 19), _arr((128, 256), 20)

        def branches(ones, t):
            return [lambda x: x @ w_(t), lambda x: ones((192, 256)),
                    lambda x: ((x @ w_(t)) @ w_(t).T) @ w_(t)]

        def w_(t):
            return t(w)

        ref, port = _both(
            lambda i, a: jax.lax.switch(i, branches(jnp.ones, jnp.asarray),
                                        a),
            lambda i, a: switch(i, branches(
                lambda s: torch.ones(s, dtype=torch.float64),
                torch.from_numpy), a), (index, a))
        assert port == ref
        assert [r[0] for r in port] == [
            "cond0/br0/dot0", "cond0/br2/dot0", "cond0/br2/dot1",
            "cond0/br2/dot2"]

    def test_while_with_products_in_the_predicate(self):
        x = _arr((128, 128), 21, 0.01)
        ref, port = _both(
            lambda x: jax.lax.while_loop(
                lambda v: (v[0] < 3) & (jnp.sum(v[1] @ v[1]) > -1e300),
                lambda v: (v[0] + 1, (v[1] @ v[1].T) @ v[1]), (0, x))[1],
            lambda x: while_loop(
                lambda v: (v[0] < 3) and bool((v[1] @ v[1]).sum() > -1e300),
                lambda v: (v[0] + 1, (v[1] @ v[1].T) @ v[1]), (0, x))[1],
            (x,))
        assert port == ref
        assert [r[0] for r in port] == ["while0/cond/dot0", "while0/dot0",
                                        "while0/dot1"]
        assert [r[5] for r in port] == [1, 1, 1]

    def test_while_that_never_runs_lists_its_body(self):
        x = _arr((128, 128), 22)
        ref, port = _both(
            lambda x: jax.lax.while_loop(lambda v: v[0] < 0,
                                         lambda v: (v[0] + 1, v[1] @ v[1]),
                                         (0, x))[1],
            lambda x: while_loop(lambda v: v[0] < 0,
                                 lambda v: (v[0] + 1, v[1] @ v[1]),
                                 (0, x))[1], (x,))
        assert port == ref == [("while0/dot0", 128, 128, 128, 1, 1,
                                (128, 128), (128, 128), True, 4)]

    @pytest.mark.parametrize("pred", [True, False])
    def test_cond_and_scan_nested(self, pred):
        x = _arr((128, 128), 23, 0.05)
        ws = np.stack([x, x])

        def f_jax(p, x, ws):
            def body(c, w):
                return jax.lax.cond(p, lambda c: c @ w, lambda c: c, c), None
            return jax.lax.cond(p, lambda x: jax.lax.scan(body, x, ws)[0],
                                lambda x: x @ ws[0], x)

        def f_torch(p, x, ws):
            def body(c, w):
                return cond(p, lambda c: c @ w, lambda c: c, c), None
            return cond(p, lambda x: scan(body, x, ws)[0],
                        lambda x: x @ ws[0], x)

        ref, port = _both(f_jax, f_torch, (pred, x, ws))
        assert port == ref
        assert [(r[0], r[5]) for r in port] == [
            ("cond0/br0/dot0", 1), ("cond0/br1/scan0/cond0/br1/dot0", 2)]

    @pytest.mark.parametrize("eq,shapes", [
        ("ij,jk,kl->il", [(128, 256), (256, 192), (192, 160)]),
        ("ij,jk,kl->li", [(128, 256), (256, 192), (192, 160)]),
        ("ij,jk,kl->ki", [(128, 256), (256, 192), (192, 160)]),
        ("ij,jk,kl,lm->im", [(128, 256), (256, 192), (192, 160),
                             (160, 96)]),
        ("bij,bjk,kl,lm->bmi", [(2, 64, 96), (2, 96, 128), (128, 80),
                                (80, 72)]),
        ("ij,jk,kl,lm,mn->in", [(128, 256), (256, 192), (192, 160),
                                (160, 96), (96, 200)]),
    ])
    def test_einsum_sites_and_values(self, eq, shapes):
        arrs = [_arr(s, 30 + i) for i, s in enumerate(shapes)]
        ref, port = _both(lambda *a: jnp.einsum(eq, *a),
                          lambda *a: torch.einsum(eq, *a), arrs, min_dim=1)
        assert port == ref
        assert len(port) == len(shapes) - 1
        kw = dict(default_splits=6, min_dim=1, backend="fp64_int8_6")
        want = offload_ref(lambda *a: jnp.einsum(eq, *a), PolicyRef(**kw))(
            *map(jnp.asarray, arrs))
        got = offload(lambda *a: torch.einsum(eq, *a), PrecisionPolicy(
            **kw))(*map(torch.from_numpy, arrs))
        assert same_bits(want, got)

    def test_einsum_gradient_sites(self):
        arrs = [_arr(s, 40 + i) for i, s in enumerate(
            [(128, 256), (256, 192), (192, 160)])]
        eq = "ij,jk,kl->il"
        ref, port = _both(
            lambda a, b, c: jax.grad(lambda b: jnp.sum(jnp.einsum(
                eq, a, b, c)))(b),
            lambda a, b, c: torch.autograd.grad(
                torch.einsum(eq, a, b, c).sum(), b)[0], arrs, grad=(1,))
        assert port == ref

    def test_unsupported_einsums_still_raise(self):
        """The name is kept from when these equations raised
        NotImplementedError; the test now holds each three-operand
        equation with a repeated index, an ellipsis or an implicit
        output to the reference's site records and bits."""
        a = _arr((4, 4), 45)
        kw = dict(default_splits=6, min_dim=1, backend="fp64_int8_6")
        for eq in ("ii,ij,jk->k", "...i,ij,jk->...k", "ij,jk,kl"):
            ref, port = _both(lambda x: jnp.einsum(eq, x, x, x),
                              lambda x: torch.einsum(eq, x, x, x), [a],
                              **kw)
            assert port == ref, eq
            want = offload_ref(lambda x: jnp.einsum(eq, x, x, x),
                               PolicyRef(**kw))(jnp.asarray(a))
            got = offload(lambda x: torch.einsum(eq, x, x, x),
                          PrecisionPolicy(**kw))(torch.from_numpy(a))
            assert same_bits(want, got), eq
