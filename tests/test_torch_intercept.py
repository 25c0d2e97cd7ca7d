"""Port parity: eager offload against the reference's jaxpr transform.

The same program is written once in JAX and once in torch; the port's
site report must give the reference's names, shapes, extents, gates
and splits, and offloaded results and gradients must be bitwise equal.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import PrecisionPolicy as PolicyRef
from repro.core import offload as offload_ref
from repro.core import site_report as site_report_ref
from repro_torch.core import PrecisionPolicy, offload, scan, site_report
from torch_parity import same_bits

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)


def _arr(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def legacy_solver_jax(a, b):  # the quickstart's "someone else's code"
    x = jnp.tanh(a @ b)
    for _ in range(2):
        x = x @ b / jnp.linalg.norm(x)
    return jnp.sum(x)


def legacy_solver_torch(a, b):
    x = torch.tanh(a @ b)
    for _ in range(2):
        x = x @ b / torch.linalg.norm(x)
    return torch.sum(x)


def _record(site):
    return (site.name, tuple(site.lhs_shape), tuple(site.rhs_shape),
            site.offloaded, site.eligible, site.splits, site.reason,
            site.m, site.k, site.n, site.batch, site.backend, site.flops)


def _policies(**kw):
    return PolicyRef(**kw), PrecisionPolicy(**kw)


class TestSiteReport:
    @pytest.mark.parametrize("kw", [
        dict(default_splits=6, min_dim=256),
        dict(default_splits=6, min_dim=256, site_splits={"dot0": 9},
             site_backends={"dot2": "dgemm"}),
        dict(default_splits=4, min_dim=512),
    ])
    def test_legacy_solver_sites_match(self, kw):
        a, b = _arr((288, 288), 1, np.float32), _arr((288, 288), 2,
                                                     np.float32)
        p_ref, p_port = _policies(**kw)
        r = site_report_ref(legacy_solver_jax, p_ref)(jnp.asarray(a),
                                                      jnp.asarray(b))
        t = site_report(legacy_solver_torch, p_port)(torch.from_numpy(a),
                                                     torch.from_numpy(b))
        assert [_record(s) for s in t] == [_record(s) for s in r]
        assert [repr(s) for s in t] == [repr(s) for s in r]

    def test_offload_sites_equal_site_report(self):
        a, b = torch.ones(288, 288), torch.ones(288, 288)
        pol = PrecisionPolicy(min_dim=256, site_splits={"dot1": 3})
        via_offload = offload(legacy_solver_torch, pol).sites(a, b)
        via_report = site_report(legacy_solver_torch, pol)(a, b)
        assert [_record(s) for s in via_offload] == \
            [_record(s) for s in via_report]

    def test_rank_n_and_layer_sites_match(self):
        x = _arr((3, 40, 48), 3)
        w = _arr((32, 48), 4)
        bias = _arr((32,), 5)
        y = _arr((3, 48, 32), 6)
        v = _arr((48,), 7)

        def f_jax(x, w, bias, y, v):
            h = x @ w.T + bias           # F.linear
            g = x @ y                    # batched
            u = x @ v                    # matrix-vector
            return h, g, u, x[0] @ y     # broadcast rhs batch

        def f_torch(x, w, bias, y, v):
            return F.linear(x, w, bias), torch.bmm(x, y), x.matmul(v), \
                torch.matmul(x[0], y)

        p_ref, p_port = _policies(min_dim=16, backend="fp64_int8_5")
        args = (x, w, bias, y, v)
        r = site_report_ref(f_jax, p_ref)(*map(jnp.asarray, args))
        t = site_report(f_torch, p_port)(*map(torch.from_numpy, args))
        assert [_record(s) for s in t] == [_record(s) for s in r]

    def test_integer_and_small_sites_stay_native(self):
        a = torch.ones((200, 200), dtype=torch.int32)
        b = torch.ones((8, 8))
        sites = site_report(lambda a, b: (a @ a, b @ b))(a, b)
        assert [s.reason for s in sites] == [
            "dtype int32", "min(m,k,n)=8 < min_dim=128"]
        assert not any(s.offloaded for s in sites)


class TestOffloadNumerics:
    def test_pure_matmul_and_gradient_bitwise(self):
        a, b = _arr((64, 64), 8), _arr((64, 64), 9)
        p_ref, p_port = _policies(backend="fp64_int8_6", min_dim=16)

        def f_jax(a, b):
            return (a @ b) @ b - a

        def f_torch(a, b):
            return (a @ b) @ b - a

        r = offload_ref(f_jax, p_ref)(jnp.asarray(a), jnp.asarray(b))
        ta = torch.from_numpy(a).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        t = offload(f_torch, p_port)(ta, tb)
        assert same_bits(r, t)

        g_ref = jax.grad(lambda a, b: offload_ref(f_jax, p_ref)(a, b).sum(),
                         argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        t.sum().backward()
        assert same_bits(g_ref[0], ta.grad)
        assert same_bits(g_ref[1], tb.grad)

    def test_batched_rank3_bitwise(self):
        a, b = _arr((3, 40, 48), 10), _arr((3, 48, 32), 11)
        p_ref, p_port = _policies(backend="fp64_int8_5", min_dim=16)
        r = offload_ref(lambda a, b: a @ b, p_ref)(jnp.asarray(a),
                                                   jnp.asarray(b))
        t = offload(lambda a, b: a @ b, p_port)(torch.from_numpy(a),
                                                torch.from_numpy(b))
        assert same_bits(r, t)

    def test_linear_layer_bitwise(self):
        x, w, bias = _arr((2, 40, 48), 12), _arr((32, 48), 13), _arr(
            (32,), 14)
        p_ref, p_port = _policies(backend="fp64_int8_4", min_dim=16)
        r = offload_ref(lambda x, w, c: x @ w.T + c, p_ref)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
        t = offload(F.linear, p_port)(*map(torch.from_numpy, (x, w, bias)))
        assert same_bits(r, t)

    def test_grad_kernel_family_equals_plain_family(self):
        # The port's version of the reference's
        # test_grad_through_offload_bit_identical.
        a = torch.from_numpy(_arr((64, 96), 15, np.float32))
        b = torch.from_numpy(_arr((96, 48), 16, np.float32))
        grads = []
        for backend in ("pallas_int8", "fp64_int8"):
            ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
            out = offload(lambda a, b: (a @ b).sum(), PrecisionPolicy(
                backend=backend, default_splits=4, min_dim=16))(ta, tb)
            out.backward()
            grads.append((ta.grad, tb.grad))
        assert torch.equal(grads[0][0], grads[1][0])
        assert torch.equal(grads[0][1], grads[1][1])

    def test_demoted_and_native_sites_run_natively(self):
        a, b = torch.from_numpy(_arr((32, 32), 17)), torch.from_numpy(
            _arr((32, 32), 18))
        pol = PrecisionPolicy(min_dim=16, site_backends={"dot0": "dgemm"})
        assert torch.equal(offload(lambda a, b: a @ b, pol)(a, b), a @ b)

    def test_gradient_inside_offload_adds_no_sites(self):
        # A gradient taken inside fn adds no sites of its own making:
        # only the reference's cotangent sites (dot1, dot2 of jax.grad
        # inside the traced function); the products the backward runs
        # are never caught as new forward sites.
        a_np = _arr((32, 32), 19)
        a = torch.from_numpy(a_np).requires_grad_()

        def f(a):
            y = (a @ a).sum()
            (g,) = torch.autograd.grad(y, a)
            return g

        def f_jax(a):
            return jax.grad(lambda a: jnp.sum(a @ a))(a)

        p_ref, pol = _policies(min_dim=16, backend="fp64_int8_5")
        want = [_record(s) for s in offload_ref(f_jax, p_ref).sites(
            jnp.asarray(a_np))]
        assert [s.name for s in offload(f, pol).sites(a)] == \
            ["dot0", "dot1", "dot2"]
        assert [_record(s)[3:] for s in offload(f, pol).sites(a)] == \
            [w[3:] for w in want]
        offload(f, pol)(a)


class TestUnmatchedOverrides:
    def test_raise(self):
        a = torch.ones(32, 32)
        pol = PrecisionPolicy(min_dim=16, site_splits={"dot9": 4},
                              on_unmatched_site="raise")
        with pytest.raises(ValueError, match="dot9"):
            offload(lambda a: a @ a, pol)(a)

    def test_warn_and_ignore(self):
        a = torch.ones(32, 32)
        with pytest.warns(UserWarning, match="dot9"):
            offload(lambda a: a @ a, PrecisionPolicy(
                min_dim=16, site_splits={"dot9": 4}))(a)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            offload(lambda a: a @ a, PrecisionPolicy(
                min_dim=16, site_splits={"dot9": 4},
                on_unmatched_site="ignore"))(a)


def _scan_program_jax(x, ws):
    def inner(c, w):
        return c @ w, None

    def body(c, w):
        h = c @ w["a"]
        h, _ = jax.lax.scan(inner, h, w["c"])
        return h @ w["b"] * 0.5, None

    x, _ = jax.lax.scan(body, x, ws)
    y = x @ ws["a"][0]
    y, _ = jax.lax.scan(inner, y, ws["b"])
    return y


def _scan_program_torch(x, ws):
    def inner(c, w):
        return c @ w, None

    def body(c, w):
        h = c @ w["a"]
        h, _ = scan(inner, h, w["c"])
        return h @ w["b"] * 0.5, None

    x, _ = scan(body, x, ws)
    y = x @ ws["a"][0]
    y, _ = scan(inner, y, ws["b"])
    return y


def _scan_inputs(dtype=np.float64):
    x = _arr((160, 144), 30, dtype)
    ws = {"a": _arr((3, 144, 144), 31, dtype) * 0.1,
          "b": _arr((3, 144, 144), 32, dtype) * 0.1,
          "c": _arr((3, 2, 144, 144), 33, dtype) * 0.1}
    return x, ws


def _mult_record(site):
    return _record(site) + (site.mult,)


class TestScanScopes:
    @pytest.mark.parametrize("kw", [
        dict(min_dim=128),
        dict(min_dim=128, site_splits={"scan0/scan0/dot0": 9},
             site_backends={"scan0/dot1": "dgemm"}),
        dict(min_dim=200),
    ])
    def test_site_names_mult_and_decisions_match(self, kw):
        x, ws = _scan_inputs()
        p_ref, p_port = _policies(**kw)
        r = site_report_ref(_scan_program_jax, p_ref)(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in ws.items()})
        t = site_report(_scan_program_torch, p_port)(
            torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in ws.items()})
        assert [_mult_record(s) for s in t] == [_mult_record(s) for s in r]
        assert [s.name for s in t] == [
            "scan0/dot0", "scan0/scan0/dot0", "scan0/dot1", "dot0",
            "scan1/dot0"]
        assert [s.mult for s in t] == [3, 6, 3, 1, 3]

    def test_offloaded_scan_bitwise(self):
        x, ws = _scan_inputs()
        p_ref, p_port = _policies(min_dim=128, backend="fp64_int8_5")
        r = offload_ref(_scan_program_jax, p_ref)(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in ws.items()})
        t = offload(_scan_program_torch, p_port)(
            torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in ws.items()})
        assert same_bits(r, t)

    def test_scan_stacks_outputs_and_runs_without_offload(self):
        xs = (torch.arange(6.0).reshape(3, 2), torch.ones(3))

        def body(c, x):
            a, b = x
            return c + b, {"sum": a.sum(), "pair": (a, b)}

        c, ys = scan(body, torch.tensor(0.0), xs)
        assert float(c) == 3.0
        assert ys["sum"].tolist() == [1.0, 5.0, 9.0]
        assert torch.equal(ys["pair"][0], xs[0])
        assert scan(lambda c, x: (c, None), 0, torch.zeros(2)) == (0, None)


class TestEinsumSites:
    @pytest.mark.parametrize("eq,sa,sb", [
        ("bthd,bshd->bhts", (2, 64, 4, 32), (2, 128, 4, 32)),
        ("bhts,bshd->bthd", (2, 4, 64, 128), (2, 128, 4, 32)),
        ("bthd,bshd->bhts", (2, 1, 4, 32), (2, 128, 4, 32)),
        ("ij,jk->ik", (130, 140), (140, 150)),
        ("ij,kj->ik", (130, 140), (150, 140)),
        ("bij,jk->bik", (3, 130, 140), (140, 150)),
        ("bij,bjk->bik", (1, 130, 140), (3, 140, 150)),
    ])
    def test_sites_and_results_match(self, eq, sa, sb):
        a, b = _arr(sa, 40), _arr(sb, 41)
        p_ref, p_port = _policies(min_dim=16, backend="fp64_int8_6")
        r = site_report_ref(lambda x, y: jnp.einsum(eq, x, y), p_ref)(
            jnp.asarray(a), jnp.asarray(b))
        t = site_report(lambda x, y: torch.einsum(eq, x, y), p_port)(
            torch.from_numpy(a), torch.from_numpy(b))
        assert [_record(s) for s in t] == [_record(s) for s in r]
        r = offload_ref(lambda x, y: jnp.einsum(eq, x, y), p_ref)(
            jnp.asarray(a), jnp.asarray(b))
        t = offload(lambda x, y: torch.einsum(eq, x, y), p_port)(
            torch.from_numpy(a), torch.from_numpy(b))
        assert same_bits(r, t)

    def test_unsupported_forms_raise(self):
        """The name is kept from when these equations raised
        NotImplementedError; the test now holds each to the reference:
        the same site records and the same bits."""
        a = _arr((4, 4), 42)
        pol_ref, pol = _policies(min_dim=1, backend="fp64_int8_6")
        for eq in ("ii,ij->j", "...i,ij->...j"):
            r = site_report_ref(lambda x: jnp.einsum(eq, x, x), pol_ref)(
                jnp.asarray(a))
            t = site_report(lambda x: torch.einsum(eq, x, x), pol)(
                torch.from_numpy(a))
            assert [_record(s) for s in t] == [_record(s) for s in r], eq
            assert same_bits(
                offload_ref(lambda x: jnp.einsum(eq, x, x), pol_ref)(
                    jnp.asarray(a)),
                offload(lambda x: torch.einsum(eq, x, x), pol)(
                    torch.from_numpy(a))), eq
        # One operand is not a matmul: no site, runs natively.
        assert site_report(lambda x: torch.einsum("ij->j", x), pol)(
            torch.from_numpy(a)) == []


# Every torch entry point whose jnp counterpart lowers to dot_general,
# beside that counterpart: (id, jnp program, torch program, operand
# shapes).  The vector forms' sites have m or n = 1.
_ENTRY_POINTS = [
    ("tensordot-int", lambda a, b: jnp.tensordot(a, b, 1),
     lambda a, b: torch.tensordot(a, b, 1), [(64, 40), (40, 48)]),
    ("tensordot-2", lambda a, b: jnp.tensordot(a, b, 2),
     lambda a, b: torch.tensordot(a, b), [(36, 8, 40), (8, 40, 48)]),
    ("tensordot-pair", lambda a, b: jnp.tensordot(a, b, ([0, 2], [2, 1])),
     lambda a, b: torch.tensordot(a, b, dims=([0, 2], [2, 1])),
     [(4, 64, 40), (48, 40, 4)]),
    ("tensordot-ints", lambda a, b: jnp.tensordot(a, b, (1, 0)),
     lambda a, b: torch.tensordot(a, b, dims=([1], [0])),
     [(64, 40), (40, 48)]),
    ("linalg.matmul", jnp.linalg.matmul, torch.linalg.matmul,
     [(2, 64, 40), (40, 48)]),
    ("inner", jnp.inner, torch.inner, [(64, 40), (48, 40)]),
    ("Tensor.inner", jnp.inner, torch.Tensor.inner,
     [(3, 64, 40), (48, 40)]),
    ("multi_dot-3", lambda *m: jnp.linalg.multi_dot(m),
     lambda *m: torch.linalg.multi_dot(m), [(64, 40), (40, 96), (96, 48)]),
    ("multi_dot-tie", lambda *m: jnp.linalg.multi_dot(m),
     lambda *m: torch.linalg.multi_dot(m), [(64, 64)] * 3),
    ("multi_dot-4", lambda *m: jnp.linalg.multi_dot(m),
     lambda *m: torch.linalg.multi_dot(m),
     [(64, 40), (40, 50), (50, 64), (64, 33)]),
    ("multi_dot-1d", lambda *m: jnp.linalg.multi_dot(m),
     lambda *m: torch.linalg.multi_dot(m), [(64,), (64, 40), (40, 48)]),
    ("chain_matmul", lambda *m: jnp.linalg.multi_dot(m),
     torch.chain_matmul, [(64, 40), (40, 96), (96, 48)]),
    ("baddbmm", lambda x, a, b: x + a @ b, torch.baddbmm,
     [(3, 64, 48), (3, 64, 40), (3, 40, 48)]),
    ("baddbmm-beta-alpha", lambda x, a, b: 0.5 * x + 2.0 * (a @ b),
     lambda x, a, b: torch.baddbmm(x, a, b, beta=0.5, alpha=2.0),
     [(3, 64, 48), (3, 64, 40), (3, 40, 48)]),
    ("addbmm", lambda x, a, b: x + jnp.einsum("bij,bjk->ik", a, b),
     torch.addbmm, [(64, 48), (3, 64, 40), (3, 40, 48)]),
    ("Tensor.addbmm", lambda x, a, b: x + jnp.einsum("bij,bjk->ik", a, b),
     torch.Tensor.addbmm, [(64, 48), (3, 64, 40), (3, 40, 48)]),
    ("addmv", lambda x, a, v: x + a @ v, torch.addmv,
     [(64,), (64, 40), (40,)]),
    ("mv", lambda a, v: a @ v, torch.mv, [(64, 40), (40,)]),
    ("Tensor.mv", lambda a, v: a @ v, torch.Tensor.mv, [(64, 40), (40,)]),
    ("dot", jnp.dot, torch.dot, [(64,), (64,)]),
    ("vdot", jnp.vdot, torch.vdot, [(64,), (64,)]),
    ("vecdot", jnp.linalg.vecdot, torch.linalg.vecdot, [(40, 64), (40, 64)]),
    ("vecdot-1d", jnp.linalg.vecdot, torch.linalg.vecdot, [(64,), (64,)]),
    ("vecdot-broadcast", jnp.linalg.vecdot, torch.linalg.vecdot,
     [(4, 40, 64), (40, 64)]),
    ("vecdot-squeeze", jnp.linalg.vecdot, torch.linalg.vecdot,
     [(3, 1, 5, 64), (4, 5, 64)]),
    ("vecdot-dim", lambda a, b: jnp.linalg.vecdot(a, b, axis=1),
     lambda a, b: torch.linalg.vecdot(a, b, dim=1),
     [(3, 64, 5), (1, 64, 5)]),
]

# The in-place forms: (id, jnp program, method, operand shapes).
_IN_PLACE = [
    ("addmm_", lambda x, a, b: x + a @ b, torch.Tensor.addmm_,
     [(64, 48), (64, 40), (40, 48)]),
    ("baddbmm_", lambda x, a, b: x + a @ b, torch.Tensor.baddbmm_,
     [(3, 64, 48), (3, 64, 40), (3, 40, 48)]),
    ("addbmm_", lambda x, a, b: x + jnp.einsum("bij,bjk->ik", a, b),
     torch.Tensor.addbmm_, [(64, 48), (3, 64, 40), (3, 40, 48)]),
    ("addmv_", lambda x, a, v: x + a @ v, torch.Tensor.addmv_,
     [(64,), (64, 40), (40,)]),
]

def _mm(a, b):
    return a @ b


def _bmm_sum(a, b):
    return jnp.einsum("bij,bjk->ik", a, b)


# Every add form: (id, function, in place, its jnp product, shapes of
# input, mat1, mat2).
_ADD_FORMS = [
    ("addmm", torch.addmm, False, _mm, [(64, 48), (64, 40), (40, 48)]),
    ("Tensor.addmm", torch.Tensor.addmm, False, _mm,
     [(64, 48), (64, 40), (40, 48)]),
    ("addmm_", torch.Tensor.addmm_, True, _mm,
     [(64, 48), (64, 40), (40, 48)]),
    ("addmv", torch.addmv, False, _mm, [(64,), (64, 40), (40,)]),
    ("Tensor.addmv", torch.Tensor.addmv, False, _mm,
     [(64,), (64, 40), (40,)]),
    ("addmv_", torch.Tensor.addmv_, True, _mm, [(64,), (64, 40), (40,)]),
    ("baddbmm", torch.baddbmm, False, _mm,
     [(3, 64, 48), (3, 64, 40), (3, 40, 48)]),
    ("Tensor.baddbmm", torch.Tensor.baddbmm, False, _mm,
     [(3, 64, 48), (3, 64, 40), (3, 40, 48)]),
    ("baddbmm_", torch.Tensor.baddbmm_, True, _mm,
     [(3, 64, 48), (3, 64, 40), (3, 40, 48)]),
    ("addbmm", torch.addbmm, False, _bmm_sum,
     [(64, 48), (3, 64, 40), (3, 40, 48)]),
    ("Tensor.addbmm", torch.Tensor.addbmm, False, _bmm_sum,
     [(64, 48), (3, 64, 40), (3, 40, 48)]),
    ("addbmm_", torch.Tensor.addbmm_, True, _bmm_sum,
     [(64, 48), (3, 64, 40), (3, 40, 48)]),
]

# The einsum forms jnp.einsum reads with opt_einsum's parser: ellipses,
# implicit outputs and indices repeated within an operand.
_EINSUM_FORMS = [
    ("...ij,...jk->...ik", [(4, 64, 40), (4, 40, 48)]),
    ("...ij,jk->...ik", [(2, 3, 64, 40), (40, 48)]),
    ("...ij,...jk", [(4, 64, 40), (1, 40, 48)]),
    ("bij,bjk", [(4, 64, 40), (4, 40, 48)]),
    ("ij,jk,kl", [(64, 40), (40, 96), (96, 48)]),
    ("bii,bij->bj", [(4, 64, 64), (4, 64, 48)]),
    ("iik,kj->ij", [(64, 64, 40), (40, 48)]),
    ("kii,kj->ij", [(40, 64, 64), (40, 48)]),
    ("iij,jk->k", [(8, 8, 64), (64, 48)]),
]


def _same_values(ref, port):
    if isinstance(ref, tuple):
        return all(same_bits(r, t) for r, t in zip(ref, port))
    return same_bits(ref, port)


def _parity(f_jax, f_torch, shapes, seed, **kw):
    """Site records (each the reference's?) and offloaded values
    (bitwise?) of the two programs on the same seeded operands."""
    args = [_arr(shape, seed + i) for i, shape in enumerate(shapes)]
    p_ref, p_port = _policies(backend="fp64_int8_6", **kw)
    r = site_report_ref(f_jax, p_ref)(*map(jnp.asarray, args))
    t = site_report(f_torch, p_port)(*map(torch.from_numpy, args))
    want = offload_ref(f_jax, p_ref)(*map(jnp.asarray, args))
    got = offload(f_torch, p_port)(*map(torch.from_numpy, args))
    return [_record(s) for s in t], [_record(s) for s in r], want, got


class TestEntryPoints:
    """F6: every entry point is a site, or a chain of sites, with the
    reference's records; offloaded, the values are the reference's
    bits."""

    @pytest.mark.parametrize("case", _ENTRY_POINTS, ids=lambda c: c[0])
    def test_gated_sites_match_reference(self, case):
        _, f_jax, f_torch, shapes = case
        got, want, r, t = _parity(f_jax, f_torch, shapes, 50, min_dim=32)
        assert got == want
        assert len(got) >= 1
        np.testing.assert_allclose(np.asarray(r), np.asarray(t),
                                   rtol=1e-10, atol=1e-10)

    @pytest.mark.parametrize("case", _ENTRY_POINTS, ids=lambda c: c[0])
    def test_offloaded_sites_bitwise(self, case):
        _, f_jax, f_torch, shapes = case
        got, want, r, t = _parity(f_jax, f_torch, shapes, 60, min_dim=1)
        assert got == want
        assert all(rec[3] for rec in got)   # every site offloaded
        assert same_bits(r, t)

    @pytest.mark.parametrize("case", _IN_PLACE, ids=lambda c: c[0])
    def test_in_place_forms_write_self(self, case):
        _, f_jax, method, shapes = case
        args = [_arr(shape, 70 + i) for i, shape in enumerate(shapes)]
        p_ref, p_port = _policies(backend="fp64_int8_6", min_dim=1)
        r = site_report_ref(f_jax, p_ref)(*map(jnp.asarray, args))
        # Copies: jnp.asarray may share the numpy buffer, and the
        # reference's asynchronous dispatch must not read self written.
        x, *ops = (torch.from_numpy(a.copy()) for a in args)
        t = site_report(lambda x, *o: method(x.clone(), *o), p_port)(x, *ops)
        assert [_record(s) for s in t] == [_record(s) for s in r]
        want = offload_ref(f_jax, p_ref)(*map(jnp.asarray, args))
        out = offload(method, p_port)(x, *ops)
        assert out is x
        assert same_bits(want, x)

    @pytest.mark.parametrize("alpha", [1.0, 2.0])
    @pytest.mark.parametrize("case", _ADD_FORMS, ids=lambda c: c[0])
    def test_beta_zero_ignores_input(self, case, alpha):
        # torch reads no input at beta=0 (attention's baddbmm on an
        # empty buffer): a NaN-filled one gives the native result, and
        # the bits of the reference's alpha * (mat1 @ mat2).
        _, fn, in_place, prod, shapes = case
        a, b = (_arr(shape, 76 + i) for i, shape in enumerate(shapes[1:]))
        p_ref, p_port = _policies(backend="fp64_int8_6", min_dim=1)

        def f_jax(a, b):
            return alpha * prod(a, b)

        def f_torch(x, a, b):
            return fn(x, a, b, beta=0, alpha=alpha)

        x, ta, tb = (torch.from_numpy(np.full(shapes[0], np.nan)),
                     torch.from_numpy(a), torch.from_numpy(b))
        r = site_report_ref(f_jax, p_ref)(jnp.asarray(a), jnp.asarray(b))
        t = site_report(lambda x, a, b: f_torch(x.clone(), a, b),
                        p_port)(x, ta, tb)
        assert [_record(s) for s in t] == [_record(s) for s in r]
        native = f_torch(x.clone(), ta, tb)
        assert torch.isfinite(native).all()
        want = offload_ref(f_jax, p_ref)(jnp.asarray(a), jnp.asarray(b))
        out = offload(f_torch, p_port)(x, ta, tb)
        assert (out is x) == in_place
        assert same_bits(want, out)
        # Six int8 slices: the emulation's error, not the input's NaN.
        np.testing.assert_allclose(out.numpy(), native.numpy(), rtol=0,
                                   atol=1e-6 * native.abs().max().item())

    def test_gated_mv_shifts_the_next_name(self):
        a, v, b = _arr((64, 40), 80), _arr((40,), 81), _arr((40, 48), 82)
        p_ref, p_port = _policies(backend="fp64_int8_6", min_dim=32)
        r = site_report_ref(lambda a, v, b: (a @ v, a @ b), p_ref)(
            *map(jnp.asarray, (a, v, b)))
        t = site_report(lambda a, v, b: (torch.mv(a, v), a @ b), p_port)(
            *map(torch.from_numpy, (a, v, b)))
        assert [_record(s) for s in t] == [_record(s) for s in r]
        assert [(s.name, s.offloaded) for s in t] == [("dot0", False),
                                                      ("dot1", True)]

    @pytest.mark.parametrize("fn", [torch.outer, torch.kron])
    def test_products_without_dot_general_have_no_site(self, fn):
        a = torch.from_numpy(_arr((64,), 83))
        assert site_report(fn, PrecisionPolicy(min_dim=1))(a, a) == []

    def test_out_argument_runs_natively(self):
        a = torch.from_numpy(_arr((64, 64), 84))
        out = torch.empty(64, 64, dtype=torch.float64)
        sites = site_report(lambda a: torch.tensordot(a, a, 1, out=out),
                            PrecisionPolicy(min_dim=1))(a)
        assert sites == []

    def test_gradient_through_tensordot_matches_reference(self):
        a, b = _arr((64, 40), 85), _arr((40, 48), 86)
        p_ref, p_port = _policies(backend="fp64_int8_6", min_dim=32)

        def f_jax(a, b):
            return jax.grad(lambda a, b: jnp.sum(jnp.tanh(
                jnp.tensordot(a, b, 1))), argnums=(0, 1))(a, b)

        def f_torch(a, b):
            a, b = a.requires_grad_(), b.requires_grad_()
            with torch.enable_grad():
                loss = torch.tanh(torch.tensordot(a, b, 1)).sum()
                return torch.autograd.grad(loss, (a, b))

        want = offload_ref(f_jax, p_ref)
        got = offload(f_torch, p_port)
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        assert [_record(s) for s in got.sites(torch.from_numpy(a),
                                              torch.from_numpy(b))] == \
            [_record(s) for s in want.sites(ja, jb)]
        assert _same_values(want(ja, jb), got(torch.from_numpy(a),
                                              torch.from_numpy(b)))


class TestEinsumForms:
    """F7: the forms ``offload`` once refused, lowered as ``jnp.einsum``
    lowers them."""

    @pytest.mark.parametrize("eq,shapes", _EINSUM_FORMS)
    @pytest.mark.parametrize("min_dim", [32, 1])
    def test_sites_and_values_match_reference(self, eq, shapes, min_dim):
        got, want, r, t = _parity(
            lambda *x: jnp.einsum(eq, *x), lambda *x: torch.einsum(eq, *x),
            shapes, 90, min_dim=min_dim)
        assert got == want
        if all(rec[3] for rec in got):
            assert same_bits(r, t)
        else:
            np.testing.assert_allclose(np.asarray(r), np.asarray(t),
                                       rtol=1e-10, atol=1e-10)

    def test_issue_forms_records(self):
        # The three equations at 64-wide operands: one site each, the
        # diagonal's gated by min_dim.
        pol = PrecisionPolicy(default_splits=6, min_dim=32)
        b3 = torch.from_numpy(_arr((4, 64, 64), 95))
        got = [[(s.name, s.offloaded, s.m, s.k, s.n, s.batch)
                for s in site_report(lambda x, y: torch.einsum(eq, x, y),
                                     pol)(b3, b3)]
               for eq in ("...ij,...jk->...ik", "bij,bjk", "bii,bij->bj")]
        assert got == [[("dot0", True, 64, 64, 64, 4)],
                       [("dot0", True, 64, 256, 64, 1)],
                       [("dot0", False, 1, 64, 64, 4)]]


def _train_step_pair():
    """The reference's and the port's train step on the tiny LM (2
    layers, d 64, d_ff 192, vocab 160), the same weights, state and
    batch for each."""
    from repro.configs import get_config as get_config_ref
    from repro.launch.train import build_train_step as build_ref
    from repro.models import Model as ModelRef
    from repro.train import AdamW as AdamWRef
    from repro.train import SyntheticText
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_train_step
    from repro_torch.models import Model, params_from_reference
    from repro_torch.train import AdamW

    over = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, d_ff=192, vocab_size=160)
    ref = ModelRef(get_config_ref("tiny").replace(**over))
    params = ref.init_params(jax.random.PRNGKey(0))
    params["lm_head"] = jnp.asarray(np.random.default_rng(1).standard_normal(
        params["lm_head"].shape) * 0.1, jnp.float32)
    batch = SyntheticText(160, 24, 4).batch(0)
    port = Model(get_config("tiny").replace(**over), device="cpu")
    p_port = params_from_reference(
        jax.tree_util.tree_map(np.asarray, params), "cpu")
    return ((build_ref(ref, AdamWRef()),
             (params, AdamWRef().init(params), jnp.asarray(batch))),
            (build_train_step(port, AdamW()),
             (p_port, AdamW().init(p_port), torch.from_numpy(batch))))


def _geometry(site):
    return (site.name, site.m, site.k, site.n, site.batch, site.mult,
            site.offloaded, site.splits, site.eligible, site.reason,
            site.backend)


class TestBackwardSites:
    """A gradient taken inside the offloaded function: each cotangent is
    a site of its own, named, ordered and shaped as the reference's
    ``value_and_grad`` jaxpr names them."""

    @pytest.fixture(scope="class")
    def steps(self):
        return _train_step_pair()

    @pytest.mark.parametrize("kw", [
        dict(backend="fp64_int8_4", min_dim=16),
        dict(backend="fp64_int8_4", min_dim=128),
        dict(backend="pallas_int8", min_dim=16,
             site_splits={"scan1/dot3": 9, "dot2": 3},
             site_backends={"scan0/dot6": "dgemm", "scan1/dot0": "dgemm"}),
    ])
    def test_train_step_sites_match_reference(self, steps, kw):
        (ref_step, ref_args), (port_step, port_args) = steps
        p_ref, p_port = _policies(**kw)
        want = [_geometry(s) for s in offload_ref(ref_step, p_ref).sites(
            *ref_args)]
        got = [_geometry(s) for s in offload(port_step, p_port).sites(
            *port_args)]
        assert got == want
        assert len(got) == 30
        assert [g[0] for g in got[9:12]] == ["dot0", "dot1", "dot2"]
        # Down (96, 192, 64) is forward dot 8 of 9: its rhs cotangent is
        # scan1/dot0 as (n, m, k), its lhs cotangent scan1/dot1 (m, n, k).
        assert got[12][:4] == ("scan1/dot0", 64, 96, 192)
        assert got[13][:4] == ("scan1/dot1", 96, 64, 192)

    def test_backward_overrides_change_only_their_site(self, steps):
        _, (port_step, port_args) = steps
        base = offload(port_step, PrecisionPolicy(
            backend="pallas_int8", min_dim=16)).sites(*port_args)
        pol = PrecisionPolicy(backend="pallas_int8", min_dim=16,
                              site_splits={"scan1/dot3": 9},
                              on_unmatched_site="raise")
        tuned = offload(port_step, pol).sites(*port_args)
        changed = [(a.name, a.splits, b.splits) for a, b in zip(base, tuned)
                   if _geometry(a) != _geometry(b)]
        assert changed == [("scan1/dot3", 6, 9)]
        # The forward site scan0/dot6 demoted to dgemm: its cotangents
        # stay offloaded, and the step still runs and trains.
        pol = PrecisionPolicy(backend="fp64_int8_4", min_dim=16,
                              site_backends={"scan0/dot6": "dgemm"},
                              on_unmatched_site="raise")
        wrapped = offload(port_step, pol)
        sites = {s.name: s for s in wrapped.sites(*port_args)}
        assert not sites["scan0/dot6"].offloaded
        assert sites["scan1/dot4"].offloaded and sites["scan1/dot5"].offloaded
        _, _, loss = wrapped(*port_args)
        assert torch.isfinite(loss)

    def test_adaptive_keeps_separate_states(self, steps):
        _, (port_step, port_args) = steps
        wrapped = offload(port_step, PrecisionPolicy(
            backend="adaptive:1e-5", min_dim=16))
        _, _, loss = wrapped(*port_args)
        assert torch.isfinite(loss)
        states = wrapped.backend.gemm.sites
        names = {s.name for s in wrapped.sites(*port_args) if s.offloaded}
        assert set(states) == names
        assert {"scan0/dot8", "scan1/dot0", "scan1/dot1", "dot0", "dot1",
                "dot2"} <= set(states)
        # Each backward site was probed on its own operands and runs once
        # per layer, like its forward site.
        assert states["scan1/dot0"].calls == states["scan0/dot8"].calls == 2
        assert states["dot1"].calls == 1

    @pytest.mark.parametrize("min_dim", [16, 128])
    def test_count_int8_gemms_matches_reference(self, steps, min_dim):
        from repro.tune.solve import count_int8_gemms as count_ref
        from repro_torch.tune import count_int8_gemms

        (ref_step, ref_args), (port_step, port_args) = steps
        p_ref, p_port = _policies(backend="fp64_int8_4", min_dim=min_dim)
        want = count_ref(offload_ref(ref_step, p_ref).sites(*ref_args))
        got = count_int8_gemms(offload(port_step, p_port).sites(*port_args))
        assert got == want
        # Per layer 7 projection sites and 2 attention einsums (batch
        # 16), plus the head; each forward product has two cotangents;
        # s = 6 (the policy's default) is 21 pair GEMMs.
        assert got == (21 * 3 * (2 * (7 + 2 * 16) + 1)
                       if min_dim == 16 else 0)

    def test_gated_out_sites_keep_the_native_gradient(self):
        # Below min_dim nothing is offloaded: the cotangent records
        # exist (offloaded=False) and the gradient is torch's own, bit
        # for bit.
        a = torch.from_numpy(_arr((32, 48), 50))
        b = torch.from_numpy(_arr((48, 40), 51))

        def f(a, b):
            a = a.clone().requires_grad_()
            b = b.clone().requires_grad_()
            return torch.autograd.grad(torch.tanh(a @ b).sum(), (a, b))

        pol = PrecisionPolicy(min_dim=64, backend="fp64_int8_5")
        sites = offload(f, pol).sites(a, b)
        assert [(s.name, s.m, s.k, s.n, s.offloaded) for s in sites] == [
            ("dot0", 32, 48, 40, False), ("dot1", 40, 32, 48, False),
            ("dot2", 32, 40, 48, False)]
        for got, want in zip(offload(f, pol)(a, b), f(a, b)):
            assert torch.equal(got, want)

    @pytest.mark.parametrize("frozen", [0, 1])
    def test_swapped_einsum_with_a_frozen_operand(self, frozen):
        # 'ij,kj->ki' packs its operands swapped (W first): the one
        # cotangent taken is named and shaped as the reference's, and
        # the gradient equals the native one.
        x_np, w_np = _arr((32, 48), 54), _arr((40, 48), 55)

        def f(x, w):
            ops = [x.clone(), w.clone()]
            ops[1 - frozen].requires_grad_()
            y = torch.einsum("ij,kj->ki", *ops)
            (g,) = torch.autograd.grad(torch.tanh(y).sum(), ops[1 - frozen])
            return g

        def f_jax(x, w):
            loss = lambda x, w: jnp.sum(jnp.tanh(jnp.einsum("ij,kj->ki",
                                                            x, w)))
            return jax.grad(loss, argnums=1 - frozen)(x, w)

        p_ref, pol = _policies(min_dim=16, backend="fp64_int8_5")
        want = [_record(s) for s in offload_ref(f_jax, p_ref).sites(
            jnp.asarray(x_np), jnp.asarray(w_np))]
        args = torch.from_numpy(x_np), torch.from_numpy(w_np)
        got = [_record(s) for s in offload(f, pol).sites(*args)]
        assert [r[0] for r in got] == ["dot0", "dot1"]
        assert got == want
        got = offload(f, pol)(*args)
        assert same_bits(offload_ref(f_jax, p_ref)(
            jnp.asarray(x_np), jnp.asarray(w_np)), got)
        # Against the native gradient (entries up to 7): the forward
        # product at s = 5 is off by up to 5.1e-7 here, through tanh'.
        torch.testing.assert_close(got, f(*args), rtol=0, atol=2e-6)

    # Programs the reference names without a cotangent for every
    # product: one whose product never reaches the loss, and two
    # gradient passes in one call (the second differentiating b only,
    # though b takes a gradient in the first pass's graph too).
    @staticmethod
    def _dead_product_jax(a, b, c):
        def loss(a, b, c):
            y = a @ b
            dead = y @ c
            return jnp.sum(jnp.tanh(y @ b.T)), dead

        (val, dead), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(a, b, c)
        return val, dead, g

    @staticmethod
    def _dead_product_torch(a, b, c):
        a, b, c = (x.clone().requires_grad_() for x in (a, b, c))
        y = a @ b
        dead = y @ c
        loss = torch.sum(torch.tanh(y @ b.T))
        g = torch.autograd.grad(loss, (a, b, c), allow_unused=True)
        return loss, dead, g

    @staticmethod
    def _two_passes_jax(a, b, c):
        g1 = jax.grad(lambda a: jnp.sum(jnp.tanh(a @ b)))(a)
        return jax.grad(lambda b: jnp.sum(jnp.tanh(g1 @ b @ c)))(b)

    @staticmethod
    def _two_passes_torch(a, b, c):
        a, b = a.clone().requires_grad_(), b.clone().requires_grad_()
        (g1,) = torch.autograd.grad(torch.sum(torch.tanh(a @ b)), (a,))
        (g2,) = torch.autograd.grad(torch.sum(torch.tanh(g1 @ b @ c)),
                                    (b,))
        return g2

    @pytest.mark.parametrize("min_dim", [16, 128])
    @pytest.mark.parametrize("program", ["dead_product", "two_passes"])
    def test_sites_match_reference_beyond_one_pass(self, program, min_dim):
        # min_dim 16 routes every product (and cotangent) through the
        # engine, 128 leaves them native (hooks name the cotangents).
        fj = getattr(self, f"_{program}_jax")
        ft = getattr(self, f"_{program}_torch")
        arrays = _arr((32, 48), 60), _arr((48, 40), 61), _arr((40, 24), 62)
        p_ref, pol = _policies(min_dim=min_dim, backend="fp64_int8_5")
        want = [_record(s) for s in offload_ref(fj, p_ref).sites(
            *map(jnp.asarray, arrays))]
        args = [torch.from_numpy(x) for x in arrays]
        got = [_record(s) for s in offload(ft, pol).sites(*args)]
        assert got == want
        assert len(got) == (7 if program == "dead_product" else 6)
        # The offloaded call runs (no cotangent without a site): the dead
        # product, emulated, is the reference's to the bit; the outputs
        # (native products, sums of cotangents and of tanh' terms, in
        # other orders) agree to 1e-12 of their largest entry.
        out = jax.tree_util.tree_leaves(offload_ref(fj, p_ref)(
            *map(jnp.asarray, arrays)))
        mine = [x.detach() for x in jax.tree_util.tree_leaves(
            offload(ft, pol)(*args)) if x is not None]
        if program == "dead_product":
            assert same_bits(out[1], mine[1]) or min_dim == 128
            out, mine = out[:4], mine[:4]   # c's gradient: None here
        for a, b in zip(out, mine):
            a = np.asarray(a)
            assert np.abs(a - b.numpy()).max() <= 1e-12 * np.abs(a).max()

    def test_loss_backward_names_like_grad(self):
        # Tensor.backward() starts a pass too: the cotangents of the
        # products that reach the loss, onto every leaf.
        arrays = _arr((32, 48), 63), _arr((48, 40), 64), _arr((40, 24), 65)

        def f(a, b, c):
            a, b, c = (x.clone().requires_grad_() for x in (a, b, c))
            y = a @ b
            dead = y @ c
            torch.sum(torch.tanh(y @ b.T)).backward()
            return a.grad, b.grad, dead

        def g(a, b, c):
            loss, dead, grads = self._dead_product_torch(a, b, c)
            return grads[0], grads[1], dead

        pol = PrecisionPolicy(min_dim=16, backend="fp64_int8_5")
        args = [torch.from_numpy(x) for x in arrays]
        assert [_record(s) for s in offload(f, pol).sites(*args)] == \
            [_record(s) for s in offload(g, pol).sites(*args)]
        for x, y in zip(offload(f, pol)(*args), offload(g, pol)(*args)):
            assert torch.equal(x, y)

    @pytest.mark.parametrize("s", [3, 6, 9])
    def test_rhs_cotangent_orientations_bitwise(self, s):
        # (g^T @ lhs)^T, the reference's orientation and the port's,
        # equals lhs^T @ g to the bit, in both accumulators and through
        # the kernel family (plain K1 here).
        from repro_torch.core import get_backend
        from repro_torch.core import ozaki_matmul

        x = torch.from_numpy(_arr((256, 192), 52, np.float32))
        g = torch.from_numpy(_arr((256, 160), 53, np.float32))
        for acc in ("df32", "f64"):
            assert torch.equal(
                ozaki_matmul(g.T, x, s, accumulator=acc).T,
                ozaki_matmul(x.T, g, s, accumulator=acc))
        kernel = get_backend(f"pallas_int8_{s}")
        assert torch.equal(kernel(g.T, x).T, kernel(x.T, g))
