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
        a = torch.from_numpy(_arr((32, 32), 19)).requires_grad_()

        def f(a):
            y = (a @ a).sum()
            (g,) = torch.autograd.grad(y, a)
            return g

        pol = PrecisionPolicy(min_dim=16, backend="fp64_int8_5")
        assert [s.name for s in offload(f, pol).sites(a)] == ["dot0"]
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
        a = torch.ones(4, 4)
        pol = PrecisionPolicy(min_dim=1)
        with pytest.raises(NotImplementedError):
            site_report(lambda x: torch.einsum("ii,ij->j", x, x), pol)(a)
        with pytest.raises(NotImplementedError):
            site_report(lambda x: torch.einsum("...i,ij->...j", x, x),
                        pol)(a)
        # One operand is not a matmul: no site, runs natively.
        assert site_report(lambda x: torch.einsum("ij->j", x), pol)(a) == []
