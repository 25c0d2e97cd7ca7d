"""The slicing kernel's wrapper and plan on the CPU.

``kernels.slicing.slice_operand`` returns ``slice_matrix``'s result for
CPU tensors and launches ``csrc/slice_operand.cu`` for CUDA ones; the
card tests (``tests/test_torch_cuda.py``) hold the kernel bitwise
against ``slice_matrix`` there, under its own plans and forced ones.
Here: the CPU contract, the spans of ``ozaki_matmul`` around it, the
build's digest and the plan's limits.
"""

import ctypes
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import ozaki as ozaki_ref
from repro_torch.core.ozaki import _INV_LN2, slice_matrix
from repro_torch.kernels import _build, ops, slicing
from repro_torch.obs import trace

# One intra-op thread: tier-1 runs several test processes at once,
# and torch's default thread pool per process oversubscribes the CPU.
torch.set_num_threads(1)

CU = (pathlib.Path(slicing.__file__).resolve().parent / "csrc"
      / "slice_operand.cu")
THREADS = 256


def _layouts(m, k, dtype, seed=0):
    """(name, x) for an (m, k) operand held contiguous, as the transposed
    view of a (k, m) tensor, and as the real and imaginary views of a
    complex one (element stride 2)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((m, k)) * np.exp2(
        rng.integers(-30, 30, (m, 1)))
    plain = torch.from_numpy(base).to(dtype)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    cplx = torch.complex(plain, torch.from_numpy(
        rng.standard_normal((m, k))).to(dtype)).to(ctype)
    return [("contiguous", plain),
            ("transposed", plain.T.contiguous().T),
            ("real", cplx.real), ("imag", cplx.imag),
            ("real_transposed", cplx.T.contiguous().T.real)]


LAYOUT_NAMES = [name for name, _ in _layouts(2, 2, torch.float32)]


@pytest.mark.parametrize("layout", LAYOUT_NAMES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,k", [(1, 1), (37, 130), (64, 48)])
def test_cpu_result_is_slice_matrix(m, k, dtype, layout):
    x = dict(_layouts(m, k, dtype))[layout]
    before = dict(ops.LAUNCHES)
    slices, sigma = slicing.slice_operand(x, 6)
    want_sl, want_sigma = slice_matrix(x, 6, axis=1)
    assert ops.LAUNCHES == before   # no launch on the CPU
    assert slices.dtype == torch.int8 and slices.shape == (6, m, k)
    assert slices.is_contiguous()
    assert sigma.dtype == torch.float64 and sigma.shape == (m,)
    assert torch.equal(slices, want_sl)
    assert torch.equal(sigma.view(torch.int64), want_sigma.view(torch.int64))


@pytest.mark.parametrize("transposed", [False, True])
def test_cpu_result_equals_the_reference_package(transposed):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((40, 70)) * np.exp2(rng.integers(-9, 9, (40, 1)))
    t = torch.from_numpy(x)
    if transposed:
        t = t.T.contiguous().T
    slices, sigma = slicing.slice_operand(t, 5)
    ref_sl, ref_sigma = ozaki_ref.slice_matrix(x, 5, axis=1)
    assert np.array_equal(slices.numpy(), np.asarray(ref_sl))
    assert np.array_equal(sigma.numpy().view(np.int64),
                          np.asarray(ref_sigma).view(np.int64))


def test_ozaki_matmul_spans_hold_the_slicing():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((48, 64)))
    b = torch.from_numpy(rng.standard_normal((64, 40)))
    tracer = trace.Tracer()
    with trace.activate(tracer):
        got = ops.ozaki_matmul(a, b, 4)
    spans = tracer.events
    names = [s["name"] for s in spans]
    # A float64 product is finished in K1's epilogue, inside
    # ozaki.kernel: no ozaki.combine.
    assert sorted(names) == ["ozaki", "ozaki.kernel", "ozaki.slice"]
    outer = spans[names.index("ozaki")]
    for s in spans:
        assert outer["ts"] <= s["ts"]
        assert s["ts"] + s["dur"] <= outer["ts"] + outer["dur"]
    assert torch.equal(got, ops.ozaki_matmul(a, b, 4))


@pytest.mark.parametrize("route", ["fused", "bfloat16"])
def test_torch_combine_keeps_its_span_and_count(route):
    """Where K1's epilogue does not finish the product (K2's path, or an
    output dtype other than float32 and float64), the torch combine runs
    in exactly one ozaki.combine and counts as "torch"."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((48, 64)))
    b = torch.from_numpy(rng.standard_normal((64, 40)))
    kw = ({"fuse_slicing": True} if route == "fused"
          else {"out_dtype": torch.bfloat16})
    before = dict(ops.COMBINES)
    tracer = trace.Tracer()
    with trace.activate(tracer):
        got = ops.ozaki_matmul(a, b, 4, **kw)
    names = sorted(s["name"] for s in tracer.events)
    assert names == ["ozaki", "ozaki.combine", "ozaki.kernel", "ozaki.slice"]
    assert ops.COMBINES == {"epilogue": before["epilogue"],
                            "torch": before["torch"] + 1}
    assert got.dtype == kw.get("out_dtype", torch.float64)


def test_build_digest_covers_the_slicing_source(tmp_path, monkeypatch):
    assert "slice_operand.cu" in _build._SOURCES
    for name in _build._SOURCES:
        (tmp_path / name).write_bytes((_build._CSRC / name).read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = _build._digest()
    (tmp_path / "slice_operand.cu").write_text(CU.read_text() + "\n// x\n")
    assert _build._digest() != before


def test_constants_and_struct_match_the_source():
    text = CU.read_text()
    assert re.search(r"S_SMEM_MAX = 200 \* 1024;", text)
    assert slicing.SLICE_SMEM_MAX == 200 * 1024
    assert re.search(rf"S_UNIT = {slicing.SLICE_UNIT};", text)
    assert re.search(rf"S_THREADS = {THREADS};", text)
    inv = re.search(r"INV_LN2 = (0x[0-9a-fp.+-]+);", text).group(1)
    assert float.fromhex(inv) == _INV_LN2 == 1.0 / math.log(2.0)
    fields = re.search(r"struct SliceArgs \{(.*?)\};", text, re.S).group(1)
    declared = re.findall(r"(long long|int) ([\w, ]+);", fields)
    want = [(n, ctypes.c_longlong if t == "long long" else ctypes.c_int)
            for t, names in declared
            for n in names.replace(" ", "").split(",")]
    assert [(n, t) for n, t in _build.SliceArgs._fields_] == want


PLAN_CASES = [(m, k, sm, sk, it, al)
              for m, k in ((2048, 960), (960, 2048), (2048, 49152),
                           (49152, 960), (960, 49152), (2560, 2048),
                           (37, 130), (1, 1), (320, 960))
              for sm, sk in ((k, 1), (1, m), (2 * k, 2), (2, 2 * m))
              for it in (4, 8) for al in (True, False)]


@pytest.mark.parametrize("m,k,sm,sk,itemsize,aligned", PLAN_CASES)
def test_plan_is_one_the_launcher_takes(m, k, sm, sk, itemsize, aligned):
    p = slicing.slice_plan(m, k, sm, sk, itemsize, aligned)
    assert p.fast_k == (sk == 1 or (sm != 1 and sk <= sm))
    assert 1 <= p.tm <= THREADS and p.tm & (p.tm - 1) == 0
    assert p.tk % slicing.SLICE_UNIT == 0
    assert p.chunks == -(-k // p.tk)
    assert p.tm * p.tk * itemsize <= slicing.SLICE_SMEM_MAX
    assert p.vec in (1, 16 // itemsize)
    if p.vec > 1:   # a copy is 16 aligned bytes along the unit stride
        fast_len, fast_stride, slow_stride = ((k, sk, sm) if p.fast_k
                                              else (m, sm, sk))
        assert aligned and fast_stride == 1
        assert fast_len % p.vec == 0 and slow_stride % p.vec == 0
        assert (p.tk if p.fast_k else p.tm) % p.vec == 0
    if not p.fast_k:   # a k line is read in whole 32-byte sectors
        assert p.tm * itemsize >= 32
    if p.chunks == 1:
        assert p.tk == -(-k // 16) * 16

