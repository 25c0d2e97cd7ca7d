"""The reference's seeded random numbers: ``jax.random`` on threefry.

The reference makes its parameters with ``jax.random.PRNGKey(seed)``,
``jax.random.split(key, 8)`` and ``jax.random.normal(key, shape,
float32)``.  This module computes the same bits with torch, on any
device, so that a model made from a seed here holds the reference's
weights to the bit:

* :func:`prng_key` — the key of a 64-bit seed: its high and low 32-bit
  words;
* :func:`split` and :func:`random_bits` — the threefry2x32 hash (20
  rounds, the reference's rotations and key schedule) of the counter
  pairs ``(i >> 32, i & 0xFFFFFFFF)`` over a row-major ``iota``, the
  layout of ``jax_threefry_partitionable`` (on by default): a split's
  key ``i`` is the hash's two words, a draw's 32 bits their XOR;
* :func:`normal` — 23 random mantissa bits OR'd into 1.0, minus 1,
  mapped onto ``(nextafter(-1, 0), 1)``, then ``sqrt(2) * erf_inv(u)``
  with ``erf_inv`` as XLA's CPU backend compiles it: Giles'
  single-precision polynomial, whose ``log1p`` is XLA's (a Cephes
  rational function below ``sqrt(2) - 1``, else the Cephes ``log`` of
  ``1 + x``), every polynomial step a fused multiply-add.

The words are held in int64 tensors masked to 32 bits, which gives the
same bits on the CPU and the card.  A fused multiply-add is computed in
float64 and rounded to odd before the rounding to float32, which makes
it exact whatever the device's own contraction: ``erf_inv`` over all
2**23 values ``u`` can take equals XLA-CPU's bit for bit
(``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import math
import struct

import torch

__all__ = ["prng_key", "split", "random_bits", "normal", "erf_inv"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Elements per pass of normal(): bounds its float64 temporaries.
_CHUNK = 1 << 24


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``: the seed's high and low words."""
    seed = int(seed) % (1 << 64)
    return seed >> 32, seed & _MASK


def _threefry2x32(key, x0, x1):
    """The threefry2x32 hash of the counter words ``(x0, x1)`` (int64
    tensors of uint32 values) under ``key``; returns both words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _hash_iota(key, start: int, count: int, device):
    """The hash of the counters ``start .. start + count - 1``."""
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    return _threefry2x32(key, idx >> 32, idx & _MASK)


def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as ``num`` keys (word pairs)."""
    w0, w1 = _hash_iota(key, 0, num, "cpu")
    return [(int(a), int(b)) for a, b in zip(w0.tolist(), w1.tolist())]


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    w0, w1 = _hash_iota(key, 0, math.prod(shape), device)
    return (w0 ^ w1).reshape(shape)


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32 (float32 tensors).

    The product is exact in float64; the sum, rounded to odd there
    (53 bits, at least two more than float32's 24), rounds to float32
    as the exact value would.
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)   # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    bump = (err != 0) & even
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where(bump, torch.nextafter(s, toward), s)
    return s.float()


def _div(a, b):
    """``a / b`` correctly rounded to float32.  Computed in float64 (a
    double rounding that cannot change the result), as is ``sqrt``
    below: torch's vectorized float32 ``sqrt`` on the CPU is not
    correctly rounded."""
    return (a.double() / b.double()).float()


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, x, dtype=torch.float32)


def _horner(x, coefficients):
    """``sum(c * x**i)`` from the highest power down, one fused
    multiply-add per step."""
    p = _f32(coefficients[0], x)
    for c in coefficients[1:]:
        p = _fma(p, x, _f32(c, x))
    return p


# Cephes' log (single precision), the polynomial XLA's CPU backend
# compiles ``log`` to, by the words of its float32 constants.
def _word(w: int) -> float:
    return struct.unpack("<f", struct.pack("<I", w))[0]


_LOG_P = [_word(w) for w in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A,
                             0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
                             0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LOG_Q1, _LOG_Q2 = _word(0xB95E8083), _word(0x3F318000)
_SQRT_HALF = _word(0x3F3504F3)
_MIN_NORMAL = _word(0x00800000)


def _log(x):
    """XLA-CPU's float32 ``log`` of positive finite ``x``."""
    x = torch.maximum(x, _f32(_MIN_NORMAL, x))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    t = m - 1.0
    e = e - small.float()
    t = t + torch.where(small, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    P = [_f32(p, t) for p in _LOG_P]
    y = _fma(t, P[0], P[1])
    y1 = _fma(t, P[3], P[4])
    y2 = _fma(t, P[6], P[7])
    y = _fma(y, t, P[2])
    y1 = _fma(y1, t, P[5])
    y2 = _fma(y2, t, P[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = _fma(y, t3, e * _LOG_Q1)
    t = t - t2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


# Cephes' log1p rational function, numerator and denominator from the
# highest power down (XLA's small-argument branch).
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192198491e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = 0.41421356237309504880   # sqrt(2) - 1


def _log1p(x):
    """XLA-CPU's float32 ``log1p`` of ``x`` in (-1, 0]."""
    x2 = x * x
    ratio = _div(_horner(x, _LOG1P_P), _horner(x, _LOG1P_Q))
    small = x + (-0.5 * x2 + (x * x2) * ratio)
    return torch.where(x.abs() < _f32(_LOG1P_SMALL, x), small,
                       _log(x + 1.0))


# Giles' erf_inv polynomials, for w = -log1p(-x*x) below 5 and above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA-CPU's float32 ``erf_inv`` of ``x`` in [-1, 1]."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coefficient(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i], x),
                           _f32(_ERFINV_GE5[i], x))

    p = coefficient(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coefficient(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=device)
    lo = -(1.0 - 2.0 ** -24)   # nextafter(-1, 0) in float32
    sqrt2 = _word(struct.unpack("<I", struct.pack("<f", math.sqrt(2)))[0])
    for start in range(0, n, _CHUNK):
        count = min(_CHUNK, n - start)
        w0, w1 = _hash_iota(key, start, count, device)
        bits = ((w0 ^ w1) >> 9) | 0x3F800000
        f = bits.to(torch.int32).view(torch.float32) - 1.0
        lo_t = _f32(lo, f)
        u = torch.maximum(lo_t, f * 2.0 + lo_t)
        out[start:start + count] = _f32(sqrt2, u) * erf_inv(u)
    return out.reshape(shape)
