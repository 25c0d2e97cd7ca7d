"""Operations and bytes of the split-GEMM kernels, from shapes.

K1 reads the int8 slice stacks of A (s, m, k) and B (s, k, n) and
writes the compensated f32 pair (hi, lo) of C.  It issues one exact
int8 product per slice pair, P = s(s+1)/2 of them.  Each input byte is
counted once and each output byte once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .peaks import bound_s

Shape = Tuple[int, int, int]


def splits_of(spec: str) -> int:
    """The split count a backend spec pins (``pallas_int8_6:fused``: 6)."""
    return int(spec.split(":")[0].rsplit("_", 1)[1])


def pairs(s: int) -> int:
    return s * (s + 1) // 2


def ops(m: int, k: int, n: int, s: int) -> int:
    """int8 multiply-adds of one emulated GEMM, counted as 2 ops each."""
    return 2 * m * k * n * pairs(s)


def k1_bytes(m: int, k: int, n: int, s: int) -> int:
    return s * (m * k + k * n) + 8 * m * n


def k1_bound_s(shapes: Iterable[Shape], s: int) -> float:
    """Sum of K1's per-launch bounds over real GEMM shapes."""
    return sum(bound_s(ops(m, k, n, s), k1_bytes(m, k, n, s))
               for m, k, n in shapes)

