"""GEMM backend registry: one dispatch point for every execution engine.

PyTorch port of :mod:`repro.core.backends`.  Every way the port can run
a matmul — native, plain Ozaki emulation, the CUDA split-GEMM kernels,
adaptive per-site tuning — is a :class:`GemmBackend` obtained from a
*spec string*, and it is here that a
:class:`~repro_torch.core.precision.PrecisionPolicy` binds to
execution.

Spec-string grammar (the reference's, accepted verbatim)::

    spec    := family [ "_" splits ] [ ":" arg ]

Families: ``"dgemm"`` (native), ``"fp64_int8"`` (plain Ozaki
emulation, the A/B control), ``"pallas_int8"`` (the split-GEMM
kernels; the family keeps the reference's name so MuST modes and tuned
plans resolve unchanged, ``:fused`` selects K2) and ``"adaptive"``
(``adaptive:1e-9``).  ``get_backend(s).spec == s`` for every spec.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch

from .ozaki import complex_matmul_via_real, is_complex_problem, ozaki_matmul
from .precision import AdaptiveGemm, PrecisionPolicy

__all__ = [
    "GemmBackend",
    "register_backend",
    "get_backend",
    "registered_families",
    "example_specs",
]

_SPLITS_RE = re.compile(r"(?P<family>.+)_(?P<splits>\d+)")


class GemmBackend:
    """A 2-D matmul engine bound to a precision policy.

    ``backend(a, b, out_dtype=None, num_splits=None, site="default")``
    on 2-D real or complex tensors; ``num_splits`` is honoured unless
    the spec pinned a count; ``site`` keys per-site state and overrides.
    """

    spec: str = ""

    def __init__(self, spec: str, policy: PrecisionPolicy):
        self.spec = spec
        self.policy = policy

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        raise NotImplementedError

    def __call__(self, a, b, *, out_dtype=None, num_splits=None,
                 site: str = "default"):
        return self.matmul(a, b, out_dtype=out_dtype,
                           num_splits=num_splits, site=site)

    def __repr__(self):
        return f"{type(self).__name__}({self.spec!r})"


class DgemmBackend(GemmBackend):
    """Native torch matmul — the reference engine (and the A/B control)."""

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        del num_splits, site
        c = torch.matmul(a, b)
        return c.to(out_dtype) if out_dtype is not None else c


class OzakiBackend(GemmBackend):
    """Plain Ozaki INT8 split-GEMM (:func:`repro_torch.core.ozaki_matmul`).

    A pinned spec (``"fp64_int8_6"``) is authoritative; an unpinned one
    resolves the split count per call, falling back to
    ``policy.splits_for(site)``.
    """

    def __init__(self, spec, policy, splits: Optional[int] = None):
        super().__init__(spec, policy)
        self.pinned_splits = splits

    def resolve_splits(self, num_splits, site) -> int:
        if self.pinned_splits is not None:
            return self.pinned_splits
        if num_splits is not None:
            return num_splits
        return self.policy.splits_for(site)

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        return ozaki_matmul(a, b,
                            num_splits=self.resolve_splits(num_splits, site),
                            accumulator=self.policy.accumulator,
                            out_dtype=out_dtype,
                            slice_bits=self.policy.slice_bits)


class KernelBackend(OzakiBackend):
    """The split-GEMM kernels (:mod:`repro_torch.kernels.ops`).

    CUDA tensors launch K1 (or K2 with ``:fused``); CPU tensors run the
    kernels' plain versions.  Like the reference's ``PallasBackend`` it
    always accumulates compensated f32 ("df32") and ignores
    ``policy.accumulator``.  Complex operands decompose into four real
    kernel launches.  Blocks come from
    :func:`repro_torch.kernels.tile_model.select_tiles` per (m, k, n, s).
    """

    def __init__(self, spec, policy, splits: Optional[int] = None,
                 fused: bool = False):
        super().__init__(spec, policy, splits)
        self.fused = fused

    def tile_decision(self, m, k, n, num_splits, dtype=None):
        """The block/schedule pick for one (m, k, n, s) site."""
        from ..kernels import tile_model

        return tile_model.select_tiles(m, k, n, num_splits, dtype=dtype,
                                       fused=self.fused)

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        from ..kernels import ops

        s = self.resolve_splits(num_splits, site)
        if out_dtype is None:
            out_dtype = torch.promote_types(a.dtype, b.dtype)

        def kernel(x, y, real_out):
            tiles = self.tile_decision(x.shape[0], x.shape[1], y.shape[1],
                                       s, dtype=real_out)
            return ops.ozaki_matmul(x, y, num_splits=s, out_dtype=real_out,
                                    slice_bits=self.policy.slice_bits,
                                    fuse_slicing=self.fused, tiles=tiles)

        if is_complex_problem(a, b, out_dtype):
            return complex_matmul_via_real(kernel, a, b, out_dtype)
        return kernel(a, b, out_dtype)


class AdaptiveBackend(GemmBackend):
    """Per-site tuned emulation (:class:`repro_torch.core.AdaptiveGemm`).

    The port runs eagerly, so every call sees concrete operands: the
    first call per site probes the split count empirically.
    """

    def __init__(self, spec, policy, target_rel: float):
        super().__init__(spec, policy)
        self.target_rel = float(target_rel)
        self.gemm = AdaptiveGemm(target_rel=self.target_rel,
                                 accumulator=policy.accumulator,
                                 slice_bits=policy.slice_bits)

    def matmul(self, a, b, *, out_dtype=None, num_splits=None,
               site: str = "default"):
        del num_splits  # adaptivity owns the split count
        return self.gemm(a, b, site=site, out_dtype=out_dtype)


#: family -> factory(spec, policy, splits, arg) -> GemmBackend
_FACTORIES: Dict[str, Callable[..., GemmBackend]] = {}


def register_backend(family: str,
                     factory: Callable[..., GemmBackend]) -> None:
    """Register a backend family under ``family``."""
    _FACTORIES[family] = factory


def registered_families() -> List[str]:
    """Sorted registered family names."""
    return sorted(_FACTORIES)


def example_specs() -> List[str]:
    """One representative, resolvable spec per registered shape."""
    return ["dgemm", "fp64_int8", "fp64_int8_6", "pallas_int8_6",
            "pallas_int8_6:fused", "adaptive:1e-9"]


def get_backend(spec: str,
                policy: PrecisionPolicy | None = None) -> GemmBackend:
    """Resolve a spec string to a :class:`GemmBackend`.

    The returned backend carries ``spec`` verbatim and binds ``policy``
    (accumulator, slice bits, per-site splits) to execution.
    """
    policy = policy or PrecisionPolicy()
    head, sep, arg = (spec or "").partition(":")
    arg = arg if sep else None
    family, splits = head, None
    if family not in _FACTORIES:
        m = _SPLITS_RE.fullmatch(head)
        if m and m.group("family") in _FACTORIES:
            family, splits = m.group("family"), int(m.group("splits"))
        else:
            raise ValueError(
                f"unknown backend spec {spec!r}; registered families: "
                f"{', '.join(registered_families())} "
                "(grammar: family[_<splits>][:<arg>])")
    return _FACTORIES[family](spec=spec, policy=policy, splits=splits,
                              arg=arg)


def _dgemm_factory(spec, policy, splits, arg):
    if splits is not None or arg is not None:
        raise ValueError(f"'dgemm' takes no parameters, got {spec!r}")
    return DgemmBackend(spec, policy)


def _ozaki_factory(spec, policy, splits, arg):
    if arg is not None:
        raise ValueError(f"'fp64_int8' takes no ':<arg>', got {spec!r}")
    return OzakiBackend(spec, policy, splits)


def _kernel_factory(spec, policy, splits, arg):
    if arg not in (None, "fused"):
        raise ValueError(f"'pallas_int8' accepts only ':fused' as an "
                         f"argument, got {spec!r}")
    return KernelBackend(spec, policy, splits, fused=arg == "fused")


def _adaptive_factory(spec, policy, splits, arg):
    if splits is not None:
        raise ValueError(
            f"'adaptive' tunes its own split count, got {spec!r}")
    return AdaptiveBackend(spec, policy,
                           target_rel=float(arg) if arg else 1e-9)


register_backend("dgemm", _dgemm_factory)
register_backend("fp64_int8", _ozaki_factory)
register_backend("pallas_int8", _kernel_factory)
register_backend("adaptive", _adaptive_factory)
