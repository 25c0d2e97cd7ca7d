"""repro_torch.core — tunable-precision INT8 GEMM emulation.

Layers:
  * :mod:`repro_torch.core.ozaki`      — the split-GEMM arithmetic engine;
  * :mod:`repro_torch.core.precision`  — policies, split prediction and
    measurement, adaptive per-site tuning;
  * :mod:`repro_torch.core.backends`   — the GEMM backend registry;
  * :mod:`repro_torch.core.intercept`  — eager automatic BLAS offload.
"""

from .backends import (GemmBackend, example_specs, get_backend,
                       register_backend, registered_families)
from .intercept import (OFFLOAD_CACHE_SIZE, CacheInfo, PersistInfo, Site,
                        cond, offload, scan, site_report, spmd_mesh,
                        spmd_scope, switch, while_loop)
from .ozaki import (SLICE_BITS, num_pair_gemms, ozaki_matmul,
                    pair_indices, slice_matrix)
from .precision import (AdaptiveGemm, PrecisionPolicy, SiteState,
                        canonical_site, estimate_rel_error,
                        measure_splits, predict_splits,
                        splits_for_tolerance)

__all__ = [
    "OFFLOAD_CACHE_SIZE",
    "SLICE_BITS",
    "AdaptiveGemm",
    "CacheInfo",
    "canonical_site",
    "cond",
    "GemmBackend",
    "PersistInfo",
    "PrecisionPolicy",
    "Site",
    "SiteState",
    "estimate_rel_error",
    "example_specs",
    "get_backend",
    "measure_splits",
    "num_pair_gemms",
    "offload",
    "ozaki_matmul",
    "pair_indices",
    "predict_splits",
    "register_backend",
    "registered_families",
    "scan",
    "site_report",
    "slice_matrix",
    "splits_for_tolerance",
    "spmd_mesh",
    "spmd_scope",
    "switch",
    "while_loop",
]
