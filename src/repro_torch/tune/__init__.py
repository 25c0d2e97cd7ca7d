"""repro_torch.tune — precision-plan tooling.

Port of :mod:`repro.tune`, so far only :func:`count_int8_gemms`, the
per-step INT8 GEMM count the trainer reports.  Calibration, the
solver and plans are ROADMAP item 7.
"""

from .solve import count_int8_gemms

__all__ = ["count_int8_gemms"]
