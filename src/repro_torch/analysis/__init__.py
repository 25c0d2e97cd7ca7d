"""repro_torch.analysis — performance models over work counts."""

from . import roofline

__all__ = ["roofline"]
