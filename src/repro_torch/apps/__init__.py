"""repro_torch.apps — paper workloads driven through the emulation engine."""

from . import must

__all__ = ["must"]
