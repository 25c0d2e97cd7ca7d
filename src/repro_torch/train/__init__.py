"""repro_torch.train — optimizer, synthetic data, checkpointing.

Port of :mod:`repro.train`.
"""

from . import checkpoint
from .checkpoint import CheckpointError
from .data import SyntheticText
from .optimizer import AdamW

__all__ = ["AdamW", "CheckpointError", "SyntheticText", "checkpoint"]
