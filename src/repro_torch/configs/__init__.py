"""repro_torch.configs — named, frozen run configurations for the LM stack.

The port's own copy of :mod:`repro.configs` (it imports nothing of the
reference package), with the same presets.
"""

from .base import LMConfig, available_configs, get_config, register_config

__all__ = ["LMConfig", "available_configs", "get_config",
           "register_config"]
