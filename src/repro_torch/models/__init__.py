"""repro_torch.models — the decoder-only LM as eager PyTorch programs."""

from .lm import Model, params_from_reference

__all__ = ["Model", "params_from_reference"]
