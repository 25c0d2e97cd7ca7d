"""repro_torch.models — the decoder-only LMs as eager PyTorch programs:
the dense :class:`Model` and :class:`MoEModel`, with routed experts and
sliding/full attention layers."""

from .lm import Model, params_from_reference
from .moe import MoEModel

__all__ = ["Model", "MoEModel", "params_from_reference"]
