"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card.  An entry point given no device resolves
to ``cuda`` and raises when no card is present; the CPU is used only
when a caller asks for it (the tests pass ``device="cpu"``).  Nothing
here ever falls back quietly from the card to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "as_tensor"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raise without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor keeps its device unless one is named,
    anything else (numpy arrays, lists) lands on :func:`resolve_device`.
    """
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))
