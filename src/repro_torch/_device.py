"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card.  An entry point given no device resolves
to ``cuda`` and raises when no card is present; the CPU is used only
when a caller asks for it (the tests pass ``device="cpu"``).  Nothing
here ever falls back quietly from the card to the CPU.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "as_tensor", "growable_segments"]


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


def growable_segments(device) -> None:
    """Let the card's caching allocator grow its segments in place
    (``expandable_segments``) from here on, for the whole process.  A
    model whose blocks change size every step (routed experts) otherwise
    fragments a cache of fixed segments until a step near the card's
    capacity fails.  A setting the process was started with
    (``PYTORCH_CUDA_ALLOC_CONF``) stands; on the CPU nothing changes."""
    if torch.device(device).type != "cuda" or "expandable_segments" in \
            os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""):
        return
    # Newer torch names the setter per accelerator and deprecates the
    # CUDA one.
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    setter("expandable_segments:True")
