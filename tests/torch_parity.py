"""Shared helper of the port's parity tests (not a test module)."""

import numpy as np
import torch


def same_bits(ref, port) -> bool:
    """True when a reference array and a port result agree to the bit:
    same dtype, same shape, same bytes."""
    r = np.asarray(ref)
    t = (port.detach().cpu().numpy() if isinstance(port, torch.Tensor)
         else np.asarray(port))
    return (r.dtype == t.dtype and r.shape == t.shape
            and r.tobytes() == t.tobytes())
