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


def reference_config(cfg):
    """The reference's ``LMConfig`` of a port config of the dense model:
    its keys (the port's keys for layer kinds and experts, which the
    reference lacks, must sit at their dense defaults)."""
    import dataclasses

    from repro.configs import LMConfig as LMConfigRef

    keys = {f.name for f in dataclasses.fields(LMConfigRef)}
    extra = {k: v for k, v in vars(cfg).items() if k not in keys}
    dense = {k: v for k, v in vars(type(cfg)()).items() if k in extra}
    if extra != dense:
        raise ValueError(f"{cfg.name} is no dense model: {extra}")
    return LMConfigRef(**{k: v for k, v in vars(cfg).items() if k in keys})
