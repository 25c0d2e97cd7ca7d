"""AdamW on the port's parameter dicts (nested dicts of tensors).

Port of :mod:`repro.train.optimizer`.  The update is elementwise
arithmetic with no matmul, so wrapping a whole train step in
:func:`repro_torch.core.offload` leaves the optimizer untouched while
the loss's forward and backward GEMMs run emulated.

The arithmetic is the reference's as XLA's CPU backend compiles it,
term by term, so that on the CPU a float64 update is bitwise the
reference's:

* the moment updates ``beta * old + (1 - beta) * g`` are contracted
  into one fused multiply-add, ``fma(beta, old, (1 - beta) * g)``
  (``torch.addcmul`` with a 0-d factor is that fma on the CPU);
* ``(m / bc1) / (sqrt(v / bc2) + eps)`` is rewritten
  ``m / (bc1 * (sqrt(v / bc2) + eps))``;
* ``upd + wd * p`` and ``p - lr * upd`` are fmas as well;
* ``sqrt`` is correctly rounded, as XLA's is (torch's vectorized CPU
  ``sqrt`` is not always; on the CPU the port takes numpy's);
* the bias corrections ``1 - b ** t`` take ``b ** t`` from the C
  library's ``pow`` (float64; XLA's is correctly rounded and so is
  glibc's) or ``powf`` (float32, with XLA's flush of subnormal results
  to zero).

Python-float hyperparameters enter each leaf's arithmetic rounded to
its accumulation dtype, as JAX's weakly typed scalars do.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math

import numpy as np
import torch

__all__ = ["AdamW"]

_POWF = None
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _powf(base: float, exp: float) -> float:
    """float32 ``base ** exp`` as XLA's CPU backend computes it: the C
    library's ``powf``, subnormal results flushed to zero."""
    global _POWF
    if _POWF is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        lib.powf.restype = ctypes.c_float
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _POWF = lib.powf
    out = _POWF(float(np.float32(base)), float(np.float32(exp)))
    return 0.0 if abs(out) < _FLT_MIN else out


def _bias_correction(beta: float, t: int, dtype: torch.dtype) -> float:
    """``1 - beta ** t`` in ``dtype`` (float64 or float32)."""
    if dtype == torch.float64:
        return 1.0 - math.pow(beta, t)
    return float(np.float32(1.0) - np.float32(_powf(beta, t)))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (numpy's on the CPU, torch's on the
    card, where it is IEEE)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts with one structure."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val, *(r[key] for r in rest))
                for key, val in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Decoupled-weight-decay Adam.

    ``init(params)`` builds the state dict; ``update(grads, params,
    state)`` returns ``(new_params, new_state)`` as new tensors and
    leaves its arguments as they were.  The state is a plain dict
    (``step``, ``mu``, ``nu``), so it checkpoints with the parameters.
    """

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01

    @staticmethod
    def _acc_dtype(p):
        # Moments and update arithmetic run in at-least-f32: f32 for
        # f32/bf16 params, f64 for f64 params.
        return torch.promote_types(p.dtype, torch.float32)

    def init(self, params) -> dict:
        zeros = lambda t: _tree_map(  # noqa: E731
            lambda p: torch.zeros_like(p, dtype=self._acc_dtype(p)), t)
        some = params
        while isinstance(some, dict):
            some = next(iter(some.values()))
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=some.device),
                "mu": zeros(params), "nu": zeros(params)}

    def update(self, grads, params, state):
        with torch.no_grad():
            t = state["step"] + 1
            step = int(t)

            def scalar(x, like):
                return torch.tensor(x, dtype=like.dtype, device=like.device)

            def moment(old, g, beta, square):
                term = (g * g if square else g).to(old.dtype) * (1.0 - beta)
                return torch.addcmul(term, old, scalar(beta, old))

            mu = _tree_map(lambda m, g: moment(m, g, self.b1, False),
                           state["mu"], grads)
            nu = _tree_map(lambda v, g: moment(v, g, self.b2, True),
                           state["nu"], grads)

            def param(p, m, v):
                bc1 = _bias_correction(self.b1, step, m.dtype)
                bc2 = _bias_correction(self.b2, step, m.dtype)
                upd = m / (bc1 * (_sqrt(v / bc2) + self.eps))
                pa = p.to(upd.dtype)
                upd = torch.addcmul(upd, pa, scalar(self.weight_decay, upd))
                return torch.addcmul(pa, upd, scalar(-self.lr, upd)).to(
                    p.dtype)

            new_params = _tree_map(param, params, mu, nu)
        return new_params, {"step": t, "mu": mu, "nu": nu}
