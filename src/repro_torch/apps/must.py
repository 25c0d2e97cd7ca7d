"""MuST-style Green's-function contour workload on the device.

Port of :mod:`repro.apps.must`.  MuST (LSMS family) inverts the KKR
multiple-scattering matrix at every energy point of a contour around
the Fermi energy with a blocked LU driver (``zblock_lu``) whose flops
are almost all ZGEMMs — the calls the paper redirects to INT8
emulation.  For each energy ``z`` the resolvent ``G(z) = (z I - H)^-1``
is computed by blocked LU plus blocked triangular solves, where every
block GEMM goes through a registry backend (:mod:`repro_torch.core`
``get_backend``; any spec string is a mode).

The matrices stay on the device as ``complex128`` tensors.  The
diagonal-block inversions are native ``torch.linalg.inv`` in float64 —
the LAPACK part MuST keeps on the host — so the accuracy difference
between modes isolates the GEMM emulation (the paper's Table 1), and
the poles near the Fermi energy give Figure 1's isolated error peak.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from .._device import resolve_device
from ..core.backends import get_backend
from ..core.precision import PrecisionPolicy

__all__ = ["MustConfig", "build_system", "contour_points", "run_contour",
           "relative_errors", "system_to_device"]


@dataclasses.dataclass
class MustConfig:
    """Synthetic LSMS system + contour discretization."""

    n: int = 384            # scattering-matrix dimension
    block: int = 96         # zblock_lu block size
    n_energies: int = 16    # contour points
    fermi: float = 0.72     # Fermi energy (Ryd), where G has poles
    eta: float = 0.03       # contour height above the real axis
    e_min: float = 0.12     # contour start (Ryd)
    e_max: float = 1.32     # contour end (Ryd)
    cluster_frac: float = 0.25  # fraction of states near the Fermi energy
    cluster_width: float = 0.04
    seed: int = 0

    def __post_init__(self):
        if self.n % self.block != 0:
            raise ValueError(
                f"block {self.block} must divide n {self.n}")


def build_system(cfg: MustConfig) -> Dict[str, np.ndarray]:
    """Random Hermitian Hamiltonian with a state cluster at E_f.

    A verbatim numpy copy of the reference's ``build_system``: the same
    ``MustConfig`` gives byte-identical ``H`` and ``evals``.
    """
    rng = np.random.default_rng(cfg.seed)
    n = cfg.n
    n_cluster = int(round(cfg.cluster_frac * n))
    evals = np.concatenate([
        rng.uniform(cfg.e_min - 0.1, cfg.e_max + 0.1, n - n_cluster),
        cfg.fermi + cfg.cluster_width * rng.standard_normal(n_cluster),
    ])
    # Random unitary eigenbasis via QR of a complex Ginibre matrix.
    z = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    q, r = np.linalg.qr(z)
    q = q * (np.diagonal(r) / np.abs(np.diagonal(r)))
    h = (q * evals) @ q.conj().T
    h = 0.5 * (h + h.conj().T)  # exact Hermitian symmetrization
    return {"H": h, "evals": np.sort(evals)}


def system_to_device(system: Dict[str, np.ndarray], device=None):
    """The reference's ``build_system`` output as device tensors."""
    dev = resolve_device(device)
    return {"H": torch.as_tensor(system["H"], dtype=torch.complex128,
                                 device=dev),
            "evals": torch.as_tensor(system["evals"], dtype=torch.float64,
                                     device=dev)}


def _make_gemm(mode: str) -> Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]:
    """Resolve a mode string to a complex128 block GEMM on tensors.

    The bound policy selects the ``"f64"`` accumulator, as the
    reference does; the kernel family ignores it and accumulates df32,
    also as the reference does.
    """
    backend = get_backend(mode, policy=PrecisionPolicy(accumulator="f64"))

    def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return backend(a, b, out_dtype=torch.complex128, site="zblock_lu")

    return gemm


def _blocked_inverse(m_mat: torch.Tensor, block: int, gemm) -> torch.Tensor:
    """``m_mat^{-1}`` via blocked LU + blocked triangular solves.

    The reference's loop nest on device tensors: the Schur updates and
    substitution products are block GEMMs through ``gemm``; only the
    per-diagonal-block inversions are native.
    """
    n = m_mat.shape[0]
    nb = n // block
    sl = [slice(i * block, (i + 1) * block) for i in range(nb)]
    eye_blk = torch.eye(block, dtype=m_mat.dtype, device=m_mat.device)

    a = m_mat.clone()
    lower = torch.zeros_like(a)
    for k in range(nb):
        inv_kk = torch.linalg.inv(a[sl[k], sl[k]])
        lower[sl[k], sl[k]] = eye_blk
        for i in range(k + 1, nb):
            lower[sl[i], sl[k]] = gemm(a[sl[i], sl[k]], inv_kk)
        for i in range(k + 1, nb):
            upd = gemm(lower[sl[i], sl[k]], a[sl[k], k * block:])
            a[sl[i], k * block:] -= upd
    upper = a
    for i in range(1, nb):
        for j in range(i):
            upper[sl[i], sl[j]] = 0.0

    # Forward substitution  L Y = I   (unit block diagonal).
    y = torch.zeros_like(a)
    ident = torch.eye(n, dtype=a.dtype, device=a.device)
    for i in range(nb):
        acc = ident[sl[i], :].clone()
        for j in range(i):
            acc -= gemm(lower[sl[i], sl[j]], y[sl[j], :])
        y[sl[i], :] = acc

    # Backward substitution  U G = Y; applying the diagonal-block
    # inverse is itself a block GEMM through the backend.
    g = torch.zeros_like(a)
    for i in range(nb - 1, -1, -1):
        acc = y[sl[i], :].clone()
        for j in range(i + 1, nb):
            acc -= gemm(upper[sl[i], sl[j]], g[sl[j], :])
        g[sl[i], :] = gemm(torch.linalg.inv(upper[sl[i], sl[i]]), acc)
    return g


def block_gemm_calls(cfg: MustConfig) -> int:
    """Block GEMMs one energy point issues (each is 4 real GEMMs)."""
    nb = cfg.n // cfg.block
    lu = nb * (nb - 1)                  # L blocks + Schur updates
    forward = nb * (nb - 1) // 2
    backward = nb * (nb - 1) // 2 + nb  # + diagonal-inverse products
    return lu + forward + backward


def contour_points(cfg: MustConfig):
    """Energy contour and trapezoid weights just above the real axis."""
    e = np.linspace(cfg.e_min, cfg.e_max, cfg.n_energies)
    z = e + 1j * cfg.eta
    w = np.gradient(e)
    return z, w


def run_contour(cfg: MustConfig, mode: str,
                system: Dict[str, np.ndarray], device=None) -> Dict:
    """Sweep ``G(z) = (z I - H)^{-1}`` over the contour in one mode.

    ``system`` is :func:`build_system`'s numpy output (or
    :func:`system_to_device`'s tensors).  Runs on ``device`` (CUDA
    unless the caller passes ``device="cpu"``) and returns the
    reference's dict: per-energy diagonals of G, the trace, and the
    contour-integrated observables ``ne`` and ``etot``, as numpy.
    """
    dev = resolve_device(device)
    gemm = _make_gemm(mode)
    h = torch.as_tensor(system["H"], dtype=torch.complex128, device=dev)
    z, w = contour_points(cfg)
    n = cfg.n
    eye = torch.eye(n, dtype=torch.complex128, device=dev)
    g_diag = torch.zeros((cfg.n_energies, n), dtype=torch.complex128,
                         device=dev)
    tr_g = torch.zeros(cfg.n_energies, dtype=torch.complex128, device=dev)
    for idx, zk in enumerate(z):
        m_mat = complex(zk) * eye - h
        g = _blocked_inverse(m_mat, cfg.block, gemm)
        g_diag[idx] = torch.diagonal(g)
        tr_g[idx] = torch.trace(g)
    g_diag = g_diag.cpu().numpy()
    tr_g = tr_g.cpu().numpy()
    ne = float(-np.imag(np.sum(w * tr_g)) / np.pi)
    etot = float(-np.imag(np.sum(w * z * tr_g)) / np.pi)
    return {"mode": mode, "z": z, "weights": w, "g_diag": g_diag,
            "tr_g": tr_g, "ne": ne, "etot": etot}


def relative_errors(ref: Dict, test: Dict) -> Dict:
    """Paper Table-1 metrics: Re/Im errors of G plus observable drifts.

    Per-energy errors are normalized by the largest |component| of the
    reference at that energy (so the Figure-1 profile shows where the
    relative accuracy degrades, i.e. near the poles at E_f).
    """
    dre = np.abs(np.real(test["g_diag"]) - np.real(ref["g_diag"]))
    dim = np.abs(np.imag(test["g_diag"]) - np.imag(ref["g_diag"]))
    norm_re = np.max(np.abs(np.real(ref["g_diag"])), axis=1)
    norm_im = np.max(np.abs(np.imag(ref["g_diag"])), axis=1)
    per_z_real = np.max(dre, axis=1) / np.where(norm_re == 0, 1, norm_re)
    per_z_imag = np.max(dim, axis=1) / np.where(norm_im == 0, 1, norm_im)
    return {
        "per_z_real": per_z_real,
        "per_z_imag": per_z_imag,
        "max_real": float(np.max(per_z_real)),
        "max_imag": float(np.max(per_z_imag)),
        "d_etot": abs(test["etot"] - ref["etot"]) / max(
            1e-30, abs(ref["etot"])),
        "d_ne": abs(test["ne"] - ref["ne"]) / max(
            1e-30, abs(ref["ne"])),
    }
