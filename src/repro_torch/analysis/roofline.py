"""Roofline analysis of work counts, priced by one H100.

Port of :mod:`repro.analysis.roofline`.  :func:`analyze_cell` turns one
artifact — a JSON file or dict describing a cell's work (flops, HBM
bytes, collective bytes, device count) — into the three roofline times
and names the binding resource: the paper's argument for when INT8
emulation pays (a compute-bound GEMM gains the INT8-to-FP64 ratio; a
memory- or collective-bound one does not).

Artifact schema (all numeric fields optional, default 0), the
reference's::

    {
      "cell": "must_n4096",            # any label
      "num_devices": 1,
      "flops": 1.2e15,                 # total programme flops
      "int8_flops": 9.6e14,            # flops issued as INT8 operations
      "hbm_bytes": 3.1e12,
      "collective_bytes": 4.0e10,
      "peaks": {"flops": ..., "int8_flops": ..., "hbm_gbps": ...,
                "ici_gbps": ...}       # optional per-artifact override
    }

The per-device peaks default to :data:`H100_PEAKS`; ``analyze_cell(...,
peaks=)`` prices against another table (the reference's TPU table
reproduces its numbers), and an artifact's own ``peaks`` override
either, key by key.  As in the reference the rate keys named ``*_gbps``
hold bytes per second.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

from ..kernels.tile_model import DEFAULT_PARAMS

__all__ = ["H100_PEAKS", "CellAnalysis", "analyze_cell"]

#: Per-device peak rates of one H100 SXM at its 700 W limit, from
#: NVIDIA's H100 Tensor Core GPU data sheet (dense, no sparsity).
H100_PEAKS: Dict[str, float] = {
    # FP64 tensor-core FLOP/s (67 TFLOPS): the FP64 GEMM the emulation
    # replaces.
    "flops": 67e12,
    # INT8 tensor-core operations per second (1,979 TOPS): the emulation
    # substrate, tile_model.HopperParams.int8_ops.
    "int8_flops": DEFAULT_PARAMS.int8_ops,
    # HBM3 bytes per second (3.35 TB/s), HopperParams.hbm_bw.
    "hbm_gbps": DEFAULT_PARAMS.hbm_bw,
    # NVLink 4 bytes per second in one direction (900 GB/s total over
    # both directions).
    "ici_gbps": 450e9,
}


@dataclasses.dataclass
class CellAnalysis:
    """Roofline times (seconds) for one cell."""

    cell: str
    num_devices: int
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        times = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(times, key=times.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def analyze_cell(artifact: Union[str, Path, Dict],
                 peaks: Optional[Mapping[str, float]] = None
                 ) -> CellAnalysis:
    """Evaluate the roofline model for one artifact.

    ``artifact`` may be a path to a JSON file (its stem is the default
    label) or an already-parsed dict.  ``peaks`` is the rate table
    (default :data:`H100_PEAKS`).  Raises ``ValueError`` on an artifact
    that is not a JSON object or carries non-numeric work counts.
    """
    if isinstance(artifact, (str, Path)):
        path = Path(artifact)
        data = json.loads(path.read_text())
        default_cell = path.stem
    else:
        data = dict(artifact)
        default_cell = "cell"
    if not isinstance(data, dict):
        raise ValueError(f"artifact must be a JSON object, got "
                         f"{type(data).__name__}")

    cell = str(data.get("cell", default_cell))
    ndev = int(data.get("num_devices", 1) or 1)
    rates = dict(H100_PEAKS if peaks is None else peaks)
    rates.update(data.get("peaks", {}))

    def work(key):
        v = data.get(key, 0.0)
        if not isinstance(v, (int, float)):
            raise ValueError(f"field {key!r} must be numeric, got {v!r}")
        return float(v)

    # Mixed precision: the flops not issued as INT8 ride the FP64 peak,
    # the INT8-emulated portion the INT8 peak.
    f_total = work("flops")
    f_int8 = min(work("int8_flops"), f_total)
    compute_s = ((f_total - f_int8) / rates["flops"]
                 + f_int8 / rates["int8_flops"]) / ndev
    memory_s = work("hbm_bytes") / rates["hbm_gbps"] / ndev
    collective_s = work("collective_bytes") / rates["ici_gbps"] / ndev
    return CellAnalysis(cell=cell, num_devices=ndev,
                        compute_s=compute_s, memory_s=memory_s,
                        collective_s=collective_s)
