"""Published peaks of one NVIDIA H100 SXM at its 700 W limit.

NVIDIA's H100 Tensor Core GPU data sheet, dense rates without sparsity.
Every share the benchmark reports is taken against these; the run
prints the card's name and power limit beside them.
"""

#: INT8 tensor-core operations per second: the card's highest dense
#: rate and the substrate of the Ozaki emulation.
INT8_OPS_PER_S = 1979e12
#: HBM3 bytes per second.
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> float:
    """Least time the card could take: operations at the INT8 peak or
    bytes at the HBM rate, whichever is longer."""
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
