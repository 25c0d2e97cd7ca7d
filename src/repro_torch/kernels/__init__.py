"""repro_torch.kernels — CUDA split-GEMM kernels, slicing, tile rule.

Importing builds nothing: ``ops`` compiles and loads the CUDA library
only when a kernel is first launched on a CUDA tensor.
"""

from . import ops, slicing, tile_model

__all__ = ["ops", "slicing", "tile_model"]
