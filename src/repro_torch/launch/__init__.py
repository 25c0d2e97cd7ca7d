"""repro_torch.launch — runnable entry points (``python -m
repro_torch.launch.train``).

Port of :mod:`repro.launch`.
"""

__all__ = ["train"]
