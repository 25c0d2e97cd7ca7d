"""repro_torch.launch — runnable entry points (``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.serve``).

Port of :mod:`repro.launch`; ``serve`` is the command-line form of
``examples/serve_lm.py``.
"""

__all__ = ["train", "serve"]
