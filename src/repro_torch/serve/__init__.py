"""repro_torch.serve — layered continuous-batching inference.

Port of :mod:`repro.serve`:

- :mod:`repro_torch.serve.scheduler` — admission queue, request
  validation, slot assignment (FIFO / EDF);
- :mod:`repro_torch.serve.kvcache` — KV layout managers: paged block
  tables over a shared pool, or the dense per-slot rectangle;
- :mod:`repro_torch.serve.runner` — device execution: packed
  chunked-prefill waves interleaved with masked decode ticks;
- :mod:`repro_torch.serve.engine` — the facade behind
  ``Engine.run(requests)``.
"""

from .engine import Engine
from .kvcache import DenseKVCache, PagedKVCache
from .scheduler import Request, SamplingParamError, Scheduler

__all__ = ["Engine", "Request", "SamplingParamError", "Scheduler",
           "PagedKVCache", "DenseKVCache"]
