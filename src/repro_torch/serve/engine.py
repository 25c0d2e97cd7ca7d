"""Continuous-batching inference engine (facade over the serve layers).

Port of :mod:`repro.serve.engine`.  The engine wires three
single-purpose layers together and drives the serve loop:

- :class:`repro_torch.serve.scheduler.Scheduler` — request validation,
  queueing, slot assignment (FIFO default, optional EDF);
- :class:`repro_torch.serve.kvcache.PagedKVCache` /
  :class:`~repro_torch.serve.kvcache.DenseKVCache` — cache layout and
  block allocation, behind one manager API;
- :class:`repro_torch.serve.runner.Runner` — the device programs:
  packed chunked-prefill waves interleaved with masked decode ticks.

Each slot's computation is independent of its batch neighbours, so a
prompt decoded in a busy batch yields the same greedy tokens as the
same prompt decoded alone; the paged layout is bit-identical to the
dense rectangle.  Pass ``policy=`` to run the prefill and decode GEMMs
through :func:`repro_torch.core.offload`: with
``PrecisionPolicy(backend="pallas_int8", default_splits=s)`` every
prefill projection and MLP GEMM (``m`` = tokens of the wave) runs on
the CUDA split-GEMM kernel K1; decode GEMMs (``m`` = slots) and the LM
head (``m`` = rows) stay under the size gate and run native.

Not ported: ``mesh``, ``plan``, ``metrics``, ``metrics_port`` and
``warm_cache_dir`` raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import PrecisionPolicy
from ..models import Model
from .kvcache import DenseKVCache, PagedKVCache
from .runner import Runner, _not_ported
from .scheduler import Request, SamplingParamError, Scheduler

__all__ = ["Engine", "Request", "SamplingParamError"]


class Engine:
    """Continuous-batching engine (greedy by default, per-request
    temperature sampling on top).

    Args:
      model: the :class:`~repro_torch.models.Model` (its config fixes
        the vocabulary and ``eos_id``; its device is the engine's).
      params: the parameter dict the programs take (``model.params``
        or :func:`~repro_torch.models.params_from_reference`).
      batch_slots: decode batch width = number of concurrent requests.
      max_len: KV-cache capacity per slot.
      policy: optional :class:`~repro_torch.core.PrecisionPolicy`; the
        prefill and decode programs run under ``offload``.
      kv_layout: ``"paged"`` (default) or ``"dense"``.
      block_size: paged block granularity; ``max_len`` must divide by
        it.
      num_blocks: paged pool size in usable blocks (default: the dense
        equivalent).
      chunk_tokens: prefill chunk length (``None``: whole prompts).
      chunk_token_budget: cap on real tokens per prefill wave.
      scheduler_policy: ``"fifo"`` (default) or ``"edf"``.
      device: must be the model's device when given.
    """

    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 512, mesh=None, plan=None,
                 policy: Optional[PrecisionPolicy] = None,
                 metrics=None, *, kv_layout: str = "paged",
                 block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 chunk_tokens: Optional[int] = None,
                 chunk_token_budget: Optional[int] = None,
                 warm_cache_dir=None,
                 scheduler_policy: str = "fifo",
                 metrics_port: Optional[int] = None,
                 device=None):
        _not_ported(mesh=mesh, plan=plan, metrics=metrics,
                    metrics_port=metrics_port,
                    warm_cache_dir=warm_cache_dir)
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                             "have ('paged', 'dense')")
        if device is not None and str(device) != str(model.device):
            raise ValueError(f"device={device} but the model lives on "
                             f"{model.device}")
        self.model = model
        self.batch_slots = int(batch_slots)
        self.max_len = int(max_len)
        self.params = params
        self.policy = policy
        if kv_layout == "paged":
            self.kv = PagedKVCache(model, self.batch_slots, self.max_len,
                                   block_size=block_size,
                                   num_blocks=num_blocks)
        else:
            self.kv = DenseKVCache(model, self.batch_slots, self.max_len)
        self.runner = Runner(
            model, params, self.kv, max_len=self.max_len, policy=policy,
            chunk_tokens=chunk_tokens,
            chunk_token_budget=chunk_token_budget)
        self.scheduler = Scheduler(self.max_len, policy=scheduler_policy)
        self.slots: List[Optional[Request]] = [None] * self.batch_slots
        self._next_token = np.zeros(self.batch_slots, np.int32)

    # -- introspection -----------------------------------------------

    @property
    def cache(self) -> dict:
        """The live KV-cache tensors (owned by the runner)."""
        return self.runner.cache

    def prefill_sites(self, rows: int, width: int):
        """Site decisions of the prefill program for a wave of shape
        ``(rows, width)``; empty without a policy."""
        return self.runner.sites_for(rows, width)

    # -- lifecycle ---------------------------------------------------

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not self.scheduler.pending:
            return
        placed = self.scheduler.admit(
            free, lambda slot, req: self.kv.can_reserve(
                slot, len(req.prompt), req.max_new_tokens))
        if not placed and not any(r is not None for r in self.slots):
            # Idle engine, head of queue still unplaceable: its worst
            # case exceeds what an *empty* pool can book.
            raise RuntimeError(
                "request can never be admitted: its worst-case cache "
                f"(prompt + max_new_tokens) outgrows the configured "
                f"pool ({self.kv.stats()}) — raise num_blocks")
        for slot, req in placed:
            self.kv.reserve(slot, len(req.prompt), req.max_new_tokens)
            self.slots[slot] = req
            self.runner.enqueue_prefill(slot, req)

    def _prefill_tick(self) -> None:
        res = self.runner.prefill_wave()
        if res is None:
            return
        for slot, req, token in res.completed:
            self._emit(slot, req, token)

    def _decode_tick(self) -> None:
        active = np.array([
            req is not None and not self.runner.is_prefilling(slot)
            for slot, req in enumerate(self.slots)])
        if not active.any():
            return
        nxt = self.runner.decode_tick(self._next_token, active,
                                      self.slots)
        for slot in np.flatnonzero(active):
            self._emit(int(slot), self.slots[slot], int(nxt[slot]))

    def _emit(self, slot: int, req: Request, token: int) -> None:
        req.out.append(token)
        self._next_token[slot] = token
        eos = self.model.cfg.eos_id
        length_next = len(req.prompt) + len(req.out)
        if (len(req.out) >= req.max_new_tokens
                or (eos is not None and token == eos)
                or length_next >= self.max_len):
            req.done = True
            self.slots[slot] = None
            self.kv.release(slot)
            self.scheduler.forget(req)

    # -- public API --------------------------------------------------

    def run(self, requests: List[Request]) -> List[Request]:
        """Drive all ``requests`` to completion; returns them in order.

        Requests are validated up front (:class:`SamplingParamError`,
        a ``ValueError``); more requests than slots queue and are
        admitted as earlier ones finish.
        """
        self.scheduler.submit(requests)
        while (self.scheduler.pending or
               any(r is not None for r in self.slots)):
            self._admit()
            self._prefill_tick()
            self._decode_tick()
        return requests
