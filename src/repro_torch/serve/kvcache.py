"""KV-cache managers: paged block-table allocation and the dense rectangle.

The dense layout gives every slot a ``max_len`` rectangle up front:
simple, but a 16-token request in a 512-token engine holds 32x the
cache bytes it ever touches.  The paged layout (vLLM-style) carves the
cache into fixed-size *blocks* shared by all slots through a per-slot
block table; blocks are allocated lazily as a slot's length crosses a
block boundary and returned on eviction, so resident cache bytes track
the *actual* tokens in flight, not the worst case.

Layout of the paged pool (see
:meth:`repro_torch.models.Model.init_paged_cache` and
:meth:`~repro_torch.models.Model._paged_forward`)::

    pool:  (layers, num_blocks_total, kv_heads, block_size, head_dim)
    table: (slots, blocks_per_slot + 1) int32  — last column = trash

Allocation is **host-side and deterministic**: per-dp-group sorted free
lists, lowest id first, so two runs of the same trace produce identical
block tables (and the mesh test can compare token streams exactly).
Each dp group owns a contiguous range of pool rows whose first block is
the group's *trash block* — the write target for chunk padding and
masked decode writes — so every slot's blocks (and its trash) live on
its own dp shard and the block axis shards evenly.

Admission safety: :meth:`PagedKVCache.reserve` books the worst-case
block count (``ceil((prompt + max_new) / block_size)``) at admission
time, and :meth:`can_reserve` refuses admissions that could deadlock a
decoding request mid-stream — a request, once admitted, can always
grow to its reserved size.

The port's copy of :mod:`repro.serve.kvcache`: the pools, the block
table and the lengths are tensors on the model's device, the host
mirror of the table is numpy as in the reference.

Under a mesh of processes (``group=``, one dp rank's view) the host
manager stays global and identical on every rank: admission,
reservation, the block table and :meth:`~PagedKVCache.stats` see every
slot, so the gauges are the reference's.  The device side is the
rank's alone: the group's slots (their lengths, their rows of the
dense rectangle) and the group's range of pool rows, its trash block
first, addressed by local ids (global id minus the range's base), with
the model's kv heads (this rank's ``num_kv_heads / tp`` under a tp
view).
"""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np
import torch

from ..models import Model

__all__ = ["PagedKVCache", "DenseKVCache"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _group_slots(batch_slots: int, dp_groups: int,
                 group: Optional[int]) -> np.ndarray:
    """The global slots whose device state this process holds: all of
    them, or dp group ``group``'s contiguous range."""
    if batch_slots % dp_groups:
        raise ValueError(f"batch_slots={batch_slots} not divisible "
                         f"by dp_groups={dp_groups}")
    if group is None:
        return np.arange(batch_slots)
    if not 0 <= group < dp_groups:
        raise ValueError(f"group={group} outside 0..{dp_groups - 1}")
    per = batch_slots // dp_groups
    return np.arange(group * per, (group + 1) * per)


class PagedKVCache:
    """Block-table KV manager over a shared pool of fixed-size blocks.

    Args:
      model: the LM (fixes layer/head/dim extents of the pool).
      batch_slots: number of engine slots (block-table rows).
      max_len: per-slot logical capacity; must be a multiple of
        ``block_size`` so the paged attention extent equals the dense
        one (that equality is what makes paged == dense bitwise).
      block_size: tokens per block.
      num_blocks: usable (data) blocks in the pool, shared by all
        slots; default ``batch_slots * max_len/block_size`` (the dense
        equivalent — no admission ever waits).  Rounded up to a
        multiple of ``dp_groups``; per-group trash blocks are added on
        top.
      dp_groups: data-parallel extent — slots and pool rows are split
        into this many contiguous groups so the device arrays shard
        evenly over the mesh dp axis.
      group: the dp group whose device pools this process holds (a
        mesh rank's); ``None``, every group's (one device).
      registry: optional metrics registry for the block
        gauges (``serve_kv_blocks_allocated`` / ``_hwm`` /
        ``serve_kv_block_utilization``).
    """

    def __init__(self, model: Model, batch_slots: int, max_len: int,
                 block_size: int = 16,
                 num_blocks: Optional[int] = None, dp_groups: int = 1,
                 group: Optional[int] = None, registry=None):
        if max_len % block_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of block_size="
                f"{block_size} (equal attention extents are what make "
                "the paged cache bit-identical to the dense one)")
        self.local_slots = _group_slots(batch_slots, dp_groups, group)
        self.block_size = int(block_size)
        self.blocks_per_slot = max_len // block_size
        self.batch_slots = int(batch_slots)
        self.max_len = int(max_len)
        self.dp_groups = int(dp_groups)
        self._slots_per_group = batch_slots // dp_groups
        usable = int(num_blocks or batch_slots * self.blocks_per_slot)
        usable = _ceil_div(usable, dp_groups) * dp_groups
        self.num_blocks = usable                  # usable data blocks
        self._per_group = usable // dp_groups
        # Pool rows: each group owns [g*(per+1), (g+1)*(per+1)); the
        # first row of the range is the group's trash block.
        self.num_blocks_total = usable + dp_groups
        self._free: List[List[int]] = []
        self._trash: List[int] = []
        for g in range(dp_groups):
            base = g * (self._per_group + 1)
            self._trash.append(base)
            self._free.append(list(range(base + 1,
                                         base + 1 + self._per_group)))
        self._reserved = [0] * dp_groups          # booked, not yet mapped
        self._mapped: List[List[int]] = [[] for _ in range(batch_slots)]
        self._reserved_left = [0] * batch_slots
        self._registry = registry
        self.allocated_hwm = 0
        # Host mirror of the device block table; every entry starts at
        # the slot's trash block, so unmapped logical blocks read (and
        # padding writes hit) memory that is never attended unmasked.
        self._table = np.empty((batch_slots, self.blocks_per_slot + 1),
                               np.int32)
        for slot in range(batch_slots):
            self._table[slot, :] = self._trash[self.group_of(slot)]
        self._table_dirty = True
        self.device = model.device
        # Local pool row 0 is global row ``_base``: the group's trash.
        self._base = 0 if group is None else group * (self._per_group + 1)
        self.pools = model.init_paged_cache(
            self.num_blocks_total if group is None
            else self._per_group + 1, self.block_size)
        self._gauges()

    # -- geometry ----------------------------------------------------

    def group_of(self, slot: int) -> int:
        return slot // self._slots_per_group

    @property
    def allocated_blocks(self) -> int:
        return sum(len(m) for m in self._mapped)

    @property
    def dense_equivalent_blocks(self) -> int:
        """Blocks a dense rectangle layout would hold resident."""
        return self.batch_slots * self.blocks_per_slot

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        return _ceil_div(prompt_len + max_new, self.block_size)

    # -- cache assembly ----------------------------------------------

    def init_cache(self) -> dict:
        """The device cache dict the paged programs consume (the local
        slots' rows)."""
        return {"k": self.pools["k"], "v": self.pools["v"],
                "block_table": self._device_table(),
                "length": torch.zeros((len(self.local_slots),),
                                      dtype=torch.int32,
                                      device=self.device)}

    def table_rows(self, slots) -> np.ndarray:
        """The host table's rows of ``slots`` in local pool ids."""
        return self._table[np.asarray(slots)] - self._base

    def _device_table(self) -> torch.Tensor:
        return torch.as_tensor(self.table_rows(self.local_slots),
                               device=self.device)

    def sync_table(self, cache: dict) -> dict:
        """Push the host block table to the device if it changed."""
        if self._table_dirty:
            cache = dict(cache, block_table=self._device_table())
            self._table_dirty = False
        return cache

    # -- allocation --------------------------------------------------

    def can_reserve(self, slot: int, prompt_len: int,
                    max_new: int) -> bool:
        """Would admitting this request into ``slot`` be deadlock-free?"""
        g = self.group_of(slot)
        need = self.blocks_needed(prompt_len, max_new)
        return need <= len(self._free[g]) - self._reserved[g]

    def reserve(self, slot: int, prompt_len: int, max_new: int) -> None:
        """Book the worst-case block count for a newly admitted request."""
        need = self.blocks_needed(prompt_len, max_new)
        if need > self._per_group:
            raise ValueError(
                f"request needs {need} blocks but the pool holds only "
                f"{self._per_group} per dp group — raise num_blocks or "
                "block_size")
        g = self.group_of(slot)
        if need > len(self._free[g]) - self._reserved[g]:
            raise RuntimeError(
                f"reserve() without can_reserve(): slot {slot} needs "
                f"{need} blocks, group {g} has "
                f"{len(self._free[g]) - self._reserved[g]} unbooked")
        self._reserved[g] += need
        self._reserved_left[slot] = need

    def ensure(self, slot: int, upto_len: int) -> None:
        """Map blocks so positions ``0 .. upto_len-1`` are backed."""
        g = self.group_of(slot)
        mapped = self._mapped[slot]
        while len(mapped) < _ceil_div(upto_len, self.block_size):
            block = self._free[g].pop(0)   # lowest id: deterministic
            self._table[slot, len(mapped)] = block
            mapped.append(block)
            if self._reserved_left[slot] > 0:
                self._reserved_left[slot] -= 1
                self._reserved[g] -= 1
            self._table_dirty = True
        self.allocated_hwm = max(self.allocated_hwm,
                                 self.allocated_blocks)
        self._gauges()

    def release(self, slot: int) -> None:
        """Return a finished slot's blocks and reservation to the pool."""
        g = self.group_of(slot)
        for block in self._mapped[slot]:
            bisect.insort(self._free[g], block)
        self._mapped[slot] = []
        self._reserved[g] -= self._reserved_left[slot]
        self._reserved_left[slot] = 0
        self._table[slot, :] = self._trash[g]
        self._table_dirty = True
        self._gauges()

    def _gauges(self) -> None:
        if self._registry is None:
            return
        alloc = self.allocated_blocks
        self._registry.gauge("serve_kv_blocks_allocated").set(alloc)
        self._registry.gauge("serve_kv_blocks_hwm").set(
            self.allocated_hwm)
        self._registry.gauge("serve_kv_block_utilization").set(
            alloc / max(self.num_blocks, 1))

    def stats(self) -> dict:
        return {"layout": "paged", "block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "allocated_blocks": self.allocated_blocks,
                "allocated_hwm": self.allocated_hwm,
                "dense_equivalent_blocks": self.dense_equivalent_blocks}


class DenseKVCache:
    """The original rectangular layout behind the same manager API.

    Every slot owns a ``max_len`` rectangle for its lifetime; there is
    nothing to allocate or release, so reservation always succeeds and
    the "allocated" accounting equals the dense equivalent by
    definition.  Kept (and asserted bit-identical to paged) as the
    reference layout.  ``dp_groups``/``group`` as for
    :class:`PagedKVCache`: a mesh rank holds its group's rectangles.
    """

    def __init__(self, model: Model, batch_slots: int, max_len: int,
                 dp_groups: int = 1, group: Optional[int] = None,
                 registry=None):
        self.local_slots = _group_slots(batch_slots, dp_groups, group)
        self.model = model
        self.batch_slots = int(batch_slots)
        self.max_len = int(max_len)
        self.allocated_hwm = batch_slots * max_len
        self._registry = registry

    def init_cache(self) -> dict:
        return self.model.init_cache(len(self.local_slots), self.max_len)

    def sync_table(self, cache: dict) -> dict:
        return cache

    def can_reserve(self, slot: int, prompt_len: int,
                    max_new: int) -> bool:
        return True

    def reserve(self, slot: int, prompt_len: int, max_new: int) -> None:
        pass

    def ensure(self, slot: int, upto_len: int) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

    def stats(self) -> dict:
        return {"layout": "dense",
                "dense_equivalent_tokens": self.batch_slots
                * self.max_len}
