"""Counters of the expert layers (:class:`repro_torch.models.moe.MoEModel`).

Always on: each call of an expert layer adds one record, at the cost of
two ``time.perf_counter_ns`` reads and an append.  The counts come from
the routing's own host copy of the per-expert token counts, which the
layer needs anyway to size its products.  Standard library only.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["ExpertCounter"]


class ExpertCounter:
    """What the expert layers of one model did, call by call.

    ``routed[i]`` holds, for the ``i``-th expert-layer call (one a layer
    per forward pass, in layer order), the tokens routed to each held
    expert, in ``experts_held`` order: the rows of that expert's
    products, from which the offload's size gate decides whether they
    run emulated.  ``host_ns`` is the host time spent inside the expert
    layers' forward calls, routing and products together.
    """

    def __init__(self):
        self.routed: List[Tuple[int, ...]] = []
        self.host_ns = 0

    def record(self, tokens, host_ns: int) -> None:
        """One expert-layer call: its tokens per held expert and its host
        nanoseconds."""
        self.routed.append(tuple(tokens))
        self.host_ns += host_ns
