"""Admission scheduling: request validation, queueing, slot assignment.

The scheduler owns the request queue and nothing else — it never sees
tokens or caches.  Admission hands out ``(slot, request)`` pairs
against the free slots and the KV manager's reservation check, so a
request is only admitted when its worst-case cache growth is already
booked (no decode-time deadlock).

Policies:

``fifo`` (default)
    Strict submission order, head-of-line blocking: if the oldest
    request cannot be placed (no slot, or no blocks for its worst
    case), nothing younger overtakes it.  This is exactly the ordering
    the pre-refactor engine had, which is why it is the default.

``edf``
    Earliest deadline first over ``t_enqueue + latency_target_s``
    (requests without a target sort last, FIFO among themselves).
    Still head-of-line blocking per the chosen order, so a starved
    urgent request blocks rather than being skipped forever.

Validation happens at submission with :class:`SamplingParamError` (a
``ValueError``), so a malformed request is rejected by name before it
ever costs a prefill.

The port's copy of :mod:`repro.serve.scheduler` (the module is
framework-free); the engine hands it the run's ``metrics`` and its
:class:`repro_torch.obs.SLOTracker` as ``slo``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

__all__ = ["Request", "SamplingParamError", "Scheduler",
           "validate_request"]


class SamplingParamError(ValueError):
    """A request's admission/sampling parameters are out of range."""


@dataclasses.dataclass
class Request:
    """One generation request; ``out`` fills as the engine decodes.

    ``temperature=0`` (the default) is greedy decoding — the engine's
    token-identity guarantees apply to it.  ``temperature > 0`` samples
    from the softmax at that temperature using a per-request
    deterministic stream seeded by ``seed`` (same request, same model,
    same tokens — regardless of batch neighbours).
    ``latency_target_s`` is the admission scheduler's deadline input
    (EDF policy) and is recorded against realized TTFT either way.
    """

    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    latency_target_s: Optional[float] = None
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def validate_request(req: Request, max_len: int) -> None:
    """Raise :class:`SamplingParamError` for out-of-range parameters.

    The message texts for the pre-existing checks are part of the
    public behavior (tests match on them); SamplingParamError subclasses
    ValueError so older callers' ``except ValueError`` still works.
    """
    if not req.prompt:
        raise SamplingParamError("empty prompt")
    if req.max_new_tokens < 1:
        raise SamplingParamError(
            "max_new_tokens must be >= 1 (the engine always decodes "
            "the prompt's continuation)")
    if len(req.prompt) + req.max_new_tokens > max_len:
        raise SamplingParamError(
            f"prompt({len(req.prompt)}) + max_new_tokens"
            f"({req.max_new_tokens}) exceeds max_len={max_len}")
    if not (req.temperature >= 0.0):
        raise SamplingParamError(
            f"temperature must be >= 0 (0 = greedy), got "
            f"{req.temperature}")
    if req.temperature > 0 and not isinstance(req.seed, int):
        raise SamplingParamError(
            f"seed must be an int for sampled (temperature > 0) "
            f"requests, got {type(req.seed).__name__}")
    if req.latency_target_s is not None and not (
            req.latency_target_s > 0):
        raise SamplingParamError(
            f"latency_target_s must be > 0 (or None), got "
            f"{req.latency_target_s}")


class Scheduler:
    """Admission queue with pluggable ordering policy."""

    POLICIES = ("fifo", "edf")

    def __init__(self, max_len: int, policy: str = "fifo",
                 metrics=None, slo=None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown scheduler policy {policy!r}; "
                             f"have {self.POLICIES}")
        self.max_len = int(max_len)
        self.policy = policy
        self.metrics = metrics
        # Optional SLO tracker (an object with ``late_admission``): under
        # edf, admitting a request whose deadline already lapsed in the
        # queue is reported as a late admission (the violation is
        # certain before prefill).
        self.slo = slo
        self._queue: List[Request] = []
        self._t_enqueue: dict = {}

    def submit(self, requests: List[Request],
               now: Optional[float] = None) -> None:
        """Validate and enqueue; raises before accepting any of them."""
        for req in requests:
            validate_request(req, self.max_len)
        now = time.perf_counter() if now is None else now
        for req in requests:
            self._queue.append(req)
            self._t_enqueue[id(req)] = now
            if self.metrics is not None \
                    and req.latency_target_s is not None:
                self.metrics.registry.histogram(
                    "serve_latency_target_s").observe(
                    req.latency_target_s)
        self._gauge()

    def t_enqueue(self, req: Request) -> float:
        return self._t_enqueue.get(id(req), 0.0)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _ordered(self) -> List[Request]:
        if self.policy == "fifo":
            return self._queue
        # EDF: deadline = enqueue + target; no target sorts last, FIFO
        # among equals (sort is stable, the queue is in FIFO order).
        return sorted(
            self._queue,
            key=lambda r: (r.latency_target_s is None,
                           self._t_enqueue[id(r)]
                           + (r.latency_target_s or 0.0)))

    def admit(self, free_slots: List[int],
              can_reserve: Callable[[int, Request], bool]
              ) -> List[tuple]:
        """Assign queued requests to free slots, in policy order.

        ``can_reserve(slot, req)`` is the KV manager's veto.  Each
        request takes the lowest-numbered free slot that can host it;
        the first request that fits nowhere blocks the queue (no
        overtaking), which keeps completion order deterministic.
        """
        placed = []
        free = sorted(free_slots)
        for req in self._ordered():
            slot = next((s for s in free if can_reserve(s, req)), None)
            if slot is None:
                break
            free.remove(slot)
            placed.append((slot, req))
        for _, req in placed:
            self._queue.remove(req)
        if self.policy == "edf" and self.slo is not None and placed:
            now = time.perf_counter()
            for _, req in placed:
                if req.latency_target_s is None:
                    continue
                overdue = now - (self._t_enqueue[id(req)]
                                 + req.latency_target_s)
                if overdue > 0:
                    self.slo.late_admission(overdue)
        self._gauge()
        return placed

    def forget(self, req: Request) -> None:
        self._t_enqueue.pop(id(req), None)

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.registry.gauge("serve_queue_depth").set(
                len(self._queue))
