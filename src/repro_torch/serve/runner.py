"""Batched execution: chunked prefill waves interleaved with decode ticks.

Port of :mod:`repro.serve.runner`.  The runner owns the device side of
serving — the prefill-chunk and decode programs (run through
:func:`repro_torch.core.offload` when a precision policy is given), the
KV cache tensors, and the host mirror of per-slot lengths.  It knows
nothing about queues or request lifecycles; the engine hands it
admitted requests and asks for one prefill wave or one decode tick at
a time.

Prompts are ingested in *pieces* of at most ``chunk_tokens``, packed
FIFO into waves of at most ``chunk_token_budget`` total tokens; a
wave's width is the largest piece in it.  Pieces whose slot rectangle
cannot absorb the wave width stop the wave early (head-of-line, order
preserved) — only relevant for the dense layout, whose chunk padding is
written in-rectangle; the paged layout routes padding to the trash
block.

A precision plan runs in subset mode: the programs take the plan's
entries for the sites they have and ignore the rest.

Telemetry (``metrics=``, a :class:`repro_torch.obs.MetricsRun`): the
offloaded programs carry the run's ``site_exec`` hook, each prefill
wave and decode tick is a ``prefill`` / ``decode_tick`` span that ends
after the sampled tokens are read back to the host (so it covers the
device's work, CUDA being asynchronous), and the first wave declares
the prefill program's sites (``site_decl``) through the offload's
``sites``, whose native report pass over zero inputs of the wave's
shape fills the decision-cache entry the wave then hits.

Warm start (``warm_cache_dir``): the offload wrappers persist their
decision caches there (``offload(persist_dir=)``, labels
``serve_prefill_{layout}`` and ``serve_decode_{layout}``), and each
entry's resolution is a ``transform_cache`` counter and event in the
run, which ``python -m repro_torch.obs report --expect-cache-hit``
reads.  A restarted server finds its decisions on disk and checks them
byte for byte (``disk_decisions_hit``); an eager program has no
exported program to restore, so nothing else is skipped.  The
reference replaces the live hook by static ``site_exec`` accounting on
a warm run, because its exported programs cannot carry a callback; the
port's eager calls can, so the hook stays live.  The directory is
ignored without a policy.

Not ported: meshes (sharded serving, ROADMAP item 13); passing one
raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import offload
from ..models import Model
from ..obs import get_logger

__all__ = ["Runner", "WaveResult"]

log = get_logger("serve")


class _Prefill:
    """One slot's in-flight prompt ingestion."""

    __slots__ = ("req", "tokens", "pos")

    def __init__(self, req):
        self.req = req
        self.tokens = np.asarray(req.prompt, np.int32)
        self.pos = 0

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.pos


@dataclasses.dataclass
class WaveResult:
    """What one prefill wave did."""

    pieces: list          # (slot, req, take) in wave-row order
    completed: list       # (slot, req, sampled first token)
    rows: int             # device rows
    width: int            # wave width (largest piece)
    padded_tokens: int    # rows * width actually computed
    real_tokens: int      # sum of piece lengths
    duration_s: float


#: The ROADMAP item that ports each refused option.
_ROADMAP_ITEM = {"mesh": 13}


def _not_ported(**options) -> None:
    given = sorted(name for name, val in options.items() if val is not None)
    if given:
        raise NotImplementedError(
            "; ".join(f"{name}: not ported to repro_torch yet (ROADMAP "
                      f"item {_ROADMAP_ITEM[name]})" for name in given))


class Runner:
    """Executes prefill waves and decode ticks over one KV cache."""

    def __init__(self, model: Model, params, kv, *, max_len: int,
                 policy=None, chunk_tokens: Optional[int] = None,
                 chunk_token_budget: Optional[int] = None, mesh=None,
                 plan=None, metrics=None, warm_cache_dir=None):
        _not_ported(mesh=mesh)
        self.model = model
        self.metrics = metrics
        self._declared = False
        self.plan = plan
        self.params = params
        self.kv = kv
        self.max_len = int(max_len)
        self.policy = policy
        self.layout = kv.stats()["layout"]
        self.chunk_tokens = (int(chunk_tokens) if chunk_tokens
                             else self.max_len)
        self.chunk_token_budget = (int(chunk_token_budget)
                                   if chunk_token_budget else None)
        self.batch_slots = kv.batch_slots
        self.device = model.device
        self._persist_dir = None
        if warm_cache_dir is not None:
            if policy is None:
                log.debug("warm_cache_dir ignored: no policy/plan, so "
                          "there is no decision cache to persist")
            else:
                self._persist_dir = warm_cache_dir

        if self.layout == "paged":
            prefill_fn = model.prefill_chunk_paged
            decode_fn = model.decode_step_paged
        else:
            prefill_fn = model.prefill_chunk
            decode_fn = model.decode_step
        self._prefill_wrapped = self._wrap(
            prefill_fn, f"serve_prefill_{self.layout}")
        self._decode_wrapped = self._wrap(
            decode_fn, f"serve_decode_{self.layout}")
        self._prefill_call = self._prefill_wrapped or prefill_fn
        self._decode_call = self._decode_wrapped or decode_fn

        self.cache = kv.init_cache()
        self._len = np.zeros(self.batch_slots, np.int64)
        self._pending: dict = {}      # slot -> _Prefill (admission order)
        self.waves_total = 0
        self.padded_tokens_total = 0
        self.real_tokens_total = 0

    # -- program wiring ----------------------------------------------

    def _wrap(self, fn, label):
        """The offloaded program (None without a policy): with the
        run's site hook when metrics are on, its decisions persisted
        under ``label`` on a warm start."""
        if self.policy is None:
            return None
        hook = (self.metrics.site_event_handler()
                if self.metrics is not None else None)
        warm = ({} if self._persist_dir is None else dict(
            persist_dir=self._persist_dir, fn_label=label,
            on_cache_event=self._cache_event))
        return offload(fn, self.policy, plan=self.plan,
                       plan_match="subset", on_site_event=hook, **warm)

    def _cache_event(self, kind: str) -> None:
        if self.metrics is None:
            return
        self.metrics.registry.counter("transform_cache",
                                      result=kind).inc()
        self.metrics.event("transform_cache", result=kind)

    def _span(self, name, **kw):
        if self.metrics is None:
            return contextlib.nullcontext()
        return self.metrics.tracer.span(name, **kw)

    def _declare_once(self, rows: int, width: int) -> None:
        """First wave: record the prefill program's site decisions, so
        ``python -m repro_torch.obs report --check`` can hold execution
        counts against them."""
        if (self.metrics is None or self._prefill_wrapped is None
                or self._declared):
            return
        self.metrics.declare_sites(self.sites_for(rows, width))
        self._declared = True

    def _tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    def sites_for(self, rows: int, width: int):
        """Site decisions of the prefill-chunk program for a wave shape,
        through the offload's decision cache.

        On a miss the program runs once natively on zero inputs of that
        shape (an eager program has no abstract trace), which fills the
        entry a wave of that shape then hits.  The programs write the
        cache in place, so the paged run writes only to the trash block
        (piece length 0) and the dense run to a copy of slot 0.
        """
        if self._prefill_wrapped is None:
            return []
        tokens = self._tensor(np.zeros((rows, width), np.int32))
        start = self._tensor(np.zeros((rows,), np.int32))
        if self.layout == "paged":
            table = self._tensor(np.tile(
                self.kv._table[:1], (rows, 1)))
            args = (self.params, self.cache["k"], self.cache["v"], table,
                    tokens, start, start)
        else:
            sub = self.cache["k"][:, :1].expand(
                -1, rows, -1, -1, -1).contiguous()
            vec = self._tensor(np.ones((rows,), np.int32))
            args = (self.params, sub, sub, tokens, start, vec)
        with torch.no_grad():
            return self._prefill_wrapped.sites(*args)

    # -- sampling ----------------------------------------------------

    def _sample(self, logits_dev, reqs: List) -> np.ndarray:
        """Greedy on device; temperature>0 rows re-sampled host-side
        from a per-request deterministic stream (seeded by the request
        seed and the emission index, so batching never changes a
        sampled request's tokens)."""
        toks = self.model.greedy(logits_dev).cpu().numpy().copy()
        hot = [i for i, r in enumerate(reqs)
               if r is not None and r.temperature > 0]
        if hot:
            lg = logits_dev.cpu().numpy().astype(np.float64)
            for i in hot:
                r = reqs[i]
                z = lg[i] / r.temperature
                z -= z.max()
                p = np.exp(z)
                p /= p.sum()
                rng = np.random.default_rng(
                    [r.seed & 0xFFFFFFFF, len(r.out)])
                toks[i] = rng.choice(p.size, p=p)
        return toks

    # -- prefill -----------------------------------------------------

    def enqueue_prefill(self, slot: int, req) -> None:
        self._pending[slot] = _Prefill(req)

    def is_prefilling(self, slot: int) -> bool:
        return slot in self._pending

    @property
    def prefilling(self) -> bool:
        return bool(self._pending)

    def _pack(self) -> List[tuple]:
        """Pick this wave's pieces: FIFO, chunk-capped, budget-capped.

        The wave width is the largest accepted piece; a piece is only
        accepted if every already-accepted piece's rectangle can absorb
        that width (``pos + width <= max_len``) — a solo piece always
        fits, so the wave is never empty and head-of-line order holds.
        """
        budget = self.chunk_token_budget or float("inf")
        pieces, width = [], 0
        for slot, st in self._pending.items():
            if budget <= 0:
                break
            take = int(min(self.chunk_tokens, st.remaining, budget))
            if take <= 0:
                break
            new_width = max(width, take)
            ok = all(p.pos + new_width <= self.max_len
                     for _, p, _ in pieces + [(slot, st, take)])
            if not ok:
                break
            pieces.append((slot, st, take))
            width = new_width
            budget -= take
        return pieces

    def prefill_wave(self) -> Optional[WaveResult]:
        """Run one packed prefill wave; returns None when idle."""
        if not self._pending:
            return None
        pieces = self._pack()
        width = max(take for _, _, take in pieces)
        rows = n = len(pieces)
        # Before the clock starts: the wave's duration is the wave's.
        self._declare_once(rows, width)
        t0 = time.perf_counter()
        tokens = np.zeros((rows, width), np.int32)
        start = np.zeros((rows,), np.int32)
        piece = np.ones((rows,), np.int32)
        for i, (slot, st, take) in enumerate(pieces):
            tokens[i, :take] = st.tokens[st.pos:st.pos + take]
            start[i] = st.pos
            piece[i] = take
        with self._span("prefill", rows=rows, padded_len=width, chunks=n):
            with torch.no_grad():
                if self.layout == "paged":
                    logits = self._wave_paged(pieces, tokens, start, piece,
                                              rows)
                else:
                    logits = self._wave_dense(pieces, tokens, start, piece)
            # Scatter the new per-slot lengths (host-known): decoding
            # neighbours keep theirs, wave slots move to their chunk end
            # — which also parks the dense layout's masked decode writes
            # at a position the next chunk overwrites first.
            ends = np.array([st.pos + take for _, st, take in pieces],
                            np.int32)
            slots = self._tensor(np.array([s for s, _, _ in pieces]))
            length = self.cache["length"].clone()
            length[slots.to(torch.long)] = self._tensor(ends)
            self.cache = dict(self.cache, length=length)
            completed = []
            done_rows = []
            reqs_rows = [None] * n
            for i, (slot, st, take) in enumerate(pieces):
                self._len[slot] = st.pos + take
                st.pos += take
                if st.remaining == 0:
                    del self._pending[slot]
                    done_rows.append(i)
                    reqs_rows[i] = st.req
            # _sample reads the tokens back to the host, which waits for
            # the device: the span (and prefill_s) covers the wave.
            toks = self._sample(logits[:n], reqs_rows)
            for i in done_rows:
                slot, st, _ = pieces[i]
                completed.append((slot, st.req, int(toks[i])))
        self.waves_total += 1
        self.padded_tokens_total += rows * width
        self.real_tokens_total += int(sum(t for _, _, t in pieces))
        return WaveResult(
            pieces=[(s, st.req, t) for s, st, t in pieces],
            completed=completed, rows=rows, width=width,
            padded_tokens=rows * width,
            real_tokens=int(sum(t for _, _, t in pieces)),
            duration_s=time.perf_counter() - t0)

    def _wave_paged(self, pieces, tokens, start, piece, rows):
        for slot, st, take in pieces:
            self.kv.ensure(slot, st.pos + take)
        self.cache = self.kv.sync_table(self.cache)
        table = np.empty((rows, self.kv.blocks_per_slot + 1), np.int32)
        for i, (slot, _, _) in enumerate(pieces):
            table[i] = self.kv._table[slot]
        # The program writes the pools in place.
        _, _, logits = self._prefill_call(
            self.params, self.cache["k"], self.cache["v"],
            self._tensor(table), self._tensor(tokens),
            self._tensor(start), self._tensor(piece))
        return logits

    def _wave_dense(self, pieces, tokens, start, piece):
        idx = self._tensor(np.array([s for s, _, _ in pieces])).to(
            torch.long)
        # The program writes the gathered rows (a copy) in place; they
        # are scattered back into the cache's own buffers.
        k_new, v_new, logits = self._prefill_call(
            self.params, self.cache["k"][:, idx], self.cache["v"][:, idx],
            self._tensor(tokens), self._tensor(start), self._tensor(piece))
        self.cache["k"][:, idx] = k_new
        self.cache["v"][:, idx] = v_new
        return logits

    # -- decode ------------------------------------------------------

    def decode_tick(self, next_token: np.ndarray, active: np.ndarray,
                    reqs: List) -> np.ndarray:
        """One masked decode step across all slots; returns sampled
        tokens for the active ones (others carry garbage)."""
        if self.layout == "paged":
            for slot in np.flatnonzero(active):
                self.kv.ensure(int(slot), int(self._len[slot]) + 1)
            self.cache = self.kv.sync_table(self.cache)
        with self._span("decode_tick", active=int(active.sum())):
            with torch.no_grad():
                self.cache, logits = self._decode_call(
                    self.params, self.cache, self._tensor(next_token),
                    self._tensor(active))
            # Reads the tokens back: the span covers the device step.
            toks = self._sample(logits, reqs)
        self._len[active] += 1
        return toks
