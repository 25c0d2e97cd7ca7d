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

Tunable-precision serving: pass ``plan=`` (a
:class:`repro_torch.tune.PrecisionPlan`, e.g. the one the trainer's
``--tune`` wrote) and the engine serves under the policy the plan
encodes, in subset mode: a train-calibrated plan carries backward-pass
sites the serving programs never run, and those entries are ignored.

Telemetry, as in the reference: pass ``metrics=`` (a
:class:`repro_torch.obs.MetricsRun`) for the per-site ``site_exec``
hook on the offloaded programs, ``prefill`` / ``decode_tick`` spans,
per-request latency histograms (``serve_admission_wait_s``,
``serve_prefill_s``, ``serve_ttft_s``, ``serve_latency_slack_s``) and
``request`` events, the ``serve_tokens`` counter, the
``serve_slot_occupancy`` gauge, the scheduler's queue and the KV
cache's block gauges, and TTFT against ``latency_target_s`` feeding an
:class:`~repro_torch.obs.SLOTracker`; ``metrics_port=`` also serves the
run's registry live at ``/metrics``.

Warm start, as in the reference: ``warm_cache_dir=`` persists the
programs' offload decision caches there, so a restarted engine reads
its site decisions from disk and checks them byte for byte (see
:mod:`repro_torch.serve.runner`).

Sharded serving: inside each rank of a mesh of processes (started by
:func:`repro_torch.shard.launch.spawn` or ``torchrun``), pass the
rank's :class:`repro_torch.shard.Mesh` as ``mesh=`` (``build_mesh(
"dp=2")``, ``build_mesh("dp=2,tp=2")``) and the same model, parameters
and requests on every rank.  The dp axis (the first that is not
``tp``) splits the slots into contiguous groups, one per dp
coordinate, and ``batch_slots`` must divide by its extent; the ``tp``
axis runs the LM's tensor parallelism (:meth:`Model.tp_view`, the
parameters cut per :func:`repro_torch.shard.lm_param_specs`) and
splits the kv heads.  Control is replicated: every rank runs the same
scheduler, packing and block manager over every slot, while its device
holds and computes only its group's slots (requests take the lowest
free slot, as in the reference: nothing balances the groups) and its
kv heads; the sampled tokens are exchanged over dp, so every rank's
``run`` returns every request's tokens.  Rank 0's enqueue stamp is
every rank's, so EDF order and the SLO readings agree.  ``metrics=``
and ``metrics_port=`` are per rank (give each rank its own
:class:`~repro_torch.obs.MetricsRun`); ``warm_cache_dir`` is ignored.
See :mod:`repro_torch.serve.runner` for what the sites record.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..core import PrecisionPolicy
from ..models import Model
from ..obs import MetricsServer, SLOTracker, get_logger
from ..shard import broadcast_scalar, serve_dp_axis, serve_mesh_setup
from .kvcache import DenseKVCache, PagedKVCache
from .runner import Runner
from .scheduler import Request, SamplingParamError, Scheduler

__all__ = ["Engine", "Request", "SamplingParamError"]

log = get_logger("serve")


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
      mesh: optional :class:`repro_torch.shard.Mesh`, this rank's view
        of a mesh of processes (module docstring); ``batch_slots`` must
        divide by its dp extent.
      plan: optional :class:`~repro_torch.tune.PrecisionPlan`; the
        programs run under ``offload`` with the plan's policy, in
        subset mode (``on_unmatched_site="ignore"``).
      policy: optional :class:`~repro_torch.core.PrecisionPolicy`; the
        prefill and decode programs run under ``offload``.  Wins over
        ``plan`` for the offload's configuration if both are given.
      kv_layout: ``"paged"`` (default) or ``"dense"``.
      block_size: paged block granularity; ``max_len`` must divide by
        it.
      num_blocks: paged pool size in usable blocks (default: the dense
        equivalent).
      chunk_tokens: prefill chunk length (``None``: whole prompts).
      chunk_token_budget: cap on real tokens per prefill wave.
      warm_cache_dir: persist the programs' offload decisions here
        (ignored without a policy); a restarted engine reads them back.
      scheduler_policy: ``"fifo"`` (default) or ``"edf"``.
      metrics: optional :class:`repro_torch.obs.MetricsRun` (see the
        module docstring).
      metrics_port: start a live :class:`repro_torch.obs.MetricsServer`
        on this port (0 = ephemeral; read it back from
        ``engine.metrics_server.port``) serving the run's registry at
        ``/metrics`` while the engine runs.  Requires ``metrics=``.
      slo_objective / slo_window_s: the serve SLO — per-request TTFT
        vs ``latency_target_s`` feeds a rolling burn-rate gauge
        (``slo_burn_rate``); only active with ``metrics=``.
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
                 slo_objective: float = 0.99,
                 slo_window_s: float = 60.0,
                 device=None):
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                             "have ('paged', 'dense')")
        if device is not None and str(device) != str(model.device):
            raise ValueError(f"device={device} but the model lives on "
                             f"{model.device}")
        self.metrics = metrics
        self.batch_slots = int(batch_slots)
        self.max_len = int(max_len)
        self.mesh = mesh
        dp, group = 1, None
        if mesh is not None:
            dp_axis, dp = serve_dp_axis(mesh)
            if self.batch_slots % dp:
                raise ValueError(
                    f"batch_slots={self.batch_slots} is not divisible "
                    f"by the data-parallel extent {dp_axis}={dp}")
            group = 0 if dp_axis is None else mesh.coords[dp_axis]
            model, params = serve_mesh_setup(mesh, model, params)
        self.model = model
        self.params = params
        if policy is None and plan is not None:
            # Subset mode: the plan's backward-pass and other unmatched
            # entries are expected here, not typos to warn about.
            policy = PrecisionPolicy.from_plan(plan,
                                               on_unmatched_site="ignore")
        self.plan = plan
        self.policy = policy
        registry = metrics.registry if metrics is not None else None
        if kv_layout == "paged":
            self.kv = PagedKVCache(model, self.batch_slots, self.max_len,
                                   block_size=block_size,
                                   num_blocks=num_blocks, dp_groups=dp,
                                   group=group, registry=registry)
        else:
            self.kv = DenseKVCache(model, self.batch_slots, self.max_len,
                                   dp_groups=dp, group=group,
                                   registry=registry)
        self.runner = Runner(
            model, params, self.kv, max_len=self.max_len, mesh=mesh,
            policy=policy, plan=plan, metrics=metrics,
            chunk_tokens=chunk_tokens,
            chunk_token_budget=chunk_token_budget,
            warm_cache_dir=warm_cache_dir)
        self.slo = None
        if metrics is not None:
            self.slo = SLOTracker(registry=metrics.registry,
                                  objective=slo_objective,
                                  window_s=slo_window_s,
                                  sink=metrics.sink)
        self.scheduler = Scheduler(self.max_len, policy=scheduler_policy,
                                   metrics=metrics, slo=self.slo)
        self.metrics_server = None
        if metrics_port is not None:
            if metrics is None:
                raise ValueError("metrics_port requires metrics= (the "
                                 "server exposes that run's registry)")
            self.metrics_server = MetricsServer(
                metrics.registry, port=metrics_port,
                runs_dir=metrics.directory).start()
        self.slots: List[Optional[Request]] = [None] * self.batch_slots
        self._next_token = np.zeros(self.batch_slots, np.int32)
        # Per-request latency bookkeeping, keyed by request identity
        # (Request is a plain mutable dataclass, not hashable by value).
        self._rstats: dict = {}

    # -- introspection -----------------------------------------------

    @property
    def cache(self) -> dict:
        """The live KV-cache tensors (owned by the runner)."""
        return self.runner.cache

    def prefill_sites(self, rows: int, width: int):
        """Site decisions of the prefill program for a wave of shape
        ``(rows, width)``; empty without a policy.  Under a mesh: of the
        program this rank runs for ``rows`` rows of its own (every rank
        of a tp group must ask alike, :meth:`Runner.sites_for`)."""
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
        if self.metrics is not None:
            log.debug(f"prefill wave: {len(res.pieces)} chunks, "
                      f"{res.real_tokens} tokens "
                      f"(padded {res.rows}x{res.width}) in "
                      f"{res.duration_s * 1e3:.1f} ms")
            t_wave = time.perf_counter() - res.duration_s
            for _, req, _ in res.pieces:
                st = self._rstats.get(id(req))
                if st is None:
                    continue
                if "t_admit" not in st:
                    # First chunk of this request to reach a device.
                    st["t_admit"] = t_wave
                    st["admission_wait_s"] = t_wave - st["t_enqueue"]
                    self.metrics.registry.histogram(
                        "serve_admission_wait_s").observe(
                        st["admission_wait_s"])
                st["prefill_s"] = (st.get("prefill_s", 0.0)
                                   + res.duration_s)
        for slot, req, token in res.completed:
            st = self._rstats.get(id(req))
            if st is not None:
                self.metrics.registry.histogram(
                    "serve_prefill_s").observe(st["prefill_s"])
            self._emit(slot, req, token)

    def _decode_tick(self) -> None:
        active = np.array([
            req is not None and not self.runner.is_prefilling(slot)
            for slot, req in enumerate(self.slots)])
        if not active.any():
            return
        if self.metrics is not None:
            self.metrics.registry.gauge("serve_slot_occupancy").set(
                int(active.sum()))
            for slot in np.flatnonzero(active):
                st = self._rstats.get(id(self.slots[slot]))
                if st is not None:
                    st["decode_ticks"] = st.get("decode_ticks", 0) + 1
        nxt = self.runner.decode_tick(self._next_token, active,
                                      self.slots)
        for slot in np.flatnonzero(active):
            self._emit(int(slot), self.slots[slot], int(nxt[slot]))

    def _emit(self, slot: int, req: Request, token: int) -> None:
        req.out.append(token)
        st = self._rstats.get(id(req))
        if st is not None and "ttft_s" not in st:
            # First emitted token (from the final prefill chunk), read
            # back to the host already: the time covers the device work.
            st["ttft_s"] = time.perf_counter() - st["t_enqueue"]
            self.metrics.registry.histogram(
                "serve_ttft_s").observe(st["ttft_s"])
            if req.latency_target_s is not None:
                slack = req.latency_target_s - st["ttft_s"]
                self.metrics.registry.histogram(
                    "serve_latency_slack_s").observe(slack)
                if slack < 0:
                    self.metrics.registry.counter(
                        "serve_latency_miss").inc()
            if self.slo is not None:
                self.slo.observe(st["ttft_s"], req.latency_target_s)
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
            if st is not None:
                self._finish(req, st)

    def _finish(self, req: Request, st: dict) -> None:
        """Finalize one request's telemetry: the ``request`` event."""
        gen_s = time.perf_counter() - st.get("t_admit", st["t_enqueue"])
        tokens_per_s = len(req.out) / max(gen_s, 1e-9)
        self.metrics.registry.counter("serve_tokens").inc(len(req.out))
        self.metrics.event(
            "request", prompt_len=len(req.prompt),
            new_tokens=len(req.out),
            admission_wait_s=st.get("admission_wait_s"),
            prefill_s=st.get("prefill_s"), ttft_s=st.get("ttft_s"),
            decode_ticks=st.get("decode_ticks", 0),
            tokens_per_s=tokens_per_s,
            latency_target_s=req.latency_target_s)
        log.debug(f"request done: {len(req.prompt)} prompt + "
                  f"{len(req.out)} new tokens, "
                  f"ttft {st.get('ttft_s', 0) * 1e3:.1f} ms, "
                  f"{tokens_per_s:.1f} tok/s")
        self._rstats.pop(id(req), None)

    # -- public API --------------------------------------------------

    def run(self, requests: List[Request]) -> List[Request]:
        """Drive all ``requests`` to completion; returns them in order.

        Requests are validated up front (:class:`SamplingParamError`,
        a ``ValueError``); more requests than slots queue and are
        admitted as earlier ones finish.  Under a mesh every rank must
        call it with the same requests.
        """
        now = time.perf_counter()
        if self.mesh is not None:
            now = broadcast_scalar(now, self.mesh)
        self.scheduler.submit(requests, now=now)
        if self.metrics is not None:
            for req in requests:
                self._rstats[id(req)] = {
                    "t_enqueue": self.scheduler.t_enqueue(req)}
        while (self.scheduler.pending or
               any(r is not None for r in self.slots)):
            self._admit()
            self._prefill_tick()
            self._decode_tick()
        if self.metrics is not None:
            # The site hook runs on the host as each product is issued,
            # so the execution counters are complete here.
            self.metrics.registry.gauge("serve_slot_occupancy").set(0)
        return requests

    def close(self) -> None:
        """Stop the live metrics server, if one was started."""
        if self.metrics_server is not None:
            self.metrics_server.close()
            self.metrics_server = None
