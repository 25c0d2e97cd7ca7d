"""A decoder with routed experts and sliding/full attention layers.

:class:`MoEModel` is :class:`repro_torch.models.lm.Model` with two
changes to the block, both read from its
:class:`~repro_torch.configs.LMConfig`:

* Attention by layer kind (``layer_pattern``).  A full layer attends
  causally, with RoPE scaled by YaRN when ``yarn_factor`` is set
  (arXiv:2309.00071, as Hugging Face's ``_compute_yarn_parameters``
  computes it: the ramp between ``beta_fast`` and ``beta_slow`` over the
  correction dimensions with floor/ceil truncation, cos and sin scaled
  by ``attention_factor``); a sliding layer lets query ``i`` see key
  ``j`` when ``i - sliding_window < j <= i``, with plain RoPE.  Both
  kinds run in the same stacked-block :func:`~repro_torch.core.
  intercept.scan`: each layer takes its kind's mask and (cos, sin)
  table, so every layer makes the same products and the sites keep
  their ``scan0/dot{j}`` names.
* An expert layer in place of the dense MLP, told which experts it
  holds (``experts_held``), as one rank of an expert-parallel layer
  computes it.  With ``h`` the post-attention RMSNorm of ``x``: the
  router's probabilities ``p = softmax(h @ router)`` over all
  ``num_experts``, in float32; the ``num_experts_per_tok`` largest,
  renormalised to sum to 1 when ``norm_topk_prob``; and ``out = x +
  sum over the held experts e routed to of w_e * down_e(silu(h gate_e)
  * h up_e)``.  Experts that are not held add nothing.  Each held expert
  gathers the tokens routed to it and runs its SwiGLU as three plain
  ``@`` products on them, then adds its weighted rows back
  (``index_add_`` with each row once a call, so the sum is
  deterministic).  No token is dropped and there is no capacity: the
  products take as many rows as the routing gives, which changes from
  step to step and from layer to layer.  Every held expert makes its
  three products on every call, with zero rows too, so the offload's
  site names do not depend on the routing.

The expert layer opens the layer spans ``moe.route`` (router, top-k and
the index build, which reads the per-expert token counts on the host:
one synchronizing read a layer) and ``moe.experts`` (gathers, the held
experts' products, the weighted adds), and records each call in the
model's :class:`~repro_torch.obs.experts.ExpertCounter`
(:attr:`MoEModel.counter`).  :attr:`MoEModel.routing` keeps the last
forward pass's choice: each layer's (tokens, top-k) expert ids, the
tensors the layer made (no copy).

Built on the card, the model turns on the caching allocator's growable
segments for the process (:func:`repro_torch._device.growable_segments`):
the experts' blocks change size every step, and at the Mellum2 cut's
peak of about 73 GB a cache of fixed segments fragments until a step
fails.

Parameters: the dense model's tree with ``blocks/router`` (L, d,
num_experts) and ``blocks/w_gate``, ``w_up`` (L, held, d, moe_d_ff) and
``w_down`` (L, held, moe_d_ff, d) in place of the dense MLP.  The
programs are :meth:`apply` and :meth:`loss` (training); serving needs a
window-aware cache, which the port does not have, so the cache programs
raise.
"""

from __future__ import annotations

import math
import time

import torch
import torch.nn as nn

from .._device import growable_segments, resolve_device
from ..configs import LMConfig
from ..core.intercept import scan
from ..obs.experts import ExpertCounter
from ..obs.trace import span
from . import lm
from .lm import Model, _rms_norm, _rope_cos_sin, _sdpa, _softmax

__all__ = ["MoEModel", "yarn_inv_freq", "attention_mask"]

_MOE_BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                   "router", "w_gate", "w_up", "w_down")


def yarn_inv_freq(head_dim: int, theta: float, factor: float,
                  original_max_positions: int, beta_fast: float,
                  beta_slow: float) -> torch.Tensor:
    """YaRN's float32 inverse frequencies (head_dim / 2,), as Hugging
    Face's ``_compute_yarn_parameters`` computes them on the host."""
    dim = head_dim

    def correction_dim(rotations):
        return (dim * math.log(original_max_positions
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low),
        0, 1)
    pos_freqs = theta ** (torch.arange(0, dim, 2).to(torch.float32) / dim)
    extrapolation = 1.0 - ramp
    return ((1.0 / (factor * pos_freqs)) * (1 - extrapolation)
            + (1.0 / pos_freqs) * extrapolation)


_YARN_TABLES: dict = {}


def _yarn_table(num_positions: int, cfg: LMConfig, device):
    """float32 (cos, sin) of YaRN's angles ``p * inv_freq``, times the
    attention factor, for p < num_positions, on ``device``; built on
    the host and kept per size."""
    attention = cfg.yarn_attention_factor or (
        0.1 * math.log(cfg.yarn_factor) + 1.0)
    key = (cfg.head_dim, cfg.rope_theta, cfg.yarn_factor,
           cfg.yarn_original_max_positions, cfg.yarn_beta_fast,
           cfg.yarn_beta_slow, attention, torch.device(device))
    have = _YARN_TABLES.get(key)
    if have is not None and have[0].shape[0] >= num_positions:
        return have
    inv_freq = yarn_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.yarn_factor,
                             cfg.yarn_original_max_positions,
                             cfg.yarn_beta_fast, cfg.yarn_beta_slow)
    size = max(num_positions, 64)
    ang = torch.arange(size, dtype=torch.float32)[:, None] * inv_freq
    table = ((torch.cos(ang) * attention).to(device),
             (torch.sin(ang) * attention).to(device))
    _YARN_TABLES[key] = table
    return table


def attention_mask(kind: str, q_pos, k_pos, window: int):
    """Keep-mask (..., T, S) of queries at ``q_pos`` (..., T) over keys
    at ``k_pos`` (S,): causal for ``"full"``, and within the last
    ``window`` positions for ``"sliding"``."""
    q, k = q_pos[..., :, None], k_pos[None, :]
    keep = k <= q
    if kind == "sliding":
        keep = keep & (k > q - window)
    return keep


class MoEModel(Model):
    """A decoder with expert layers and per-layer attention kinds
    (module docstring), bound to an
    :class:`~repro_torch.configs.LMConfig` whose ``num_experts`` is set.

    ``seed`` draws the parameters (normal, std d^-1/2 for the
    projections, the router and the experts' inputs, damped by
    (2L)^-1/2 on the residual outputs, 0.02 for the embedding and the
    head; norms ones) from a ``torch.Generator`` on ``device``.
    ``seed=None`` allocates none: the programs take their parameters
    from the caller (a benchmark that draws its own, a trainer that
    restores), and :attr:`params` is then empty.
    """

    def __init__(self, cfg: LMConfig, device=None, seed: int | None = 0,
                 tp=None):
        if not cfg.num_experts:
            raise ValueError(f"{cfg.name}: MoEModel needs num_experts")
        if tp is not None:
            raise ValueError("MoEModel has no tensor-parallel form")
        growable_segments(resolve_device(device))
        super().__init__(cfg, device=device, seed=seed)
        #: what the expert layers did (:class:`ExpertCounter`)
        self.counter = ExpertCounter()
        #: the experts each token went to, one (tokens, top-k) tensor per
        #: expert layer of the last :meth:`apply`
        self.routing: list = []
        self._held_ids: dict = {}

    # -- parameters --------------------------------------------------

    def _init_params(self, seed) -> None:
        cfg = self.cfg
        L, d, f = cfg.num_layers, cfg.d_model, cfg.moe_d_ff
        E, held = cfg.num_experts, len(cfg.held_experts)
        shapes = {"wq": ((L, d, cfg.q_dim), "in"),
                  "wk": ((L, d, cfg.kv_dim), "in"),
                  "wv": ((L, d, cfg.kv_dim), "in"),
                  "wo": ((L, cfg.q_dim, d), "out"),
                  "router": ((L, d, E), "in"),
                  "w_gate": ((L, held, d, f), "in"),
                  "w_up": ((L, held, d, f), "in"),
                  "w_down": ((L, held, f, d), "out")}
        self._drawn = seed is not None
        if seed is None:
            self.blocks = nn.ParameterDict()
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed) % (1 << 63))
        s_in = d ** -0.5
        scales = {"in": s_in, "out": s_in / math.sqrt(2 * L),
                  "embed": 0.02}

        def init(shape, kind):
            w = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=self.device) * scales[kind]
            return nn.Parameter(w.to(self.param_dtype), requires_grad=False)

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=self.param_dtype,
                                           device=self.device),
                                requires_grad=False)

        self.embed = init((cfg.vocab_size, d), "embed")
        blocks = {key: init(*spec) for key, spec in shapes.items()}
        blocks["attn_norm"] = ones((L, d))
        blocks["mlp_norm"] = ones((L, d))
        self.blocks = nn.ParameterDict(
            {key: blocks[key] for key in _MOE_BLOCK_KEYS})
        self.final_norm = ones((d,))
        if not cfg.tie_embeddings:
            self.lm_head = init((d, cfg.vocab_size), "embed")

    @property
    def params(self) -> dict:
        return super().params if self._drawn else {}

    # -- the expert layer ----------------------------------------------

    def _held(self, device) -> torch.Tensor:
        ids = self._held_ids.get(device)
        if ids is None:
            ids = torch.tensor(self.cfg.held_experts, dtype=torch.long,
                               device=device)
            self._held_ids[device] = ids
        return ids

    def _experts(self, lp, x):
        """``x`` plus the held experts' share of the expert layer
        (module docstring); one record in :attr:`counter`."""
        t0 = time.perf_counter_ns()
        cfg = self.cfg
        shape = x.shape
        h = _rms_norm(x, lp["mlp_norm"], cfg.norm_eps).reshape(-1, shape[-1])
        with span("moe.route"):
            probs = _softmax((h @ lp["router"]).to(lm.ISLAND_DTYPE))
            weights, chosen = torch.topk(probs, cfg.num_experts_per_tok,
                                         dim=-1)
            self.routing.append(chosen)
            if cfg.norm_topk_prob:
                weights = weights / torch.sum(weights, dim=-1, keepdim=True)
            hit = chosen[:, :, None] == self._held(h.device)  # (N, k, held)
            # Each token's routing weight for each held expert (0 where
            # not routed; an expert appears at most once in a top-k).
            gates = torch.sum(weights[:, :, None] * hit, dim=1).to(x.dtype)
            routed = torch.any(hit, dim=1).T                   # (held, N)
            counts = torch.sum(routed, dim=1).tolist()
            rows = torch.split(torch.nonzero(routed)[:, 1], counts)
        with span("moe.experts"):
            out = torch.zeros_like(h)
            experts = zip(rows, torch.unbind(gates.T),
                          torch.unbind(lp["w_gate"]), torch.unbind(lp["w_up"]),
                          torch.unbind(lp["w_down"]))
            for idx, gate, w_gate, w_up, w_down in experts:
                xe = torch.index_select(h, 0, idx)
                g = (xe @ w_gate).to(lm.ISLAND_DTYPE)
                up = (xe @ w_up).to(lm.ISLAND_DTYPE)
                y = (g * torch.sigmoid(g) * up).to(x.dtype) @ w_down
                out.index_add_(0, idx, y * gate[idx, None])
        self.counter.record(counts, time.perf_counter_ns() - t0)
        return x + out.reshape(shape)

    # -- full-context forward ----------------------------------------

    def apply(self, params, tokens):
        """Causal logits for ``tokens`` (B, T) -> (B, T, vocab), each
        layer attending as its kind says."""
        cfg = self.cfg
        B, T = tokens.shape
        x = self._embed(params, tokens)
        dev = x.device
        pos = torch.arange(T, device=dev)
        positions = pos.expand(B, T)
        kinds = {}
        for kind in set(map(cfg.layer_kind, range(cfg.num_layers))):
            if kind == "full" and cfg.yarn_factor:
                cos, sin = _yarn_table(T, cfg, dev)
                cos, sin = cos[positions], sin[positions]
            else:
                cos, sin = _rope_cos_sin(positions, T, cfg.head_dim,
                                         cfg.rope_theta)
            mask = attention_mask(kind, pos, pos, cfg.sliding_window)
            kinds[kind] = (cos, sin, mask.expand(B, T, T))
        full = torch.tensor([cfg.layer_kind(i) == "full"
                             for i in range(cfg.num_layers)])
        self.routing = []

        def block(x, layer):
            lp, is_full = layer
            cos, sin, mask = kinds["full" if bool(is_full) else "sliding"]
            q, k, v = self._qkv(lp, x, cos, sin)
            H = q.shape[2]
            o = _sdpa(q, self._repeat_kv(k, H), self._repeat_kv(v, H), mask)
            x = self._attn_out(lp, x, o)
            return self._experts(lp, x), None

        x, _ = scan(block, x, (params["blocks"], full))
        return self._head(params, x)

    # -- serving -------------------------------------------------------

    def _cached_forward(self, *args, **kwargs):
        raise NotImplementedError(
            "serving a model with sliding-window layers and experts needs "
            "a window-aware KV cache, which the port does not have")

    _paged_forward = _cached_forward
