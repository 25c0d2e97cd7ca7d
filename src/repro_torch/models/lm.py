"""Llama-style decoder-only LM as eager PyTorch programs.

Port of :mod:`repro.models.lm`.  :class:`Model` is an ``nn.Module``
that owns the parameters under the reference's names — ``embed``,
the stacked block tensors ``blocks/{attn_norm, wq, wk, wv, wo,
mlp_norm, w_gate, w_up, w_down}`` with a leading layer axis,
``final_norm`` and ``lm_head`` — and :attr:`Model.params` hands them
out as the reference's parameter dict.  Every program takes that dict
first, as the reference's pure functions do, so
``offload(model.prefill_chunk_paged, policy)`` routes its GEMMs
exactly where the reference's transform routes them.

Programs: :meth:`Model.apply` (full-context logits), :meth:`Model.loss`
(training), and the serving programs :meth:`~Model.init_cache`,
:meth:`~Model.prefill`, :meth:`~Model.decode_step`,
:meth:`~Model.prefill_chunk` (dense cache) and
:meth:`~Model.init_paged_cache`, :meth:`~Model.prefill_chunk_paged`,
:meth:`~Model.decode_step_paged` (block-table cache), plus
:meth:`~Model.greedy`.  Each runs its blocks through
:func:`repro_torch.core.intercept.scan`, so the block GEMMs are the
sites ``scan0/dot0`` .. ``scan0/dot8`` (q, k, v, the two attention
einsums, o, gate, up, down) and the LM head is ``dot0``, as in the
reference.

The dense cache layout is ``(num_layers, batch, kv_heads, max_len,
head_dim)``; the paged pool is ``(num_layers, num_blocks, kv_heads,
block_size, head_dim)`` addressed through a per-slot block table whose
last column is the slot's trash block.  The paged attention view is
gathered through the dense buffer's layout, so paged == dense bitwise.
Unlike the reference's pure functions, the cache programs write the new
K/V rows into the cache tensors they are given, in place, and return
those same tensors: an eager program gains nothing from a functional
copy of the whole cache per layer.

Numerics follow the reference: RMSNorm in at-least-f32, RoPE angles in
float32 (their cosines and sines from the C library's ``cosf`` and
``sinf``, which is what the reference's XLA CPU build computes),
attention scores, softmax and the SwiGLU gate in float32 (the module's
``ISLAND_DTYPE``; a probe may raise it to float64 to see the GEMMs'
own error in a float64 model).

:meth:`Model.loss` is the mean causal cross-entropy in at-least-f32, as
the reference's, and is differentiable through :meth:`Model.apply`:
give it a parameter dict whose tensors require gradients (the train
step makes such leaves; :attr:`Model.params` are frozen).  The
backward pass is deterministic on the card: the embedding gather is
``F.embedding`` (its CUDA backward sums each row's gradients in a
fixed order, where ``weight[tokens]``'s backward adds them atomically),
grouped-query heads are repeated by ``expand`` (whose backward is a
sum, where ``repeat_interleave``'s is an atomic index add), and the
softmaxes stop the gradient at their max, as ``jax.nn`` does.

Tensor parallelism.  ``Model(cfg, tp=group)`` (or :meth:`Model.tp_view`
of a model) runs the block math Megatron-style for one rank of a tp
process group, on that rank's blocks of the parameters
(:mod:`repro_torch.shard.rules`): ``wq``/``wk``/``wv`` and
``w_gate``/``w_up`` column-parallel, ``wo``/``w_down`` row-parallel.
Each block's normed input passes :class:`_TPEnter` (identity forward,
all-reduce of the gradient backward), and the outputs of ``wo`` and
``w_down`` pass :class:`_TPExit` (all-reduce forward, identity
backward), the reference's ``_tp_enter``/``_tp_exit``.  The head counts
come from the local shapes, so the same code runs the full model and
any shard width, and the KV caches hold the rank's
``num_kv_heads / tp`` heads (:attr:`Model.kv_heads`).  The two are user
``autograd.Function`` classes, which the offload leaves opaque.
"""

from __future__ import annotations

import copy
import ctypes
import ctypes.util

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..configs import LMConfig
from ..core.intercept import scan
from . import prng

__all__ = ["Model", "params_from_reference"]

# Finite mask value: -inf breaks softmax rows that are fully masked
# (inactive serve slots attend to nothing real); a large negative
# float32 yields harmless uniform attention there instead of NaNs.
_MASK_VALUE = -1e30

# The dtype of the attention scores and softmax and of the SwiGLU gate,
# whatever the model's dtype: float32, as in the reference.
ISLAND_DTYPE = torch.float32

_BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _rms_norm(x, weight, eps):
    """RMSNorm in at-least-f32 (f64 for an f64 model), cast back."""
    dt = torch.promote_types(x.dtype, torch.float32)
    h = x.to(dt)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * weight.to(dt)).to(x.dtype)


_LIBM = None


def _libm():
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for name in ("cosf", "sinf", "powf"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_float
            fn.argtypes = ([ctypes.c_float] * (2 if name == "powf" else 1))
        _LIBM = lib
    return _LIBM


_ROPE_TABLES: dict = {}


def _rope_table(num_positions: int, head_dim: int, theta: float, device):
    """float32 (cos, sin) of ``p * theta**(-j/half)`` for p < num_positions,
    on ``device``.

    The angle is the reference's float32 product; ``cosf``/``sinf``/
    ``powf`` of the C library give the values its XLA CPU build gives
    (torch's own float32 ``cos`` differs in about 1% of the entries by
    an ulp).  Built on the host, copied to the device once per size and
    kept there.
    """
    key = (head_dim, float(theta), torch.device(device))
    have = _ROPE_TABLES.get(key)
    if have is not None and have[0].shape[0] >= num_positions:
        return have
    lib = _libm()
    half = head_dim // 2
    expo = -np.arange(half, dtype=np.float32) / np.float32(half)
    freq = np.array([lib.powf(theta, float(e)) for e in expo], np.float32)
    size = max(num_positions, 2 * (have[0].shape[0] if have else 0), 64)
    ang = np.arange(size, dtype=np.float32)[:, None] * freq[None, :]
    flat = ang.ravel().tolist()
    cos = np.array([lib.cosf(a) for a in flat], np.float32)
    sin = np.array([lib.sinf(a) for a in flat], np.float32)
    table = (torch.from_numpy(cos.reshape(size, half)).to(device),
             torch.from_numpy(sin.reshape(size, half)).to(device))
    _ROPE_TABLES[key] = table
    return table


def _rope_cos_sin(positions, num_positions: int, head_dim: int,
                  theta: float):
    """(cos, sin) float32 tables gathered at ``positions`` (..., T)."""
    cos, sin = _rope_table(num_positions, head_dim, theta,
                           positions.device)
    idx = positions.to(torch.long)
    return cos[idx], sin[idx]


def _rope(x, cos, sin):
    """Rotate half-dim pairs of ``x`` (..., T, H, head_dim)."""
    half = x.shape[-1] // 2
    cos = cos[..., None, :]  # broadcast over the head axis
    sin = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _softmax(x):
    """``jax.nn.softmax`` over the last axis, spelled out (no gradient
    through the max, as there)."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True).detach())
    return e / torch.sum(e, dim=-1, keepdim=True)


def _log_softmax(x):
    """``jax.nn.log_softmax`` over the last axis, spelled out."""
    shifted = x - torch.amax(x, dim=-1, keepdim=True).detach()
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1,
                                         keepdim=True))


def _sdpa(q, k, v, mask):
    """Softmax(QK^T / sqrt(d)) V with a boolean keep-mask.

    q: (B, T, H, d); k, v: (B, S, H, d); mask: (B, T, S) True = attend.
    Scores are computed and normalized in ``ISLAND_DTYPE`` (float32).
    """
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bthd,bshd->bhts", q, k).to(ISLAND_DTYPE)
    scores = scores * scale
    scores = torch.where(mask[:, None, :, :], scores,
                         torch.tensor(_MASK_VALUE, dtype=scores.dtype,
                                      device=scores.device))
    attn = _softmax(scores)
    return torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)


def _paged_view(pool, attend, head_dim):
    """The attention view of a paged pool (NB, KV, bs, d) for block
    table rows ``attend`` (B, nb): gathered as (B, nb, KV, bs, d), laid
    out as the dense buffer's (B, KV, S, d), then moved to (B, S, KV, d)
    exactly as the dense path moves its buffer — so the einsum gets the
    dense path's strides, and sums in its order."""
    B, nb = attend.shape
    S = nb * pool.shape[2]
    buf = pool[attend].permute(0, 2, 1, 3, 4).reshape(B, -1, S, head_dim)
    return torch.movedim(buf, 1, 2)


class _TPEnter(torch.autograd.Function):
    """Identity forward, all-reduce over the tp group backward.

    Megatron's ``f`` around the replicated input of a tensor-parallel
    block: each rank's backward yields only its shard's part of the
    input's gradient, and the all-reduce completes it, so the residual
    stream and every replicated parameter upstream see the whole
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TPExit(torch.autograd.Function):
    """All-reduce over the tp group forward, identity backward.

    Megatron's ``g`` after a row-parallel product (``wo``, ``w_down``):
    it sums the ranks' partial products into the replicated output; the
    gradient arriving is replicated already."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def params_from_reference(params, device=None) -> dict:
    """The reference's parameter pytree (arrays, e.g. ``np.asarray`` of
    each leaf) as the port's parameter dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        return torch.as_tensor(np.array(x), device=dev)

    out = {key: conv(val) for key, val in params.items()
           if key != "blocks"}
    out["blocks"] = {key: conv(params["blocks"][key])
                     for key in _BLOCK_KEYS}
    return out


class Model(nn.Module):
    """A decoder-only LM bound to an :class:`~repro_torch.configs.LMConfig`.

    The module owns the parameters (random from ``seed`` until
    :meth:`load_params` replaces them); the programs are functions of
    ``(params, ...)`` like the reference's, with ``params`` the dict
    :attr:`params` returns.  ``tp``, a process group, makes the block
    math tensor-parallel over it (module docstring); the programs then
    take this rank's blocks of the parameters.
    """

    def __init__(self, cfg: LMConfig, device=None, seed: int = 0, tp=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg.dtype)
        self.param_dtype = _dtype(cfg.param_dtype)
        self.tp = tp
        self._init_params(seed)

    def tp_view(self, tp) -> "Model":
        """This model's programs, tensor-parallel over the process group
        ``tp`` (``None``: not), sharing its parameters."""
        view = copy.copy(self)
        view.tp = tp
        return view

    def _tp_in(self, x):
        return x if self.tp is None else _TPEnter.apply(x, self.tp)

    def _tp_out(self, x):
        return x if self.tp is None else _TPExit.apply(x, self.tp)

    # -- parameters --------------------------------------------------

    def _init_params(self, seed: int) -> None:
        """The reference's ``init_params(PRNGKey(seed))``, to the bit:
        scaled-normal projections drawn from ``split(key, 8)`` in its
        order (:mod:`repro_torch.models.prng`), unit norms and a zero
        LM head (untied) — a model made only from the seed therefore
        decodes token 0; serving smokes set the head."""
        cfg = self.cfg
        L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
        keys = iter(prng.split(prng.prng_key(seed), 8))
        s_in = d ** -0.5
        s_out = s_in / (2 * L) ** 0.5  # residual-branch damping

        def init(shape, scale):
            # The scale is a weakly typed float32 scalar, as in jax.
            w = prng.normal(next(keys), shape, self.device) * torch.tensor(
                scale, dtype=torch.float32, device=self.device)
            return nn.Parameter(w.to(self.param_dtype),
                                requires_grad=False)

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=self.param_dtype,
                                           device=self.device),
                                requires_grad=False)

        self.embed = init((cfg.vocab_size, d), 0.02)
        self.blocks = nn.ParameterDict({
            "attn_norm": ones((L, d)),
            "wq": init((L, d, cfg.q_dim), s_in),
            "wk": init((L, d, cfg.kv_dim), s_in),
            "wv": init((L, d, cfg.kv_dim), s_in),
            "wo": init((L, cfg.q_dim, d), s_out),
            "mlp_norm": ones((L, d)),
            "w_gate": init((L, d, f), s_in),
            "w_up": init((L, d, f), s_in),
            "w_down": init((L, f, d), s_out),
        })
        self.final_norm = ones((d,))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((d, cfg.vocab_size), dtype=self.param_dtype,
                            device=self.device), requires_grad=False)

    @property
    def params(self) -> dict:
        """The parameter dict the programs take (the reference's tree)."""
        out = {"embed": self.embed,
               "blocks": {key: self.blocks[key] for key in _BLOCK_KEYS},
               "final_norm": self.final_norm}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = self.lm_head
        return out

    def load_params(self, params: dict) -> "Model":
        """Copy a parameter dict (e.g. :func:`params_from_reference`)
        into the module; shapes must match the config."""
        with torch.no_grad():
            for key, val in params.items():
                if key == "blocks":
                    for bkey in _BLOCK_KEYS:
                        self.blocks[bkey].copy_(val[bkey])
                else:
                    getattr(self, key).copy_(val)
        return self

    # -- shared block pieces -----------------------------------------

    def _qkv(self, lp, x, cos, sin):
        """Project + reshape + rope.  x: (B, T, d) -> q/k/v heads."""
        cfg = self.cfg
        B, T = x.shape[:2]
        h = self._tp_in(_rms_norm(x, lp["attn_norm"], cfg.norm_eps))
        q = (h @ lp["wq"]).reshape(B, T, -1, cfg.head_dim)
        k = (h @ lp["wk"]).reshape(B, T, -1, cfg.head_dim)
        v = (h @ lp["wv"]).reshape(B, T, -1, cfg.head_dim)
        return _rope(q, cos, sin), _rope(k, cos, sin), v

    def _attn_out(self, lp, x, o):
        B, T = x.shape[:2]
        return x + self._tp_out(o.reshape(B, T, -1) @ lp["wo"])

    def _mlp(self, lp, x):
        h = self._tp_in(_rms_norm(x, lp["mlp_norm"], self.cfg.norm_eps))
        g = (h @ lp["w_gate"]).to(ISLAND_DTYPE)
        gate = g * torch.sigmoid(g)
        up = (h @ lp["w_up"]).to(ISLAND_DTYPE)
        return x + self._tp_out((gate * up).to(x.dtype) @ lp["w_down"])

    @staticmethod
    def _repeat_kv(kv, num_heads):
        """(B, S, KV, d) -> (B, S, H, d) for grouped-query attention
        (query head h reads kv head h // rep, as ``jnp.repeat``)."""
        B, S, KV, d = kv.shape
        rep = num_heads // KV
        if rep == 1:
            return kv
        return kv[:, :, :, None, :].expand(B, S, KV, rep, d).reshape(
            B, S, KV * rep, d)

    def _head(self, params, x):
        """Final norm + LM head on (..., d) activations."""
        x = _rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x @ head

    def _rope_at(self, positions, num_positions):
        return _rope_cos_sin(positions, num_positions, self.cfg.head_dim,
                             self.cfg.rope_theta)

    def _embed(self, params, tokens):
        return F.embedding(tokens.to(torch.long),
                           params["embed"]).to(self.dtype)

    # -- full-context forward ----------------------------------------

    def apply(self, params, tokens):
        """Causal logits for ``tokens`` (B, T) -> (B, T, vocab)."""
        B, T = tokens.shape
        x = self._embed(params, tokens)
        dev = x.device
        positions = torch.arange(T, device=dev).expand(B, T)
        cos, sin = self._rope_at(positions, T)
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=dev))
        mask = causal.expand(B, T, T)

        def block(x, lp):
            q, k, v = self._qkv(lp, x, cos, sin)
            H = q.shape[2]
            o = _sdpa(q, self._repeat_kv(k, H), self._repeat_kv(v, H),
                      mask)
            x = self._attn_out(lp, x, o)
            return self._mlp(lp, x), None

        x, _ = scan(block, x, params["blocks"])
        return self._head(params, x)

    def loss(self, params, tokens):
        """Mean causal cross-entropy over ``tokens`` (B, T+1), computed
        in at-least-f32 (f64 for an f64 model)."""
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        logits = self.apply(params, inputs)
        logits = logits.to(torch.promote_types(logits.dtype,
                                               torch.float32))
        logp = _log_softmax(logits)
        nll = -torch.gather(logp, -1, targets[..., None].to(torch.long))
        return torch.mean(nll)

    # -- KV-cache programs (serving) ---------------------------------

    @property
    def kv_heads(self) -> int:
        """The kv heads this model's programs compute: all of them, or
        this rank's ``num_kv_heads / tp`` under a tp group."""
        tp = 1 if self.tp is None else dist.get_world_size(self.tp)
        return self.cfg.num_kv_heads // tp

    def init_cache(self, batch: int, max_len: int) -> dict:
        """Empty cache: stacked K/V buffers (this rank's kv heads under
        a tp group) + per-slot lengths."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, self.kv_heads, max_len,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype,
                                 device=self.device),
                "length": torch.zeros((batch,), dtype=torch.int32,
                                      device=self.device)}

    def _cached_forward(self, params, cache, tokens, start):
        """Shared prefill/decode body over the dense cache.

        tokens: (B, T) new tokens; start: (B,) their first absolute
        position.  Writes the new K/V at ``start..start+T-1`` per slot
        into the cache's buffers in place (clamped into the buffer as
        ``dynamic_update_slice`` clamps), attends over the whole buffer
        under a key_pos <= query_pos mask, and returns ``(k, v, hidden
        (B, T, d))`` with ``k``/``v`` the cache's own tensors.
        """
        B, T = tokens.shape
        S = cache["k"].shape[3]
        x = self._embed(params, tokens)
        dev = x.device
        offs = torch.arange(T, device=dev)
        positions = start.to(torch.long)[:, None] + offs       # (B, T)
        cos, sin = self._rope_at(positions, S)
        key_pos = torch.arange(S, device=dev)
        mask = key_pos[None, None, :] <= positions[:, :, None]
        at = torch.clamp(start.to(torch.long), 0, S - T)[:, None] + offs
        rows = torch.arange(B, device=dev)[:, None]

        def block(x, layer):
            # k_buf, v_buf: this layer's (B, KV, S, d) views of the cache.
            lp, k_buf, v_buf = layer
            q, k, v = self._qkv(lp, x, cos, sin)
            k_buf[rows, :, at, :] = k
            v_buf[rows, :, at, :] = v
            k_all = torch.movedim(k_buf, 1, 2)  # (B, S, KV, d)
            v_all = torch.movedim(v_buf, 1, 2)
            H = q.shape[2]
            o = _sdpa(q, self._repeat_kv(k_all, H),
                      self._repeat_kv(v_all, H), mask)
            x = self._attn_out(lp, x, o)
            return self._mlp(lp, x), None

        x, _ = scan(block, x, (params["blocks"], cache["k"], cache["v"]))
        return cache["k"], cache["v"], x

    @staticmethod
    def _last(x, count):
        """Rows of ``x`` (B, T, d) at position ``count - 1`` per slot
        (``count == 0``, a padding row, wraps to the last position as
        ``take_along_axis`` wraps -1)."""
        idx = count.to(torch.long) - 1
        idx = torch.where(idx < 0, idx + x.shape[1], idx)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def prefill(self, params, tokens, lengths, max_len: int):
        """Ingest right-padded prompts into a fresh cache; returns
        ``(cache, logits)`` at each prompt's final real token."""
        b = tokens.shape[0]
        cache = self.init_cache(b, max_len)
        start = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
        k_new, v_new, x = self._cached_forward(params, cache, tokens,
                                               start)
        logits = self._head(params, self._last(x, lengths))
        return ({"k": k_new, "v": v_new,
                 "length": lengths.to(torch.int32)}, logits)

    def decode_step(self, params, cache, tokens, active):
        """One decoding step: consume ``tokens`` (B,), emit next logits;
        ``active`` (B,) gates the length bump."""
        start = cache["length"]
        k_new, v_new, x = self._cached_forward(params, cache,
                                               tokens[:, None], start)
        logits = self._head(params, x[:, 0, :])
        new_len = torch.where(active, start + 1, start)
        return ({"k": k_new, "v": v_new, "length": new_len}, logits)

    def prefill_chunk(self, params, k, v, tokens, start, piece_len):
        """One chunk of a dense prefill over gathered cache rows k/v
        (L, rows, KV, max_len, d); logits at each chunk's last real
        token."""
        k_new, v_new, x = self._cached_forward(
            params, {"k": k, "v": v}, tokens, start)
        logits = self._head(params, self._last(x, piece_len))
        return k_new, v_new, logits

    # -- paged KV-cache programs (serving) ---------------------------

    def init_paged_cache(self, num_blocks: int, block_size: int) -> dict:
        """Empty K/V block pools for the paged cache layout (this
        rank's kv heads under a tp group)."""
        cfg = self.cfg
        shape = (cfg.num_layers, num_blocks, self.kv_heads,
                 block_size, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype,
                                 device=self.device)}

    def _paged_forward(self, params, k_pool, v_pool, table, tokens,
                       start, write_mask):
        """Shared paged prefill/decode body (block-table indirection).

        table: (B, nb + 1) physical block ids, the last column the
        slot's trash block, where padded or inactive tokens write;
        write_mask: (B, T) True where the token is real.  The new K/V
        rows are written into the pools in place.  The attention view
        is gathered through the dense buffer's (B, KV, S, d) layout, so
        its operand has the dense path's strides and the einsum sums in
        the same order: paged == dense bitwise.
        """
        cfg = self.cfg
        B, T = tokens.shape
        nb = table.shape[1] - 1
        bs = k_pool.shape[3]
        S = nb * bs
        x = self._embed(params, tokens)
        dev = x.device
        table = table.to(torch.long)
        positions = (start.to(torch.long)[:, None]
                     + torch.arange(T, device=dev))              # (B, T)
        cos, sin = self._rope_at(positions, S)
        key_pos = torch.arange(S, device=dev)
        mask = key_pos[None, None, :] <= positions[:, :, None]
        col = torch.where(write_mask, positions // bs,
                          torch.full_like(positions, nb))
        phys = torch.gather(table, 1, col)                        # (B, T)
        flat_phys = phys.reshape(-1)
        flat_off = (positions % bs).reshape(-1)
        attend = table[:, :nb]                                    # (B, nb)

        def write(pool, new):
            # pool: this layer's (NB, KV, bs, d) view; new: (B, T, KV, d).
            pool[flat_phys, :, flat_off, :] = new.reshape(
                B * T, new.shape[2], new.shape[3])

        def block(x, layer):
            lp, kp, vp = layer
            q, k, v = self._qkv(lp, x, cos, sin)
            write(kp, k)
            write(vp, v)
            H = q.shape[2]
            k_all = _paged_view(kp, attend, cfg.head_dim)
            v_all = _paged_view(vp, attend, cfg.head_dim)
            o = _sdpa(q, self._repeat_kv(k_all, H),
                      self._repeat_kv(v_all, H), mask)
            x = self._attn_out(lp, x, o)
            return self._mlp(lp, x), None

        x, _ = scan(block, x, (params["blocks"], k_pool, v_pool))
        return k_pool, v_pool, x

    def prefill_chunk_paged(self, params, k, v, table, tokens, start,
                            piece_len):
        """Paged :meth:`prefill_chunk` over the whole block pools."""
        T = tokens.shape[1]
        write_mask = (torch.arange(T, device=tokens.device)[None, :]
                      < piece_len[:, None])
        k_new, v_new, x = self._paged_forward(
            params, k, v, table, tokens, start, write_mask)
        logits = self._head(params, self._last(x, piece_len))
        return k_new, v_new, logits

    def decode_step_paged(self, params, cache, tokens, active):
        """One decoding step against the paged cache (same contract as
        :meth:`decode_step`; inactive slots write to their trash)."""
        start = cache["length"]
        k_new, v_new, x = self._paged_forward(
            params, cache["k"], cache["v"], cache["block_table"],
            tokens[:, None], start, active[:, None])
        logits = self._head(params, x[:, 0, :])
        new_len = torch.where(active, start + 1, start)
        return ({"k": k_new, "v": v_new,
                 "block_table": cache["block_table"],
                 "length": new_len}, logits)

    @staticmethod
    def greedy(logits):
        """Greedy token choice (B, vocab) -> (B,) int32."""
        return torch.argmax(logits, dim=-1).to(torch.int32)
