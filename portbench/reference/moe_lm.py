"""Plain reference of the expert model (the Mellum2 configuration):
forward, loss, gradients and AdamW.

Written from the published description in plain torch, on the
parameter layout of ``portbench.inputs_moe.moe_params``: RMSNorm; q, k,
v projections; rotary embeddings in Hugging Face's layout (``cat(freqs,
freqs)``, ``rotate_half``), plain on sliding layers and YaRN on full
layers (arXiv:2309.00071 as ``_compute_yarn_parameters`` computes it);
grouped-query attention (query head h reads kv head h // (heads /
kv_heads)) under a causal mask, on sliding layers over the last
``sliding_window`` positions only; the output projection; RMSNorm; the
router's softmax over all ``router_experts`` outputs, the top
``num_experts_per_tok`` renormalised (``norm_topk_prob``); the held
experts' SwiGLU outputs weighted by each token's routing weight; a
final norm and the untied head.  It runs in float32 with TF32 off;
``tf32=True`` is the lower-precision control, ``dtype=torch.float64``
a higher-precision witness.  Imports torch and the dense reference
only, nothing of the program.

Departures from the published description, each deliberate:

* The experts held on the other ranks add nothing, as in the program
  (one expert-parallel rank's share of each layer).
* Every held expert runs on every token and is weighted by 0 where the
  token is not routed to it: the same sum as gathering the routed
  tokens, with no index bookkeeping shared with the program.
* No QK-norm, softmax routing, no auxiliary loss (the config names
  none of them); the router's softmax runs in the reference's dtype.
* To fit the card, each layer's activations are recomputed in the
  backward (``torch.utils.checkpoint``, the same operations again), and
  a float64 step or run takes the batch's sequences one at a time,
  summing each sequence's share of the mean loss and of its gradient.

Routing.  Top-k is discontinuous: where a token's k-th and (k+1)-th
probabilities lie within rounding of each other, two sound computations
choose different experts and their outputs part by a whole expert's
share.  So the reference can be handed a routing (``routing``: per step,
each layer's (tokens, k) expert ids, the program's): it then sends each
token to those experts, with weights from its own probabilities, and
reports ``margin``, the largest amount by which its own probability of
an expert not chosen exceeds that of one chosen (0 where the choice is
its own top-k).  Without a routing it routes by its own top-k and
returns its choice.  ``route_margin`` is that margin from a float64
forward of given parameters: the witness of whether a step's routing,
made from those parameters, is their top-k.

A step handed the AdamW moments it starts from (``step(...,
moments=...)``) also reports the norm of each leaf's change under that
step, worked out as the port's AdamW works it out, in the step's dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..work.moe_lm import MoEShape
from .lm import _leaves, _rms_norm, leaf_norms, matmul_precision, tree_map


def _inv_freq(rope: dict, head_dim: int):
    """(inverse frequencies, attention scaling) of one rope section, in
    float32."""
    base, dim = rope["rope_theta"], head_dim
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.int64)
                         .float() / dim)
    if rope["rope_type"] == "default":
        return 1.0 / pos_freqs, 1.0
    factor = rope["factor"]
    scaling = rope.get("attention_factor") or 0.1 * math.log(factor) + 1.0
    orig = rope["original_max_position_embeddings"]

    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rope["beta_fast"])), 0)
    high = min(math.ceil(corr(rope["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    extrapolation = 1 - ramp
    return ((1.0 / (factor * pos_freqs)) * (1 - extrapolation)
            + (1.0 / pos_freqs) * extrapolation), scaling


def _tables(shape: MoEShape, cfg: dict, T: int, device) -> dict:
    """Per layer kind: float32 (cos, sin) (T, head_dim) and the (T, T)
    keep-mask."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    out = {}
    for kind in set(shape.kinds):
        freq, scaling = _inv_freq(cfg["rope_parameters"][f"{kind}_attention"],
                                  shape.head_dim)
        ang = torch.arange(T, dtype=torch.float32)[:, None] * freq[None, :]
        emb = torch.cat([ang, ang], dim=-1)
        keep = j <= i
        if kind == "sliding":
            keep = keep & (j > i - shape.window)
        out[kind] = ((emb.cos() * scaling).to(device),
                     (emb.sin() * scaling).to(device), keep)
    return out


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rope(x, cos, sin):
    cos, sin = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
    return x * cos + _rotate_half(x) * sin


def _experts(h, blk, i, shape: MoEShape, cfg: dict, route: dict):
    """The held experts' share of layer ``i``'s expert output, rows
    ``h`` (N, d), routed by ``route["forced"][i]`` or by its own top-k
    (kept in ``route["chosen"][i]``)."""
    probs = torch.softmax(h @ blk["router"][i], dim=-1)
    if route["forced"] is None:
        _, chosen = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
        route["chosen"][i] = chosen
    else:
        chosen = route["forced"][i]
        p = probs.detach()
        taken = torch.zeros_like(p, dtype=torch.bool).scatter_(-1, chosen,
                                                                True)
        over = (p.masked_fill(taken, -1.0).amax(-1)
                - p.masked_fill(~taken, 2.0).amin(-1))
        route["margin"] = max(route["margin"], float(over.max()), 0.0)
    weights = probs.gather(-1, chosen)
    if cfg["norm_topk_prob"]:
        weights = weights / weights.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for j, e in enumerate(shape.held):
        w = (weights * (chosen == e)).sum(-1)
        y = (F.silu(h @ blk["w_gate"][i][j]) * (h @ blk["w_up"][i][j])) \
            @ blk["w_down"][i][j]
        out = out + w[:, None] * y
    return out


def _layer(x, blk, i, shape: MoEShape, cfg: dict, tables: dict,
           route: dict):
    B, T, _ = x.shape
    hd, eps = shape.head_dim, cfg["rms_norm_eps"]
    cos, sin, keep = tables[shape.kinds[i]]
    h = _rms_norm(x, blk["attn_norm"][i], eps)
    q = _rope((h @ blk["wq"][i]).view(B, T, shape.heads, hd), cos, sin)
    k = _rope((h @ blk["wk"][i]).view(B, T, shape.kv_heads, hd), cos, sin)
    v = (h @ blk["wv"][i]).view(B, T, shape.kv_heads, hd)
    rep = shape.heads // shape.kv_heads
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * hd ** -0.5
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, -1)
    x = x + o @ blk["wo"][i]
    h = _rms_norm(x, blk["mlp_norm"][i], eps)
    return x + _experts(h.reshape(B * T, -1), blk, i, shape, cfg,
                        route).view(B, T, -1)


def _route(forced=None) -> dict:
    return {"forced": forced, "chosen": {}, "margin": 0.0}


def logits(params, tokens, shape: MoEShape, cfg: dict,
           route: dict | None = None) -> torch.Tensor:
    """Logits (B, T, vocab) of ``tokens`` (B, T), each layer recomputed
    in the backward; ``route`` (``_route``) routes them."""
    route = _route() if route is None else route
    tables = _tables(shape, cfg, tokens.shape[1], tokens.device)
    blk = params["blocks"]
    x = params["embed"][tokens]
    for i in range(shape.layers):
        x = checkpoint(_layer, x, blk, i, shape, cfg, tables, route,
                       use_reentrant=False)
    x = _rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    head = params["embed"].T if shape.tied else params["lm_head"]
    return x @ head


def route_margin(params, batch, shape: MoEShape, cfg: dict,
                 routing) -> float:
    """The margin of ``routing`` (each layer's (tokens, k) expert ids
    for ``batch`` (B, T + 1)) from a float64 forward of ``params`` that
    follows it, one sequence at a time."""
    params = tree_map(lambda p: p.detach().double(), params)
    T = batch.shape[1] - 1
    tables = _tables(shape, cfg, T, batch.device)
    margin = 0.0
    with torch.no_grad():
        for b in range(batch.shape[0]):
            route = _route([r[b * T:(b + 1) * T] for r in routing])
            x = params["embed"][batch[b:b + 1, :-1]]
            for i in range(shape.layers):
                x = _layer(x, params["blocks"], i, shape, cfg, tables, route)
            margin = max(margin, route["margin"])
    return margin


def loss(params, batch, shape: MoEShape, cfg: dict, rows=None,
         route: dict | None = None):
    """Mean next-token cross-entropy of ``batch`` (B, T + 1); ``rows``
    limits the mean to the first ``rows`` token positions."""
    out = logits(params, batch[:, :-1], shape, cfg, route)
    targets = batch[:, 1:]
    if rows is not None:
        out, targets = out[:, :rows], targets[:, :rows]
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           targets.reshape(-1).long())


def loss_and_grads(params, batch, shape: MoEShape, cfg: dict, rows=None,
                   per_sequence: bool = False, routing=None):
    """The loss, its gradient (a tree like ``params``) and the routing
    (``{"routing": each layer's choice, "margin": ...}``, module
    docstring); with ``per_sequence`` one sequence at a time, each its
    share of the mean (sequences are of one length)."""
    B, T = batch.shape[0], batch.shape[1] - 1
    n = 1 if per_sequence else B
    total, grads, margin, chosen = 0.0, None, 0.0, []
    for b in range(0, B, n):
        part = batch[b:b + n]
        route = _route(None if routing is None else
                       [r[b * T:(b + n) * T] for r in routing])
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            value = loss(leaves, part, shape, cfg, rows=rows, route=route) * (
                n / B)
            got = torch.autograd.grad(value, _leaves(leaves))
        margin = max(margin, route["margin"])
        chosen.append(route["chosen"])
        total += float(value.detach())
        it = iter(got)
        got = tree_map(lambda _: next(it), params)
        grads = got if grads is None else tree_map(torch.Tensor.add_,
                                                   grads, got)
        del leaves, value
    own = None if routing is not None else [
        torch.cat([part[i] for part in chosen]) for i in range(shape.layers)]
    return total, grads, {"routing": own, "margin": margin}


def train(params0: dict, batches: Sequence[torch.Tensor], shape: MoEShape,
          cfg: dict, opt: dict, tf32: bool = False, rows=None,
          dtype=torch.float32, routing=None, witness: bool = False) -> dict:
    """Steps of AdamW from ``params0`` over ``batches``: each step's
    loss, the first step's gradient norms and the norms of the
    parameters' change after the last step, leaf by leaf (the dense
    reference's ``train``, on this model); and each step's routing
    (``routing``: handed in, per step, or its own, returned); with
    ``witness``, each step's ``route_margin`` of its routing from the
    parameters it started from (``margins``).  Float64 takes the
    sequences one at a time; the moments and parameters are updated a
    leaf at a time, in place, so that a float64 run fits beside the
    program's held state on the card."""
    params = tree_map(lambda p: p.detach().to(dtype, copy=True), params0)
    mu = tree_map(torch.zeros_like, params)
    nu = tree_map(torch.zeros_like, params)
    losses, grad1, chosen, margins = [], None, [], []

    def update(p, m, v, g):
        m.copy_(_moment(m, g, opt["b1"]))
        v.copy_(_moment(v, g, opt["b2"], True))
        p.copy_(p + _change(p, m, v, t, opt))
    with matmul_precision(tf32):
        for t, batch in enumerate(batches, 1):
            value, grads, route = loss_and_grads(
                params, batch, shape, cfg, rows=rows,
                per_sequence=dtype == torch.float64,
                routing=None if routing is None else routing[t - 1])
            losses.append(value)
            chosen.append(route["routing"])
            if witness:
                margins.append(route_margin(
                    params, batch, shape, cfg, route["routing"]
                    or routing[t - 1]))
            if t == 1:
                grad1 = leaf_norms(grads)
            with torch.no_grad():
                tree_map(update, params, mu, nu, grads)
            del grads
    delta = tree_map(lambda p, q: p - q, params, params0)
    return {"losses": losses, "grad1": grad1, "delta": leaf_norms(delta),
            "routing": chosen, "margins": margins}


def _moment(old, g, beta: float, square: bool = False):
    """An AdamW moment updated by gradient ``g`` (by its square)."""
    return beta * old + ((1 - beta) * g * g if square else (1 - beta) * g)


def _change(p, m, v, t: int, opt: dict):
    """A leaf's change under AdamW step ``t`` (from 1), from its updated
    moments."""
    bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
    return -opt["lr"] * (m / (bc1 * (torch.sqrt(v / bc2) + opt["eps"]))
                         + opt["weight_decay"] * p)


def step(params: dict, batch: torch.Tensor, shape: MoEShape, cfg: dict,
         tf32: bool = False, rows=None, dtype=torch.float32,
         routing=None, moments=None, opt: dict | None = None) -> dict:
    """One step's loss and gradient norms from ``params``, in ``dtype``,
    and its routing (``routing``: handed in, or its own, returned);
    float64 takes the sequences one at a time.  With ``moments`` ((mu,
    nu, t): the AdamW moments the step starts from and its number, from
    1) and ``opt``, also ``delta``: the norms of each leaf's change under
    that step, one leaf's moments widened at a time."""
    params = tree_map(lambda p: p.detach().to(dtype, copy=True), params)
    with matmul_precision(tf32):
        value, grads, route = loss_and_grads(
            params, batch, shape, cfg, rows=rows,
            per_sequence=dtype == torch.float64, routing=routing)
    out = {"loss": value, "grad": leaf_norms(grads), **route}
    if moments is not None:
        mu, nu, t = moments

        def change(p, g, m, v):
            return _change(p, _moment(m.to(dtype), g, opt["b1"]),
                           _moment(v.to(dtype), g, opt["b2"], True), t, opt)
        with torch.no_grad():
            out["delta"] = leaf_norms(tree_map(change, params, grads, mu,
                                               nu))
    return out
