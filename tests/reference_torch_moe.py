"""Plain reference of a decoder with routed experts and sliding/full
attention (Mellum2-12B-A2.5B's block), for the tier-1 tests.

Written from the published description in plain torch, with no kernel,
cache or batching; it imports nothing of ``repro_torch``, ``repro`` or
JAX.  The configuration is a dict of the published ``config.json``
keys (``hidden_size``, ``layer_types``, ``rope_parameters``, ...), with
``held_experts`` for the experts whose weights are given; parameters
are the port's tree (``embed``, stacked ``blocks`` leaves with a
leading layer axis, ``final_norm``, ``lm_head``).

The block: RMSNorm; q, k, v projections; rotary embeddings in Hugging
Face's layout (``cat(freqs, freqs)`` and ``rotate_half``), plain on
sliding layers and YaRN on full layers; grouped-query attention (query
head h reads kv head h // (heads / kv_heads)) under a causal mask, and
on sliding layers only the last ``sliding_window`` positions; the
output projection; RMSNorm; the router's softmax over all experts, the
top ``num_experts_per_tok`` renormalised when ``norm_topk_prob``; and
the held experts' SwiGLU outputs, each weighted by the token's routing
weight for it (0 where the token is not routed to it).

Departures from the published description, each deliberate:

* Experts that are not held add nothing (one expert-parallel rank's
  share of the layer, as the program computes it).
* Every held expert runs on every token and is weighted by 0 where the
  token is not routed to it: the same sum as gathering the routed
  tokens, with no index bookkeeping to share a fault with the program.
* No QK-norm, softmax routing and no auxiliary loss (the config names
  none of them).
* The router's softmax runs in the reference's dtype (the published
  code takes it in float32; the float64 witness keeps float64).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def inv_freq(rope: dict, head_dim: int) -> tuple:
    """(inverse frequencies, attention scaling) of one rope section:
    ``default``, or ``yarn`` as in Hugging Face's
    ``_compute_yarn_parameters``, in float32."""
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
    freq = ((1.0 / (factor * pos_freqs)) * (1 - extrapolation)
            + (1.0 / pos_freqs) * extrapolation)
    return freq, scaling


def rope_table(rope: dict, head_dim: int, T: int, device) -> tuple:
    """float32 (cos, sin) of shape (T, head_dim) of one rope section."""
    freq, scaling = inv_freq(rope, head_dim)
    ang = torch.arange(T, dtype=torch.float32)[:, None] * freq[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    return ((emb.cos() * scaling).to(device), (emb.sin() * scaling).to(device))


def keep_mask(kind: str, T: int, window: int, device) -> torch.Tensor:
    """(T, T) True where query i sees key j."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    keep = j <= i
    if kind == "sliding_attention":
        keep &= j > i - window
    return keep


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    """x (B, T, H, d); cos, sin (T, d)."""
    cos, sin = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
    return x * cos + rotate_half(x) * sin


def routing(h, router, cfg):
    """(weights (N, k), chosen (N, k)) of the router on rows ``h``."""
    probs = torch.softmax(h @ router, dim=-1)
    weights, chosen = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights, chosen


def experts(h, blk, i, cfg):
    """The held experts' share of layer ``i``'s expert output for rows
    ``h`` (N, d)."""
    weights, chosen = routing(h, blk["router"][i], cfg)
    out = torch.zeros_like(h)
    for j, e in enumerate(cfg["held_experts"]):
        w = (weights * (chosen == e)).sum(-1)
        y = (F.silu(h @ blk["w_gate"][i][j]) * (h @ blk["w_up"][i][j])) \
            @ blk["w_down"][i][j]
        out = out + w[:, None] * y
    return out


def layer(x, blk, i, cfg, tables, masks):
    B, T, _ = x.shape
    hd = cfg["head_dim"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    kind = cfg["layer_types"][i]
    cos, sin = tables[kind]
    eps = cfg["rms_norm_eps"]
    h = rms_norm(x, blk["attn_norm"][i], eps)
    q = apply_rope((h @ blk["wq"][i]).view(B, T, heads, hd), cos, sin)
    k = apply_rope((h @ blk["wk"][i]).view(B, T, kv, hd), cos, sin)
    v = (h @ blk["wv"][i]).view(B, T, kv, hd)
    k = k.repeat_interleave(heads // kv, dim=2)
    v = v.repeat_interleave(heads // kv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * hd ** -0.5
    p = torch.softmax(s.masked_fill(~masks[kind], float("-inf")), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, -1)
    x = x + o @ blk["wo"][i]
    h = rms_norm(x, blk["mlp_norm"][i], eps)
    return x + experts(h.reshape(B * T, -1), blk, i, cfg).view(B, T, -1)


def tables_and_masks(cfg, T, device):
    kinds = set(cfg["layer_types"][:cfg["num_hidden_layers"]])
    tables = {kind: rope_table(cfg["rope_parameters"][kind],
                               cfg["head_dim"], T, device) for kind in kinds}
    masks = {kind: keep_mask(kind, T, cfg["sliding_window"], device)
             for kind in kinds}
    return tables, masks


def logits(params, tokens, cfg):
    """Logits (B, T, vocab) of ``tokens`` (B, T)."""
    T = tokens.shape[1]
    tables, masks = tables_and_masks(cfg, T, tokens.device)
    x = params["embed"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        x = layer(x, params["blocks"], i, cfg, tables, masks)
    x = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
    head = params["embed"].T if cfg["tie_word_embeddings"] \
        else params["lm_head"]
    return x @ head


def loss(params, batch, cfg):
    """Mean next-token cross-entropy of ``batch`` (B, T + 1)."""
    out = logits(params, batch[:, :-1], cfg)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           batch[:, 1:].reshape(-1).long())


def loss_and_grads(params, batch, cfg):
    """The loss and its gradient, a tree like ``params``."""
    leaves, rebuild = _flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        value = loss(rebuild(leaves), batch, cfg)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), rebuild(list(grads))


def _flatten(tree):
    keys = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            keys.append(path)
    walk(tree, ())

    def get(node, path):
        for k in path:
            node = node[k]
        return node

    def rebuild(leaves):
        out: dict = {}
        for path, leaf in zip(keys, leaves):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out
    return [get(tree, p) for p in keys], rebuild
