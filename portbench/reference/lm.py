"""Plain reference of the Llama-style decoder: forward, loss, AdamW.

Written from the architecture's equations in plain torch, on the
parameter layout of ``portbench.inputs.lm_params``: RMSNorm, rotary
embeddings on the half-split pairs, grouped-query attention (query head
h reads kv head h // (heads / kv_heads)), a causal softmax, SwiGLU, a
final norm and the head (the embedding's transpose when tied).  It
runs in float32 with TF32 off; ``tf32=True`` is the lower-precision
control, and ``dtype=torch.float64`` a higher-precision witness.
Imports torch only.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..inputs import leaf_items
from ..work.lm import LMShape


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def hidden(params: dict, tokens: torch.Tensor, lm: LMShape,
           cfg: dict) -> torch.Tensor:
    """Final-normed hidden states (B, T, d) of ``tokens`` (B, T)."""
    B, T = tokens.shape
    eps, hd = cfg["rms_norm_eps"], lm.head_dim
    dev = tokens.device
    # Angles in float32, as the published implementation computes them.
    inv_freq = 1.0 / cfg["rope_theta"] ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=dev)[:, None] * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    causal = torch.ones(T, T, dtype=torch.bool, device=dev).tril()
    rep = lm.heads // lm.kv_heads
    blk = params["blocks"]
    x = params["embed"][tokens]
    for i in range(lm.layers):
        h = _rms_norm(x, blk["attn_norm"][i], eps)
        q = _rope((h @ blk["wq"][i]).view(B, T, lm.heads, hd), cos, sin)
        k = _rope((h @ blk["wk"][i]).view(B, T, lm.kv_heads, hd), cos, sin)
        v = (h @ blk["wv"][i]).view(B, T, lm.kv_heads, hd)
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        s = torch.einsum("bthd,bshd->bhts", q, k) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, -1)
        x = x + o @ blk["wo"][i]
        h = _rms_norm(x, blk["mlp_norm"][i], eps)
        x = x + (F.silu(h @ blk["w_gate"][i]) * (h @ blk["w_up"][i])) \
            @ blk["w_down"][i]
    return _rms_norm(x, params["final_norm"], eps)


def logits(params, tokens, lm: LMShape, cfg: dict) -> torch.Tensor:
    head = params["embed"].T if lm.tied else params["lm_head"]
    return hidden(params, tokens, lm, cfg) @ head


def loss(params, batch: torch.Tensor, lm: LMShape, cfg: dict,
         rows=None) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (B, T + 1); ``rows``
    limits the mean to the first ``rows`` token positions."""
    out = logits(params, batch[:, :-1], lm, cfg)
    targets = batch[:, 1:]
    if rows is not None:
        out, targets = out[:, :rows], targets[:, :rows]
    return F.cross_entropy(out.reshape(-1, out.shape[-1]),
                           targets.reshape(-1).long())


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    return [tree]


def leaf_norms(tree) -> Dict[str, float]:
    """Norm of each leaf, in float32 or the leaf's wider type."""
    return {name: float(torch.linalg.vector_norm(
                t.to(torch.promote_types(t.dtype, torch.float32))))
            for name, t in leaf_items(tree)}


def train(params0: dict, batches: Sequence[torch.Tensor], lm: LMShape,
          cfg: dict, opt: dict, tf32: bool = False, rows=None,
          dtype=torch.float32) -> dict:
    """Steps of AdamW from ``params0`` over ``batches``: each step's
    loss, the first step's gradient norms and the norms of the
    parameters' change after the last step, leaf by leaf.  ``rows``
    (a planted fault) takes each loss over the first ``rows``
    positions only; ``dtype``: the type the steps run in."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    params = tree_map(lambda p: p.detach().to(dtype, copy=True), params0)
    mu = tree_map(torch.zeros_like, params)
    nu = tree_map(torch.zeros_like, params)
    losses, grad1 = [], None
    with matmul_precision(tf32):
        for t, batch in enumerate(batches, 1):
            leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                value = loss(leaves, batch, lm, cfg, rows=rows)
                grads = torch.autograd.grad(value, _leaves(leaves))
            losses.append(float(value.detach()))
            it = iter(grads)
            grads = tree_map(lambda _: next(it), params)
            if t == 1:
                grad1 = leaf_norms(grads)
            with torch.no_grad():
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, mu, grads)
                nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                               nu, grads)
                params = tree_map(
                    lambda p, m, v: p - lr * (
                        m / (bc1 * (torch.sqrt(v / bc2) + eps)) + wd * p),
                    params, mu, nu)
            del leaves, grads
    delta = tree_map(lambda p, q: p - q, params, params0)
    return {"losses": losses, "grad1": grad1, "delta": leaf_norms(delta)}
