"""Seeded weights of the expert model (the Mellum2 configuration), in
the layout the port's ``MoEModel`` programs take.

As ``inputs.lm_params`` draws the dense model's: one normal draw on the
run's device from a ``torch.Generator`` seeded from ``--seed``, cut into
the leaves and scaled.  Projections, the router and the experts' gate
and up are std d^-1/2, the attention and expert outputs (``wo``,
``w_down``) damped by (2L)^-1/2, the embedding std 0.02, the untied head
std d^-1/2; norms are ones.
"""

from __future__ import annotations

import math

import torch

from .inputs import generator
from .work.moe_lm import MoEShape


def moe_params(shape: MoEShape, seed: int, device,
               dtype=torch.float32) -> dict:
    """``embed``, stacked ``blocks`` leaves with a leading layer axis
    (``router`` (L, d, router_experts), ``w_gate``/``w_up`` (L, held, d,
    f), ``w_down`` (L, held, f, d)), ``final_norm`` and ``lm_head``."""
    L, d, f, E = shape.layers, shape.d, shape.expert_ff, len(shape.held)
    s_in = d ** -0.5
    s_out = s_in / math.sqrt(2 * L)
    drawn = [("embed", (shape.vocab, d), 0.02),
             ("wq", (L, d, shape.q_dim), s_in),
             ("wk", (L, d, shape.kv_dim), s_in),
             ("wv", (L, d, shape.kv_dim), s_in),
             ("wo", (L, shape.q_dim, d), s_out),
             ("router", (L, d, shape.router_experts), s_in),
             ("w_gate", (L, E, d, f), s_in), ("w_up", (L, E, d, f), s_in),
             ("w_down", (L, E, f, d), s_out)]
    if not shape.tied:
        drawn.append(("lm_head", (d, shape.vocab), s_in))
    sizes = [math.prod(dims) for _, dims, _ in drawn]
    flat = torch.randn(sum(sizes), dtype=torch.float32, device=device,
                       generator=generator(seed, device))
    leaves = {}
    for (name, dims, scale), part in zip(drawn, torch.split(flat, sizes)):
        leaves[name] = part.view(dims).mul_(scale).to(dtype)
    ones = dict(dtype=dtype, device=device)
    blocks = {key: leaves.pop(key) for key in
              ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down")}
    blocks["attn_norm"] = torch.ones(L, d, **ones)
    blocks["mlp_norm"] = torch.ones(L, d, **ones)
    out = {"embed": leaves.pop("embed"), "blocks": blocks,
           "final_norm": torch.ones(d, **ones)}
    out.update(leaves)
    return out
