"""Inputs the benchmark makes from ``--seed`` and hands to both sides.

The program under test and the plain reference read the same tensors;
neither makes its own.  Everything is drawn on the run's device with a
``torch.Generator`` seeded from ``--seed``, in a few large calls, so the
same seed gives the same inputs and set-up stays short.
"""

from __future__ import annotations

import math

import torch

from .work.lm import LMShape


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def lm_params(lm: LMShape, seed: int, device,
              dtype=torch.float32) -> dict:
    """Seeded weights in the layout the port's programs take: ``embed``,
    stacked ``blocks`` leaves with a leading layer axis, ``final_norm``
    (and ``lm_head`` when the head is untied).  Projections are normal
    with std d^-1/2 (the residual outputs damped by (2L)^-1/2), the
    embedding std 0.02, the norms ones; one draw for all of them."""
    L, d, f = lm.layers, lm.d, lm.d_ff
    s_in = d ** -0.5
    s_out = s_in / math.sqrt(2 * L)
    drawn = [("embed", (lm.vocab, d), 0.02),
             ("wq", (L, d, lm.q_dim), s_in), ("wk", (L, d, lm.kv_dim), s_in),
             ("wv", (L, d, lm.kv_dim), s_in), ("wo", (L, lm.q_dim, d), s_out),
             ("w_gate", (L, d, f), s_in), ("w_up", (L, d, f), s_in),
             ("w_down", (L, f, d), s_out)]
    if not lm.tied:
        drawn.append(("lm_head", (d, lm.vocab), s_in))
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    flat = torch.randn(sum(sizes), dtype=torch.float32, device=device,
                       generator=generator(seed, device))
    leaves = {}
    for (name, shape, scale), part in zip(drawn, torch.split(flat, sizes)):
        leaves[name] = part.view(shape).mul_(scale).to(dtype)
    ones = dict(dtype=dtype, device=device)
    blocks = {key: leaves.pop(key) for key in
              ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
    blocks["attn_norm"] = torch.ones(L, d, **ones)
    blocks["mlp_norm"] = torch.ones(L, d, **ones)
    out = {"embed": leaves.pop("embed"), "blocks": blocks,
           "final_norm": torch.ones(d, **ones)}
    out.update(leaves)
    return out


def leaf_items(params: dict, prefix: str = ""):
    """(name, tensor) of every leaf, block leaves split per layer: the
    unit the training check compares."""
    for key in sorted(params):
        val = params[key]
        if isinstance(val, dict):
            for sub in sorted(val):
                for layer, t in enumerate(val[sub]):
                    yield f"{key}.{sub}.{layer}", t
        else:
            yield prefix + key, val
