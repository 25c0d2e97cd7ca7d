"""GEMM shapes and model FLOPs of a decoder with routed experts and
sliding/full attention (the Mellum2 configuration), from its config and
from the tokens the program routed.

The shapes are the products the offload sees.  Per layer: the q, k, v,
o projections, the router ``(t, d, router_experts)``, and the two
attention products per (batch, head) over the whole sequence (the
program computes every score and masks the window, so a sliding layer
multiplies as much as a full one); the LM head once.  Per layer and
held expert with ``m`` routed tokens: the SwiGLU's gate and up ``(m, d,
f)`` and down ``(m, f, d)``; ``m`` changes every step, so these come
from the program's counter (``ExpertCounter.routed``), one tuple a
layer and step.  A training step adds, for every forward product, its
two cotangent products, as ``lm.train_gemms`` counts them.

Model FLOPs count the work the model needs: 2 per multiply-add, the
attention of each query over the positions it sees (all before it on a
full layer, the last ``sliding_window`` on a sliding one), the held
experts at the tokens routed to them, a backward pass at twice the
forward's.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Iterable, Sequence, Tuple

from .lm import emulated

Shape = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class MoEShape:
    vocab: int
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    router_experts: int
    held: Tuple[int, ...]
    top_k: int
    expert_ff: int
    window: int
    kinds: Tuple[str, ...]        # "full" or "sliding", one a layer
    tied: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "MoEShape":
        """From a configuration file's published keys (``num_experts``
        counts the experts held here, ``router_experts`` the router's
        outputs)."""
        layers = cfg["num_hidden_layers"]
        held = tuple(cfg["held_experts"][:cfg["num_experts"]])
        return cls(vocab=cfg["vocab_size"], layers=layers,
                   d=cfg["hidden_size"], heads=cfg["num_attention_heads"],
                   kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg["head_dim"],
                   router_experts=cfg["router_experts"], held=held,
                   top_k=cfg["num_experts_per_tok"],
                   expert_ff=cfg["moe_intermediate_size"],
                   window=cfg["sliding_window"],
                   kinds=tuple(k.split("_")[0] for k in
                               cfg["layer_types"][:layers]),
                   tied=bool(cfg["tie_word_embeddings"]))

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def dense_matmul_params(self) -> int:
        """Weights every token multiplies: attention and the router, all
        layers."""
        d = self.d
        return self.layers * (2 * d * self.q_dim + 2 * d * self.kv_dim
                              + d * self.router_experts)

    def num_params(self) -> int:
        d, v, L = self.d, self.vocab, self.layers
        experts = L * len(self.held) * 3 * d * self.expert_ff
        return (v * d + self.dense_matmul_params() + experts + 2 * L * d + d
                + (0 if self.tied else d * v))


def dense_gemms(shape: MoEShape, batch: int, seq: int) -> Counter:
    """Forward products of a full-sequence pass, the experts' aside:
    (m, k, n) -> count."""
    t = batch * seq
    d, L = shape.d, shape.layers
    out: Counter = Counter()
    for dims in ((t, d, shape.q_dim), (t, d, shape.kv_dim),
                 (t, d, shape.kv_dim), (t, shape.q_dim, d),
                 (t, d, shape.router_experts)):
        out[dims] += L
    per_head = batch * shape.heads * L
    out[(seq, shape.head_dim, seq)] += per_head     # scores
    out[(seq, seq, shape.head_dim)] += per_head     # probabilities @ V
    out[(t, d, shape.vocab)] += 1                   # LM head
    return out


def expert_gemms(shape: MoEShape, routed: Iterable[Sequence[int]]) -> Counter:
    """Forward products of the held experts, from the tokens routed to
    each (one sequence per expert-layer call)."""
    d, f = shape.d, shape.expert_ff
    out: Counter = Counter()
    for call in routed:
        for m in call:
            out[(m, d, f)] += 2
            out[(m, f, d)] += 1
    return out


def train_gemms(shape: MoEShape, batch: int, seq: int, routed) -> Counter:
    """Forward and cotangent products of training steps whose expert
    layers routed ``routed`` (the steps' records, in order): the dense
    products once per step (one record a layer and step)."""
    routed = list(routed)
    steps = len(routed) // shape.layers
    fwd = Counter({k: v * steps for k, v in
                   dense_gemms(shape, batch, seq).items()})
    fwd.update(expert_gemms(shape, routed))
    out: Counter = Counter()
    for (m, k, n), count in fwd.items():
        for dims in ((m, k, n), (m, n, k), (k, m, n)):
            out[dims] += count
    return out


def attended(shape: MoEShape, seq: int) -> int:
    """Sum over the layers and a sequence's queries of the positions each
    sees."""
    full = seq * (seq + 1) // 2
    w = min(shape.window, seq)
    sliding = w * (w + 1) // 2 + (seq - w) * w
    return sum(full if kind == "full" else sliding for kind in shape.kinds)


def train_flops(shape: MoEShape, batch: int, seq: int, routed) -> float:
    """Model FLOPs of training steps whose expert layers routed
    ``routed``: 3x the forward."""
    routed = list(routed)
    steps = len(routed) // shape.layers
    t = batch * seq
    attn = 4 * shape.q_dim * batch * attended(shape, seq)
    dense = 2 * t * (shape.dense_matmul_params() + shape.d * shape.vocab)
    experts = 2 * 3 * shape.d * shape.expert_ff * sum(map(sum, routed))
    return 3 * (steps * (dense + attn) + experts)

