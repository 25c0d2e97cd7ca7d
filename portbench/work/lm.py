"""GEMM shapes and model FLOPs of a Llama-style decoder, from its config.

The shapes are the products the offload sees: per layer the q, k, v, o
projections and the SwiGLU gate, up and down, the two attention
products per (batch, head), and the LM head (the embedding's transpose
when tied).  A training step adds, for every forward product
``(m, k, n)``, its two cotangent products ``dX (m, n, k)`` and
``dW (k, m, n)``.  The offload's size gate sends a product to the
emulation when ``min(m, k, n) >= min_dim``.

Model FLOPs count the work the model needs, whatever runs it: 2 per
multiply-add, causal attention over the positions each query sees, a
backward pass at twice the forward's.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Tuple

Shape = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class LMShape:
    vocab: int
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    tied: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "LMShape":
        """From a configuration file's published keys."""
        d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(vocab=cfg["vocab_size"], layers=cfg["num_hidden_layers"],
                   d=d, heads=heads, kv_heads=cfg["num_key_value_heads"],
                   head_dim=cfg.get("head_dim", d // heads),
                   d_ff=cfg["intermediate_size"],
                   tied=bool(cfg["tie_word_embeddings"]))

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def layer_matmul_params(self) -> int:
        d, f = self.d, self.d_ff
        return self.layers * (2 * d * self.q_dim + 2 * d * self.kv_dim
                              + 3 * d * f)

    def num_params(self) -> int:
        d, v, L = self.d, self.vocab, self.layers
        return (v * d + self.layer_matmul_params() + 2 * L * d + d
                + (0 if self.tied else d * v))


def forward_gemms(lm: LMShape, batch: int, seq: int) -> Counter:
    """Forward products of a full-sequence pass: (m, k, n) -> count."""
    t = batch * seq
    d, f, L = lm.d, lm.d_ff, lm.layers
    out: Counter = Counter()
    for shape in ((t, d, lm.q_dim), (t, d, lm.kv_dim), (t, d, lm.kv_dim),
                  (t, lm.q_dim, d), (t, d, f), (t, d, f), (t, f, d)):
        out[shape] += L
    per_head = batch * lm.heads * L
    out[(seq, lm.head_dim, seq)] += per_head       # scores
    out[(seq, seq, lm.head_dim)] += per_head       # probabilities @ V
    out[(t, d, lm.vocab)] += 1                     # LM head
    return out


def train_gemms(lm: LMShape, batch: int, seq: int) -> Counter:
    """Forward and cotangent products of one training step."""
    out: Counter = Counter()
    for (m, k, n), count in forward_gemms(lm, batch, seq).items():
        for shape in ((m, k, n), (m, n, k), (k, m, n)):
            out[shape] += count
    return out


def emulated(gemms: Counter, min_dim: int) -> Counter:
    """The products the offload's size gate sends to the emulation."""
    return Counter({s: c for s, c in gemms.items() if min(s) >= min_dim})


def expand(gemms: Counter) -> List[Shape]:
    return [s for s, c in sorted(gemms.items()) for _ in range(c)]


def train_flops(lm: LMShape, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 3x the forward."""
    attn = 4 * lm.q_dim * lm.layers * batch * seq * (seq + 1) / 2
    fwd = 2 * batch * seq * (lm.layer_matmul_params() + lm.d * lm.vocab)
    return 3 * (fwd + attn)

