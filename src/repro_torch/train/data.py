"""Deterministic synthetic LM data.

Port of :mod:`repro.train.data`, unchanged: the stream is pure numpy,
so the port's batches are the reference's bytes.

Batches are a pure function of ``(seed, step)`` — no files, no state —
which is what makes kill-and-resume training bit-exact: a run restored
from step ``s`` regenerates exactly the batches an uninterrupted run
would have seen from step ``s`` on.

The stream mixes two signals at different learning speeds:

* a random walk over the vocabulary — token ``t+1`` is ``(t + delta)
  mod vocab`` with ``delta`` from a small skewed set.  Near-uniform
  marginal, ~1.3 nats of conditional entropy: the "hard" part that
  real training runs chew on over hundreds of steps;
* an *anchor*: each position is replaced by token 0 with probability
  0.25 (the walk's hidden state still advances).  This skews the
  unigram marginal, which a zero-initialized LM head fits within the
  first couple of optimizer steps — so even a 4-step CI smoke run sees
  a strictly improving loss instead of noise around ``log(vocab)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticText"]

_DELTAS = np.array([1, 2, 3, 5, 8], dtype=np.int64)
_PROBS = np.array([0.40, 0.30, 0.15, 0.10, 0.05])
_ANCHOR_P = 0.25


class SyntheticText:
    """Deterministic ``(batch, seq_len + 1)`` token batches by step index."""

    def __init__(self, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0):
        if vocab_size <= int(_DELTAS.max()):
            raise ValueError(f"vocab_size={vocab_size} too small for "
                             "the synthetic walk")
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.seed = int(seed)

    def batch(self, step: int) -> np.ndarray:
        """Tokens for ``step`` — (batch, seq_len + 1) int32.

        Column ``0..seq_len-1`` are the inputs, ``1..seq_len`` the
        targets (the caller shifts).  Same ``(seed, step)`` -> same
        bytes, on any platform numpy supports.
        """
        rng = np.random.default_rng([self.seed, int(step)])
        B, T, V = self.batch_size, self.seq_len, self.vocab_size
        start = rng.integers(0, V, size=(B, 1))
        deltas = rng.choice(_DELTAS, size=(B, T), p=_PROBS)
        walk = np.concatenate([start, deltas], axis=1).cumsum(axis=1) % V
        anchored = np.where(rng.random(walk.shape) < _ANCHOR_P, 0, walk)
        return anchored.astype(np.int32)
