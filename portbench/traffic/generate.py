"""The general generator: it reads a traffic file's parameters and the
run's ``--seed`` and yields the work of each unit of the window.

Every seed gets the same sizes; the seed changes the data, so runs with
different seeds do the same amount of work.

* ``synthetic_text``: training batches, a copy of the program's
  ``train.data.SyntheticText`` (a skewed random walk over the
  vocabulary with a quarter of the positions set to token 0), a pure
  function of (seed, step).
"""

from __future__ import annotations

import numpy as np

_DELTAS = np.array([1, 2, 3, 5, 8], dtype=np.int64)
_PROBS = np.array([0.40, 0.30, 0.15, 0.10, 0.05])
_ANCHOR_P = 0.25


def synthetic_text(vocab: int, seq_len: int, batch: int, seed: int,
                   step: int) -> np.ndarray:
    """(batch, seq_len + 1) int32 tokens of ``step``: inputs are columns
    0..seq_len-1, targets 1..seq_len."""
    rng = np.random.default_rng([int(seed), int(step)])
    start = rng.integers(0, vocab, size=(batch, 1))
    deltas = rng.choice(_DELTAS, size=(batch, seq_len), p=_PROBS)
    walk = np.concatenate([start, deltas], axis=1).cumsum(axis=1) % vocab
    anchored = np.where(rng.random(walk.shape) < _ANCHOR_P, 0, walk)
    return anchored.astype(np.int32)

