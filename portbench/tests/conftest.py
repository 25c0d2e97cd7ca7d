"""Shared helpers of the benchmark's CPU tests: the repository's root
and its program on the path, and each cell shrunk to a CPU size."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for path in (str(ROOT / "src"), str(ROOT)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_LM = dict(vocab_size=512, num_hidden_layers=2, hidden_size=128,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=256, max_position_embeddings=256)


def tiny_spec(name: str) -> dict:
    """Cell ``name`` at a size the CPU runs in seconds: the LM at two
    layers of width 128 on 128-token sequences; every other setting,
    the limits included, as committed."""
    from portbench import harness

    spec = harness.cell_spec(name)
    spec["config"].update(TINY_LM)
    spec["traffic"].update(seq_len=128)
    return spec


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
