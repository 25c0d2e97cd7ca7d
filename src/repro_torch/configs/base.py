"""Model/run configuration: one frozen record, named presets, overrides.

The LM subsystem (``repro_torch.models`` / ``repro_torch.serve``)
is configured by a single immutable :class:`LMConfig`.  Presets are
registered by name (``get_config("smollm_360m")``) and specialized with
``cfg.replace(num_layers=2, d_model=128)`` — the pattern the example
drivers use to scale the same architecture from CI-smoke size up to the
full model without touching model code.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["LMConfig", "get_config", "register_config", "available_configs"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Architecture + numerics of a llama-style decoder-only LM.

    Attributes:
      name: preset name this config was derived from.
      vocab_size: token vocabulary size.
      num_layers: number of decoder blocks (stacked, run under ``scan``).
      d_model: residual stream width.
      num_heads: query heads.
      num_kv_heads: key/value heads (GQA when ``< num_heads``).
      head_dim: per-head width (RoPE operates on this axis).
      d_ff: SwiGLU hidden width.
      max_seq_len: nominal context length (serving default; RoPE itself
        is position-parametric and does not bake this in).
      rope_theta: RoPE frequency base.
      norm_eps: RMSNorm epsilon.
      dtype: activation dtype name (``"float32"`` / ``"bfloat16"``).
      param_dtype: parameter dtype name.
      remat: rematerialize each block under ``jax.checkpoint`` (the
        offload transform inlines remat bodies, so emulated sites
        survive the recompute schedule).
      tie_embeddings: reuse the embedding matrix as the LM head.
      eos_id: end-of-sequence token id for serving, or ``None`` to
        decode until ``max_new_tokens``.
    """

    name: str = "smollm_360m"
    vocab_size: int = 49152
    num_layers: int = 32
    d_model: int = 960
    num_heads: int = 15
    num_kv_heads: int = 5
    head_dim: int = 64
    d_ff: int = 2560
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: bool = False
    tie_embeddings: bool = False
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} must be a multiple of "
                f"num_kv_heads={self.num_kv_heads}")
        if self.head_dim % 2:
            raise ValueError(f"head_dim={self.head_dim} must be even "
                             "(RoPE rotates half-dim pairs)")

    def replace(self, **overrides) -> "LMConfig":
        """A copy with ``overrides`` applied (validation re-runs)."""
        return dataclasses.replace(self, **overrides)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def num_params(self) -> int:
        """Exact parameter count of the LM
        (:class:`repro_torch.models.lm.Model`'s parameters)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_block = (2 * d                       # the two norms
                     + d * self.q_dim + 2 * d * self.kv_dim
                     + self.q_dim * d            # attention
                     + 2 * d * f + f * d)        # SwiGLU
        head = 0 if self.tie_embeddings else d * v
        return v * d + self.num_layers * per_block + d + head


_CONFIGS: Dict[str, LMConfig] = {}


def register_config(cfg: LMConfig) -> LMConfig:
    """Register ``cfg`` under ``cfg.name``; returns it for chaining."""
    _CONFIGS[cfg.name] = cfg
    return cfg


def available_configs():
    """Sorted registered preset names."""
    return sorted(_CONFIGS)


def get_config(name: str) -> LMConfig:
    """Look up a preset by name.

    The returned config is frozen; specialize with ``.replace(...)``.
    """
    try:
        return _CONFIGS[name]
    except KeyError:
        raise ValueError(f"unknown config {name!r}; available: "
                         f"{', '.join(available_configs())}") from None


# SmolLM-360M geometry (the paper-scale serving target of the ROADMAP
# dry runs); the examples shrink it with .replace for CPU runs.
register_config(LMConfig(name="smollm_360m"))

# A CI/test-scale preset: two blocks at d128 — large enough that the
# projection GEMMs clear the default offload size gate (m=k=n >= 128
# once batch*seq >= 128) while a full train step stays sub-second on
# CPU, small enough that attention (k = head_dim = 32) stays native.
register_config(LMConfig(
    name="tiny", vocab_size=512, num_layers=2, d_model=128,
    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
    max_seq_len=256))

# CPU-sized reductions of the same architecture, used by the example
# drivers (examples/train_lm.py presets "reduced" and "100m").
register_config(LMConfig(
    name="reduced", vocab_size=4096, num_layers=6, d_model=256,
    num_heads=8, num_kv_heads=4, head_dim=32, d_ff=1024,
    max_seq_len=1024))
register_config(LMConfig(
    name="reduced_100m", vocab_size=16384, num_layers=12, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=64, d_ff=2816,
    max_seq_len=2048))
