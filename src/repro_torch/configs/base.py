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
from typing import Dict, Optional, Tuple

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
      layer_pattern: attention kind of each layer, ``"full"`` or
        ``"sliding"``, repeating with period ``len(layer_pattern)``
        (layer ``i`` takes ``layer_pattern[i % period]``); empty: every
        layer full.  A full layer attends causally, a sliding one over
        the last ``sliding_window`` positions.
      sliding_window: positions a sliding layer's query sees, itself
        included (query ``i`` sees key ``j`` when ``i - window < j <=
        i``).
      yarn_factor: YaRN's context extension factor for the full layers'
        RoPE (arXiv:2309.00071); 0 keeps plain RoPE.  With it,
        ``yarn_original_max_positions``, ``yarn_beta_fast``,
        ``yarn_beta_slow`` and ``yarn_attention_factor`` (0: ``0.1 ln
        factor + 1``) as Hugging Face's ``_compute_yarn_parameters``
        reads them.  Sliding layers keep plain RoPE.
      num_experts: routed experts of every layer's MLP, as the router
        scores them (the published count); 0: a dense SwiGLU MLP.
      experts_held: the experts whose weights this model holds and
        computes (one expert-parallel rank's share, increasing ids);
        empty: all of them.  The others add nothing to the layer.
      num_experts_per_tok: experts each token is routed to (top-k).
      moe_d_ff: each expert's SwiGLU hidden width.
      norm_topk_prob: renormalise the top-k routing weights to sum to 1.
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
    layer_pattern: Tuple[str, ...] = ()
    sliding_window: int = 0
    yarn_factor: float = 0.0
    yarn_original_max_positions: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 0.0
    num_experts: int = 0
    experts_held: Tuple[int, ...] = ()
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    norm_topk_prob: bool = True

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads={self.num_heads} must be a multiple of "
                f"num_kv_heads={self.num_kv_heads}")
        if self.head_dim % 2:
            raise ValueError(f"head_dim={self.head_dim} must be even "
                             "(RoPE rotates half-dim pairs)")
        # Lists (a JSON override) become tuples, so the record stays
        # immutable.
        for key in ("layer_pattern", "experts_held"):
            object.__setattr__(self, key, tuple(getattr(self, key)))
        if set(self.layer_pattern) - {"full", "sliding"}:
            raise ValueError(f"layer_pattern={self.layer_pattern}: each "
                             "entry must be 'full' or 'sliding'")
        if "sliding" in self.layer_pattern and self.sliding_window < 1:
            raise ValueError("sliding layers need sliding_window >= 1")
        if self.yarn_factor and self.yarn_original_max_positions < 1:
            raise ValueError("yarn_factor needs "
                             "yarn_original_max_positions >= 1")
        if self.num_experts:
            held = self.experts_held
            if not 1 <= self.num_experts_per_tok <= self.num_experts:
                raise ValueError(
                    f"num_experts_per_tok={self.num_experts_per_tok} must "
                    f"lie in 1..num_experts={self.num_experts}")
            if self.moe_d_ff < 1:
                raise ValueError("an expert MLP needs moe_d_ff >= 1")
            if list(held) != sorted(set(held)) or (
                    held and not 0 <= held[0] <= held[-1] < self.num_experts):
                raise ValueError(
                    f"experts_held={held} must be increasing expert ids "
                    f"below num_experts={self.num_experts}")

    def replace(self, **overrides) -> "LMConfig":
        """A copy with ``overrides`` applied (validation re-runs)."""
        return dataclasses.replace(self, **overrides)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def held_experts(self) -> Tuple[int, ...]:
        """The ids of the experts this model computes (all when
        ``experts_held`` is empty)."""
        return self.experts_held or tuple(range(self.num_experts))

    def layer_kind(self, layer: int) -> str:
        """``"full"`` or ``"sliding"``: layer ``layer``'s attention."""
        pattern = self.layer_pattern
        return pattern[layer % len(pattern)] if pattern else "full"

    def num_params(self) -> int:
        """Exact parameter count of the LM (the parameters of
        :class:`repro_torch.models.lm.Model`, or of
        :class:`repro_torch.models.moe.MoEModel` with experts: the
        router's and the held experts')."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        if self.num_experts:
            mlp = (d * self.num_experts
                   + len(self.held_experts) * 3 * d * self.moe_d_ff)
        else:
            mlp = 2 * d * f + f * d              # SwiGLU
        per_block = (2 * d                       # the two norms
                     + d * self.q_dim + 2 * d * self.kv_dim
                     + self.q_dim * d            # attention
                     + mlp)
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

# Mellum2-12B-A2.5B (huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct,
# config.json) at its published widths, as one stage of one
# expert-parallel rank of eight: layers 0-11 (three whole periods of
# three sliding-window layers and one full layer with YaRN RoPE) and
# experts 0-7 of each layer's 64, with the embedding and the head whole.
register_config(LMConfig(
    name="mellum2_12b_a2_5b_ep8", vocab_size=98304, num_layers=12,
    d_model=2304, num_heads=32, num_kv_heads=4, head_dim=128, d_ff=7168,
    max_seq_len=131072, rope_theta=500000.0, norm_eps=1e-6,
    layer_pattern=("sliding", "sliding", "sliding", "full"),
    sliding_window=1024, yarn_factor=16.0,
    yarn_original_max_positions=8192, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_attention_factor=1.2772588722239782,
    num_experts=64, experts_held=tuple(range(8)), num_experts_per_tok=8,
    moe_d_ff=896, norm_topk_prob=True))

# Its CPU-sized reduction (one whole period, 4 of 16 experts held, a
# window shorter than the test sequences), for tests and CPU runs.
register_config(LMConfig(
    name="mellum2_tiny", vocab_size=512, num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, max_seq_len=256,
    rope_theta=500000.0, norm_eps=1e-6,
    layer_pattern=("sliding", "sliding", "sliding", "full"),
    sliding_window=8, yarn_factor=16.0, yarn_original_max_positions=32,
    yarn_beta_fast=32.0, yarn_beta_slow=1.0,
    yarn_attention_factor=1.2772588722239782, num_experts=16,
    experts_held=(0, 1, 2, 3), num_experts_per_tok=4, moe_d_ff=32,
    norm_topk_prob=True))
