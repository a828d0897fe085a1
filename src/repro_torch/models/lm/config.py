"""Unified transformer-zoo configuration for the assigned architectures.

One ``LMConfig`` drives every architecture: the layer stack is a repeated
``block_pattern`` (period P, repeated R = n_layers / P times) whose entries
name a mixer kind — ``attn`` (full causal), ``local`` (sliding window),
``mamba``, ``rwkv`` — so parameters and caches stack per pattern position
with a leading repeat dim, which ``models/lm/model.py`` walks in a Python
loop.  MoE/MLA/rope/softcap options are orthogonal knobs.  A copy of the
JAX package's ``models/lm/config.py`` (pure Python).
"""

from __future__ import annotations

import dataclasses

__all__ = ["MoEConfig", "MLAConfig", "LMConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0  # total intermediate width of the shared path
    every: int = 1  # MoE on every ``every``-th layer within the pattern period
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec-audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_pattern: tuple[str, ...] = ("attn",)
    moe: MoEConfig | None = None
    attn_kind: str = "gqa"  # gqa | mla
    mla: MLAConfig | None = None
    window: int | None = None  # sliding window for "local" layers
    attn_softcap: float | None = None
    final_softcap: float | None = None
    activation: str = "silu"  # silu | geglu | gelu
    rope_kind: str = "default"  # default | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w rotary halves
    # Encoder-decoder (SeamlessM4T): encoder layer count; 0 = decoder-only.
    encoder_layers: int = 0
    # Input modality: "tokens" (ids) or "embeds" (stub frontend supplies
    # frame/patch embeddings directly — the audio/VLM carve-out).
    input_mode: str = "tokens"
    tie_embeddings: bool = True
    # SSM dims
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    rwkv_head_dim: int = 64
    # long_500k dense carve-in: ring-buffer window used when decoding past
    # this many positions (None = arch is natively sub-quadratic or full).
    long_context_window: int | None = 8192
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.arch_id}: n_layers={self.n_layers} not divisible by "
                f"pattern period {len(self.block_pattern)}"
            )
        if self.attn_kind == "mla" and self.mla is None:
            raise ValueError("attn_kind='mla' requires an MLAConfig")

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to 256 so the vocab dim shards evenly."""
        return -(-self.vocab // 256) * 256

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // self.pattern_period

    def layer_kinds(self) -> tuple[str, ...]:
        return tuple(self.block_pattern[i % self.pattern_period] for i in range(self.n_layers))

    def is_moe_position(self, pos: int) -> bool:
        """Is pattern position ``pos`` an MoE FFN (vs dense FFN)?"""
        if self.moe is None:
            return False
        return (pos % self.moe.every) == (self.moe.every - 1) if self.moe.every > 1 else True

    def uses_attention(self) -> bool:
        return any(k in ("attn", "local") for k in self.block_pattern)
