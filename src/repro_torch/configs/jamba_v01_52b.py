"""Jamba v0.1 (52B) [arXiv:2403.19887].

32 layers, period-8 blocks with attention:mamba = 1:7 (attention at
position 4 of each block), MoE (16 experts top-2) on every other layer,
d_model=4096, 32 heads (GQA kv=8), dense d_ff=14336, vocab=65536.
No RoPE (Mamba layers carry position).  Hybrid: long_500k runs with the
attention layers ring-buffered, Mamba state O(1).
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    rope_kind="none",
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    block_pattern=("mamba", "attn"),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256, every=2),
)
