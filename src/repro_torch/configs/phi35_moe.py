"""Phi-3.5-MoE-instruct (42B total / 6.6B active)
[hf:microsoft/Phi-3.5-MoE-instruct].

32 layers, d_model=4096, 32 heads (GQA kv=8), 16 experts top-2 with
d_ff_expert=6400, vocab=32064.
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
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
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256),
)
