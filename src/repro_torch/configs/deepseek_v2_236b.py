"""DeepSeek-V2 236B [arXiv:2405.04434].

60 layers, d_model=5120, 128 heads with MLA (kv_lora=512, rope 64,
nope 128, v 128), MoE: 160 routed experts top-6 + 2 shared,
d_ff_expert=1536, vocab=102400.
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,  # nope(128) + rope(64); bookkeeping only under MLA
    d_ff=1536,
    vocab=102400,
    attn_kind="mla",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_ff_expert=1536,
        n_shared=2,
        d_ff_shared=3072,
    ),
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=48,
    d_ff=128,
    vocab=512,
    mla=MLAConfig(
        kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16, nope_head_dim=32, v_head_dim=32
    ),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=1, d_ff_shared=128),
)
