"""RWKV-6 "Finch" 3B [arXiv:2404.05892].

32 layers, d_model=2560 (40 heads x 64), attention-free with
data-dependent decay; channel-mix d_ff=8960; vocab=65536.
Natively O(1)-state: runs long_500k without any carve-in.
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    arch_id="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    block_pattern=("rwkv",),
    rope_kind="none",
    rwkv_head_dim=64,
    long_context_window=None,  # attention-free: no window needed
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    d_model=128,
    n_heads=2,
    n_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab=512,
)
