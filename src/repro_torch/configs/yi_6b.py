"""Yi-6B [arXiv:2403.04652].

Llama-architecture GQA: 32 layers, d_model=4096, 32 heads (kv=4),
d_ff=11008, vocab=64000, rope theta 5e6.
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    arch_id="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
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
)
