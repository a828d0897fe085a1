"""Gemma-2 27B [arXiv:2408.00118].

46 layers alternating local(4096-window)/global attention, d_model=4608,
32 heads (GQA kv=16), d_ff=36864, vocab=256000, GeGLU, logit softcaps
(attn 50, final 30).
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    arch_id="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    block_pattern=("local", "attn"),  # alternating local/global
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    activation="geglu",
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
    window=16,
)
