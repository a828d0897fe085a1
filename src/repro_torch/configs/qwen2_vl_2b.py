"""Qwen2-VL 2B [arXiv:2409.12191].

28 layers, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936,
M-RoPE (temporal/height/width rotary sections).  The ViT frontend is a
stub: input_specs supplies patch+text embeddings (DESIGN.md carve-out);
decode is plain text decoding.
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    input_mode="embeds",
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
    mrope_sections=(4, 6, 6),
)
