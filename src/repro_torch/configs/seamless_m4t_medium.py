"""SeamlessM4T-medium transformer backbone [arXiv:2308.11596].

Encoder-decoder, 12+12 layers, d_model=1024, 16 heads (kv=16 -> MHA),
d_ff=4096, vocab=256206.  The audio frontend (mel + conv) is a stub:
input_specs supplies precomputed frame embeddings (DESIGN.md carve-out).
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    arch_id="seamless-m4t-medium",
    family="encdec-audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    encoder_layers=12,
    input_mode="embeds",  # encoder side consumes frame embeddings
    activation="gelu",
)

SMOKE = reduced(
    CONFIG,
    n_layers=2,
    encoder_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
)
