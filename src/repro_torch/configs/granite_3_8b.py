"""IBM Granite-3 8B [hf:ibm-granite/granite-3.0-2b-base family].

40 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=12800, vocab=49155.
Dense full attention; long_500k uses the sliding-window carve-in.
"""

from repro_torch.configs.common import reduced
from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    arch_id="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab=49155,
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
