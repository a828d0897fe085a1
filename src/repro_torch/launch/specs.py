"""Abstract inputs for the dry-run: meta tensors in place of every input.

Each function builds, for one (architecture x input shape) pair, the
inputs a step takes, as tensors on ``"meta"``: the shapes and dtypes are
real, nothing is allocated.  ``concrete_from_abstract`` materializes such
a tree on a named device from a seeded generator.

Shape conventions, as the reference's:

* train / prefill: tokens or frontend embeddings of ``seq_len`` with
  ``global_batch`` rows (enc-dec adds encoder frames: ``seq_len`` of them
  in training, at most ``DECODE_ENC_LEN`` otherwise);
* decode: ONE new token against caches of ``seq_len`` logical context, and
  ``cache_len`` as a 0-d int32 tensor (the reference's traced scalar);
  ``long_500k`` switches long mode on (ring-buffer windows for dense
  attention, native state for SSM and hybrid archs).
"""

from __future__ import annotations

import torch

from repro_torch.configs.common import InputShape
from repro_torch.models.lm.blocks import init_block_cache
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import abstract_params
from repro_torch.optim.adamw import init_adamw
from repro_torch.utils.tree import tree_map

__all__ = [
    "abstract_train_inputs",
    "abstract_prefill_inputs",
    "abstract_decode_inputs",
    "abstract_caches",
    "concrete_from_abstract",
    "DECODE_ENC_LEN",
]

DECODE_ENC_LEN = 4096  # encoder frames held fixed for enc-dec decode shapes
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def _batch_dict(cfg: LMConfig, b: int, s: int, *, labels: bool) -> dict:
    dtype = _DTYPES[cfg.dtype]
    batch: dict = {}
    if cfg.encoder_layers > 0:
        batch["src_embeds"] = _meta((b, s if labels else min(s, DECODE_ENC_LEN), cfg.d_model),
                                    dtype)
        batch["tokens"] = _meta((b, s), torch.int32)
    elif cfg.input_mode == "embeds":
        batch["embeds"] = _meta((b, s, cfg.d_model), dtype)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
    if cfg.rope_kind == "mrope":
        batch["positions"] = _meta((b, s, 3), torch.int32)
    if labels:
        batch["labels"] = _meta((b, s), torch.int32)
    return batch


def abstract_train_inputs(cfg: LMConfig, shape: InputShape):
    params = abstract_params(cfg)
    return params, init_adamw(params), _batch_dict(cfg, shape.global_batch, shape.seq_len,
                                                   labels=True)


def abstract_prefill_inputs(cfg: LMConfig, shape: InputShape):
    return abstract_params(cfg), _batch_dict(cfg, shape.global_batch, shape.seq_len, labels=False)


def abstract_caches(cfg: LMConfig, batch: int, cache_size: int, *, long_mode: bool) -> tuple:
    """Caches stacked over repeats, one entry per pattern position, as
    ``prefill`` returns them."""
    enc_len = DECODE_ENC_LEN if cfg.encoder_layers > 0 else None
    dtype = _DTYPES[cfg.dtype]

    def stacked(pos: int):
        one = init_block_cache(cfg, pos, batch, cache_size, dtype, long_mode=long_mode,
                               enc_len=enc_len, device="meta")
        return tree_map(lambda t: _meta((cfg.n_repeats, *t.shape), t.dtype), one)

    return tuple(stacked(pos) for pos in range(cfg.pattern_period))


def abstract_decode_inputs(cfg: LMConfig, shape: InputShape, *, long_mode: bool):
    params = abstract_params(cfg)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    caches = abstract_caches(cfg, shape.global_batch, shape.seq_len, long_mode=long_mode)
    return params, tokens, caches, _meta((), torch.int32)


def concrete_from_abstract(tree, seed: int = 0, *, device: torch.device | str = "cpu"):
    """Materialize an abstract tree on ``device`` from a generator seeded
    with ``seed`` on that device: integer leaves in {0, 1}, float leaves
    normal with std 0.02, each in its leaf's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(x: torch.Tensor) -> torch.Tensor:
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=gen, device=device) * 0.02).to(x.dtype)
        return torch.randint(0, 2, x.shape, generator=gen, device=device, dtype=x.dtype)

    return tree_map(leaf, tree)
