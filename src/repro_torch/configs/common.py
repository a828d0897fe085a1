"""Shared helpers for architecture configs + the assigned input shapes."""

from __future__ import annotations

import dataclasses

from repro_torch.models.lm.config import LMConfig

__all__ = ["INPUT_SHAPES", "InputShape"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned input shapes.
INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: LMConfig, **overrides) -> LMConfig:
    """Build the smoke-test variant: same family, toy dims."""
    return dataclasses.replace(cfg, **overrides)
