"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``."""

from __future__ import annotations

import importlib

from repro_torch.configs.common import INPUT_SHAPES, InputShape
from repro_torch.models.lm.config import LMConfig

_MODULES = {
    "seamless-m4t-medium": "seamless_m4t_medium",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "rwkv6-3b": "rwkv6_3b",
    "granite-3-8b": "granite_3_8b",
    "gemma2-27b": "gemma2_27b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "gemma-2b": "gemma_2b",
    "yi-6b": "yi_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> LMConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> LMConfig:
    return _module(arch_id).SMOKE


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "get_config", "get_smoke"]
