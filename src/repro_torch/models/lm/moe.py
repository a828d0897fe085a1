"""Dense FFN; the MoE half of the reference's ``models/lm/moe.py`` is not
ported yet.

``dense_ffn`` is the SwiGLU / GeGLU / GELU block every dense
architecture uses.  ``jax.nn.gelu`` defaults to the tanh approximation,
so GELU here is ``gelu(approximate="tanh")``.  The top-k MoE with
sort-based dispatch (``init_moe_params``, ``moe_ffn``, ``moe_capacity``)
raises ``NotImplementedError`` until ROADMAP A-item 18.2 ports it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.tp import maybe_row_parallel

__all__ = [
    "MOE_UNPORTED",
    "init_moe_params",
    "moe_ffn",
    "init_dense_ffn",
    "dense_ffn",
    "moe_capacity",
]

MOE_UNPORTED = "MoE is not ported yet (ROADMAP A-item 18.2: MoE, Mamba and RWKV-6)"


def _init(generator: torch.Generator, shape, dtype, device, fan_in=None) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)`` (default ``shape[-2]``)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    w = torch.randn(shape, generator=generator, device=generator.device) / math.sqrt(fan_in)
    return w.to(device=device, dtype=dtype)


# ------------------------------------------------------------- dense FFN


def init_dense_ffn(
    generator: torch.Generator, d: int, ff: int, activation: str, dtype, *, device
) -> dict:
    p = {
        "w1": _init(generator, (d, ff), dtype, device),
        "w2": _init(generator, (ff, d), dtype, device),
    }
    if activation in ("silu", "geglu"):
        p["w3"] = _init(generator, (d, ff), dtype, device)  # gate
    return p


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(h)
    if activation in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    raise ValueError(activation)


def dense_ffn(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ params["w1"]
    if "w3" in params:
        h = _act(h, activation) * (x @ params["w3"])
    else:
        h = _act(h, activation)
    return maybe_row_parallel(h, params["w2"])


# -------------------------------------------------------------------- MoE


def moe_capacity(num_tokens: int, cfg: LMConfig) -> int:
    raise NotImplementedError(MOE_UNPORTED)


def init_moe_params(generator: torch.Generator, cfg: LMConfig, dtype, *, device) -> dict:
    raise NotImplementedError(MOE_UNPORTED)


def moe_ffn(params: dict, x: torch.Tensor, cfg: LMConfig):
    raise NotImplementedError(MOE_UNPORTED)
