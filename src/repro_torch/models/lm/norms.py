"""RMSNorm (the zoo's universal norm; fp32 accumulation)."""

from __future__ import annotations

import torch

__all__ = ["rms_norm", "init_rms_norm"]


def init_rms_norm(d: int, dtype=torch.float32, *, device: torch.device | str = "cpu") -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32 and cast back to ``x``'s dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)
