"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE.

M-RoPE splits the rotary half-dim into (temporal, height, width) sections,
each rotated by its own position stream; text tokens carry identical
(t, h, w) positions, which reduces exactly to standard RoPE.  Positions:
``[..., S]`` for default, ``[..., S, 3]`` for mrope.  The rotation is
half-split (the first and second halves of the head dim pair up), not
interleaved.
"""

from __future__ import annotations

import torch

__all__ = ["apply_rope", "rope_angles"]


def rope_angles(
    positions: torch.Tensor,  # [B, S] or [B, S, 3]
    head_dim: int,
    theta: float,
    kind: str,
    mrope_sections: tuple[int, int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin) of shape [B, S, head_dim // 2] (fp32)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    if kind == "default":
        ang = positions[..., None].float() * freqs  # [B,S,half]
    elif kind == "mrope":
        if positions.dim() < 2 or positions.shape[-1] != 3:
            raise ValueError("mrope needs positions [..., S, 3]")
        secs = mrope_sections
        if sum(secs) != half:
            raise ValueError(f"mrope sections {secs} must sum to half dim {half}")
        parts = []
        start = 0
        for axis, width in enumerate(secs):
            f = freqs[start : start + width]
            parts.append(positions[..., axis][..., None].float() * f)
            start += width
        ang = torch.cat(parts, dim=-1)  # [B,S,half]
    else:
        raise ValueError(f"unknown rope kind {kind!r}")
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x: [B, S, H, D]`` with angles ``[B, S, D//2]``; computed in
    fp32 and cast back to ``x``'s dtype."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
