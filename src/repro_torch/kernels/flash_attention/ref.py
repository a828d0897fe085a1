"""Plain-torch dense attention with causal / sliding-window / softcap.

The CPU route of :func:`~repro_torch.kernels.flash_attention.kernel.flash_attention`
and the oracle the CUDA kernel is held to.  It takes any leading batch
dimensions (``[..., Sq, D]`` against ``[..., Sk, D]``) and mirrors the
reference's ``attention_ref``: the scale ``1/sqrt(D)`` in q's dtype,
scores in q's dtype, masks aligned at position 0 for both sequences, and
a fully masked row gives 0, not NaN.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "expand_kv"]


def expand_kv(x: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """``[B, Hkv, S, D]`` kv heads repeated to ``num_q_heads`` (GQA/MQA):
    query head ``h`` meets kv head ``h // (num_q_heads / Hkv)``."""
    group = num_q_heads // x.shape[1]
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def attention_ref(
    q: torch.Tensor,  # [..., Sq, D]
    k: torch.Tensor,  # [..., Sk, D]
    v: torch.Tensor,  # [..., Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype, device=q.device)
    s = (q @ k.transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(q.shape[-2], device=q.device)[:, None]
    ki = torch.arange(k.shape[-2], device=q.device)[None, :]
    mask = torch.ones((q.shape[-2], k.shape[-2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    # Fully masked rows give NaN in softmax; zero them as flash attention does.
    p = torch.nan_to_num(p, nan=0.0)
    return p @ v
