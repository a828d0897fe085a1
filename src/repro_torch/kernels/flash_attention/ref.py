"""Plain-torch dense attention with causal / sliding-window / softcap.

The CPU route of :func:`~repro_torch.kernels.flash_attention.kernel.flash_attention`
and the oracle the CUDA kernels are held to.  :func:`attention_ref` takes
any leading batch dimensions (``[..., Sq, D]`` against ``[..., Sk, D]``)
and mirrors the reference's ``attention_ref``: the scale ``1/sqrt(D)`` in
q's dtype, scores in q's dtype, masks aligned at position 0 for both
sequences, and a fully masked row gives 0, not NaN.
:func:`attention_split_ref` states the split-key decode kernel's
arithmetic (per-chunk partials, then their combination); the tests and
``chip_smoke.py`` use it, the wrapper does not.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "attention_split_ref", "expand_kv"]

NEG_INF = -1e30  # the reference's masked score


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


def attention_split_ref(
    q: torch.Tensor,  # [..., Sq, D]
    k: torch.Tensor,  # [..., Sk, D]
    v: torch.Tensor,  # [..., Sk, D]
    *,
    chunk: int,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Attention as the split-key kernel computes it.  Scores in fp32 (the
    scale in q's dtype); the keys cut into chunks of ``chunk``; per chunk c
    and row, ``m_c`` the max kept score (``NEG_INF`` if none), ``p = exp(s -
    m_c)`` on kept keys, ``l_c = sum p`` and ``acc_c = p' @ v`` with ``p'``
    rounded to v's dtype; then ``m = max_c m_c``, ``w_c = exp(m_c - m)``
    (0 for a chunk that keeps no key) and ``out = sum_c w_c acc_c / sum_c
    w_c l_c``, 0 for a row with no kept key, in q's dtype."""
    sq, sk = q.shape[-2], k.shape[-2]
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= qi >= ki
    if window is not None:
        keep &= qi - ki < window
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    s = torch.nn.functional.pad(s.masked_fill(~keep, NEG_INF), (0, pad), value=NEG_INF)
    s = s.unflatten(-1, (n_chunks, chunk))  # [..., Sq, C, chunk]
    m_c = s.amax(-1)  # [..., Sq, C]
    p = torch.where(s <= NEG_INF, 0.0, torch.exp(s - m_c[..., None]))
    l_c = p.sum(-1)
    vv = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).unflatten(-2, (n_chunks, chunk))
    acc_c = torch.einsum("...qcj,...cjd->...qcd", p.to(v.dtype).float(), vv)
    m = m_c.amax(-1, keepdim=True)
    w = torch.where(m_c <= NEG_INF, 0.0, torch.exp(m_c - m))
    l = (w * l_c).sum(-1, keepdim=True)
    out = (w[..., None] * acc_c).sum(-2) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)
