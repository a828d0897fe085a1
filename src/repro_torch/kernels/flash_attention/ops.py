"""Public op: multi-head attention through the flash kernel or the plain
version.

``q``: ``[B, Hq, Sq, D]``; ``k``/``v``: ``[B, Hkv, Sk, D]`` with ``Hq`` a
multiple of ``Hkv`` (GQA/MQA).  ``use_kernel=True`` routes through
:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention` (one
CUDA launch over every batch and head on CUDA tensors, the plain version
on CPU tensors); ``use_kernel=False`` takes CPU tensors only, which the
same wrapper hands to the plain version (``ref.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["multi_head_attention"]


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention over batched, multi-head inputs.

    Args:
      q: ``[B, Hq, Sq, D]`` queries.
      k, v: ``[B, Hkv, Sk, D]`` keys/values; ``Hq`` must be a multiple of
        ``Hkv`` (query head ``h`` reads kv head ``h // (Hq / Hkv)``).
      causal: query ``i`` attends only to keys ``j <= i`` (both sequences
        counted from position 0).
      window: optional sliding-window width — query ``i`` attends only to
        keys with ``i - j < window``.
      softcap: optional logit soft-capping ``softcap * tanh(x / softcap)``
        (Gemma-2 style) applied before the mask and the softmax.
      use_kernel: route through the CUDA kernel wrapper; required for
        CUDA tensors.  On CPU tensors both settings compute the plain
        version.

    Returns:
      ``[B, Hq, Sq, D]`` attention outputs in q's dtype.
    """
    if not use_kernel and any(t.is_cuda for t in (q, k, v)):
        raise ValueError("multi_head_attention on CUDA tensors needs use_kernel=True")
    return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
