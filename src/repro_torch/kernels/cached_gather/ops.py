"""Public op: cached feature gather (CUDA kernel on the card, plain torch
on the CPU).

``use_kernel=True`` routes through :func:`~repro_torch.kernels.cached_gather.kernel.cached_gather`,
which launches the CUDA kernel for CUDA tensors and computes the plain
version for CPU tensors; ``use_kernel=False`` computes the plain version
(``ref.py``) and takes CPU tensors only: on the card the plain version
would gather a pinned table's miss rows on the host, a route the port
does not serve with.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cached_gather.kernel import cached_gather
from repro_torch.kernels.cached_gather.ref import cached_gather_ref

__all__ = ["cached_feature_gather"]


def cached_feature_gather(
    hot_table: torch.Tensor,
    host_table: torch.Tensor,
    indices: torch.Tensor,
    positions: torch.Tensor,
    *,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Gather feature rows via DCI's dual-source cache.

    Args:
      hot_table: ``[H, F]`` — the device-resident feature cache (``H >= 1``;
        row 0 is a placeholder when the cache is empty).
      host_table: ``[N, F]`` — the full feature table (pinned host memory
        or a device tensor).
      indices: ``int32[S]`` — node ids to gather.
      positions: ``int32[S]`` — each id's slot in ``hot_table``, or ``-1``.
      use_kernel: route through the CUDA kernel wrapper; required for
        CUDA tensors.

    Returns:
      ``[S, F]`` — row ``i`` is ``hot_table[positions[i]]`` on a hit,
      ``host_table[indices[i]]`` on a miss.
    """
    if use_kernel:
        return cached_gather(hot_table, host_table, indices, positions)
    if any(t.is_cuda for t in (hot_table, host_table, indices, positions)):
        raise ValueError("cached_feature_gather on CUDA tensors needs use_kernel=True")
    return cached_gather_ref(hot_table, host_table, indices, positions)
