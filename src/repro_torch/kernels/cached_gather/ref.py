"""Plain-torch version of the DCI two-source cached feature gather.

The CPU route of every ``kernel.py`` wrapper and the oracle the CUDA
kernels are held to.  A host table on another device than the positions
(a pinned CPU table beside a CUDA hot table) is gathered where it lives
and the rows are moved to the hot table's device.
"""

from __future__ import annotations

import torch

__all__ = ["cached_gather_ref"]


def cached_gather_ref(
    hot_table: torch.Tensor,  # [H, F]
    host_table: torch.Tensor,  # [N, F]
    indices: torch.Tensor,  # int32 [S] node ids
    positions: torch.Tensor,  # int32 [S] hot slot or -1
) -> torch.Tensor:
    hit = positions >= 0
    safe_pos = positions.clamp(0, hot_table.shape[0] - 1).to(torch.int64)
    safe_idx = indices.clamp(0, host_table.shape[0] - 1).to(torch.int64)
    miss_rows = host_table[safe_idx.to(host_table.device)].to(hot_table.device)
    return torch.where(hit[:, None], hot_table[safe_pos], miss_rows)
