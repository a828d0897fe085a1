"""Plain-torch version of the padded-neighbourhood aggregation.

The CPU route of :func:`~repro_torch.kernels.seg_agg.kernel.seg_agg` and
the oracle the CUDA kernel is held to.
"""

from __future__ import annotations

import torch

__all__ = ["seg_agg_ref"]


def seg_agg_ref(nbr_feats: torch.Tensor, *, mode: str = "sum") -> torch.Tensor:
    """Aggregate ``[S, fanout, F]`` neighbour features to ``[S, F]``."""
    if mode == "sum":
        return nbr_feats.sum(dim=1)
    if mode == "mean":
        return nbr_feats.mean(dim=1)
    raise ValueError(f"unknown mode {mode!r}")
