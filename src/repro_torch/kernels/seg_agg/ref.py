"""Plain-torch versions of the padded-neighbourhood aggregation.

The CPU routes of :func:`~repro_torch.kernels.seg_agg.kernel.seg_agg` and
:func:`~repro_torch.kernels.seg_agg.kernel.seg_agg_indexed`, and the
oracles the CUDA kernels are held to.
"""

from __future__ import annotations

import torch

__all__ = ["seg_agg_indexed_ref", "seg_agg_ref"]


def seg_agg_ref(nbr_feats: torch.Tensor, *, mode: str = "sum") -> torch.Tensor:
    """Aggregate ``[S, fanout, F]`` neighbour features to ``[S, F]``."""
    if mode == "sum":
        return nbr_feats.sum(dim=1)
    if mode == "mean":
        return nbr_feats.mean(dim=1)
    raise ValueError(f"unknown mode {mode!r}")


def seg_agg_indexed_ref(
    x: torch.Tensor,
    idx: torch.Tensor | None,
    *,
    num_dst: int,
    fanout: int,
    mode: str,
) -> tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """A sampled layer's self-and-fanout aggregation over ``x[idx]``.

    ``x[idx]`` (``x`` itself when ``idx`` is None) has the ``[self |
    neighbours]`` layout of ``sample_blocks``; then the layer's own
    reshape-and-sum: ``sage`` gives ``(self rows, neighbour sums)``,
    ``gcn`` ``(self + sum) / (fanout + 1)``."""
    h = x if idx is None else x[idx.to(torch.int64)]
    self_h = h[:num_dst]
    nbr_sum = h[num_dst:].reshape(num_dst, fanout, h.shape[-1]).sum(dim=1)
    if mode == "sage":
        return self_h, nbr_sum
    if mode == "gcn":
        return (self_h + nbr_sum) / (fanout + 1)
    raise ValueError(f"unknown mode {mode!r}")
