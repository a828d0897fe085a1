"""GraphSAGE / GCN layers over padded sampled blocks (paper Table III).

A block layer's input is a feature matrix over frontier ``l+1`` with the
``[self | neighbors]`` layout produced by ``sample_blocks``; the layer
reduces it to features over frontier ``l``.  With-replacement fan-out
sampling makes neighborhoods dense ``(S, fanout, F)`` tensors, so
aggregation is a plain reshape + reduction, done inline as in the
reference.  Weights keep the reference's ``[in, out]`` layout.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["sage_layer", "gcn_layer", "split_frontier"]


def split_frontier(
    h: torch.Tensor, num_dst: int, fanout: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``[self | neighbors]`` features: ``(dst[S,F], nbrs[S,fanout,F])``."""
    self_part = h[:num_dst]
    nbr_part = h[num_dst:].reshape(num_dst, fanout, h.shape[-1])
    return self_part, nbr_part


def sage_layer(
    params: Mapping[str, torch.Tensor], h: torch.Tensor, num_dst: int, fanout: int
) -> torch.Tensor:
    """GraphSAGE: sum-aggregate neighbors, separate self/neighbor FCs."""
    self_h, nbr_h = split_frontier(h, num_dst, fanout)
    agg = nbr_h.sum(dim=1)
    return self_h @ params["w_self"] + agg @ params["w_nbr"] + params["b"]


def gcn_layer(
    params: Mapping[str, torch.Tensor], h: torch.Tensor, num_dst: int, fanout: int
) -> torch.Tensor:
    """GCN: mean over {self} ∪ neighbors, single FC (divisor ``fanout + 1``)."""
    self_h, nbr_h = split_frontier(h, num_dst, fanout)
    agg = (self_h + nbr_h.sum(dim=1)) / (fanout + 1)
    return agg @ params["w_self"] + params["b"]
