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

__all__ = ["gcn_apply", "gcn_layer", "sage_apply", "sage_layer", "split_frontier"]


def split_frontier(
    h: torch.Tensor, num_dst: int, fanout: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split ``[self | neighbors]`` features: ``(dst[S,F], nbrs[S,fanout,F])``."""
    self_part = h[:num_dst]
    nbr_part = h[num_dst:].reshape(num_dst, fanout, h.shape[-1])
    return self_part, nbr_part


def sage_apply(
    params: Mapping[str, torch.Tensor], self_h: torch.Tensor, agg: torch.Tensor
) -> torch.Tensor:
    """GraphSAGE's FCs over the self rows and the neighbour sums."""
    return self_h @ params["w_self"] + agg @ params["w_nbr"] + params["b"]


def gcn_apply(params: Mapping[str, torch.Tensor], mean: torch.Tensor) -> torch.Tensor:
    """GCN's FC over the mean of {self} ∪ neighbors."""
    return mean @ params["w_self"] + params["b"]


def sage_layer(
    params: Mapping[str, torch.Tensor], h: torch.Tensor, num_dst: int, fanout: int
) -> torch.Tensor:
    """GraphSAGE: sum-aggregate neighbors, separate self/neighbor FCs."""
    self_h, nbr_h = split_frontier(h, num_dst, fanout)
    return sage_apply(params, self_h, nbr_h.sum(dim=1))


def gcn_layer(
    params: Mapping[str, torch.Tensor], h: torch.Tensor, num_dst: int, fanout: int
) -> torch.Tensor:
    """GCN: mean over {self} ∪ neighbors, single FC (divisor ``fanout + 1``)."""
    self_h, nbr_h = split_frontier(h, num_dst, fanout)
    return gcn_apply(params, (self_h + nbr_h.sum(dim=1)) / (fanout + 1))
