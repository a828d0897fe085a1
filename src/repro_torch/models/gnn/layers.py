"""GraphSAGE / GCN layers over padded sampled blocks (paper Table III), and
the heads' maps of a GAT layer.

A block layer's input is a feature matrix over frontier ``l+1`` with the
``[self | neighbors]`` layout produced by ``sample_blocks``; the layer
reduces it to features over frontier ``l``.  With-replacement fan-out
sampling makes neighborhoods dense ``(S, fanout, F)`` tensors, so
aggregation is a plain reshape + reduction, done inline as in the
reference.  Weights keep the reference's ``[in, out]`` layout.  A GAT
layer's attention is a kernel of its own (``kernels/gat_attend``); its
maps follow here.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["gat_apply", "gcn_apply", "gcn_layer", "sage_apply", "sage_layer", "split_frontier"]


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


def gat_apply(
    params: Mapping[str, torch.Tensor], att: torch.Tensor, self_h: torch.Tensor | None = None
) -> torch.Tensor:
    """GAT's per-head maps over ``att [rows, H, F]``, each head's
    attention-weighted sum of the layer's input rows: ``w [F, H*D]`` maps
    head ``k`` by its columns ``k*D:(k+1)*D``.  Where the bias ``b`` is
    ``H*D`` wide the heads are concatenated, each map one product of a
    batched matmul written in place into ``[rows, H*D]``; else (the output
    layer) they are averaged, one product over the heads' stacked rows.
    ``self_h``, the destinations' own input rows, goes through the skip's
    map ``w_res`` (and ``b_res``) on a layer that has one."""
    w, b = params["w"], params["b"]
    rows, heads, f = att.shape
    width = params["a_src"].shape[1]
    w3 = w.view(f, heads, width)
    if b.shape[0] == heads * width:
        out = torch.empty((rows, heads * width), dtype=att.dtype, device=att.device)
        torch.bmm(att.transpose(0, 1), w3.transpose(0, 1),
                  out=out.view(rows, heads, width).transpose(0, 1))
    else:
        stacked = w3.transpose(0, 1).reshape(heads * f, width)
        out = att.reshape(rows, heads * f) @ stacked
        out /= heads
    out += b
    if "w_res" in params:
        out.addmm_(self_h, params["w_res"])
        out += params["b_res"]
    return out
