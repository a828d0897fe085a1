"""GraphSAGE / GCN layers over padded sampled blocks (paper Table III), the
heads' maps of a GAT layer, and the value maps, skip, gate and LayerNorm of
a Graph Transformer layer.

A block layer's input is a feature matrix over frontier ``l+1`` with the
``[self | neighbors]`` layout produced by ``sample_blocks``; the layer
reduces it to features over frontier ``l``.  With-replacement fan-out
sampling makes neighborhoods dense ``(S, fanout, F)`` tensors, so
aggregation is a plain reshape + reduction, done inline as in the
reference.  Weights keep the reference's ``[in, out]`` layout.  A GAT
layer's attention is a kernel of its own (``kernels/gat_attend``), as is a
Graph Transformer layer's (``kernels/dot_attend``); their maps follow here.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = [
    "LAYER_NORM_EPS",
    "gat_apply",
    "gcn_apply",
    "gcn_layer",
    "gt_apply",
    "gt_gate",
    "head_maps",
    "sage_apply",
    "sage_layer",
    "split_frontier",
]

LAYER_NORM_EPS = 1e-5  # the Graph Transformer's LayerNorm (torch's default)


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


def head_maps(att: torch.Tensor, w: torch.Tensor, width: int, *, concat: bool) -> torch.Tensor:
    """Per-head maps over ``att [rows, H, F]``: ``w [F, H*D]`` maps head
    ``k`` by its columns ``k*D:(k+1)*D``.  Concatenated, each map is one
    product of a batched matmul written in place into ``[rows, H*D]``;
    else (an output layer) the heads are averaged, one product over the
    heads' stacked rows."""
    rows, heads, f = att.shape
    w3 = w.view(f, heads, width)
    if concat:
        out = torch.empty((rows, heads * width), dtype=att.dtype, device=att.device)
        torch.bmm(att.transpose(0, 1), w3.transpose(0, 1),
                  out=out.view(rows, heads, width).transpose(0, 1))
    else:
        stacked = w3.transpose(0, 1).reshape(heads * f, width)
        out = att.reshape(rows, heads * f) @ stacked
        out /= heads
    return out


def gat_apply(
    params: Mapping[str, torch.Tensor], att: torch.Tensor, self_h: torch.Tensor | None = None
) -> torch.Tensor:
    """GAT's per-head maps (:func:`head_maps`) over ``att [rows, H, F]``,
    each head's attention-weighted sum of the layer's input rows.  Where
    the bias ``b`` is ``H*D`` wide the heads are concatenated, else (the
    output layer) averaged.  ``self_h``, the destinations' own input rows,
    goes through the skip's map ``w_res`` (and ``b_res``) on a layer that
    has one."""
    b = params["b"]
    heads, width = params["a_src"].shape
    out = head_maps(att, params["w"], width, concat=b.shape[0] == heads * width)
    out += b
    if "w_res" in params:
        out.addmm_(self_h, params["w_res"])
        out += params["b_res"]
    return out


def gt_apply(
    params: Mapping[str, torch.Tensor], att: torch.Tensor, self_h: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """A Graph Transformer layer's value maps and skip: ``(h', r)``.

    ``h'`` is the heads' value maps ``w_v`` (:func:`head_maps`) over ``att
    [rows, H, F]``, each head's attention-weighted sum of the neighbours'
    input rows, and the value bias ``b_v [H, D]`` (it enters once: the
    weights sum to 1); concatenated where the skip's bias ``b_r`` is
    ``H*D`` wide, else (the output layer) averaged.  ``r = self_h w_r +
    b_r`` maps the destinations' own input rows."""
    b_v, b_r = params["b_v"], params["b_r"]
    heads, width = b_v.shape
    concat = b_r.shape[0] == heads * width
    h_att = head_maps(att, params["w_v"], width, concat=concat)
    h_att += b_v.view(-1) if concat else b_v.mean(0)
    return h_att, torch.addmm(b_r, self_h, params["w_r"])


def gt_gate(
    params: Mapping[str, torch.Tensor], h_att: torch.Tensor, skip: torch.Tensor
) -> torch.Tensor:
    """The gated residual: ``beta = sigmoid(w_g . [h'; r; h' - r])`` a row,
    ``beta r + (1 - beta) h'`` (written as ``h' - beta (h' - r)`` into
    ``h_att``'s storage), then LayerNorm (``ln_w``, ``ln_b``, eps
    ``LAYER_NORM_EPS``) on a layer that has one.  ``w_g``'s three parts
    each take one matrix-vector product, so ``[h'; r; h' - r]`` is never
    written."""
    d = skip.shape[1]
    w_g = params["w_g"]
    diff = h_att - skip
    logit = torch.addmv(torch.mv(skip, w_g[d:2 * d]), h_att, w_g[:d])
    logit.addmv_(diff, w_g[2 * d:])
    out = h_att.sub_(diff.mul_(torch.sigmoid_(logit)[:, None]))
    if "ln_w" in params:
        out = torch.nn.functional.layer_norm(out, (d,), params["ln_w"], params["ln_b"],
                                             eps=LAYER_NORM_EPS)
    return out
