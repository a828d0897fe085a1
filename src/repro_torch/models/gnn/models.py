"""GraphSAGE and GCN models (paper Table III: 3 layers, hidden 128, FC apply),
GAT (Veličković et al., ICLR 2018, arXiv:1710.10903) in its inductive
model (§3.3): two layers of 4 heads of 256 concatenated with ELU, a learned
skip across the middle layer, 6 heads averaged at the output; and the Graph
Transformer (Shi et al., UniMP, IJCAI 2021, arXiv:2009.03509; PyG's
``TransformerConv``) at its ogbn-products settings: two layers of 4 heads of
128 concatenated, each with its gated skip, LayerNorm and ReLU, 4 heads
averaged at the output.

``init_params`` builds the per-layer parameter dicts from a
``torch.Generator`` (``[in, out]`` weights, as in the reference);
``params_from_jax`` carries the reference's parameters over as they are;
:class:`GNN` holds them as an ``nn.Module``; :func:`forward` consumes
input-frontier features plus the block structure (fan-outs) and produces
per-seed logits; :func:`forward_layer` is one layer over a chunk's exact
in-neighborhoods (the layer-wise mode); :func:`out_width` is a layer's
output width, whatever the model.  Matmuls run in full float32: TF32 is
switched off for both cuBLAS and cuDNN.

A GAT layer runs in the order that needs the fewest operations, which is
exact algebra on the paper's equations: each head's score vector folded
through its map (``u = W_k a_k``, so a row's score is one dot of its input
row), the per-head softmax-weighted sums of the layer's INPUT rows
(:func:`~repro_torch.kernels.gat_attend.kernel.gat_attend`, ``[rows, H,
F]``), then one batched matmul per layer for the heads' maps.  Projecting
first would map every position's row: at batch 4096 and fan-outs 15,10,5
about 983 GFLOP a batch against 174, and a ``[positions, H*D]`` tensor at
layer 0 (4.3 M x 1024).

A Graph Transformer layer runs in the same order.  Each destination's query
``q_i^k = W_q^k h_i + b_q^k`` is folded through the head's key map, ``u_i^k
= W_k^k q_i^k / sqrt(D)`` (the scale rides in the query map's product), so
a neighbour's score ``q_i^k . k_j^k / sqrt(D)`` is ``u_i^k . h_j`` plus a
term the same for every neighbour of ``i``, which the softmax cancels: the
key bias never enters.  The per-head softmax-weighted sums of the
neighbours' INPUT rows
(:func:`~repro_torch.kernels.dot_attend.kernel.dot_attend`, ``[rows, H,
F]``; the destination's own row takes no part) then go through one batched
matmul for the heads' value maps, whose bias enters once because the
weights sum to 1.  The skip ``r_i = W_r h_i + b_r``, the gate ``beta_i =
sigmoid(w_g . [h_i'; r_i; h_i' - r_i])``, the mix ``beta_i r_i + (1 -
beta_i) h_i'`` and, on a hidden layer, LayerNorm follow
(:func:`~repro_torch.models.gnn.layers.gt_apply`,
:func:`~repro_torch.models.gnn.layers.gt_gate`).  Projecting keys and values
first would map every neighbour position's row twice: about 800 GFLOP a
batch against 175 at batch 4096 and fan-outs 15,10,5, and a ``[positions,
H*D]`` key and value tensor at layer 0 (4.1 M x 512 each).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.trace import NULL_TRACER
from repro_torch.kernels.dot_attend.kernel import dot_attend
from repro_torch.kernels.gat_attend.kernel import gat_attend
from repro_torch.kernels.seg_agg.kernel import seg_agg_indexed
from repro_torch.models.gnn.layers import (
    gat_apply,
    gcn_apply,
    gcn_layer,
    gt_apply,
    gt_gate,
    sage_apply,
    sage_layer,
)

__all__ = [
    "GAT_HEAD_DIM",
    "GAT_HIDDEN_HEADS",
    "GAT_OUTPUT_HEADS",
    "GNN",
    "GT_HEADS",
    "GT_HEAD_DIM",
    "MODELS",
    "NEGATIVE_SLOPE",
    "forward",
    "forward_layer",
    "init_params",
    "out_width",
    "params_from_jax",
]

MODELS = ("graphsage", "gcn", "gat", "graph_transformer")

# GAT's inductive model (§3.3): heads of each hidden layer and of the
# output layer, the hidden heads' width, and LeakyReLU's slope in the scores.
GAT_HIDDEN_HEADS = 4
GAT_OUTPUT_HEADS = 6
GAT_HEAD_DIM = 256
NEGATIVE_SLOPE = 0.2
# The Graph Transformer at UniMP's ogbn-products settings: heads of every
# layer and the hidden heads' width (``hidden_size`` 128 read per head, the
# heads concatenated, as PyG's ``TransformerConv(128, heads=4)``).
GT_HEADS = 4
GT_HEAD_DIM = 128


def _full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_params(
    generator: torch.Generator,
    model: str,
    in_dim: int,
    num_classes: int,
    hidden: int = 128,
    n_layers: int = 3,
    *,
    device: torch.device | str = "cpu",
) -> list[dict[str, torch.Tensor]]:
    """Random normal weights scaled by ``1/sqrt(in)``, zero biases.

    GraphSAGE and GCN: ``hidden`` wide hidden layers, ``w_self`` (and
    GraphSAGE's ``w_nbr``) ``[in, out]``.  GAT takes the paper's widths,
    whatever ``hidden``: ``GAT_HIDDEN_HEADS`` heads of ``GAT_HEAD_DIM``
    concatenated in each hidden layer, ``GAT_OUTPUT_HEADS`` heads of
    ``num_classes`` averaged at the output; a layer holds ``w [in, H*D]``,
    the score halves ``a_src`` and ``a_dst`` ``[H, D]`` (normal, scaled by
    ``1/sqrt(D)``), the bias ``b`` (``[H*D]``, or ``[num_classes]`` at the
    output) and, on each middle layer (1 to ``n_layers - 2``), the skip's
    map ``w_res [in, H*D]`` and bias ``b_res``, drawn in that order.

    The Graph Transformer takes UniMP's widths, whatever ``hidden``:
    ``GT_HEADS`` heads of ``GT_HEAD_DIM`` concatenated in each hidden layer,
    ``GT_HEADS`` heads of ``num_classes`` averaged at the output; a layer
    holds the query, key and value maps ``w_q``, ``w_k``, ``w_v`` ``[in,
    H*D]`` each followed by its bias ``b_q``, ``b_k``, ``b_v`` ``[H, D]``,
    the skip's ``w_r [in, out]`` and ``b_r [out]``, the gate's ``w_g
    [3*out]`` and, on a hidden layer, LayerNorm's ``ln_w`` and ``ln_b``
    ``[out]``, drawn in that order: maps and biases normal scaled by
    ``1/sqrt(fan-in)``, ``ln_w`` ``1 + 0.1 * normal``, ``ln_b`` ``0.1 *
    normal``, none of them zero (``bench/models/graph_transformer.py``
    draws the same)."""
    if model not in MODELS:
        raise ValueError(f"unknown GNN model {model!r}")
    if model == "gat":
        return _init_gat(generator, in_dim, num_classes, n_layers, device)
    if model == "graph_transformer":
        return _init_gt(generator, in_dim, num_classes, n_layers, device)
    dims = [in_dim] + [hidden] * (n_layers - 1) + [num_classes]
    params = []
    for i in range(n_layers):
        scale = 1.0 / float(np.sqrt(dims[i]))

        def normal():
            w = torch.randn((dims[i], dims[i + 1]), generator=generator, device=generator.device)
            return (w * scale).to(device)

        layer = {
            "w_self": normal(),
            "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device),
        }
        if model == "graphsage":
            layer["w_nbr"] = normal()
        params.append(layer)
    return params


def _init_gat(generator, in_dim, num_classes, n_layers, device):
    heads = (GAT_HIDDEN_HEADS,) * (n_layers - 1) + (GAT_OUTPUT_HEADS,)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w / float(np.sqrt(fan_in))).to(device)

    params, d_in = [], in_dim
    for i, h in enumerate(heads):
        width = num_classes if i == n_layers - 1 else GAT_HEAD_DIM
        d_out = width if i == n_layers - 1 else h * width
        layer = {
            "w": normal((d_in, h * width), d_in),
            "a_src": normal((h, width), width),
            "a_dst": normal((h, width), width),
        }
        if 0 < i < n_layers - 1:
            layer["w_res"] = normal((d_in, d_out), d_in)
            layer["b_res"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
        layer["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
        params.append(layer)
        d_in = d_out
    return params


def _init_gt(generator, in_dim, num_classes, n_layers, device):
    def normal(shape, fan_in=1):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w / float(np.sqrt(fan_in))).to(device)

    params, d_in = [], in_dim
    for i in range(n_layers):
        last = i == n_layers - 1
        width = num_classes if last else GT_HEAD_DIM
        d_out = width if last else GT_HEADS * width
        layer = {}
        for name in "qkv":
            layer[f"w_{name}"] = normal((d_in, GT_HEADS * width), d_in)
            layer[f"b_{name}"] = normal((GT_HEADS, width), d_in)
        layer["w_r"] = normal((d_in, d_out), d_in)
        layer["b_r"] = normal((d_out,), d_in)
        layer["w_g"] = normal((3 * d_out,), 3 * d_out)
        if not last:
            layer["ln_w"] = 1.0 + 0.1 * normal((d_out,))
            layer["ln_b"] = 0.1 * normal((d_out,))
        params.append(layer)
        d_in = d_out
    return params


def out_width(layer_params: Mapping[str, torch.Tensor]) -> int:
    """A layer's output width, for every model: its bias's (the Graph
    Transformer's skip bias ``b_r``)."""
    return int(layer_params["b_r" if "b_r" in layer_params else "b"].shape[0])


def params_from_jax(
    params: Sequence[Mapping[str, np.ndarray]], *, device: torch.device | str = "cpu"
) -> list[dict[str, torch.Tensor]]:
    """The reference's parameter list (arrays as numpy) as torch tensors,
    layout unchanged."""
    return [
        {k: torch.from_numpy(np.array(v, copy=True)).to(device) for k, v in layer.items()}
        for layer in params
    ]


def forward(
    params: Sequence[Mapping[str, torch.Tensor]],
    input_feats: torch.Tensor,
    *,
    model: str,
    fanouts: tuple[int, ...],
    inverse_index: torch.Tensor | None = None,
    tracer=NULL_TRACER,
) -> torch.Tensor:
    """Run the GNN over one sampled block.

    ``input_feats`` covers the deepest frontier (``block.input_nodes``);
    the seed count follows from its row count and ``fanouts``.
    ``inverse_index`` switches to the unique-frontier form: ``input_feats``
    then holds one row per DISTINCT input node (possibly pow2-padded) and
    ``inverse_index`` (int32) maps the ``[self | neighbors]`` layout onto
    them.  Layer 0 reads its rows through the index inside its
    self-and-fanout sum (:func:`~repro_torch.kernels.seg_agg.kernel.seg_agg_indexed`;
    GAT's in its attention, :func:`~repro_torch.kernels.gat_attend.kernel.gat_attend`):
    one kernel on a card, so the duplicate rows are never written; on the
    CPU the reference's ``input_feats[inverse_index]`` and then the layer's
    sum), so the logits are the same bits as on the duplicate-carrying
    path.  The Graph Transformer's attention,
    :func:`~repro_torch.kernels.dot_attend.kernel.dot_attend`, reads them
    the same way, and its queries and skip read the destinations' own rows
    as ``input_feats[inverse_index[:seeds]]``.  ``tracer`` records each GAT
    layer's ``attend`` and ``project`` spans, and each Graph Transformer
    layer's ``query``, ``attend``, ``project`` and ``gate`` spans, on a
    lane of their own, ``model``."""
    _full_fp32()
    rev = tuple(reversed(fanouts))  # expansion order used by sample_blocks
    mult = 1
    for f in rev:
        mult *= 1 + f
    positions = input_feats.shape[0] if inverse_index is None else inverse_index.shape[0]
    num_seeds = positions // mult

    sizes = [num_seeds]
    for f in rev:
        sizes.append(sizes[-1] * (1 + f))

    n_layers = len(fanouts)
    if model in ("gat", "graph_transformer"):
        layer_fn, act = ((_gat_layer, torch.nn.functional.elu) if model == "gat"
                         else (_gt_layer, torch.nn.functional.relu))
        h, index = input_feats, inverse_index
        for li, l in enumerate(range(n_layers - 1, -1, -1)):
            h = layer_fn(params[li], h, index, sizes[l], rev[l], layer=li, tracer=tracer)
            index = None  # layers 1 and up read their input in place
            if li < n_layers - 1:
                h = act(h, inplace=True)
        return h  # [num_seeds, num_classes]
    layer_fn = sage_layer if model == "graphsage" else gcn_layer
    # Walk from the deepest frontier inward; model layer 0 consumes raw feats.
    for li, l in enumerate(range(n_layers - 1, -1, -1)):
        if li == 0:
            h = _first_layer(params[0], input_feats, inverse_index, model, sizes[l], rev[l])
        else:
            h = layer_fn(params[li], h, sizes[l], rev[l])
        if li < n_layers - 1:
            h = torch.relu(h)
    return h  # [num_seeds, num_classes]


def _first_layer(
    layer_params: Mapping[str, torch.Tensor],
    rows: torch.Tensor,
    index: torch.Tensor | None,
    model: str,
    num_dst: int,
    fanout: int,
) -> torch.Tensor:
    """Layer 0, its aggregation reading ``rows`` through ``index``; the FCs
    as in :func:`sage_layer` / :func:`gcn_layer`."""
    if model == "graphsage":
        self_h, agg = seg_agg_indexed(rows, index, num_dst=num_dst, fanout=fanout, mode="sage")
        return sage_apply(layer_params, self_h, agg)
    mean = seg_agg_indexed(rows, index, num_dst=num_dst, fanout=fanout, mode="gcn")
    return gcn_apply(layer_params, mean)


def _fold(layer_params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The score vectors folded through each head's map, ``[2, H, F]``:
    ``u[0, k] = W_k a_src[k]``, ``u[1, k] = W_k a_dst[k]``."""
    w, a_src = layer_params["w"], layer_params["a_src"]
    heads, width = a_src.shape
    a = torch.stack((a_src, layer_params["a_dst"]))
    return torch.einsum("fhd,shd->shf", w.view(w.shape[0], heads, width), a)


def _gat_layer(
    layer_params: Mapping[str, torch.Tensor],
    rows: torch.Tensor,
    index: torch.Tensor | None,
    num_dst: int,
    fanout: int,
    *,
    layer: int,
    tracer,
) -> torch.Tensor:
    """One GAT layer over a sampled block, reading ``rows`` through
    ``index`` (or in place): the attention over the input rows, then the
    heads' maps (:func:`~repro_torch.models.gnn.layers.gat_apply`)."""
    args = _span_args(tracer, layer, num_dst, fanout, index)
    with tracer.span("attend", lane="model", args=args):
        att = gat_attend(rows, index, _fold(layer_params), num_dst=num_dst, fanout=fanout,
                         negative_slope=NEGATIVE_SLOPE)
    with tracer.span("project", lane="model", args=args):
        self_h = None
        if "w_res" in layer_params:
            self_h = rows[:num_dst] if index is None else rows[index[:num_dst].to(torch.int64)]
        return gat_apply(layer_params, att, self_h)


def _span_args(tracer, layer: int, num_dst: int, fanout: int, index) -> dict | None:
    """The ``model`` lane's span args of one layer (None when untraced)."""
    if not tracer.enabled:
        return None
    return {"layer": layer, "rows": num_dst, "positions": num_dst * (1 + fanout),
            "indexed": index is not None}


def _gt_query(layer_params: Mapping[str, torch.Tensor], self_h: torch.Tensor) -> torch.Tensor:
    """The destinations' queries folded through the heads' key maps,
    ``[rows, H, F]``: ``u[i, k] = W_k^k (W_q^k h_i + b_q^k) / sqrt(D)``, the
    scale in the query map's product, the fold one batched matmul written
    in place."""
    b_q = layer_params["b_q"]
    heads, width = b_q.shape
    rows, f = self_h.shape
    scale = 1.0 / float(np.sqrt(width))
    q = torch.addmm(b_q.view(-1), self_h, layer_params["w_q"], beta=scale, alpha=scale)
    u = torch.empty((rows, heads, f), dtype=q.dtype, device=q.device)
    torch.bmm(q.view(rows, heads, width).transpose(0, 1),
              layer_params["w_k"].view(f, heads, width).permute(1, 2, 0), out=u.transpose(0, 1))
    return u


def _gt_layer(
    layer_params: Mapping[str, torch.Tensor],
    rows: torch.Tensor,
    index: torch.Tensor | None,
    num_dst: int,
    fanout: int,
    *,
    layer: int,
    tracer,
) -> torch.Tensor:
    """One Graph Transformer layer over a sampled block, reading ``rows``
    through ``index`` (or in place): the destinations' folded queries, the
    attention over their neighbours' input rows, the heads' value maps and
    the skip (:func:`~repro_torch.models.gnn.layers.gt_apply`), then the
    gate and, on a hidden layer, LayerNorm
    (:func:`~repro_torch.models.gnn.layers.gt_gate`)."""
    args = _span_args(tracer, layer, num_dst, fanout, index)
    with tracer.span("query", lane="model", args=args):
        self_h = rows[:num_dst] if index is None else rows[index[:num_dst].to(torch.int64)]
        u = _gt_query(layer_params, self_h)
    with tracer.span("attend", lane="model", args=args):
        att = dot_attend(rows, index, u, num_dst=num_dst, fanout=fanout)
    with tracer.span("project", lane="model", args=args):
        h_att, skip = gt_apply(layer_params, att, self_h)
    with tracer.span("gate", lane="model", args=args):
        return gt_gate(layer_params, h_att, skip)


def forward_layer(
    layer_params: Mapping[str, torch.Tensor],
    self_feats: torch.Tensor,
    nbr_feats: torch.Tensor,
    segment_ids: torch.Tensor,
    degrees: torch.Tensor,
    *,
    model: str,
    num_dst: int,
    relu: bool = False,
    levels: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """One GNN layer over EXACT neighbor aggregates — the layer-wise mode's
    per-layer split of :func:`forward`.

    ``self_feats[num_dst, F]`` are one node-range chunk's own rows,
    ``nbr_feats[E_pad, F]`` the rows of every in-edge's source in CSC
    order (pad rows carry ``segment_ids == num_dst``, a segment that is
    dropped), ``segment_ids`` each edge row's destination within the chunk
    and ``degrees[num_dst]`` the true in-degrees.  The GCN divides by
    ``degree + 1`` (the sampled layer by ``fanout + 1``).  Zero-degree
    nodes aggregate nothing.  ``relu`` applies the inter-layer activation
    (GraphSAGE's, GCN's and the Graph Transformer's ReLU, GAT's ELU).

    GAT softmaxes each head's scores over the node's exact in-neighbourhood
    plus itself (a multi-edge counts as often as it appears): the maximum
    of each segment, then the sums of the weights and of the weighted input
    rows, each reduced in the same fixed order as the sum below, then the
    heads' maps as in the sampled layer.

    The Graph Transformer softmaxes each head's scores over the node's
    exact in-neighbourhood alone, in the same fixed order: the maximum of
    each segment, the sums of the weights and of the weighted input rows,
    then the value maps, the skip, the gate and LayerNorm as in the sampled
    layer.  A node with no in-edge attends to nothing: its attention output
    is 0 (PyG's empty sum), and the gate mixes it with the skip.

    ``segment_ids`` must be sorted (``plan_chunks`` gives them so): the
    aggregate is ``torch.segment_reduce`` over segment lengths, which adds
    each segment's rows in order, in one thread per output element — the
    same bits on every run, where an atomic ``index_add_`` would add them
    in an order that changes from run to run.

    ``levels`` (``ChunkSpec.levels``) replaces ``segment_ids``: int64
    segment lengths reduced one after the other, the first over the rows
    of ``nbr_feats`` (then only the live edges), the last giving one row
    per chunk node.  A thread's loop is as long as its segment, so one
    node of in-degree near N would hold the whole chunk; split into
    pieces of a bounded length, the sum keeps a fixed order and no loop
    is longer than a piece or a node's piece count."""
    _full_fp32()
    if levels is None:
        levels = (torch.bincount(segment_ids.to(torch.int64), minlength=num_dst + 1),)
    if model == "gat":
        h = _gat_exact(layer_params, self_feats, nbr_feats, segment_ids, num_dst, levels)
        return torch.nn.functional.elu(h) if relu else h
    if model == "graph_transformer":
        h = _gt_exact(layer_params, self_feats, nbr_feats, segment_ids, num_dst, levels)
        return torch.relu(h) if relu else h
    agg = _segments(nbr_feats, "sum", levels)[:num_dst]
    if model == "graphsage":
        h = self_feats @ layer_params["w_self"] + agg @ layer_params["w_nbr"] + layer_params["b"]
    else:  # gcn: mean over {self} ∪ in-neighbors, single FC
        h = ((self_feats + agg) / (degrees[:, None] + 1.0)) @ layer_params["w_self"]
        h = h + layer_params["b"]
    return torch.relu(h) if relu else h


def _segments(x: torch.Tensor, reduce: str, levels: Sequence[torch.Tensor]) -> torch.Tensor:
    for lengths in levels:
        x = torch.segment_reduce(x, reduce, lengths=lengths, unsafe=True)
    return x


def _gat_exact(layer_params, self_feats, nbr_feats, segment_ids, num_dst, levels):
    """A GAT layer over exact in-neighbourhoods (see :func:`forward_layer`)."""
    u = _fold(layer_params)
    heads, f = u.shape[1], self_feats.shape[1]
    edges = nbr_feats.shape[0]
    dst = segment_ids[:edges].to(torch.int64)  # pad rows: segment num_dst, dropped
    leaky = torch.nn.functional.leaky_relu
    s_dst = self_feats @ u[1].T
    pad = s_dst.new_zeros((1, heads))
    e_self = leaky(s_dst + self_feats @ u[0].T, NEGATIVE_SLOPE)
    e = leaky(torch.cat([s_dst, pad])[dst] + nbr_feats @ u[0].T, NEGATIVE_SLOPE)
    m = torch.maximum(_segments(e, "max", levels)[:num_dst], e_self)  # an empty segment: -inf
    p_self = torch.exp(e_self - m)
    p = torch.exp(e - torch.cat([m, pad])[dst])
    den = _segments(p, "sum", levels)[:num_dst] + p_self
    num = _segments((p[:, :, None] * nbr_feats[:, None, :]).reshape(edges, heads * f), "sum",
                    levels)[:num_dst].view(num_dst, heads, f)
    att = (num + p_self[:, :, None] * self_feats[:, None, :]) / den[:, :, None]
    return gat_apply(layer_params, att, self_feats)


def _gt_exact(layer_params, self_feats, nbr_feats, segment_ids, num_dst, levels):
    """A Graph Transformer layer over exact in-neighbourhoods (see
    :func:`forward_layer`)."""
    u = _gt_query(layer_params, self_feats)
    heads, f = u.shape[1], u.shape[2]
    edges = nbr_feats.shape[0]
    dst = segment_ids[:edges].to(torch.int64)  # pad rows: segment num_dst, dropped
    pad = u.new_zeros((1, heads))
    e = torch.bmm(torch.cat([u, u.new_zeros((1, heads, f))])[dst], nbr_feats[:, :, None])[..., 0]
    m = _segments(e, "max", levels)[:num_dst]  # an empty segment: -inf, read by no edge
    p = torch.exp(e - torch.cat([m, pad])[dst])
    den = _segments(p, "sum", levels)[:num_dst]
    num = _segments((p[:, :, None] * nbr_feats[:, None, :]).reshape(edges, heads * f), "sum",
                    levels)[:num_dst].view(num_dst, heads, f)
    empty = den == 0  # no in-edge: every weight of the node is 0
    h_att, skip = gt_apply(layer_params, num / den.masked_fill(empty, 1.0)[:, :, None],
                           self_feats)
    h_att.masked_fill_(empty[:, :1], 0.0)
    return gt_gate(layer_params, h_att, skip)


class GNN(nn.Module):
    """GraphSAGE, GCN, GAT or the Graph Transformer over sampled blocks,
    for inference.

    Holds one ``ParameterDict`` per layer with the reference's ``[in,
    out]`` weights (no gradients: the system only serves).
    ``fused_forwards`` counts the forwards whose layer 0 ran in one kernel
    (``seg_agg_indexed``, GAT's ``gat_attend`` or the Graph Transformer's
    ``dot_attend``), reading its rows through the inverse map where there
    is one: every forward on a card, none on the CPU."""

    def __init__(
        self,
        params: Sequence[Mapping[str, torch.Tensor]],
        *,
        model: str,
        fanouts: tuple[int, ...],
    ):
        super().__init__()
        if model not in MODELS:
            raise ValueError(f"unknown GNN model {model!r}")
        self.model = model
        self.fanouts = tuple(fanouts)
        self.layers = nn.ModuleList(
            nn.ParameterDict(
                {k: nn.Parameter(v, requires_grad=False) for k, v in layer.items()}
            )
            for layer in params
        )
        self.fused_forwards = 0

    def forward(
        self,
        input_feats: torch.Tensor,
        inverse_index: torch.Tensor | None = None,
        *,
        tracer=NULL_TRACER,
    ) -> torch.Tensor:
        # The kernel the model's layer 0 runs in, looked up at each call.
        kernel = {"gat": gat_attend, "graph_transformer": dot_attend}.get(self.model,
                                                                          seg_agg_indexed)
        launches = kernel.launches
        out = forward(
            list(self.layers),
            input_feats,
            model=self.model,
            fanouts=self.fanouts,
            inverse_index=inverse_index,
            tracer=tracer,
        )
        self.fused_forwards += kernel.launches > launches
        return out
