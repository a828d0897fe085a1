"""GraphSAGE and GCN models (paper Table III: 3 layers, hidden 128, FC apply),
and GAT (Veličković et al., ICLR 2018, arXiv:1710.10903) in its inductive
model (§3.3): two layers of 4 heads of 256 concatenated with ELU, a learned
skip across the middle layer, 6 heads averaged at the output.

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
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.trace import NULL_TRACER
from repro_torch.kernels.gat_attend.kernel import gat_attend
from repro_torch.kernels.seg_agg.kernel import seg_agg_indexed
from repro_torch.models.gnn.layers import (
    gat_apply,
    gcn_apply,
    gcn_layer,
    sage_apply,
    sage_layer,
)

__all__ = [
    "GAT_HEAD_DIM",
    "GAT_HIDDEN_HEADS",
    "GAT_OUTPUT_HEADS",
    "GNN",
    "MODELS",
    "NEGATIVE_SLOPE",
    "forward",
    "forward_layer",
    "init_params",
    "out_width",
    "params_from_jax",
]

MODELS = ("graphsage", "gcn", "gat")

# GAT's inductive model (§3.3): heads of each hidden layer and of the
# output layer, the hidden heads' width, and LeakyReLU's slope in the scores.
GAT_HIDDEN_HEADS = 4
GAT_OUTPUT_HEADS = 6
GAT_HEAD_DIM = 256
NEGATIVE_SLOPE = 0.2


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
    map ``w_res [in, H*D]`` and bias ``b_res``, drawn in that order."""
    if model not in MODELS:
        raise ValueError(f"unknown GNN model {model!r}")
    if model == "gat":
        return _init_gat(generator, in_dim, num_classes, n_layers, device)
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


def out_width(layer_params: Mapping[str, torch.Tensor]) -> int:
    """A layer's output width, for every model: its bias's."""
    return int(layer_params["b"].shape[0])


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
    path.  ``tracer`` records each GAT layer's ``attend`` and ``project``
    spans on a lane of their own, ``model``."""
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
    if model == "gat":
        h, index = input_feats, inverse_index
        for li, l in enumerate(range(n_layers - 1, -1, -1)):
            h = _gat_layer(params[li], h, index, sizes[l], rev[l], layer=li, tracer=tracer)
            index = None  # layers 1 and up read their input in place
            if li < n_layers - 1:
                h = torch.nn.functional.elu(h, inplace=True)
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
    args = None
    if tracer.enabled:
        args = {"layer": layer, "rows": num_dst, "positions": num_dst * (1 + fanout),
                "indexed": index is not None}
    with tracer.span("attend", lane="model", args=args):
        att = gat_attend(rows, index, _fold(layer_params), num_dst=num_dst, fanout=fanout,
                         negative_slope=NEGATIVE_SLOPE)
    with tracer.span("project", lane="model", args=args):
        self_h = None
        if "w_res" in layer_params:
            self_h = rows[:num_dst] if index is None else rows[index[:num_dst].to(torch.int64)]
        return gat_apply(layer_params, att, self_h)


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
    (GraphSAGE's and GCN's ReLU, GAT's ELU).

    GAT softmaxes each head's scores over the node's exact in-neighbourhood
    plus itself (a multi-edge counts as often as it appears): the maximum
    of each segment, then the sums of the weights and of the weighted input
    rows, each reduced in the same fixed order as the sum below, then the
    heads' maps as in the sampled layer.

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


class GNN(nn.Module):
    """GraphSAGE, GCN or GAT over sampled blocks, for inference.

    Holds one ``ParameterDict`` per layer with the reference's ``[in,
    out]`` weights (no gradients: the system only serves).
    ``fused_forwards`` counts the forwards whose layer 0 ran in one kernel
    (``seg_agg_indexed``, or GAT's ``gat_attend``), reading its rows
    through the inverse map where there is one: every forward on a card,
    none on the CPU."""

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
        kernel = gat_attend if self.model == "gat" else seg_agg_indexed
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
