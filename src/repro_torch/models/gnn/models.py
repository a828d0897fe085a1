"""GraphSAGE and GCN models (paper Table III: 3 layers, hidden 128, FC apply).

``init_params`` builds the per-layer parameter dicts from a
``torch.Generator`` (``[in, out]`` weights, as in the reference);
``params_from_jax`` carries the reference's parameters over as they are;
:class:`GNN` holds them as an ``nn.Module``; :func:`forward` consumes
input-frontier features plus the block structure (fan-outs) and produces
per-seed logits; :func:`forward_layer` is one layer over a chunk's exact
in-neighborhoods (the layer-wise mode).  Matmuls run in full float32: TF32 is switched off for
both cuBLAS and cuDNN.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.models.gnn.layers import gcn_layer, sage_layer

__all__ = ["GNN", "MODELS", "forward", "forward_layer", "init_params", "params_from_jax"]

MODELS = ("graphsage", "gcn")


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
    """Random normal weights scaled by ``1/sqrt(in)``, zero biases."""
    if model not in MODELS:
        raise ValueError(f"unknown GNN model {model!r}")
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
) -> torch.Tensor:
    """Run the GNN over one sampled block.

    ``input_feats`` covers the deepest frontier (``block.input_nodes``);
    the seed count follows from its row count and ``fanouts``.
    ``inverse_index`` switches to the unique-frontier form: ``input_feats``
    then holds one row per DISTINCT input node (possibly pow2-padded) and
    the ``[self | neighbors]`` layout is rebuilt by one gather,
    ``input_feats[inverse_index]``, so the logits are the same bits as on
    the duplicate-carrying path."""
    _full_fp32()
    rev = tuple(reversed(fanouts))  # expansion order used by sample_blocks
    mult = 1
    for f in rev:
        mult *= 1 + f
    if inverse_index is not None:
        input_feats = input_feats[inverse_index.to(torch.int64)]
    num_seeds = input_feats.shape[0] // mult

    sizes = [num_seeds]
    for f in rev:
        sizes.append(sizes[-1] * (1 + f))

    layer_fn = sage_layer if model == "graphsage" else gcn_layer
    h = input_feats
    n_layers = len(fanouts)
    # Walk from the deepest frontier inward; model layer 0 consumes raw feats.
    for li, l in enumerate(range(n_layers - 1, -1, -1)):
        h = layer_fn(params[li], h, sizes[l], rev[l])
        if li < n_layers - 1:
            h = torch.relu(h)
    return h  # [num_seeds, num_classes]


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
    nodes aggregate nothing.  ``relu`` applies the inter-layer activation.

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
    agg = nbr_feats
    for lengths in levels:
        agg = torch.segment_reduce(agg, "sum", lengths=lengths, unsafe=True)
    agg = agg[:num_dst]
    if model == "graphsage":
        h = self_feats @ layer_params["w_self"] + agg @ layer_params["w_nbr"] + layer_params["b"]
    else:  # gcn: mean over {self} ∪ in-neighbors, single FC
        h = ((self_feats + agg) / (degrees[:, None] + 1.0)) @ layer_params["w_self"]
        h = h + layer_params["b"]
    return torch.relu(h) if relu else h


class GNN(nn.Module):
    """GraphSAGE or GCN over sampled blocks, for inference.

    Holds one ``ParameterDict`` per layer with the reference's ``[in,
    out]`` weights (no gradients: the system only serves)."""

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

    def forward(
        self, input_feats: torch.Tensor, inverse_index: torch.Tensor | None = None
    ) -> torch.Tensor:
        return forward(
            list(self.layers),
            input_feats,
            model=self.model,
            fanouts=self.fanouts,
            inverse_index=inverse_index,
        )
