"""GraphSAGE with the sum aggregator (DCI, Table III): a layer is
``h W_self + (the neighbours' rows summed) W_nbr + b``, ReLU between layers."""

from __future__ import annotations

import torch

from bench.models import _summed

activation = torch.relu
dims = _summed.dims


def init(config, gen, device):
    return _summed.init(config, gen, device, ("w_self", "w_nbr"))


def _apply(p, x_self, agg, dtype):
    w_self = p["w_self"].to(dtype)
    return x_self @ w_self + agg @ p["w_nbr"].to(dtype) + p["b"].to(dtype)


def block_layer(p, x_self, nbr, fanout, dtype, *, last):
    return _apply(p, x_self, nbr.sum(1), dtype)


def full_layer(p, x, dst, src, deg, dtype, edge_block, *, last):
    return _apply(p, x, _summed.edge_sum(x, dst, src, edge_block), dtype)


def layer_flops(rows, terms, d_in, d_out, *, config, layer):
    """``terms - rows`` adds of neighbour rows, two products, two adds an output
    (the two maps' sum and the bias)."""
    return (terms - rows) * d_in + 2 * (2 * rows * d_in * d_out) + 2 * rows * d_out
