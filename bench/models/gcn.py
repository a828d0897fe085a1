"""GCN with the mean aggregator (DCI, Table III): a layer is
``((h + the neighbours' rows summed) / (count + 1)) W_self + b``, ReLU between
layers."""

from __future__ import annotations

import torch

from bench.models import _summed

activation = torch.relu
dims = _summed.dims


def init(config, gen, device):
    return _summed.init(config, gen, device, ("w_self",))


def _apply(p, x_self, agg, count, dtype):
    w_self = p["w_self"].to(dtype)
    return ((x_self + agg) / (count + 1.0)) @ w_self + p["b"].to(dtype)


def block_layer(p, x_self, nbr, fanout, dtype, *, last):
    return _apply(p, x_self, nbr.sum(1), fanout, dtype)


def full_layer(p, x, dst, src, deg, dtype, edge_block, *, last):
    return _apply(p, x, _summed.edge_sum(x, dst, src, edge_block), deg, dtype)


def layer_flops(rows, terms, d_in, d_out, *, config, layer):
    """``terms`` adds of neighbour rows and ``rows`` of the node's own, a divide
    an input, one product, the bias."""
    return terms * d_in + rows * d_in + 2 * rows * d_in * d_out + rows * d_out
