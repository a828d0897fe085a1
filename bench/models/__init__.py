"""The models the configurations run, one file each: ``bench/models/<model>.py``,
found by a configuration's ``"model"``.

A model file is part of the yardstick: plain torch, importing nothing of the
program.  It gives

  * ``dims(config)``: the widths from input to logits;
  * ``init(config, gen, device)``: the weights, drawn from ``gen`` (seeded by
    the harness) in the layout the port's engine takes as ``params=``, one
    dict a layer;
  * ``block_layer(p, x_self, nbr, fanout, dtype, *, last)``: one layer over a
    sampled block, the destinations' own rows ``[rows, F]`` and their
    neighbours' rows unsummed ``[rows, fanout, F]``;
  * ``full_layer(p, x, dst, src, deg, dtype, edge_block, *, last)``: one
    layer over every node's exact in-neighbourhood, the edge list as
    destinations ``dst`` and source rows ``src``, the in-degrees ``deg``
    ``[N, 1]``, summed in blocks of ``edge_block`` edges;
  * ``activation``: what the reference applies between layers (the model
    owns it, not the reference);
  * ``layer_flops(rows, terms, d_in, d_out, *, config, layer)``: one
    layer's operations over ``rows`` destinations reading ``terms``
    neighbour rows in all, for the sampled block and the full graph alike.

``last`` says a layer is the output layer and ``config`` / ``layer`` which
layer of which configuration is counted: a model whose output layer differs
from its hidden ones (GAT averages its heads there) or whose count needs more
than the widths (heads) reads them; GraphSAGE and GCN do not.
"""

from __future__ import annotations

import importlib.util
import pathlib
from types import ModuleType

__all__ = ["HERE", "find", "load"]

HERE = pathlib.Path(__file__).resolve().parent


def find(name: str) -> pathlib.Path:
    """The file of model ``name``; raises naming it when there is none."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"model {name!r} has no file: {path} does not exist")
    return path


def load(name: str) -> ModuleType:
    """Model ``name``'s module, read from its file."""
    spec = importlib.util.spec_from_file_location(f"bench_model_{name.replace('.', '_')}", find(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
