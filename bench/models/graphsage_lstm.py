"""GraphSAGE with the LSTM aggregator (Hamilton, Ying, Leskovec, "Inductive Representation
Learning on Large Graphs", NeurIPS 2017, arXiv:1706.02216; the authors' ``graphsage_seq``:
``aggregators.py`` ``SeqAggregator``, ``supervised_models.py``), in the paper's own order:
every neighbour slot's row goes through the LSTM's input map, and TF's ``BasicLSTMCell`` runs
over a destination's neighbours in the order they were drawn, from a zero state:
``z_t = x_{j_t} W_ih + h_{t-1} W_hh + b`` split into the gates ``(i, j, f, o)``, ``c_t =
sigmoid(f + 1) c_{t-1} + sigmoid(i) tanh(j)``, ``h_t = sigmoid(o) tanh(c_t)``.  A layer
concatenates the self map of the destination's row and the neighbour map of the last hidden
state, ``[x_i W_self ; h_S W_nbr]`` (no aggregator bias); a hidden layer is followed by ReLU.
After the last layer each row is L2-normalised (``tf.nn.l2_normalize``) and mapped to the
logits by ``W_pred`` and ``b_pred``.

The weights are the port's layout (``repro_torch.models.gnn.models.init_params``), drawn in
its order from the harness's generator: per layer ``w_ih [in, 4L]``, ``w_hh [L, 4L]``,
``b_lstm [4L]``, ``w_self [in, D]``, ``w_nbr [L, D]`` and, on the last layer, ``w_pred [2D,
classes]`` and ``b_pred [classes]``; ``L`` is ``lstm_hidden``, ``D`` is ``hidden``.

Departures from the paper and the authors' code, each written here:
  * neighbours are sampled with replacement at DCI's fan-outs, uniformly, in place of the
    code's shuffle of an adjacency list cut to 128: a neighbour drawn twice enters the
    sequence twice, and the draw order stands in for the paper's random permutation; over the
    exact neighbourhood the sequence is the in-edges in CSC order (a multi-edge as often as it
    appears), and a node with no in-edge has ``h = 0``;
  * every sequence has all its slots (the code's sequence length counts a neighbour whose row
    is all zeros as padding: no row of the stand-in is);
  * the output is the hidden state after the last slot; no peepholes, no dropout (inference);
  * the output map has a bias (``layers.Dense``'s default);
  * the logits are compared before any softmax or sigmoid;
  * every weight and bias is drawn normal and scaled by ``1/sqrt(fan-in)`` (a bias by its
    map's), none of them zero, so every term enters the check.
"""

from __future__ import annotations

import math

import torch

activation = torch.relu
SUB_ROWS = 4096  # destinations a block runs in, so float64 fits on the card
FORGET_BIAS = 1.0
NORM_EPS = 1e-12  # tf.nn.l2_normalize's epsilon, on the squared norm


def dims(config: dict) -> list[int]:
    """Widths from input to logits: features, the concatenated maps, classes."""
    ds = config["dataset"]
    return [ds["feat_dim"]] + [2 * config["hidden"]] * (config["layers"] - 1) + [ds["num_classes"]]


def init(config: dict, gen, device) -> list[dict]:
    if not config["concat"] or config["activation"] != "relu" or config["forget_bias"] != 1.0:
        raise ValueError("GraphSAGE-LSTM concatenates its maps, applies ReLU between layers "
                         "and adds a forget bias of 1")
    widths = dims(config)
    lstm, hidden, layers = config["lstm_hidden"], config["hidden"], config["layers"]

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

    params = []
    for i in range(layers):
        d_in = widths[i]
        layer = {
            "w_ih": normal((d_in, 4 * lstm), d_in),
            "w_hh": normal((lstm, 4 * lstm), lstm),
            "b_lstm": normal((4 * lstm,), d_in),
            "w_self": normal((d_in, hidden), d_in),
            "w_nbr": normal((lstm, hidden), lstm),
        }
        if i == layers - 1:
            layer["w_pred"] = normal((2 * hidden, widths[-1]), 2 * hidden)
            layer["b_pred"] = normal((widths[-1],), 2 * hidden)
        params.append(layer)
    return params


def _step(w, z, c):
    """One BasicLSTMCell step from the gate sums: ``(h, c)``."""
    i, j, f, o = z.split(w["w_hh"].shape[0], dim=-1)
    c = torch.sigmoid(f + FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(j)
    return torch.sigmoid(o) * torch.tanh(c), c


def _finish(w, x_self, h, last):
    """The concatenated maps; after the last layer the L2 norm and the output map."""
    out = torch.cat([x_self @ w["w_self"], h @ w["w_nbr"]], dim=-1)
    if last:
        out = out * torch.rsqrt((out * out).sum(-1, keepdim=True).clamp_min(NORM_EPS))
        out = out @ w["w_pred"] + w["b_pred"]
    return out


def _block(p, x_self, nbr, dtype, last):
    w = {k: v.to(dtype) for k, v in p.items()}
    z_in = nbr @ w["w_ih"] + w["b_lstm"]  # [rows, fanout, 4L]: every slot's row mapped
    h = x_self.new_zeros((x_self.shape[0], w["w_hh"].shape[0]))
    c = torch.zeros_like(h)
    for t in range(nbr.shape[1]):
        h, c = _step(w, z_in[:, t] + h @ w["w_hh"], c)
    return _finish(w, x_self, h, last)


def block_layer(p, x_self, nbr, fanout, dtype, *, last):
    return torch.cat([
        _block(p, x_self[r0:r0 + SUB_ROWS], nbr[r0:r0 + SUB_ROWS], dtype, last)
        for r0 in range(0, x_self.shape[0], SUB_ROWS)
    ])


def full_layer(p, x, dst, src, deg, dtype, edge_block, *, last):
    """Each node's LSTM over its in-edges in CSC order (``dst`` ascending): step ``t`` takes
    the ``t``-th in-edge of every node that has one, ``edge_block`` edges at a time (a node
    has one edge a step, so the blocks of a step touch different nodes).  A node with no
    in-edge keeps ``h = 0``."""
    w = {k: v.to(dtype) for k, v in p.items()}
    n = x.shape[0]
    counts = torch.bincount(dst, minlength=n)
    slot = torch.arange(dst.shape[0], device=x.device) - (torch.cumsum(counts, 0) - counts)[dst]
    by_step = torch.sort(slot, stable=True).indices
    h = x.new_zeros((n, w["w_hh"].shape[0]))
    c = torch.zeros_like(h)
    e0 = 0
    for edges in torch.bincount(slot).tolist():
        for b0 in range(e0, e0 + edges, edge_block):
            e = by_step[b0:min(b0 + edge_block, e0 + edges)]
            d, s = dst[e], src[e].to(torch.int64)
            h[d], c[d] = _step(w, x[s] @ w["w_ih"] + w["b_lstm"] + h[d] @ w["w_hh"], c[d])
        e0 += edges
    return _finish(w, x, h, last)


def layer_flops(rows, terms, d_in, d_out, *, config, layer):
    """One layer in the port's order, counted low so that a share of the peak cannot pass
    100%.  The input map and its bias (``x W_ih + b``): at layer 0 over ``rows`` rows, fewer
    than the port maps (it maps the frontier's distinct rows, which at the cell's shapes
    outnumber the destinations, some 104,000 against 45,056; without dedup, every neighbour
    slot's), elsewhere over the ``terms`` neighbour rows.  The recurrence
    (:func:`recur_flops`).  The self and neighbour maps, and after the last layer the L2 norm
    (a square and an add an element, then a scale) and the output map with its bias.  The
    gates' sigmoids and tanhs and the norm's square root are not counted, as an activation is
    not."""
    lstm, hidden = config["lstm_hidden"], config["hidden"]
    mapped = rows if layer == 0 else terms
    input_map = 2 * mapped * d_in * 4 * lstm + mapped * 4 * lstm
    maps = 2 * rows * d_in * hidden + 2 * rows * lstm * hidden
    last = layer == config["layers"] - 1
    tail = 3 * rows * 2 * hidden + 2 * rows * 2 * hidden * d_out + rows * d_out if last else 0
    return input_map + recur_flops(rows, terms, config=config) + maps + tail


def recur_flops(rows, terms, *, config):
    """The recurrence over ``rows`` destinations and ``terms`` steps in all: every step after
    a destination's first (``terms - rows`` of them; over an exact neighbourhood, no more
    than the steps that follow a node's first) adds ``h W_hh`` to its gate row, ``2 L 4L``
    operations; the cell takes five an element a step (``f + 1``, the two products, their
    sum and ``h``'s product), two at a first step (``c`` and ``h``'s products)."""
    lstm = config["lstm_hidden"]
    later = terms - rows
    return later * (2 * lstm * 4 * lstm + 5 * lstm) + rows * 2 * lstm


def recur_bytes(rows, terms, *, config, distinct_rows, indexed):
    """The least bytes any implementation of the recurrence must move: each distinct gate row
    read once at ``4L`` floats (``distinct_rows``: at a sampled layer 0 read through the dedup
    inverse map, the frontier's distinct rows; in place, every neighbour slot's row), 4 bytes
    of index a neighbour slot where the rows are read through one, and each destination's
    last hidden state written once."""
    lstm = config["lstm_hidden"]
    return 4 * (distinct_rows * 4 * lstm + (terms if indexed else 0) + rows * lstm)
