"""GAT (Veličković et al., "Graph Attention Networks", ICLR 2018, arXiv:1710.10903),
its inductive model (§3.3, PPI), in the paper's own order: each head projects every
row (``W_k h``), scores each pair from both endpoints (Eq. 3, ``e_ij =
LeakyReLU(a_k^T [W_k h_i || W_k h_j])``), softmaxes the scores over the node and its
neighbours (Eq. 2) and sums the projected rows by those weights (Eq. 4).  Hidden
layers concatenate their heads and apply ELU; the output layer averages its heads
(Eq. 6).  The middle layer adds a learned map of the node's own input before the
ELU (the skip connection of §3.3, the authors' ``residual=True``).

The weights are the port's layout (``repro_torch.models.gnn.models.init_params``),
drawn in its order from the harness's generator: per layer ``w [in, H*D]``,
``a_src`` and ``a_dst`` ``[H, D]`` (the two halves of ``a_k``), on the middle layer
``w_res [in, H*D]`` and ``b_res``, and ``b`` (``[H*D]``, or ``[C]`` at the averaged
output).

Departures from the paper, each written here:
  * neighbours are sampled with replacement at DCI's fan-outs, so a neighbour drawn
    twice has two slots and counts twice in the softmax; over the exact
    neighbourhood a multi-edge counts as often as it appears;
  * no dropout, on the inputs or on the coefficients: this is inference;
  * no bias inside the score: Eq. 3 has none;
  * the logits are compared before any softmax or sigmoid (PPI's output is a
    logistic sigmoid);
  * the attention vectors are drawn normal and scaled by ``1/sqrt(D)``, like the
    maps by ``1/sqrt(in)``, and the biases are zero (the authors used Glorot).
"""

from __future__ import annotations

import math

import torch

activation = torch.nn.functional.elu
NEGATIVE_SLOPE = 0.2
SUB_ROWS = 4096  # destinations a block is projected in, so float64 fits on the card


def dims(config: dict) -> list[int]:
    """Widths from input to logits: features, the concatenated heads, classes."""
    ds = config["dataset"]
    hidden = [h * config["head_dim"] for h in config["heads"][:-1]]
    return [ds["feat_dim"]] + hidden + [ds["num_classes"]]


def init(config: dict, gen, device) -> list[dict]:
    if config["negative_slope"] != NEGATIVE_SLOPE or config["activation"] != "elu":
        raise ValueError("GAT runs LeakyReLU(0.2) in its scores and ELU between layers")
    widths = dims(config)
    heads = config["heads"]
    last = len(heads) - 1
    params = []
    for i, h in enumerate(heads):
        width = widths[-1] if i == last else config["head_dim"]

        def normal(shape, fan_in):
            return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

        layer = {
            "w": normal((widths[i], h * width), widths[i]),
            "a_src": normal((h, width), width),
            "a_dst": normal((h, width), width),
        }
        if i in config["residual"]:
            layer["w_res"] = normal((widths[i], widths[i + 1]), widths[i])
            layer["b_res"] = torch.zeros(widths[i + 1], device=device)
        layer["b"] = torch.zeros(widths[i + 1], device=device)
        params.append(layer)
    return params


def _finish(p, out, x_self, dtype, last):
    """Heads averaged (output) or concatenated, the bias, the skip's map."""
    y = out.mean(1) if last else out.reshape(out.shape[0], -1)
    y = y + p["b"].to(dtype)
    if "w_res" in p:
        y = y + x_self @ p["w_res"].to(dtype) + p["b_res"].to(dtype)
    return y


def _scores(z, a_src, a_dst, z_self):
    """Eq. 3 for every slot: ``a^T [W h_i || W h_j]``, then LeakyReLU."""
    e = (z_self * a_dst).sum(-1)[:, None] + (z * a_src).sum(-1)
    return torch.nn.functional.leaky_relu(e, NEGATIVE_SLOPE)


def _block(p, x_self, nbr, dtype, last):
    w = p["w"].to(dtype)
    heads, width = p["a_src"].shape
    rows, fanout = nbr.shape[0], nbr.shape[1]
    z_self = (x_self @ w).view(rows, heads, width)
    z = torch.cat([z_self[:, None], (nbr @ w).view(rows, fanout, heads, width)], 1)
    alpha = torch.softmax(_scores(z, p["a_src"].to(dtype), p["a_dst"].to(dtype), z_self), dim=1)
    return _finish(p, (alpha[..., None] * z).sum(1), x_self, dtype, last)


def block_layer(p, x_self, nbr, fanout, dtype, *, last):
    return torch.cat([
        _block(p, x_self[r0:r0 + SUB_ROWS], nbr[r0:r0 + SUB_ROWS], dtype, last)
        for r0 in range(0, x_self.shape[0], SUB_ROWS)
    ])


def full_layer(p, x, dst, src, deg, dtype, edge_block, *, last):
    """Each node over its exact in-neighbourhood and itself: a scatter maximum of
    the scores over the edges, then the sums of the weights and of the weighted
    projected rows, ``edge_block`` edges at a time."""
    w = p["w"].to(dtype)
    a_src, a_dst = p["a_src"].to(dtype), p["a_dst"].to(dtype)
    heads, width = a_src.shape
    n = x.shape[0]
    z = (x @ w).view(n, heads, width)
    s_src, s_dst = (z * a_src).sum(-1), (z * a_dst).sum(-1)
    leaky = torch.nn.functional.leaky_relu
    e_self = leaky(s_dst + s_src, NEGATIVE_SLOPE)
    blocks = [(dst[e0:e0 + edge_block], src[e0:e0 + edge_block].to(torch.int64))
              for e0 in range(0, src.shape[0], edge_block)]
    m = e_self.clone()
    for d, s in blocks:
        e = leaky(s_dst[d] + s_src[s], NEGATIVE_SLOPE)
        m.scatter_reduce_(0, d[:, None].expand(-1, heads), e, "amax")
    den = torch.exp(e_self - m)
    num = den[..., None] * z
    for d, s in blocks:
        wgt = torch.exp(leaky(s_dst[d] + s_src[s], NEGATIVE_SLOPE) - m[d])
        den.index_add_(0, d, wgt)
        num.index_add_(0, d, wgt[..., None] * z[s])
    return _finish(p, num / den[..., None], x, dtype, last)


def layer_flops(rows, terms, d_in, d_out, *, config, layer):
    """One layer in the order that needs the fewest operations (the port's):
    each head's score vectors folded through its map (``u = W_k a_k``, both
    halves), a source score per position and a destination score per
    destination (a dot of length ``d_in`` each), the weighted sums of the input
    rows over every position, one map per head of the ``d_in``-wide sums (at
    the averaged output the heads' sum is inside the same products, and the
    average's scale is one multiply an output), a bias add an output, and on
    the skip's layer its product and its add (its bias folds into ``b``).  The
    softmax (its exponentials, maxima, running sums and normalisation) is not
    counted, as an activation is not, so the count reads low and a share of the
    peak cannot pass 100%."""
    heads = config["heads"][layer]
    last = layer == len(config["heads"]) - 1
    width = d_out if last else d_out // heads
    positions = rows + terms
    fold = 2 * 2 * d_in * heads * width
    scores = 2 * d_in * heads * (positions + rows)
    attend = 2 * d_in * heads * positions
    project = 2 * rows * heads * d_in * width + (rows * d_out if last else 0)
    bias = rows * d_out
    skip = (2 * rows * d_in * d_out + rows * d_out) if layer in config["residual"] else 0
    return fold + scores + attend + project + bias + skip


def attend_bytes(d_in, d_out, *, config, layer, dst, positions, distinct_rows, indexed):
    """The least bytes any implementation of one layer's attention over ``dst``
    destinations and ``positions`` row slots must move: each distinct input row
    read once at ``d_in`` floats (``distinct_rows``: at a sampled layer 0 read
    through the dedup inverse map, the frontier's distinct rows; in place, every
    position's row), 4 bytes of index a position where the rows are read through
    one, and each destination's output written once, at the narrower of the heads'
    ``H * d_in`` sums and the layer's ``d_out`` outputs."""
    heads = config["heads"][layer]
    index = positions if indexed else 0
    return 4 * (distinct_rows * d_in + index + dst * min(heads * d_in, d_out))
