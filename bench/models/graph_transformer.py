"""The Graph Transformer (Shi et al., "Masked Label Prediction: Unified Message Passing
Model for Semi-Supervised Classification" (UniMP), IJCAI 2021, arXiv:2009.03509; PyG's
``TransformerConv``), in the paper's own order: each head maps every neighbour row to a
key and a value (``k_j = W_k h_j + b_k``, ``v_j = W_v h_j + b_v``) and the node to a
query (``q_i = W_q h_i + b_q``), softmaxes ``q_i . k_j / sqrt(D)`` over the neighbours
(Eq. 4) and sums their values by those weights (Eq. 3).  Hidden layers concatenate their
heads, the output layer averages them.  The node's own row enters through the gated
residual (Eq. 5-6): ``r_i = W_r h_i + b_r``, ``beta_i = sigmoid(w_g . [h_i'; r_i; h_i' -
r_i])``, ``beta_i r_i + (1 - beta_i) h_i'``.  A hidden layer then applies LayerNorm (eps
1e-5) and, between layers, ReLU (UniMP's ogbn-products model).

The weights are the port's layout (``repro_torch.models.gnn.models.init_params``), drawn
in its order from the harness's generator: per layer ``w_q``, ``b_q``, ``w_k``, ``b_k``,
``w_v``, ``b_v`` (maps ``[in, H*D]``, biases ``[H, D]``), ``w_r [in, out]``, ``b_r
[out]``, ``w_g [3*out]`` and, on a hidden layer, LayerNorm's ``ln_w`` and ``ln_b``
``[out]``.

Departures from the paper, each written here:
  * no label input: UniMP adds a learned row of its label to a training node's input
    (masked label prediction); the model seam hands a layer feature rows alone;
  * neighbours are sampled with replacement at DCI's fan-outs, so a neighbour drawn
    twice has two slots and counts twice in the softmax; the node's own slot takes no
    part in it (PyG adds no self-loop); over the exact neighbourhood a multi-edge counts
    as often as it appears, and a node with no in-edge attends to nothing (0);
  * ``hidden_size`` 128 is read as one head's width, the 4 heads concatenated to 512
    (PyG's ``TransformerConv(128, heads=4, concat=True)``);
  * no dropout, on the inputs or on the coefficients: this is inference; no edge
    features (ogbn-products has none);
  * the logits are compared before any softmax;
  * the maps and biases are drawn normal and scaled by ``1/sqrt(fan-in)``, LayerNorm's
    ``ln_w`` as ``1 + 0.1 * normal`` and ``ln_b`` as ``0.1 * normal``, all nonzero, so
    every term the port's order moves or cancels enters the check.
"""

from __future__ import annotations

import math

import torch

activation = torch.relu
SUB_ROWS = 4096  # destinations a block is projected in, so float64 fits on the card


def dims(config: dict) -> list[int]:
    """Widths from input to logits: features, the concatenated heads, classes."""
    ds = config["dataset"]
    hidden = [h * config["head_dim"] for h in config["heads"][:-1]]
    return [ds["feat_dim"]] + hidden + [ds["num_classes"]]


def init(config: dict, gen, device) -> list[dict]:
    if config["activation"] != "relu" or config["layer_norm_eps"] != 1e-5:
        raise ValueError("the Graph Transformer runs LayerNorm (eps 1e-5) and ReLU between layers")
    widths = dims(config)
    heads = config["heads"]
    last = len(heads) - 1

    def normal(shape, fan_in=1):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

    params = []
    for i, h in enumerate(heads):
        width = widths[-1] if i == last else config["head_dim"]
        d_in, d_out = widths[i], widths[i + 1]
        layer = {}
        for name in "qkv":
            layer[f"w_{name}"] = normal((d_in, h * width), d_in)
            layer[f"b_{name}"] = normal((h, width), d_in)
        layer["w_r"] = normal((d_in, d_out), d_in)
        layer["b_r"] = normal((d_out,), d_in)
        layer["w_g"] = normal((3 * d_out,), 3 * d_out)
        if i != last:
            layer["ln_w"] = 1.0 + 0.1 * normal((d_out,))
            layer["ln_b"] = 0.1 * normal((d_out,))
        params.append(layer)
    return params


def _maps(p, x, dtype, name):
    """``x W + b`` for map ``name`` (q, k or v), ``[..., H, D]``."""
    heads, width = p[f"b_{name}"].shape
    return (x @ p[f"w_{name}"].to(dtype)).unflatten(-1, (heads, width)) + p[f"b_{name}"].to(dtype)


def _finish(p, agg, x_self, dtype, last):
    """Heads averaged (output) or concatenated, the gated residual, LayerNorm."""
    h = agg.mean(1) if last else agg.flatten(1)
    r = x_self @ p["w_r"].to(dtype) + p["b_r"].to(dtype)
    beta = torch.sigmoid(torch.cat([h, r, h - r], -1) @ p["w_g"].to(dtype))[:, None]
    out = beta * r + (1 - beta) * h
    if "ln_w" in p:
        out = torch.nn.functional.layer_norm(out, (out.shape[-1],), p["ln_w"].to(dtype),
                                             p["ln_b"].to(dtype), eps=1e-5)
    return out


def _block(p, x_self, nbr, dtype, last):
    width = p["b_q"].shape[1]
    q = _maps(p, x_self, dtype, "q")  # [rows, H, D]
    k, v = _maps(p, nbr, dtype, "k"), _maps(p, nbr, dtype, "v")  # [rows, fanout, H, D]
    alpha = torch.softmax((q[:, None] * k).sum(-1) / math.sqrt(width), dim=1)
    return _finish(p, (alpha[..., None] * v).sum(1), x_self, dtype, last)


def block_layer(p, x_self, nbr, fanout, dtype, *, last):
    return torch.cat([
        _block(p, x_self[r0:r0 + SUB_ROWS], nbr[r0:r0 + SUB_ROWS], dtype, last)
        for r0 in range(0, x_self.shape[0], SUB_ROWS)
    ])


def full_layer(p, x, dst, src, deg, dtype, edge_block, *, last):
    """Each node over its exact in-neighbourhood: a scatter maximum of the scores over
    the edges, then the sums of the weights and of the weighted values, ``edge_block``
    edges at a time.  A node with no in-edge sums nothing."""
    heads, width = p["b_q"].shape
    n = x.shape[0]
    q, k, v = (_maps(p, x, dtype, name) for name in "qkv")
    blocks = [(dst[e0:e0 + edge_block], src[e0:e0 + edge_block].to(torch.int64))
              for e0 in range(0, src.shape[0], edge_block)]
    m = torch.full((n, heads), -math.inf, dtype=dtype, device=x.device)
    for d, s in blocks:
        e = (q[d] * k[s]).sum(-1) / math.sqrt(width)
        m.scatter_reduce_(0, d[:, None].expand(-1, heads), e, "amax")
    den = torch.zeros((n, heads), dtype=dtype, device=x.device)
    num = torch.zeros_like(q)
    for d, s in blocks:
        wgt = torch.exp((q[d] * k[s]).sum(-1) / math.sqrt(width) - m[d])
        den.index_add_(0, d, wgt)
        num.index_add_(0, d, wgt[..., None] * v[s])
    agg = num / den.clamp_min(torch.finfo(dtype).tiny)[..., None]  # no in-edge: 0 / tiny = 0
    return _finish(p, agg, x, dtype, last)


def layer_flops(rows, terms, d_in, d_out, *, config, layer):
    """One layer in the order that needs the fewest operations (the port's): each
    destination's query map and its bias add, the query folded through each head's
    key map (``u = W_k q / sqrt(D)``, the scale inside the query map's product), a
    score per neighbour and head (a dot of length ``d_in``), the weighted sums of the
    neighbours' input rows, one value map per head of the ``d_in``-wide sums (at the
    averaged output the heads' sum is inside the same products, and the average's
    scale is one multiply an output), the value bias, the skip's product and bias, and
    the gate: ``h' - r``, the dot with ``w_g`` over ``3 * d_out``, and the mix (a
    multiply and a subtract an output).  The key bias cancels in the softmax and is
    not computed.  The softmax (its exponentials, maxima, running sums and
    normalisation), the gate's sigmoid and LayerNorm are not counted, as an activation
    is not, so the count reads low and a share of the peak cannot pass 100%."""
    heads = config["heads"][layer]
    last = layer == len(config["heads"]) - 1
    width = d_out if last else d_out // heads
    query = 2 * rows * d_in * heads * width + rows * heads * width
    fold = 2 * rows * heads * width * d_in
    scores = 2 * terms * heads * d_in
    attend = 2 * terms * heads * d_in
    values = 2 * rows * heads * d_in * width + (rows * d_out if last else 0) + rows * d_out
    skip = 2 * rows * d_in * d_out + rows * d_out
    gate = rows * d_out + 2 * rows * 3 * d_out + 2 * rows * d_out
    return query + fold + scores + attend + values + skip + gate


def attend_bytes(d_in, d_out, *, config, layer, dst, positions, distinct_rows, indexed):
    """The least bytes any implementation of one layer's attention over ``dst``
    destinations and ``positions`` row slots must move: each distinct input row read
    once at ``d_in`` floats (``distinct_rows``: at a sampled layer 0 read through the
    dedup inverse map, the frontier's distinct rows; in place, every position's row;
    the destinations' own rows among them, from which their queries come), 4 bytes of
    index a position where the rows are read through one, and each destination's
    output written once, at the narrower of the heads' ``H * d_in`` sums and the
    layer's ``d_out`` outputs.  As GAT's count (``bench/models/gat.py``): the queries
    folded through the key maps are the port's own intermediate, not counted."""
    heads = config["heads"][layer]
    index = positions if indexed else 0
    return 4 * (distinct_rows * d_in + index + dst * min(heads * d_in, d_out))
