"""The model's floating-point operations, counted from shapes alone.

Each multiply and each add is one operation.  A layer aggregates its
neighbours' rows (GraphSAGE sums them; GCN adds the node's own row to the
sum and divides by the count) and applies its linear maps: GraphSAGE two
products and two adds per output (the self and neighbour maps and the
bias), GCN one product and one add.  ReLU is not counted.

Peaks, published for an H100 SXM at its 700 W limit: float32 outside the
tensor cores 67 TFLOP/s (the port computes the GNN in float32 with TF32
off); TF32 495 TFLOP/s.
"""

from __future__ import annotations

__all__ = ["FP32_PEAK", "TF32_PEAK", "full_graph_flops", "layer_dims", "sampled_flops"]

FP32_PEAK = 67e12
TF32_PEAK = 495e12


def layer_dims(config: dict) -> list[int]:
    """Widths from input to logits: features, hidden ones, classes."""
    ds = config["dataset"]
    return [ds["feat_dim"]] + [config["hidden"]] * (config["layers"] - 1) + [ds["num_classes"]]


def _layer_flops(model: str, rows: int, terms: int, d_in: int, d_out: int) -> int:
    """One layer over ``rows`` destination rows aggregating ``terms``
    neighbour rows in all."""
    if model == "graphsage":
        return (terms - rows) * d_in + 2 * (2 * rows * d_in * d_out) + 2 * rows * d_out
    return terms * d_in + rows * d_in + 2 * rows * d_in * d_out + rows * d_out


def sampled_flops(model: str, batch: int, fanouts, dims) -> int:
    """One sampled batch of ``batch`` seeds (``fanouts`` outermost first)."""
    rev = tuple(reversed(fanouts))
    sizes = [batch]
    for f in rev:
        sizes.append(sizes[-1] * (1 + f))
    total = 0
    for li, l in enumerate(range(len(rev) - 1, -1, -1)):
        total += _layer_flops(model, sizes[l], sizes[l] * rev[l], dims[li], dims[li + 1])
    return total


def full_graph_flops(model: str, num_nodes: int, num_edges: int, dims) -> int:
    """Every node over its exact neighbourhood, every layer (a graph whose
    nodes all have a neighbour, as the stand-in's do)."""
    return sum(
        _layer_flops(model, num_nodes, num_edges, dims[i], dims[i + 1])
        for i in range(len(dims) - 1)
    )
