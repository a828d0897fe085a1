"""The model's floating-point operations, counted from shapes alone.

Each multiply and each add is one operation; the activation is not counted.
One layer's count is the model's own (``layer_flops`` in
``bench/models/<model>.py``); this module counts the layers of a sampled
batch and of the full graph.

Peaks, published for an H100 SXM at its 700 W limit: float32 outside the
tensor cores 67 TFLOP/s (the port computes the GNN in float32 with TF32
off); TF32 495 TFLOP/s.
"""

from __future__ import annotations

from bench import models

__all__ = ["FP32_PEAK", "TF32_PEAK", "full_graph_flops", "layer_dims", "sampled_flops"]

FP32_PEAK = 67e12
TF32_PEAK = 495e12


def layer_dims(config: dict) -> list[int]:
    """Widths from input to logits, as the configuration's model gives them."""
    return models.load(config["model"]).dims(config)


def sampled_flops(model: str, batch: int, fanouts, dims, config: dict | None = None) -> int:
    """One sampled batch of ``batch`` seeds (``fanouts`` outermost first)
    through model ``model`` of widths ``dims``."""
    layer_flops = models.load(model).layer_flops
    rev = tuple(reversed(fanouts))
    sizes = [batch]
    for f in rev:
        sizes.append(sizes[-1] * (1 + f))
    total = 0
    for li, l in enumerate(range(len(rev) - 1, -1, -1)):
        total += layer_flops(sizes[l], sizes[l] * rev[l], dims[li], dims[li + 1],
                             config=config, layer=li)
    return total


def full_graph_flops(model: str, num_nodes: int, num_edges: int, dims,
                     config: dict | None = None) -> int:
    """Every node over its exact neighbourhood, every layer (a graph whose
    nodes all have a neighbour, as the stand-in's do)."""
    layer_flops = models.load(model).layer_flops
    return sum(
        layer_flops(num_nodes, num_edges, dims[i], dims[i + 1], config=config, layer=i)
        for i in range(len(dims) - 1)
    )
