"""What GraphSAGE and GCN share: one hidden width, weights drawn alike, and the
exact neighbourhood's sum."""

from __future__ import annotations

import math

import torch

__all__ = ["dims", "edge_sum", "init"]


def dims(config: dict) -> list[int]:
    """Widths from input to logits: features, hidden ones, classes."""
    ds = config["dataset"]
    return [ds["feat_dim"]] + [config["hidden"]] * (config["layers"] - 1) + [ds["num_classes"]]


def init(config: dict, gen, device, names) -> list[dict]:
    """Each layer's maps ``names`` normal, scaled by ``1/sqrt(fan-in)``, drawn in
    that order, and a zero bias ``b`` (the engine's own initialisation)."""
    widths = dims(config)
    params = []
    for i in range(len(widths) - 1):
        scale = 1.0 / math.sqrt(widths[i])
        layer = {
            k: torch.randn((widths[i], widths[i + 1]), generator=gen, device=device) * scale
            for k in names
        }
        layer["b"] = torch.zeros(widths[i + 1], device=device)
        params.append(layer)
    return params


def edge_sum(x, dst, src, edge_block: int) -> torch.Tensor:
    """Each node's sum of its in-neighbours' rows, in edge order, ``edge_block``
    edges at a time."""
    agg = torch.zeros_like(x)
    for e0 in range(0, src.shape[0], edge_block):
        e1 = min(e0 + edge_block, src.shape[0])
        agg.index_add_(0, dst[e0:e1], x[src[e0:e1].to(torch.int64)])
    return agg
