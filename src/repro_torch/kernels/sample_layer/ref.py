"""Plain-torch version of one layer of neighbour sampling.

The CPU route of :func:`~repro_torch.kernels.sample_layer.kernel.sample_layer`
and the oracle the CUDA kernel is held to, bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["sample_layer_ref", "slots_from_uniforms"]


def slots_from_uniforms(deg: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Slot draws ``r = min(trunc(u * max(deg, 1)), max(deg, 1) - 1)``,
    ``int32[S, fanout]``, from float64 uniforms ``u [S, fanout]`` and the
    seeds' degrees ``deg [S]``: clamped below ``deg`` so rounding can never
    reach it."""
    d = deg.clamp_min(1).to(torch.int64)[:, None]
    return torch.minimum((u * d).to(torch.int64), d - 1).to(torch.int32)


def sample_layer_ref(
    graph,
    seeds: torch.Tensor,
    draws: torch.Tensor,
    nbr: torch.Tensor,
    hit_count: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's neighbours, written into ``nbr [S * fanout]``, with
    ``hit_count`` (an int64 scalar) raised by the layer's hits.

    ``draws`` is ``u`` (float64 uniforms, turned into slots by
    :func:`slots_from_uniforms`) or the slots ``r`` (int32) themselves.
    Returns ``(hits[S, fanout], edge_slots[S, fanout])``: a hit is the
    paper's single compare ``r < cached_len[v]`` (Fig. 6c) and reads the
    compact cache arrays, a miss the full (two-level-sorted) CSC;
    ``edge_slots = col_ptr[v] + r`` unclamped.  A zero-degree seed loops to
    itself, counted as a hit.  The ``row_index`` read clamps (a trailing
    isolated node's slot is ``E``)."""
    s64 = seeds.to(torch.int64)
    start = graph.col_ptr[s64]  # [S]
    deg = graph.col_ptr[s64 + 1] - start  # [S]
    r = draws if draws.dtype == torch.int32 else slots_from_uniforms(deg, draws)
    edge_slots = start[:, None] + r
    num_edges = graph.row_index.shape[0]
    host_nbr = graph.row_index[edge_slots.to(torch.int64).clamp_(0, max(num_edges - 1, 0))]

    clen = graph.cached_len[s64]  # [S]
    hit = r < clen[:, None]
    cache_idx = graph.cache_ptr[s64][:, None] + torch.minimum(r, (clen - 1).clamp_min(0)[:, None])
    cache_idx = cache_idx.to(torch.int64).clamp_max_(graph.cache_row_index.shape[0] - 1)
    cache_nbr = graph.cache_row_index[cache_idx]
    out = torch.where(hit, cache_nbr, host_nbr)

    isolated = (deg == 0)[:, None]
    out = torch.where(isolated, seeds[:, None], out)
    hit = hit | isolated
    nbr.copy_(out.reshape(-1))
    hit_count.add_(hit.sum())
    return hit, edge_slots
