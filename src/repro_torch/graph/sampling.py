"""Vectorized neighbor sampling (paper §II-B) with optional adjacency cache.

For every seed node the sampler draws ``fanout`` uniform slots
``r ~ U[0, deg)`` and reads the neighbor at that slot.  With DCI's
adjacency cache active, the hit test is the paper's single compare
``r < cached_len[v]`` (Fig. 6c): hits read from the compact cache arrays,
misses fall back to the (two-level-sorted) full CSC.  The whole CSC and the
adjacency cache live on the device, as in the reference.

Zero-degree nodes self-loop (counted as hits: no host access is needed).
Sampling is with replacement.

The RNG seam: JAX's threefry cannot be reproduced in torch, so the draw of
``r`` is separate from its resolution.  :func:`sample_neighbors` draws
float64 uniforms ``u`` from a ``torch.Generator`` (one ``torch.rand`` call
a layer) unless the caller passes ``r``, then resolves them exactly as the
reference does; :func:`sample_blocks` takes either a generator or one
``r`` tensor per layer.  A layer is resolved by
:func:`~repro_torch.kernels.sample_layer.kernel.sample_layer`: one CUDA
launch on a card, the plain torch version (its ``ref.py``) on the CPU.

Out-of-range slots: the edge slot of a zero-degree node is ``col_ptr[v]``,
which equals ``E`` for a trailing isolated node.  JAX clamps such a gather
index and drops such a scatter index; a CUDA index asserts instead.  So the
``row_index`` read clamps, ``edge_slots`` are returned unclamped, and
:func:`count_visits` drops slots ``>= E``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.graph.csc import AdjCache, CSCGraph
from repro_torch.kernels.sample_layer.kernel import sample_layer

__all__ = [
    "DeviceGraph",
    "BlockSample",
    "DedupFrontier",
    "add_visits",
    "count_visits",
    "dedup_frontier",
    "device_graph",
    "pow2_bucket",
    "sample_neighbors",
    "sample_blocks",
]


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Graph structure as device tensors, with an optional adjacency cache.

    Without a cache, ``row_index`` is the original CSC order and
    ``cached_len`` is all zeros.  With a cache, ``row_index`` MUST be the
    two-level-sorted copy (slots refer to sorted order on both paths).
    """

    col_ptr: torch.Tensor  # int32[N+1]
    row_index: torch.Tensor  # int32[E]
    cache_ptr: torch.Tensor  # int32[N+1]
    cache_row_index: torch.Tensor  # int32[>=1] (padded to at least 1)
    cached_len: torch.Tensor  # int32[N]

    @property
    def num_nodes(self) -> int:
        return self.col_ptr.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.col_ptr.device


def device_graph(
    graph: CSCGraph,
    *,
    device: torch.device,
    sorted_row_index: np.ndarray | None = None,
    adj_cache: AdjCache | None = None,
) -> DeviceGraph:
    """Stage a CSC graph (and optionally its DCI adjacency cache) on ``device``."""
    n = graph.num_nodes
    if adj_cache is not None:
        if sorted_row_index is None:
            raise ValueError("adjacency cache requires the two-level-sorted row_index")
        row = sorted_row_index
        cache_ptr = adj_cache.cache_ptr
        cache_row = adj_cache.cache_row_index
        cached_len = adj_cache.cached_len
    else:
        row = graph.row_index if sorted_row_index is None else sorted_row_index
        cache_ptr = np.zeros(n + 1, np.int32)
        cache_row = np.empty(0, np.int32)
        cached_len = np.zeros(n, np.int32)
    if cache_row.shape[0] == 0:
        cache_row = np.zeros(1, np.int32)  # keep gathers well-defined

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return DeviceGraph(
        col_ptr=put(graph.col_ptr),
        row_index=put(row),
        cache_ptr=put(cache_ptr),
        cache_row_index=put(cache_row),
        cached_len=put(cached_len),
    )


@dataclasses.dataclass(frozen=True)
class DedupFrontier:
    """Sorted-unique view of one frontier, with static shapes.

    ``unique_ids[:num_unique]`` are the frontier's distinct node ids in
    ascending order; positions at and beyond ``num_unique`` repeat a pad
    id: the caller's ``pad_id`` (a known-cached node, so pad slots resolve
    as cache hits), or the frontier's largest id when no pad is given or
    ``pad_id < 0``.  ``inverse`` maps every frontier position to its slot
    in ``unique_ids``, so ``unique_ids[inverse]`` reconstructs the frontier
    bit for bit.  ``num_unique`` stays a device scalar; the runtime reads
    it once per batch to pick the pow2 gather bucket (:func:`pow2_bucket`).
    """

    unique_ids: torch.Tensor  # int32[S] sorted; tail padded with a cached (or max) id
    inverse: torch.Tensor  # int32[S] frontier position -> slot in unique_ids
    num_unique: torch.Tensor  # int64[] distinct-id count


def dedup_frontier(frontier: torch.Tensor, pad_id: int | None = None) -> DedupFrontier:
    """Sort-and-unique one frontier on its device with static output shapes.

    One sort + one cumsum + two scatters, no host round trip.  Duplicate
    positions scatter the same value to the same slot, so the result does
    not depend on scatter order."""
    ids = frontier.to(torch.int32)
    sorted_ids, order = torch.sort(ids)
    is_new = torch.ones_like(sorted_ids, dtype=torch.bool)
    is_new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = torch.cumsum(is_new, 0) - 1  # int64
    fill = sorted_ids[-1:]
    if pad_id is not None and pad_id >= 0:
        fill = torch.full_like(fill, pad_id)
    unique = fill.expand(ids.shape[0]).clone()
    unique.scatter_(0, rank, sorted_ids)
    inverse = torch.empty_like(ids)
    inverse.scatter_(0, order, rank.to(torch.int32))
    return DedupFrontier(unique_ids=unique, inverse=inverse, num_unique=rank[-1] + 1)


def pow2_bucket(n: int, cap: int | None = None) -> int:
    """Smallest power of two >= ``max(n, 1)``, optionally capped at ``cap``."""
    bucket = 1 << max(int(n) - 1, 0).bit_length()
    return bucket if cap is None else min(bucket, int(cap))


def _layer_draws(
    g: DeviceGraph,
    seeds: torch.Tensor,
    fanout: int,
    generator: torch.Generator | None,
    r: torch.Tensor | None,
    full_neighborhood: bool,
) -> torch.Tensor:
    """One layer's draws for :func:`sample_layer`: the slots ``r`` (int32)
    when given or enumerated, else ``u ~ U[0, 1)`` in float64 from
    ``generator`` (on ``g``'s device), one ``torch.rand`` call a layer."""
    if full_neighborhood:
        s64 = seeds.to(torch.int64)
        deg = g.col_ptr[s64 + 1] - g.col_ptr[s64]
        slots = torch.arange(fanout, dtype=torch.int32, device=g.device)
        return slots[None, :] % deg.clamp_min(1)[:, None]
    if r is not None:
        return r.to(device=g.device, dtype=torch.int32)
    if generator is None:
        raise ValueError("sampling needs a generator or the slot draws r")
    return torch.rand(
        (seeds.shape[0], fanout), generator=generator, dtype=torch.float64, device=g.device
    )


def sample_neighbors(
    g: DeviceGraph,
    seeds: torch.Tensor,
    fanout: int,
    *,
    generator: torch.Generator | None = None,
    r: torch.Tensor | None = None,
    full_neighborhood: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` in-neighbors per seed (with replacement).

    Returns ``(neighbors[S, fanout], hits[S, fanout], edge_slots[S, fanout])``
    where ``edge_slots`` are the global positions ``col_ptr[v] + r`` used for
    visit counting during pre-sampling (unclamped; see the module note).

    ``r`` gives the slot draws directly; otherwise they are drawn from
    ``generator``: ``r = min(trunc(u * max(deg, 1)), max(deg, 1) - 1)`` for
    float64 uniforms ``u``.  ``full_neighborhood=True`` replaces the draw
    with the enumeration ``r = arange(fanout) % max(deg, 1)``: a seed whose
    degree equals ``fanout`` takes every neighbor exactly once, so the
    sampled aggregate IS the full-neighborhood sum (the bridge of the
    layer-wise equivalence tests); higher degrees truncate to the first
    ``fanout`` slots, lower ones wrap."""
    seeds = seeds.to(device=g.device, dtype=torch.int32)
    draws = _layer_draws(g, seeds, fanout, generator, r, full_neighborhood)
    nbr = torch.empty(seeds.shape[0] * fanout, dtype=torch.int32, device=g.device)
    hits = torch.zeros((), dtype=torch.int64, device=g.device)
    hit, edge_slots = sample_layer(g, seeds, draws, nbr, hits)
    return nbr.view(seeds.shape[0], fanout), hit, edge_slots


@dataclasses.dataclass(frozen=True)
class BlockSample:
    """Layered mini-batch (GraphSAGE-style blocks).

    ``frontiers[0]`` are the batch seeds; ``frontiers[l+1]`` has layout
    ``[frontiers[l] | neighbors_l.reshape(-1)]`` so the model can split a
    feature matrix over frontier ``l+1`` into (self, neighbors) parts by a
    reshape.  ``input_nodes`` is the deepest frontier — the rows the
    feature loader must fetch.  ``dedup`` is the sorted-unique view of the
    deepest frontier (``sample_blocks(dedup=True)``), else ``None``.
    Every frontier is a prefix view of one buffer, the deepest frontier's.
    """

    frontiers: tuple[torch.Tensor, ...]
    neighbor_hits: tuple[torch.Tensor, ...]  # per layer, [S_l, fanout_l]
    edge_slots: tuple[torch.Tensor, ...]
    fanouts: tuple[int, ...]
    hit_count: torch.Tensor  # int64[], the hits of every layer
    dedup: DedupFrontier | None = None

    @property
    def input_nodes(self) -> torch.Tensor:
        return self.frontiers[-1]

    def adj_hit_stats(self) -> tuple[torch.Tensor, int]:
        """``(hits, lookups)``: a device scalar and a host int."""
        return self.hit_count, sum(h.numel() for h in self.neighbor_hits)


def sample_blocks(
    g: DeviceGraph,
    seeds: torch.Tensor,
    fanouts: tuple[int, ...],
    *,
    generator: torch.Generator | None = None,
    draws: Sequence[torch.Tensor] | None = None,
    dedup: bool = False,
    dedup_pad_id: int | None = None,
    full_neighborhood: bool = False,
) -> BlockSample:
    """Multi-layer fan-out sampling producing GraphSAGE blocks.

    ``fanouts`` is listed outermost-layer-first (the paper's '15,10,5'
    convention); layer 0 of the expansion uses the *last* element.
    ``draws[i]`` (if given) is expansion layer ``i``'s ``r`` tensor of
    shape ``[S_i, fanouts[-1 - i]]``; otherwise each layer draws from
    ``generator``.  ``dedup=True`` also sorts-and-uniques the deepest
    frontier (:func:`dedup_frontier`, padded with ``dedup_pad_id``);
    sampling itself is identical with the flag on or off.
    ``full_neighborhood=True`` enumerates every layer's slots instead of
    drawing them (:func:`sample_neighbors`) and needs no draws."""
    rev = tuple(reversed(fanouts))
    if draws is not None and len(draws) != len(rev):
        raise ValueError(f"need one draw tensor per layer ({len(rev)}), got {len(draws)}")
    sizes = [seeds.shape[0]]
    for fanout in rev:
        sizes.append(sizes[-1] * (1 + fanout))
    # The deepest frontier, allocated once: layer i reads its prefix
    # buf[:sizes[i]] as seeds and writes its neighbours right behind it.
    buf = torch.empty(sizes[-1], dtype=torch.int32, device=g.device)
    buf[: sizes[0]].copy_(seeds)
    hit_count = torch.zeros((), dtype=torch.int64, device=g.device)
    frontiers = []
    hits_all = []
    slots_all = []
    for i, fanout in enumerate(rev):
        frontier = buf[: sizes[i]]
        layer_draws = _layer_draws(
            g,
            frontier,
            fanout,
            generator,
            None if draws is None else draws[i],
            full_neighborhood,
        )
        hit, slots = sample_layer(g, frontier, layer_draws, buf[sizes[i] : sizes[i + 1]], hit_count)
        frontiers.append(frontier)
        hits_all.append(hit)
        slots_all.append(slots)
    frontiers.append(buf)
    return BlockSample(
        frontiers=tuple(frontiers),
        neighbor_hits=tuple(hits_all),
        edge_slots=tuple(slots_all),
        fanouts=tuple(fanouts),
        hit_count=hit_count,
        dedup=dedup_frontier(buf, dedup_pad_id) if dedup else None,
    )


def add_visits(
    node_counts: torch.Tensor, edge_counts: torch.Tensor, block: BlockSample
) -> None:
    """Accumulate one block's visits in place: each input-frontier node
    once per occurrence, each touched edge slot once per draw.  Slots
    ``>= E`` (trailing isolated nodes) are dropped, as the reference's
    scatter drops them."""
    nodes = block.input_nodes.to(torch.int64)
    node_counts.index_add_(0, nodes, torch.ones_like(nodes, dtype=node_counts.dtype))
    num_edges = edge_counts.shape[0]
    for slots in block.edge_slots if num_edges else ():
        flat = slots.reshape(-1).to(torch.int64)
        # An out-of-range slot adds 0 at a clamped index: no boolean mask,
        # so no device-to-host sync for its count.
        keep = (flat < num_edges).to(edge_counts.dtype)
        edge_counts.index_add_(0, flat.clamp_max(max(num_edges - 1, 0)), keep)


def count_visits(
    num_nodes: int, num_edges: int, blocks: Sequence[BlockSample]
) -> tuple[np.ndarray, np.ndarray]:
    """Pre-sampling visit counters (paper §IV-B), as ``int32`` host arrays.

    Node counts = how often each node's *feature* row is loaded (membership
    in input frontiers); edge counts = how often each adjacency element is
    touched by sampling."""
    device = blocks[0].input_nodes.device if blocks else torch.device("cpu")
    node_counts = torch.zeros(num_nodes, dtype=torch.int32, device=device)
    edge_counts = torch.zeros(num_edges, dtype=torch.int32, device=device)
    for b in blocks:
        add_visits(node_counts, edge_counts, b)
    return node_counts.cpu().numpy(), edge_counts.cpu().numpy()
