"""Compressed-sparse-column graph storage (paper §II-C, Fig. 4).

The CSC layout is what neighbor sampling reads: ``col_ptr[v] ..
col_ptr[v+1]`` delimits the in-neighbor list of node ``v`` inside
``row_index``.  DCI's adjacency cache (Fig. 6 / Alg. 1) is a *prefix* of a
two-level-sorted copy of these arrays, so this module also implements the
two-level reorder:

  level 1: nodes ordered by total visit count (descending)     -> fill order
  level 2: within each node, neighbors ordered by visit count  -> prefix
           (descending), so the cached prefix holds the hottest elements

All arrays are int32; ``Values`` from the paper is implicit (unweighted
graphs, all ones), matching what sampling actually touches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CSCGraph",
    "two_level_sort",
    "node_visit_totals",
    "build_adj_cache",
    "refresh_adj_cache",
    "AdjRefreshStats",
]


@dataclasses.dataclass(frozen=True)
class CSCGraph:
    """An unweighted directed graph in CSC form (host arrays)."""

    col_ptr: np.ndarray  # int64[N+1] offsets (int64: E can exceed int32 at scale)
    row_index: np.ndarray  # int32[E] in-neighbor ids

    def __post_init__(self):
        if self.col_ptr.ndim != 1 or self.row_index.ndim != 1:
            raise ValueError("col_ptr and row_index must be 1-D")
        if self.col_ptr[0] != 0 or self.col_ptr[-1] != self.row_index.shape[0]:
            raise ValueError("col_ptr must start at 0 and end at num_edges")
        if np.any(np.diff(self.col_ptr) < 0):
            raise ValueError("col_ptr must be non-decreasing")

    @property
    def num_nodes(self) -> int:
        return self.col_ptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.row_index.shape[0]

    def degrees(self) -> np.ndarray:
        return np.diff(self.col_ptr).astype(np.int32)

    def nbytes(self) -> int:
        return self.col_ptr.nbytes + self.row_index.nbytes


def two_level_sort(graph: CSCGraph, edge_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fig. 6(b): sort each node's neighbor list by visit count, descending.

    Returns ``(sorted_row_index, node_totals)``.  ``sorted_row_index`` is a
    full-length copy of ``row_index`` where every column's elements are in
    descending visit-count order (level-2 sort); ``node_totals`` is the
    per-node total visit count used for the level-1 (fill-order) sort.

    Implemented as one vectorized lexsort over (column id asc, count desc)
    instead of a Python loop over nodes — this is part of why DCI's
    preprocessing is lightweight.
    """
    if edge_counts.shape != graph.row_index.shape:
        raise ValueError("edge_counts must align with row_index")
    n = graph.num_nodes
    col_of_edge = np.repeat(np.arange(n, dtype=np.int64), np.diff(graph.col_ptr))
    # lexsort: primary key last. Sort by column asc, then count desc.
    order = np.lexsort((-edge_counts.astype(np.int64), col_of_edge))
    sorted_row_index = graph.row_index[order]
    return sorted_row_index, node_visit_totals(graph, edge_counts)


def node_visit_totals(graph: CSCGraph, edge_counts: np.ndarray) -> np.ndarray:
    """Per-node total visit count — the level-1 (fill-order) sort key.

    Split out of :func:`two_level_sort` because the serve-time refresh
    re-ranks nodes from updated counts WITHOUT re-sorting the row index
    (the sorted order is frozen at build time; see refresh_adj_cache)."""
    n = graph.num_nodes
    # The refresh path feeds decayed (float) counts; only relative order
    # matters for the fill, so keep float inputs un-truncated.
    dtype = np.float64 if np.issubdtype(edge_counts.dtype, np.floating) else np.int64
    if graph.num_edges:
        # reduceat requires start indices < num_edges; zero-degree nodes can
        # point at the very end — clip, then mask them out below.
        starts = np.minimum(graph.col_ptr[:-1], graph.num_edges - 1)
        node_totals = np.add.reduceat(edge_counts.astype(dtype), starts, dtype=dtype)
    else:
        node_totals = np.zeros(n, dtype)
    # reduceat quirk: zero-degree nodes repeat the next segment; mask them.
    return np.where(np.diff(graph.col_ptr) > 0, node_totals, 0)


@dataclasses.dataclass(frozen=True)
class AdjCache:
    """Device-resident prefix cache of the two-level-sorted CSC (Fig. 6c).

    ``cached_len[v]`` elements of node ``v``'s sorted neighbor list live in
    the cache; the sampler's hit test is ``slot < cached_len[v]``.
    """

    cache_ptr: np.ndarray  # int64[N+1] offsets into cache_row_index
    cache_row_index: np.ndarray  # int32[sum(cached_len)]
    cached_len: np.ndarray  # int32[N]

    @property
    def num_cached_elements(self) -> int:
        return self.cache_row_index.shape[0]

    def nbytes(self) -> int:
        # What the budget pays for: the cached elements themselves. The
        # ptr/len arrays are O(N) bookkeeping shared with the host copy.
        return self.cache_row_index.nbytes


BYTES_PER_ADJ_ELEMENT = 4  # int32 row index


def _prefix_lengths(graph: CSCGraph, node_totals: np.ndarray, capacity_bytes: int) -> np.ndarray:
    """Alg. 1's per-node cached-prefix lengths for a given budget.

    If the whole (sorted) CSC fits, cache it all (Alg. 1 lines 2-4).
    Otherwise fill whole nodes in descending ``node_totals`` order, and cut
    the last node's list where the budget runs out (lines 5-17)."""
    n = graph.num_nodes
    degrees = np.diff(graph.col_ptr)
    budget_elems = max(int(capacity_bytes) // BYTES_PER_ADJ_ELEMENT, 0)

    if graph.num_edges * BYTES_PER_ADJ_ELEMENT <= capacity_bytes:
        return degrees.astype(np.int32)
    fill_order = np.argsort(-node_totals, kind="stable")
    csum = np.cumsum(degrees[fill_order])
    fully = csum <= budget_elems
    cached_len = np.zeros(n, np.int64)
    cached_len[fill_order[fully]] = degrees[fill_order[fully]]
    # Partial fill of the first node that did not fully fit.
    n_full = int(fully.sum())
    if n_full < n:
        used = int(csum[n_full - 1]) if n_full > 0 else 0
        v = fill_order[n_full]
        cached_len[v] = min(budget_elems - used, degrees[v])
    return cached_len.astype(np.int32)


def build_adj_cache(
    graph: CSCGraph,
    sorted_row_index: np.ndarray,
    node_totals: np.ndarray,
    capacity_bytes: int,
) -> AdjCache:
    """Algorithm 1: fill the adjacency cache up to ``capacity_bytes``."""
    n = graph.num_nodes
    cached_len = _prefix_lengths(graph, node_totals, capacity_bytes)

    cache_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(cached_len, out=cache_ptr[1:])
    # Gather each node's prefix from the sorted copy — vectorized ragged
    # arange (no per-node Python loop; preprocessing must stay lightweight).
    total = int(cache_ptr[-1])
    if total > 0:
        lens = cached_len.astype(np.int64)
        idx = (
            np.repeat(graph.col_ptr[:-1], lens)
            + np.arange(total, dtype=np.int64)
            - np.repeat(cache_ptr[:-1], lens)
        )
        cache_row_index = sorted_row_index[idx].astype(np.int32)
    else:
        cache_row_index = np.empty(0, np.int32)
    return AdjCache(cache_ptr=cache_ptr, cache_row_index=cache_row_index, cached_len=cached_len)


@dataclasses.dataclass(frozen=True)
class AdjRefreshStats:
    """What an adjacency-cache delta re-fill actually moved."""

    nodes_changed: int  # nodes whose cached prefix length changed
    elements_kept: int  # elements copied segment-wise from the old cache
    elements_regathered: int  # elements re-gathered from the sorted host CSC
    cached_elements: int  # total cached elements after the refresh
    budget_elements: int

    @property
    def changed(self) -> bool:
        return self.nodes_changed > 0


def refresh_adj_cache(
    graph: CSCGraph,
    sorted_row_index: np.ndarray,
    old: AdjCache,
    node_totals: np.ndarray,
    capacity_bytes: int,
) -> tuple[AdjCache, AdjRefreshStats]:
    """Incremental Alg. 1 re-fill against UPDATED per-node visit totals.

    The two-level sort order is frozen at build time: a node's cached
    prefix of length L is always ``sorted_row_index[col_ptr[v] :
    col_ptr[v] + L]``, whatever epoch filled it.  That invariant is what
    makes the refresh a *delta*: only the level-1 ranking (which nodes,
    how much of each list) moves, so

      * nodes whose prefix length is unchanged have their segment copied
        straight from the old cache arrays (compact memcpy, no gather
        into the full E-sized CSC);
      * only changed nodes' segments are re-gathered from the sorted host
        copy;
      * the device-resident ``col_ptr`` / ``row_index`` (the O(E) arrays)
        are never touched or re-uploaded — only the cache-sized arrays
        move, which is the bounded pause the refresh subsystem promises.

    Freezing the level-2 (within-node) order also keeps sampling
    bit-identical across epochs: a cache hit reads the same neighbor the
    sorted host copy holds at that slot, so a refresh changes hit
    accounting and byte movement, never sampled blocks or outputs.
    """
    n = graph.num_nodes
    new_len = _prefix_lengths(graph, node_totals, capacity_bytes)
    old_len = old.cached_len.astype(np.int64)
    changed = new_len.astype(np.int64) != old_len

    cache_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(new_len, out=cache_ptr[1:])
    total = int(cache_ptr[-1])
    if total > 0:
        lens = new_len.astype(np.int64)
        within = np.arange(total, dtype=np.int64) - np.repeat(cache_ptr[:-1], lens)
        elem_changed = np.repeat(changed, lens)
        cache_row_index = np.empty(total, np.int32)
        keep = ~elem_changed
        if keep.any():
            old_pos = np.repeat(old.cache_ptr[:-1], lens)[keep] + within[keep]
            cache_row_index[keep] = old.cache_row_index[old_pos]
        if elem_changed.any():
            new_pos = np.repeat(graph.col_ptr[:-1], lens)[elem_changed] + within[elem_changed]
            cache_row_index[elem_changed] = sorted_row_index[new_pos].astype(np.int32)
        regathered = int(elem_changed.sum())
    else:
        cache_row_index = np.empty(0, np.int32)
        regathered = 0
    new = AdjCache(cache_ptr=cache_ptr, cache_row_index=cache_row_index, cached_len=new_len)
    return new, AdjRefreshStats(
        nodes_changed=int(changed.sum()),
        elements_kept=total - regathered,
        elements_regathered=regathered,
        cached_elements=total,
        budget_elements=max(int(capacity_bytes) // BYTES_PER_ADJ_ELEMENT, 0),
    )
