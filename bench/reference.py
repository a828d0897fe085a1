"""The plain reference the benchmark judges the program by.

Plain PyTorch, written from the DCI paper's description and the
configuration, with no kernel, cache or batching of the program's and no
import of it.  It takes the inputs the benchmark made (the graph, the
features, the weights and the seeds of the random draws) and works out
again what the program's set-up derives from them:

  * the presampling visit counts (paper section IV-B), which fix
  * the two-level neighbour order (Fig. 6b: each node's in-neighbours by
    visit count, descending, ties in CSC order), from whose slots the
    sampler draws, and the per-node visit totals;
  * Alg. 1's adjacency-cache prefix lengths and the sort-free hot feature
    rows, for a given capacity split;
  * the sampled blocks of every batch and their adjacency and feature
    hits (exact counts);
  * the logits, in float64 (or, for the precision control, in float32
    with TF32 on), of a sampled forward or of the exact full-graph
    forward of the layer-wise mode, each layer through the configuration's
    model file (``bench/models/<model>.py``, handed in by the caller).

The random draws: a slot for seed ``v`` is ``min(floor(u * deg(v)),
deg(v) - 1)`` with ``u`` from ``torch.rand(..., dtype=float64)`` on a
``torch.Generator`` of the run's device, one call per layer and batch, in
batch order (the uniform with-replacement sampling of paper section
II-B).  Given the generator's seed the reference draws the same ``u``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = [
    "Caches",
    "Replay",
    "adj_prefix_lengths",
    "block_forward",
    "caches_for",
    "eq1_split",
    "frontier_sizes",
    "full_forward",
    "hot_rows",
    "node_totals",
    "precision",
    "presample_counts",
    "two_level_rows",
]


@contextlib.contextmanager
def precision(tf32: bool):
    """Products in full float32 (``tf32=False``) or through TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def frontier_sizes(batch: int, fanouts) -> list[int]:
    """Rows of each frontier, seeds first; expansion runs innermost fan-out
    first (``fanouts`` is listed outermost first, as '15,10,5')."""
    sizes = [batch]
    for f in reversed(fanouts):
        sizes.append(sizes[-1] * (1 + f))
    return sizes


@dataclasses.dataclass
class Block:
    frontier: torch.Tensor  # int64, the deepest frontier (the input rows)
    adj_hits: int
    adj_lookups: int


def _sample(col_ptr, rows, seeds, fanouts, gen, cached_len=None, edge_counts=None) -> Block:
    """One batch's expansion.  ``cached_len`` counts adjacency hits
    (``slot < cached_len[v]``; a zero-degree node, which loops to itself,
    counts as a hit); ``edge_counts`` accumulates the touched slots."""
    frontier = seeds.to(torch.int64)
    num_edges = rows.shape[0]
    hits = lookups = 0
    for f in reversed(fanouts):
        start = col_ptr[frontier]
        deg = col_ptr[frontier + 1] - start
        d = deg.clamp_min(1)[:, None]
        u = torch.rand((frontier.shape[0], f), generator=gen, dtype=torch.float64, device=rows.device)
        r = torch.minimum((u * d).to(torch.int64), d - 1)
        slots = start[:, None] + r
        nbr = rows[slots.clamp(0, max(num_edges - 1, 0))].to(torch.int64)
        isolated = (deg == 0)[:, None]
        nbr = torch.where(isolated, frontier[:, None], nbr)
        if edge_counts is not None:
            flat = slots.reshape(-1)
            keep = flat < num_edges
            edge_counts.index_add_(0, flat[keep], torch.ones_like(flat[keep]))
        if cached_len is not None:
            hits += int(((r < cached_len[frontier][:, None]) | isolated).sum())
            lookups += r.numel()
        frontier = torch.cat([frontier, nbr.reshape(-1)])
    return Block(frontier=frontier, adj_hits=hits, adj_lookups=lookups)


def presample_counts(col_ptr, rows, test_idx, *, batch_size, fanouts, n_batches, seed):
    """Paper section IV-B's visit counts over ``n_batches`` presampling
    batches (the test split sliced cyclically from its start), drawn on
    the ORIGINAL neighbour order from a generator seeded ``seed``.
    Returns ``(node_counts, edge_counts)`` as int64 device tensors."""
    dev = rows.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    node_counts = torch.zeros(col_ptr.shape[0] - 1, dtype=torch.int64, device=dev)
    edge_counts = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    test = torch.as_tensor(test_idx, dtype=torch.int64, device=dev)
    for i in range(n_batches):
        start = (i * batch_size) % max(test.shape[0], 1)
        seeds = test[start : start + batch_size]
        if seeds.shape[0] < batch_size:
            seeds = torch.cat([seeds, test[: batch_size - seeds.shape[0]]])
        block = _sample(col_ptr, rows, seeds, fanouts, gen, edge_counts=edge_counts)
        node_counts.index_add_(0, block.frontier, torch.ones_like(block.frontier))
    return node_counts, edge_counts


def node_totals(col_ptr, edge_counts) -> torch.Tensor:
    """Visits of each node's whole neighbour list (0 for no neighbours)."""
    csum = torch.zeros(edge_counts.shape[0] + 1, dtype=torch.int64, device=edge_counts.device)
    torch.cumsum(edge_counts, 0, out=csum[1:])
    return csum[col_ptr[1:]] - csum[col_ptr[:-1]]


def two_level_rows(col_ptr, rows, edge_counts) -> torch.Tensor:
    """Each node's neighbours ordered by visit count, descending; equal
    counts keep CSC order (a stable sort)."""
    n = col_ptr.shape[0] - 1
    deg = col_ptr[1:] - col_ptr[:-1]
    col = torch.repeat_interleave(torch.arange(n, device=rows.device), deg)
    top = int(edge_counts.max()) + 1 if edge_counts.numel() else 1
    key = col * top + (top - 1 - edge_counts)
    order = torch.sort(key, stable=True).indices
    return rows[order]


def adj_prefix_lengths(deg, totals, capacity_bytes: int) -> torch.Tensor:
    """Alg. 1: whole neighbour lists in descending ``totals`` order (stable)
    until the budget of 4-byte elements runs out, the next list cut where
    it does; everything when the whole adjacency fits."""
    budget = max(int(capacity_bytes) // 4, 0)
    if int(deg.sum()) * 4 <= capacity_bytes:
        return deg.clone()
    order = torch.sort(-totals, stable=True).indices
    csum = torch.cumsum(deg[order], 0)
    fully = csum <= budget
    n_full = int(fully.sum())
    cached = torch.zeros_like(deg)
    cached[order[:n_full]] = deg[order[:n_full]]
    if n_full < deg.shape[0]:
        used = int(csum[n_full - 1]) if n_full > 0 else 0
        v = order[n_full]
        cached[v] = min(budget - used, int(deg[v]))
    return cached


def hot_rows(node_counts, budget_rows: int) -> torch.Tensor:
    """Section IV-B's sort-free feature fill: every node visited more than
    the mean (the hottest of them when they outnumber the budget), then
    visited nodes below it, then unvisited ones, each in ascending id."""
    n = node_counts.shape[0]
    budget_rows = min(max(int(budget_rows), 0), n)
    mean = float(node_counts.sum()) / n if n else 0.0
    counts = node_counts.to(torch.float64)
    hot = torch.nonzero(counts > mean).flatten()
    if hot.shape[0] > budget_rows:
        hot = hot[torch.sort(-counts[hot], stable=True).indices[:budget_rows]]
    elif hot.shape[0] < budget_rows:
        rest = torch.nonzero(counts <= mean).flatten()
        visited = rest[counts[rest] > 0]
        cold = rest[counts[rest] == 0]
        hot = torch.cat([hot, torch.cat([visited, cold])[: budget_rows - hot.shape[0]]])
    return hot


def eq1_split(sample_times, feature_times, total_bytes, *, adj_need, feat_need) -> tuple[int, int]:
    """Eq. 1: the budget split by the share of the sampling time, the part
    one cache cannot use spilled to the other.  ``(adj_bytes, feat_bytes)``."""
    t_s, t_f = float(sum(sample_times)), float(sum(feature_times))
    frac = 0.5 if t_s + t_f <= 0 else t_s / (t_s + t_f)
    adj = int(total_bytes * frac)
    feat = int(total_bytes) - adj
    if adj > adj_need:
        feat, adj = feat + adj - adj_need, adj_need
    if feat > feat_need:
        adj, feat = min(adj + feat - feat_need, adj_need), feat_need
    return adj, feat


@dataclasses.dataclass
class Caches:
    rows: torch.Tensor  # two-level-ordered neighbour lists
    cached_len: torch.Tensor  # adjacency-cache prefix per node
    hot: torch.Tensor  # bool[N]: feature row cached


def caches_for(col_ptr, rows, test_idx, *, batch_size, fanouts, n_presample, seed,
               adj_bytes, feat_bytes, row_bytes) -> Caches:
    """The set-up of DCI's dual cache for a given capacity split."""
    node_counts, edge_counts = presample_counts(
        col_ptr, rows, test_idx, batch_size=batch_size, fanouts=fanouts,
        n_batches=n_presample, seed=seed,
    )
    deg = col_ptr[1:] - col_ptr[:-1]
    cached_len = adj_prefix_lengths(deg, node_totals(col_ptr, edge_counts), adj_bytes)
    hot = torch.zeros(deg.shape[0], dtype=torch.bool, device=rows.device)
    hot[hot_rows(node_counts, feat_bytes // row_bytes)] = True
    return Caches(rows=two_level_rows(col_ptr, rows, edge_counts), cached_len=cached_len, hot=hot)


class Replay:
    """The blocks of one stream of batches, drawn from a generator seeded
    ``seed`` against the cached layout ``caches``, with their hits."""

    def __init__(self, col_ptr, caches: Caches, fanouts, seed: int):
        self.col_ptr = col_ptr
        self.caches = caches
        self.fanouts = tuple(fanouts)
        self.gen = torch.Generator(device=caches.rows.device).manual_seed(seed)
        self.adj_hits = self.adj_lookups = self.feat_hits = self.feat_lookups = 0
        self.distinct_hit_rows = self.distinct_miss_rows = 0

    def next(self, seeds) -> torch.Tensor:
        """Sample the next batch; count its hits; return its input rows."""
        seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int64, device=self.col_ptr.device)
        block = _sample(self.col_ptr, self.caches.rows, seeds, self.fanouts, self.gen,
                        cached_len=self.caches.cached_len)
        self.adj_hits += block.adj_hits
        self.adj_lookups += block.adj_lookups
        self.feat_hits += int(self.caches.hot[block.frontier].sum())
        self.feat_lookups += block.frontier.shape[0]
        distinct = torch.unique(block.frontier)
        hit = int(self.caches.hot[distinct].sum())
        self.distinct_hit_rows += hit
        self.distinct_miss_rows += distinct.shape[0] - hit
        return block.frontier


def block_forward(params, model, features, frontier, batch, fanouts, *, dtype=torch.float64,
                  chunk_rows=65536) -> torch.Tensor:
    """Logits of one sampled batch through ``model`` (its file under
    ``bench/models``: the layer over a block, and the activation between
    layers).  The deepest layer reads its rows from ``features`` in chunks
    of destination rows, so the input frontier's feature matrix is never
    built whole."""
    sizes = frontier_sizes(batch, fanouts)
    rev = tuple(reversed(fanouts))
    n_layers = len(fanouts)
    h = None
    for li, l in enumerate(range(n_layers - 1, -1, -1)):
        s, f = sizes[l], rev[l]
        last = li == n_layers - 1
        if h is None:
            outs = []
            for c0 in range(0, s, chunk_rows):
                c1 = min(c0 + chunk_rows, s)
                x_self = features[frontier[c0:c1]].to(dtype)
                nbr = features[frontier[s + c0 * f : s + c1 * f]].to(dtype)
                outs.append(model.block_layer(params[li], x_self, nbr.reshape(c1 - c0, f, -1), f,
                                              dtype, last=last))
            out = torch.cat(outs)
        else:
            out = model.block_layer(params[li], h[:s], h[s:].reshape(s, f, -1), f, dtype, last=last)
        h = out if last else model.activation(out)
    return h


def full_forward(params, model, col_ptr, rows, features, *, dtype=torch.float64,
                 edge_block=1 << 23) -> torch.Tensor:
    """Logits of every node over its exact in-neighbourhood (the layer-wise
    mode's semantics) through ``model``'s layer over the edge list."""
    n = col_ptr.shape[0] - 1
    deg = (col_ptr[1:] - col_ptr[:-1]).to(dtype)[:, None]
    dst = torch.repeat_interleave(torch.arange(n, device=rows.device), col_ptr[1:] - col_ptr[:-1])
    h = features
    for li, p in enumerate(params):
        last = li == len(params) - 1
        x = h.to(dtype)
        out = model.full_layer(p, x, dst, rows, deg, dtype, edge_block, last=last)
        h = out if last else model.activation(out)
        del x
    return h
