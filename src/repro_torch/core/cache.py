"""DualCache — the runtime bundle of DCI's two caches, versioned by epoch.

``DualCache`` owns the device-resident adjacency cache (inside
``DeviceGraph``) and the feature cache (inside ``FeatureStore``) plus the
allocation that produced them.  It is what the inference engine runs
against; policies (core/policies.py) are factories for it.

The online refresh (runtime/cache_refresh.py) makes it a versioned,
mutable-by-delta object: ``refresh()`` swaps in a new allocation's worth
of cache contents as an incremental delta (only changed feature rows and
adjacency segments move, never the O(N)/O(E) structures) and bumps
``epoch``.  Consumers read ``caches.dgraph`` at sample time and
``caches.store`` at prefetch and feature time, so every stream picks up a
new epoch at its next batch.  A refresh never changes sampled blocks,
gathered rows or logits — the two-level sort order and the host feature
table are frozen at build time — only hit accounting and byte movement.
Without refresh nothing mutates.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.allocation import CacheAllocation
from repro_torch.device import resolve_device
from repro_torch.graph.csc import (
    AdjCache,
    AdjRefreshStats,
    build_adj_cache,
    node_visit_totals,
    refresh_adj_cache,
    two_level_sort,
)
from repro_torch.graph.datasets import SyntheticGraphDataset
from repro_torch.graph.features import (
    FeatureRefreshStats,
    FeatureStore,
    build_feature_cache,
    plain_feature_store,
    refresh_feature_cache,
)
from repro_torch.graph.sampling import DeviceGraph, device_graph

__all__ = ["CacheRefreshDelta", "DualCache"]


@dataclasses.dataclass(frozen=True)
class CacheRefreshDelta:
    """One epoch transition: what moved, and what it cost."""

    epoch: int  # the epoch this delta produced
    allocation: CacheAllocation
    feat: FeatureRefreshStats
    adj: AdjRefreshStats
    # Host seconds of the two re-fills (the adjacency one includes the
    # per-node visit totals it ranks on); the card's copies are queued.
    adj_seconds: float = 0.0
    feat_seconds: float = 0.0

    @property
    def changed(self) -> bool:
        return self.feat.changed or self.adj.changed


@dataclasses.dataclass
class DualCache:
    dgraph: DeviceGraph
    store: FeatureStore
    allocation: CacheAllocation | None
    epoch: int = 0
    # Frozen refresh context, captured by ``build``: the host CSC, the
    # two-level-sorted row order, and the host-side adjacency cache the
    # delta re-fill copies unchanged segments from.  ``None`` for cacheless
    # builds (``none()``), which have nothing to refresh.
    _graph: object | None = dataclasses.field(default=None, repr=False)
    _sorted_row: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _adj_cache: AdjCache | None = dataclasses.field(default=None, repr=False)

    @property
    def adj_cached_elements(self) -> int:
        return int(self.dgraph.cached_len.sum())

    @property
    def feat_cached_rows(self) -> int:
        return self.store.num_cached

    @property
    def refreshable(self) -> bool:
        return self._graph is not None and self._sorted_row is not None

    @classmethod
    def build(
        cls,
        dataset: SyntheticGraphDataset,
        *,
        node_counts: np.ndarray,
        edge_counts: np.ndarray,
        allocation: CacheAllocation,
        device: torch.device | str | None = None,
    ) -> "DualCache":
        """Fill both caches per §IV-B with the given capacity split, on
        ``device`` (CUDA unless ``"cpu"`` is asked for)."""
        dev = resolve_device(device)
        sorted_row, node_totals = two_level_sort(dataset.graph, edge_counts)
        adj_cache = build_adj_cache(dataset.graph, sorted_row, node_totals, allocation.adj_bytes)
        dgraph = device_graph(
            dataset.graph, device=dev, sorted_row_index=sorted_row, adj_cache=adj_cache
        )
        store = build_feature_cache(
            dataset.features, node_counts, allocation.feat_bytes, device=dev
        )
        return cls(
            dgraph=dgraph,
            store=store,
            allocation=allocation,
            _graph=dataset.graph,
            _sorted_row=sorted_row,
            _adj_cache=adj_cache,
        )

    @classmethod
    def none(
        cls, dataset: SyntheticGraphDataset, *, device: torch.device | str | None = None
    ) -> "DualCache":
        """The DGL baseline: no caches at all."""
        dev = resolve_device(device)
        return cls(
            dgraph=device_graph(dataset.graph, device=dev),
            store=plain_feature_store(dataset.features, device=dev),
            allocation=None,
        )

    # ------------------------------------------------------------- refresh
    def refresh(
        self,
        *,
        allocation: CacheAllocation,
        node_counts: np.ndarray,
        edge_counts: np.ndarray,
        injector=None,
    ) -> CacheRefreshDelta:
        """Swap both caches to a new allocation/ranking as a delta re-fill.

        No full ``build``: the two-level sort is never re-run, unchanged
        feature rows stay in their slots, unchanged adjacency segments are
        copied from the previous cache, and the O(E) device arrays are
        shared with the previous epoch.  Batches in flight keep the
        previous epoch's tensors: the refresh writes only into tensors it
        made (the three adjacency-cache arrays, the feature store's grown
        or cloned hot table and its position map), never into the old
        epoch's, and the swap is an attribute write on this object,
        visible to the next stage that reads it.  The old tensors are
        freed when their last batch retires; that batch's kernels were
        queued on the stream the new tensors are made on, or, sampled on a
        stream of their own, waited for by it, so the caching allocator
        cannot hand their memory out early.

        The swap is TRANSACTIONAL: exactly five attributes mutate
        (``dgraph``, ``store``, ``allocation``, ``_adj_cache``, ``epoch``),
        and any failure mid-apply — an injected ``refresh_fill`` fault
        (core/faults.py), charged between the attribute writes to model a
        re-fill dying half-applied, included — restores all five from a
        snapshot before re-raising.  Nothing of the old epoch was written,
        so the rollback leaves the same objects holding the same bytes,
        and the caller keeps serving the stale epoch."""
        if not self.refreshable:
            raise ValueError("this DualCache was built without refresh context (none())")
        snapshot = (self.dgraph, self.store, self.allocation, self._adj_cache, self.epoch)
        try:
            t0 = time.perf_counter()
            node_totals = node_visit_totals(self._graph, edge_counts)
            new_adj, adj_stats = refresh_adj_cache(
                self._graph, self._sorted_row, self._adj_cache, node_totals, allocation.adj_bytes
            )
            cache_row = new_adj.cache_row_index
            # Pad the device copy to a grow-only power-of-two size, as the
            # reference does (its sampler specializes on this shape): the
            # layout stays the reference's, and the allocator sees a stable
            # size across epochs.  Padded entries are never read — the hit
            # test is ``r < cached_len``.
            phys = max(self.dgraph.cache_row_index.shape[0], 1)
            while phys < cache_row.shape[0]:
                phys *= 2
            if cache_row.shape[0] < phys:
                cache_row = np.concatenate(
                    [cache_row, np.zeros(phys - cache_row.shape[0], np.int32)]
                )
            dev = self.dgraph.device

            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

            dgraph = dataclasses.replace(
                self.dgraph,
                cache_ptr=put(new_adj.cache_ptr),
                cache_row_index=put(cache_row),
                cached_len=put(new_adj.cached_len),
            )
            t1 = time.perf_counter()
            new_store, feat_stats = refresh_feature_cache(
                self.store, node_counts, allocation.feat_bytes
            )
            t2 = time.perf_counter()
            self.dgraph = dgraph
            self.store = new_store
            if injector is not None:
                # Mid-apply on purpose: dgraph/store already swapped, the
                # rest not — the worst-case partial state rollback must
                # cleanly undo.
                injector.check("refresh_fill")
            self.allocation = allocation
            self._adj_cache = new_adj
            self.epoch += 1
        except BaseException:
            (self.dgraph, self.store, self.allocation, self._adj_cache, self.epoch) = snapshot
            raise
        return CacheRefreshDelta(
            epoch=self.epoch,
            allocation=allocation,
            feat=feat_stats,
            adj=adj_stats,
            adj_seconds=t1 - t0,
            feat_seconds=t2 - t1,
        )
