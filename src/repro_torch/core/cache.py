"""DualCache — the runtime bundle of DCI's two caches.

``DualCache`` owns the device-resident adjacency cache (inside
``DeviceGraph``) and the feature cache (inside ``FeatureStore``) plus the
allocation that produced them.  It is what the inference engine runs
against; policies (core/policies.py) are factories for it.  The online
refresh of the reference (``DualCache.refresh``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.allocation import CacheAllocation
from repro_torch.device import resolve_device
from repro_torch.graph.csc import build_adj_cache, two_level_sort
from repro_torch.graph.datasets import SyntheticGraphDataset
from repro_torch.graph.features import FeatureStore, build_feature_cache, plain_feature_store
from repro_torch.graph.sampling import DeviceGraph, device_graph

__all__ = ["DualCache"]


@dataclasses.dataclass
class DualCache:
    dgraph: DeviceGraph
    store: FeatureStore
    allocation: CacheAllocation | None

    @property
    def adj_cached_elements(self) -> int:
        return int(self.dgraph.cached_len.sum())

    @property
    def feat_cached_rows(self) -> int:
        return self.store.num_cached

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
        return cls(dgraph=dgraph, store=store, allocation=allocation)

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
