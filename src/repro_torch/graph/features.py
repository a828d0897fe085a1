"""Node-feature storage: host ("UVA") table + DCI hot-feature cache.

The paper locates cached rows "through a hash table" inside the GPU; a
dense ``position_map: int32[N]`` (−1 = miss) is the vectorized equivalent.
``gather`` reads hits from the compact hot table and misses from the full
host table, returning the hit mask so the engine can account for the bytes
moved over the slow path.

Where the tables live on a CUDA device: ``host_table`` in pinned host
memory — the paper's UVA miss path — and ``hot_table`` and
``position_map`` on the device.  On the CPU all three are plain tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FeatureStore",
    "build_feature_cache",
    "plain_feature_store",
    "select_hot_rows",
]


@dataclasses.dataclass(frozen=True)
class FeatureStore:
    host_table: torch.Tensor  # [N, F] — pinned host memory (CUDA) or CPU
    hot_table: torch.Tensor  # [H, F] — device cache (H >= 1; row 0 unused if empty)
    position_map: torch.Tensor  # int32[N] — slot in hot_table or -1

    @property
    def num_nodes(self) -> int:
        return self.host_table.shape[0]

    @property
    def feat_dim(self) -> int:
        return self.host_table.shape[1]

    @property
    def num_cached(self) -> int:
        return int((self.position_np() >= 0).sum())

    def host_np(self) -> np.ndarray:
        """Host-memory view of the full feature table (no copy)."""
        return self.host_table.numpy()

    def position_np(self) -> np.ndarray:
        """Host-memory mirror of ``position_map`` (cached lazily) — lets the
        table route find missed rows without a device round trip."""
        cached = getattr(self, "_position_np", None)
        if cached is None:
            cached = self.position_map.cpu().numpy()
            object.__setattr__(self, "_position_np", cached)
        return cached

    def pad_node_id(self) -> int:
        """A known-CACHED node id for padding deduped index buffers, or −1
        when nothing is cached (largest cached id; any would do)."""
        cached = getattr(self, "_pad_node_id", None)
        if cached is None:
            hot = np.nonzero(self.position_np() >= 0)[0]
            cached = int(hot[-1]) if hot.size else -1
            object.__setattr__(self, "_pad_node_id", cached)
        return cached

    def gather(
        self,
        indices: torch.Tensor,
        *,
        use_kernel: bool = False,
        gather_buffers: int = 2,
        row_block: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two-source gather. Returns ``(features[S, F], hit[S])``.

        ``use_kernel=True`` routes through the CUDA ``cached_gather``
        kernel (its plain version on the CPU); ``row_block > 1`` selects
        the row-block variant, whose contiguous runs suit sorted deduped
        frontiers.  ``use_kernel=False`` is the table route.  Every route
        gives the same bits."""
        indices = indices.to(torch.int32)
        pos = self.position_map[indices.to(torch.int64)]
        hit = pos >= 0
        if use_kernel:
            from repro_torch.kernels.cached_gather.kernel import (
                cached_gather,
                cached_gather_blocks,
            )

            if row_block is not None and row_block > 1:
                feats = cached_gather_blocks(
                    self.hot_table,
                    self.host_table,
                    indices,
                    pos,
                    row_block=row_block,
                    gather_buffers=gather_buffers,
                )
            else:
                feats = cached_gather(
                    self.hot_table, self.host_table, indices, pos, gather_buffers=gather_buffers
                )
            return feats, hit
        return self._gather_table(indices, pos, hit), hit

    def _gather_table(
        self, indices: torch.Tensor, pos: torch.Tensor, hit: torch.Tensor
    ) -> torch.Tensor:
        """The table route: every row from the hot table, then the miss
        rows over it.

        On a CUDA device this is how DGL loads features: the miss rows are
        gathered on the host from the pinned table, copied with one
        ``non_blocking`` copy, and written over the hot-table rows.  The
        miss ids are found on the host through the position-map mirror, so
        the route reads ``indices`` back once."""
        hot = self.hot_table
        cached = hot[pos.clamp(0, hot.shape[0] - 1).to(torch.int64)]
        if not hot.is_cuda:
            rows = self.host_table[indices.to(torch.int64)]
            return torch.where(hit[:, None], cached, rows)
        idx_host = indices.cpu().numpy()
        miss = np.nonzero(self.position_np()[idx_host] < 0)[0]
        if miss.size == 0:
            return cached
        miss_ids = torch.from_numpy(idx_host[miss].astype(np.int64))
        staged = torch.empty(
            (miss.size, self.feat_dim), dtype=self.host_table.dtype, pin_memory=True
        )
        torch.index_select(self.host_table, 0, miss_ids, out=staged)
        rows = staged.to(hot.device, non_blocking=True)
        at = torch.from_numpy(miss).to(hot.device, non_blocking=True)
        return cached.index_copy_(0, at, rows)

    def gather_cache_only(self, indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Degraded-mode gather: hit rows from the device cache, miss rows
        ZERO-FILLED — never touches the host table."""
        indices = indices.to(torch.int32)
        pos = self.position_map[indices.to(torch.int64)]
        hit = pos >= 0
        cached = self.hot_table[pos.clamp(0, self.hot_table.shape[0] - 1).to(torch.int64)]
        return torch.where(hit[:, None], cached, torch.zeros_like(cached)), hit


def select_hot_rows(node_counts: np.ndarray, budget_rows: int) -> np.ndarray:
    """DCI's sort-free hot-row selection (paper §IV-B).

    Select nodes with ``visits > mean`` directly (no global argsort); if
    capacity remains, top up with below-mean *visited* nodes, then with
    anything else.  Only the above-mean subset is ever sorted."""
    n = node_counts.shape[0]
    budget_rows = min(max(int(budget_rows), 0), n)
    counts = node_counts.astype(np.float64)
    mean = counts.mean() if n else 0.0
    hot = np.nonzero(counts > mean)[0]
    if hot.shape[0] > budget_rows:
        # More above-mean nodes than capacity: keep the hottest among them.
        hot = hot[np.argsort(-counts[hot], kind="stable")[:budget_rows]]
    elif hot.shape[0] < budget_rows:
        rest = np.nonzero(counts <= mean)[0]
        visited = rest[counts[rest] > 0]
        cold = rest[counts[rest] == 0]
        top_up = np.concatenate([visited, cold])[: budget_rows - hot.shape[0]]
        hot = np.concatenate([hot, top_up])
    return hot


def _host_table(features: np.ndarray, device: torch.device) -> torch.Tensor:
    """The full table: pinned host memory beside a CUDA device, else the
    numpy buffer itself."""
    table = torch.from_numpy(np.ascontiguousarray(features))
    return table.pin_memory() if device.type == "cuda" else table


def build_feature_cache(
    features: np.ndarray,
    node_counts: np.ndarray,
    capacity_bytes: int,
    *,
    device: torch.device,
) -> FeatureStore:
    """DCI's sort-free feature-cache fill (paper §IV-B).

    Slots are assigned in ascending node-id order, so a sorted deduped
    frontier's hit positions form the contiguous runs the row-block gather
    kernel copies as one span."""
    n, f = features.shape
    row_bytes = f * features.dtype.itemsize
    budget_rows = min(max(int(capacity_bytes) // row_bytes, 0), n)
    hot = np.sort(select_hot_rows(node_counts, budget_rows))

    position_map = np.full(n, -1, np.int32)
    position_map[hot] = np.arange(hot.shape[0], dtype=np.int32)
    hot_table = features[hot] if hot.shape[0] else np.zeros((1, f), features.dtype)
    store = FeatureStore(
        host_table=_host_table(features, device),
        hot_table=torch.from_numpy(hot_table).to(device),
        position_map=torch.from_numpy(position_map).to(device),
    )
    object.__setattr__(store, "_position_np", position_map)
    return store


def plain_feature_store(features: np.ndarray, *, device: torch.device) -> FeatureStore:
    """No cache: the position map is all −1 and every row is a miss."""
    n, f = features.shape
    host_table = _host_table(features, device)
    store = FeatureStore(
        host_table=host_table,
        hot_table=torch.zeros((1, f), dtype=host_table.dtype, device=device),
        position_map=torch.full((n,), -1, dtype=torch.int32, device=device),
    )
    object.__setattr__(store, "_position_np", np.full(n, -1, np.int32))
    return store
