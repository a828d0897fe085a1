"""Node-feature storage: host ("UVA") table + DCI hot-feature cache.

The paper locates cached rows "through a hash table" inside the GPU; a
dense ``position_map: int32[N]`` (−1 = miss) is the vectorized equivalent.
``gather`` reads hits from the compact hot table and misses from the full
host table, returning the hit mask so the engine can account for the bytes
moved over the slow path.

Where the tables live on a CUDA device: ``host_table`` in pinned host
memory — the paper's UVA miss path — and ``hot_table`` and
``position_map`` on the device.  On the CPU all three are plain tensors.

``refresh_feature_cache`` re-fills a store for new counts as a delta (the
layer-wise mode's layer-0 cache), and ``build_embedding_cache`` puts the
same store over a layer's spilled outputs.

``prefetch_misses`` stages a batch's missed rows onto the device ahead of
its gather: packed on the host into pinned memory, copied on a side CUDA
stream, and waited for (through a CUDA event) by the stream that gathers.
Its first step reads the batch's ids back to the host, and that read
waits for everything queued on the compute stream, the previous batch's
forward included: the staging cannot overlap device work while the miss
search runs on the host (a device-side miss search is queued in
ROADMAP.md).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import typing

import numpy as np
import torch

from repro_torch.graph.sampling import pow2_bucket

__all__ = [
    "FeatureRefreshStats",
    "FeatureStore",
    "PrefetchedMisses",
    "build_embedding_cache",
    "build_feature_cache",
    "plain_feature_store",
    "refresh_feature_cache",
    "select_hot_rows",
]

# One shared worker for the host-side miss-row pack: the row copy into the
# pinned staging buffer is the heavy part of prefetch staging, and a single
# worker keeps the packs ordered while the calling thread builds the index
# arrays and issues THEIR copies.
_PACK_POOL = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="dci-miss-pack"
)


class PrefetchedMisses(typing.NamedTuple):
    """Missed host rows staged onto the device ahead of their gather.

    ``rows`` is the device buffer: the full ``[S, F]`` row set when every
    row missed (``idx is None``), else a ``[P, F]`` power-of-two padded
    pack of just the miss rows (zero pad rows).  ``idx`` holds each packed
    row's position in the batch (pad entries point one past the end);
    ``pack_pos`` is the inverse map — each batch row's slot in the pack (0
    for hit rows, whose miss source is never read) — so the kernel route
    addresses the pack directly.  ``num_miss`` is the unpadded miss count.

    On a CUDA device the three tensors were copied on a side stream:
    ``ready`` is the event recorded after the copies, which the gathering
    stream waits on, and ``staging`` keeps the pinned host buffers they
    were copied from alive for as long as this object lives (the batch's
    context holds it until the batch retires, after the copies are
    done).  On the CPU ``ready`` is ``None`` and nothing is staged."""

    rows: torch.Tensor
    idx: torch.Tensor | None
    pack_pos: torch.Tensor | None
    num_miss: int
    ready: "torch.cuda.Event | None" = None
    staging: tuple = ()


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

    def _clamp(self, indices: torch.Tensor) -> torch.Tensor:
        """``indices`` as int32 with every id above ``N - 1`` set to ``N - 1``
        (what a JAX gather does with an out-of-range index)."""
        return indices.to(torch.int32).clamp_max(self.num_nodes - 1)

    def _copy_stream(self) -> torch.cuda.Stream:
        """The side stream the prefetch copies run on (one per store)."""
        stream = getattr(self, "_side_stream", None)
        if stream is None:
            stream = torch.cuda.Stream(self.hot_table.device)
            object.__setattr__(self, "_side_stream", stream)
        return stream

    def prefetch_misses(
        self,
        nodes: torch.Tensor | np.ndarray,
        *,
        num_live: int | None = None,
        injector=None,
    ) -> PrefetchedMisses:
        """Stage the missed host rows for a batch onto the device.

        The miss rows are found on the host (``nodes`` read back once
        when it is a device tensor, then looked up in the position-map
        mirror), packed into a pinned staging buffer padded to a
        power-of-two bucket, and copied ``non_blocking`` on a side CUDA
        stream.  The read of ``nodes`` waits for the compute stream's
        queued work, so neither the host pack nor the copy overlaps it.
        The returned ``ready`` event marks the copies' end; the gather
        that consumes the pack makes its stream wait on it.

        ``num_live`` marks a live prefix: positions at and beyond it are
        padding (the deduped frontier's pow2 bucket tail) whose gathered
        values are never read, so their misses are not staged.  The
        consuming gather still covers all of ``nodes``; pad miss rows read
        pack slot 0, which only lands in unread pad output rows.

        The row pack runs on a worker thread while the calling thread
        builds ``idx``/``pack_pos``; the call joins before it returns.
        ``injector`` (fault injection) is not ported yet and raises."""
        if injector is not None:
            raise NotImplementedError("fault injection is not ported yet (ROADMAP.md, A-item 16)")
        if isinstance(nodes, torch.Tensor):
            nodes = nodes.cpu().numpy()  # the id sync: one device->host copy
        nodes = np.asarray(nodes)
        live = nodes if num_live is None else nodes[:num_live]
        miss = np.nonzero(self.position_np()[live] < 0)[0].astype(np.int32)
        on_cuda = self.hot_table.is_cuda
        f = self.feat_dim

        def pack(ids: np.ndarray, n_rows: int) -> torch.Tensor:
            rows = torch.empty((n_rows, f), dtype=self.host_table.dtype, pin_memory=on_cuda)
            torch.index_select(
                self.host_table, 0, torch.from_numpy(ids.astype(np.int64)), out=rows[: ids.size]
            )
            rows[ids.size :].zero_()
            return rows

        if miss.size == nodes.size:
            # Every row missed (e.g. no cache): the staged buffer IS the
            # whole row set — no pack, no pad, no inverse map.
            rows, idx, pack_pos = pack(nodes, nodes.size), None, None
        else:
            bucket = pow2_bucket(miss.size, nodes.size)
            rows_future = _PACK_POOL.submit(pack, nodes[miss], bucket)
            idx = torch.full((bucket,), nodes.size, dtype=torch.int32, pin_memory=on_cuda)
            idx.numpy()[: miss.size] = miss  # pad → one past the end (never read)
            pack_pos = torch.zeros(nodes.size, dtype=torch.int32, pin_memory=on_cuda)
            pack_pos.numpy()[miss] = np.arange(miss.size, dtype=np.int32)  # hits → slot 0
            rows = rows_future.result()
        if not on_cuda:
            return PrefetchedMisses(rows, idx, pack_pos, int(miss.size))
        staging = (rows, idx, pack_pos)
        side = self._copy_stream()
        with torch.cuda.stream(side):
            # Allocated on the side stream, so the allocator never hands
            # these blocks to side-stream work before the compute stream's
            # uses of them (recorded below) are done.
            rows, idx, pack_pos = (
                None if t is None else t.to(self.hot_table.device, non_blocking=True)
                for t in staging
            )
            ready = torch.cuda.Event()
            ready.record(side)
        compute = torch.cuda.current_stream(self.hot_table.device)
        for t in (rows, idx, pack_pos):
            if t is not None:
                t.record_stream(compute)
        return PrefetchedMisses(rows, idx, pack_pos, int(miss.size), ready, staging)

    def gather(
        self,
        indices: torch.Tensor,
        *,
        use_kernel: bool = False,
        gather_buffers: int = 2,
        prefetched: PrefetchedMisses | None = None,
        row_block: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two-source gather. Returns ``(features[S, F], hit[S])``.

        ``use_kernel=True`` routes through the CUDA ``cached_gather``
        kernel (its plain version on the CPU); ``row_block > 1`` selects
        the row-block variant, whose contiguous runs suit sorted deduped
        frontiers.  ``use_kernel=False`` is the table route.

        ``prefetched`` (from :meth:`prefetch_misses`) replaces the host
        table as the miss source: the kernels read the device pack
        through ``pack_pos`` (the all-miss row set row by row), and the
        table route scatters the pack over the hot-table gather.  The
        stream waits for the pack's copy first.  The hit mask comes from
        ``position_map`` either way.  Every route gives the same bits.

        An id at or above ``N`` reads node ``N - 1`` (its hit flag and its
        row), as the reference's JAX gather clamps it; a negative id wraps
        in the position-map lookup."""
        indices = self._clamp(indices)
        pos = self.position_map[indices.to(torch.int64)]
        hit = pos >= 0
        if prefetched is not None and prefetched.ready is not None:
            torch.cuda.current_stream(self.hot_table.device).wait_event(prefetched.ready)
        if use_kernel:
            from repro_torch.kernels.cached_gather.kernel import (
                cached_gather,
                cached_gather_blocks,
            )

            if prefetched is None:
                host_src, host_idx = self.host_table, indices
            elif prefetched.idx is None:  # all-miss: the row set is row-aligned
                host_src = prefetched.rows
                host_idx = torch.arange(indices.shape[0], dtype=torch.int32, device=indices.device)
            else:
                host_src, host_idx = prefetched.rows, prefetched.pack_pos
            if row_block is not None and row_block > 1:
                feats = cached_gather_blocks(
                    self.hot_table,
                    host_src,
                    host_idx,
                    pos,
                    row_block=row_block,
                    gather_buffers=gather_buffers,
                )
            else:
                feats = cached_gather(
                    self.hot_table, host_src, host_idx, pos, gather_buffers=gather_buffers
                )
            return feats, hit
        if prefetched is not None:
            cached = self.hot_table[pos.clamp(0, self.hot_table.shape[0] - 1).to(torch.int64)]
            if prefetched.idx is None:  # every row missed: straight select
                return torch.where(hit[:, None], cached, prefetched.rows), hit
            # The misses overwrite their rows of the hot gather.
            m = prefetched.num_miss
            at = prefetched.idx[:m].to(torch.int64)
            return cached.index_copy_(0, at, prefetched.rows[:m]), hit
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
        ZERO-FILLED — never touches the host table.  Ids at or above ``N``
        read node ``N - 1``, as in :meth:`gather`."""
        indices = self._clamp(indices)
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


def _host_table(
    features: np.ndarray | torch.Tensor, device: torch.device | str
) -> torch.Tensor:
    """The full table: pinned host memory beside a CUDA device, else the
    host buffer itself (a numpy array is wrapped, not copied; a tensor that
    is already pinned is used as it is)."""
    if isinstance(features, torch.Tensor):
        table = features.contiguous()
    else:
        table = torch.from_numpy(np.ascontiguousarray(features))
    if torch.device(device).type == "cuda" and not table.is_pinned():
        return table.pin_memory()
    return table


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


@dataclasses.dataclass(frozen=True)
class FeatureRefreshStats:
    """What a delta re-fill actually moved (the bounded-pause accounting)."""

    rows_kept: int  # hot rows that stayed in their slots — zero bytes moved
    rows_inserted: int  # new hot rows scattered into freed slots
    rows_evicted: int  # old hot rows whose slots were reused / invalidated
    physical_rows: int  # device hot-table rows after the refresh
    budget_rows: int  # logical capacity the new allocation pays for

    @property
    def changed(self) -> bool:
        return bool(self.rows_inserted or self.rows_evicted)


def refresh_feature_cache(
    store: FeatureStore,
    node_counts: np.ndarray,
    capacity_bytes: int,
) -> tuple[FeatureStore, FeatureRefreshStats]:
    """Incremental re-fill: move only the rows whose hotness changed.

    Re-runs the sort-free selection on ``node_counts`` and applies the
    difference against ``store`` as a delta:

      * rows in both the old and the new hot set KEEP their slots;
      * evicted rows get ``position_map[v] = -1`` (their slots are freed);
      * inserted rows are gathered once on the host and copied into the
        freed slots, lowest node id into the lowest free slot.

    The hot table only grows, by doubling (capped at the node count) when
    the new set needs more rows than it has.  ``store`` is left as it was:
    the new store gets its own hot table and position map (a copy when
    nothing grows), and shares ``host_table``, so gathered rows stay
    bit-identical — a refresh changes hit accounting and byte movement,
    never outputs."""
    host = store.host_table
    n, f = host.shape
    row_bytes = f * host.element_size()
    budget_rows = min(max(int(capacity_bytes) // row_bytes, 0), n)

    old_pos = store.position_np()
    new_hot = select_hot_rows(node_counts, budget_rows)
    in_new = np.zeros(n, bool)
    in_new[new_hot] = True
    old_nodes = np.nonzero(old_pos >= 0)[0]
    kept_mask = in_new[old_nodes]
    kept_nodes = old_nodes[kept_mask]
    evicted_nodes = old_nodes[~kept_mask]
    in_old = np.zeros(n, bool)
    in_old[old_nodes] = True
    inserted_nodes = np.sort(new_hot[~in_old[new_hot]])

    physical = store.hot_table.shape[0]
    needed = kept_nodes.shape[0] + inserted_nodes.shape[0]
    if needed > physical:
        grow_to = min(max(needed, 2 * physical), max(n, needed))
        pad = store.hot_table.new_zeros((grow_to - physical, f))
        hot_table = torch.cat([store.hot_table, pad])
        physical = grow_to
    else:
        hot_table = store.hot_table.clone()

    # Free slots = every physical slot not held by a kept row, filled in
    # ascending order (deterministic given the same inputs).
    occupied = np.zeros(physical, bool)
    occupied[old_pos[kept_nodes]] = True
    free_slots = np.nonzero(~occupied)[0][: inserted_nodes.shape[0]]

    new_pos_np = old_pos.copy()
    new_pos_np[evicted_nodes] = -1
    new_pos_np[inserted_nodes] = free_slots
    device = store.hot_table.device
    if inserted_nodes.size:
        rows = host.index_select(0, torch.from_numpy(inserted_nodes.astype(np.int64)))
        hot_table.index_copy_(
            0, torch.from_numpy(free_slots.astype(np.int64)).to(device), rows.to(device)
        )
    new_store = FeatureStore(
        host_table=host,
        hot_table=hot_table,
        position_map=torch.from_numpy(new_pos_np).to(device),
    )
    object.__setattr__(new_store, "_position_np", new_pos_np)
    return new_store, FeatureRefreshStats(
        rows_kept=int(kept_nodes.shape[0]),
        rows_inserted=int(inserted_nodes.shape[0]),
        rows_evicted=int(evicted_nodes.shape[0]),
        physical_rows=int(physical),
        budget_rows=int(budget_rows),
    )


def build_embedding_cache(
    table: torch.Tensor | np.ndarray,
    access_counts: np.ndarray,
    capacity_bytes: int,
    *,
    device: torch.device | str,
) -> FeatureStore:
    """DCI's sort-free fill applied to layer-*k* output EMBEDDINGS.

    The layer-wise executor (runtime/layerwise.py) spills each layer's
    outputs to a host table and re-reads them as the next layer's inputs;
    this builds the device cache those re-reads hit — the same
    :class:`FeatureStore` (position-map lookup, two-source gather,
    row-block kernel route) as the input features, filled by
    :func:`select_hot_rows` over the EXACT chunk access counts (``1 +
    bincount(row_index)``).  Slots are id-ordered like
    :func:`build_feature_cache`.  ``table`` becomes the host table as it
    is: beside a CUDA device a pinned tensor is read in place over UVA
    (anything else is pinned first).  A zero budget gives the cache-less
    store."""
    host = _host_table(table, device)
    n, f = host.shape
    row_bytes = f * host.element_size()
    budget_rows = min(max(int(capacity_bytes) // row_bytes, 0), n)
    hot = np.sort(select_hot_rows(access_counts, budget_rows))
    position_map = np.full(n, -1, np.int32)
    position_map[hot] = np.arange(hot.shape[0], dtype=np.int32)
    if hot.shape[0]:
        hot_table = host.index_select(0, torch.from_numpy(hot.astype(np.int64)))
    else:
        hot_table = host.new_zeros((1, f))
    store = FeatureStore(
        host_table=host,
        hot_table=hot_table.to(device),
        position_map=torch.from_numpy(position_map).to(device),
    )
    object.__setattr__(store, "_position_np", position_map)
    return store


def plain_feature_store(
    features: np.ndarray | torch.Tensor, *, device: torch.device
) -> FeatureStore:
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
