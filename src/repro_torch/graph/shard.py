"""Node-id-range sharding of the feature table + feature cache.

The sharded serving path (runtime/sharded_serve.py) partitions DCI's
feature side by contiguous node-id range: each shard holds its range of
the host table, a *local* hot table re-slotted from the global feature
cache (same rows, local slot ids), and a local position map.  The
adjacency cache is replicated per device, so only feature rows ever
cross shards.

A shard's host table is a row-range VIEW of the one host table: beside a
card that is pinned host memory, and the view is pinned too, so the
gather kernels read a shard's misses over UVA at the view's address, and
a repartition copies no host rows.  Its hot table is a tensor of its own
on its device, gathered from the global hot table (hot rows are copies
of host rows, so the bits are the same).

The exchange: a frontier partitions into per-shard segments on the host
(:meth:`ShardedFeatureStore.partition` — a stable shard-sort that is the
identity for sorted input, so the dedup path's sorted unique ids split
into contiguous runs), each shard gathers only its rows from its own
tables, and the results are copied to the assembling device,
concatenated, and inverse-permuted.  Every route is a permutation of the
same row copies, so outputs and the hit mask are bit-for-bit those of
``FeatureStore.gather`` over the same ids (tests/test_torch_shard.py).

Per-shard pow2 buckets follow the one padding discipline
(:func:`~repro_torch.graph.sampling.pow2_bucket`) and pad with a
shard-local cached id (:meth:`FeatureStore.pad_node_id` of the local
store): pad slots are local-cache hits, so no shard stages a miss row for
padding.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch.core.faults import InjectedFault
from repro_torch.core.trace import resolve_tracer
from repro_torch.graph.features import FeatureStore
from repro_torch.graph.sampling import pow2_bucket

__all__ = [
    "ShardPartition",
    "ShardPlan",
    "ShardedFeatureStore",
    "ShardedPrefetch",
    "make_shard_plan",
    "partition_feature_store",
]


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Contiguous node-id-range partition: shard ``s`` owns
    ``[row_starts[s], row_starts[s+1])``."""

    num_nodes: int
    row_starts: np.ndarray  # int64[num_shards + 1], 0 .. num_nodes

    @property
    def num_shards(self) -> int:
        return len(self.row_starts) - 1

    def bounds(self, s: int) -> tuple[int, int]:
        return int(self.row_starts[s]), int(self.row_starts[s + 1])

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning shard of each id.  ``side='right'`` maps an id on a
        boundary to the shard whose range *starts* there, so empty shards
        (equal consecutive starts) never receive ids."""
        return np.searchsorted(self.row_starts, np.asarray(ids), side="right") - 1

    def shard_sizes(self) -> np.ndarray:
        return np.diff(self.row_starts)


def make_shard_plan(num_nodes: int, num_shards: int) -> ShardPlan:
    """Balanced contiguous ranges; the first ``num_nodes % num_shards``
    shards get one extra row."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    base, rem = divmod(num_nodes, num_shards)
    sizes = np.full(num_shards, base, np.int64)
    sizes[:rem] += 1
    starts = np.zeros(num_shards + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    return ShardPlan(num_nodes=num_nodes, row_starts=starts)


def partition_feature_store(
    store: FeatureStore, plan: ShardPlan, devices=None
) -> list[FeatureStore]:
    """Slice ``store`` into one local :class:`FeatureStore` per shard.

    Each shard's hot table holds exactly the globally cached rows of its
    id range, re-slotted in ascending-id order — the slot discipline of
    :func:`~repro_torch.graph.features.build_feature_cache`, so sorted
    segments keep their contiguous runs for the row-block kernel.  They
    are gathered from the global hot table (on its device; a shard on
    another device gets a copy), the same bits as the host rows.  The
    host table is ``store.host_table[lo:hi]``, a view.

    ``devices`` (optional, one ``torch.device`` per shard — entries may
    repeat) places each shard's hot table and position map; ``None``
    keeps them on the store's device (the co-resident layout)."""
    host = store.host_table
    pos = store.position_np()
    hot_dev = store.hot_table.device
    shards: list[FeatureStore] = []
    for s in range(plan.num_shards):
        lo, hi = plan.bounds(s)
        local_pos = np.full(hi - lo, -1, np.int32)
        cached = np.nonzero(pos[lo:hi] >= 0)[0]  # ascending local ids
        local_pos[cached] = np.arange(cached.size, dtype=np.int32)
        dev = devices[s % len(devices)] if devices else hot_dev
        if cached.size:
            slots = torch.from_numpy(pos[lo + cached].astype(np.int64)).to(hot_dev)
            hot = store.hot_table.index_select(0, slots).to(dev)
        else:
            hot = store.hot_table.new_zeros((1, store.feat_dim), device=dev)
        fs = FeatureStore(
            host_table=host[lo:hi],
            hot_table=hot,
            position_map=torch.from_numpy(local_pos).to(dev),
        )
        # Seed the host mirror, so per-batch partitioning and failover
        # never read the device.
        object.__setattr__(fs, "_position_np", local_pos)
        shards.append(fs)
    return shards


class ShardPartition(typing.NamedTuple):
    """One frontier's shard decomposition — shared by the prefetch stage
    and the gather that consumes it, so both see the same buckets.

    ``seg_ids[s]`` is shard ``s``'s pow2-padded **local** id bucket (None
    for shards with no positions); ``seg_len[s]`` of those are real
    frontier positions and ``seg_live[s]`` of those are live (original
    index < ``num_live`` — the dedup bucket's live prefix).  ``order`` is
    the stable shard-sort permutation over the original positions
    (identity for sorted-unique input); ``inv`` undoes it at reassembly
    (None when the identity)."""

    ids: np.ndarray
    asgn: np.ndarray
    order: np.ndarray
    inv: np.ndarray | None
    seg_ids: list
    seg_len: list
    seg_live: list

    @property
    def num_positions(self) -> int:
        return int(self.ids.size)


class ShardedPrefetch(typing.NamedTuple):
    """Per-shard staged miss packs (parallel to the shard list; None for
    empty segments).  ``num_miss`` sums the per-shard live miss counts —
    equal to the single-store staging count for the same frontier."""

    parts: list
    num_miss: int


@dataclasses.dataclass
class ShardedFeatureStore:
    """The feature side of the dual cache, range-partitioned over shards.

    ``devices`` is the per-shard device list (None: all shards
    co-resident on the store's device — partitioning, exchange and
    accounting all still run).  ``assemble_device`` is where exchanged
    rows land (the device the forward runs on; None when co-resident)."""

    plan: ShardPlan
    shards: list
    devices: list | None = None
    assemble_device: torch.device | None = None

    @classmethod
    def partition_store(
        cls, store: FeatureStore, plan: ShardPlan, devices=None
    ) -> "ShardedFeatureStore":
        shards = partition_feature_store(store, plan, devices)
        assemble = store.hot_table.device if devices else None
        return cls(plan=plan, shards=shards, devices=devices, assemble_device=assemble)

    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    def shard_cached_rows(self) -> list[int]:
        return [int((s.position_np() >= 0).sum()) for s in self.shards]

    # ---------------------------------------------------------- partition
    def partition(self, ids: np.ndarray, *, num_live: int | None = None) -> ShardPartition:
        """Decompose a frontier (host ids, any order, duplicates allowed)
        into per-shard local-id buckets.

        A stable sort on the shard assignment groups positions by owning
        shard while keeping their order inside each group — for the dedup
        path's sorted unique ids the permutation is the identity and the
        segments are contiguous sorted runs.  Each segment pads to its own
        pow2 bucket with the shard-local cached pad id (else local row 0,
        still in the shard), and ``seg_live`` clamps the live window so
        padding is never staged as a miss."""
        ids = np.asarray(ids)
        asgn = self.plan.shard_of(ids)
        # numpy's stable sort is a radix sort only for types of 16 bits or
        # fewer (timsort otherwise); a stable sort's permutation does not
        # depend on the dtype, so the narrowed keys give the same order.
        k = self.num_shards
        narrow = np.int8 if k <= 127 else np.int16 if k <= 32767 else asgn.dtype
        order = np.argsort(asgn.astype(narrow, copy=False), kind="stable")
        identity = bool(np.array_equal(order, np.arange(ids.size)))
        starts = np.searchsorted(asgn[order], np.arange(self.num_shards + 1))
        live_limit = ids.size if num_live is None else int(num_live)
        seg_ids: list = []
        seg_len: list = []
        seg_live: list = []
        for s in range(self.num_shards):
            seg_pos = order[starts[s] : starts[s + 1]]
            if seg_pos.size == 0:
                seg_ids.append(None)
                seg_len.append(0)
                seg_live.append(0)
                continue
            lo, _ = self.plan.bounds(s)
            local = (ids[seg_pos] - lo).astype(np.int32)
            bucket = pow2_bucket(int(local.size))
            pad = self.shards[s].pad_node_id()
            buf = np.full(bucket, pad if pad >= 0 else 0, np.int32)
            buf[: local.size] = local
            seg_ids.append(buf)
            seg_len.append(int(local.size))
            # Positions inside a segment keep ascending original order
            # (stable sort), so the live ones are a prefix.
            seg_live.append(int(np.searchsorted(seg_pos, live_limit)))
        inv = None
        if not identity:
            inv = np.empty(ids.size, np.int64)
            inv[order] = np.arange(ids.size)
        return ShardPartition(
            ids=ids,
            asgn=asgn,
            order=order,
            inv=inv,
            seg_ids=seg_ids,
            seg_len=seg_len,
            seg_live=seg_live,
        )

    # ----------------------------------------------------------- prefetch
    def prefetch(self, part: ShardPartition, *, down: set | None = None) -> ShardedPrefetch:
        """Stage each shard's live missed rows onto that shard's device.

        :meth:`FeatureStore.prefetch_misses` per shard with ``num_live =
        seg_live[s]``: the union of the per-shard live windows is the
        frontier's live prefix, so the summed staging count — and the rows
        staged — match the single-store path.  Shards in ``down``
        (failover, see :meth:`gather`) are skipped: their segments are
        served from the host table, which reads nothing staged."""
        parts: list = []
        total = 0
        for s, buf in enumerate(part.seg_ids):
            if buf is None or (down is not None and s in down):
                parts.append(None)
                continue
            staged = self.shards[s].prefetch_misses(buf, num_live=part.seg_live[s])
            parts.append(staged)
            total += staged.num_miss
        return ShardedPrefetch(parts=parts, num_miss=total)

    # ------------------------------------------------------------- gather
    def gather(
        self,
        part: ShardPartition,
        *,
        use_kernel: bool = False,
        prefetched: ShardedPrefetch | None = None,
        row_block: int | None = None,
        tracer=None,
        injector=None,
        down: set | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-shard gather + exchange-back + reassembly.

        Returns ``(features[B, F], hit[B])`` over all ``B`` frontier
        positions — bit-for-bit :meth:`FeatureStore.gather` over the same
        ids: every shard's rows are copies of the same host/hot rows, the
        exchange is pure copies and a concatenation, and the inverse
        permutation restores the original order.  On the kernel route
        each participating shard launches #1 (or #2 with ``row_block``)
        once.

        ``injector`` (core/faults.py, optional) charges one
        ``shard_exchange`` call per participating shard — only the rule's
        named ``shard`` when it has one — and the raised
        :class:`InjectedFault` carries the victim shard.  ``down`` names
        shards that are failed over: their segments skip the exchange and
        are read from the shard's host table onto the assembling device
        (:meth:`_failover_gather`, one launch of the same kernel on the
        kernel route), the same bits with the same hit mask, so failover
        changes where bytes come from, never values or hit accounting.

        ``tracer`` (core/trace.py, optional) records one ``exchange`` span
        per participating shard on a ``shard s`` lane, a ``failover`` span
        for a failed-over one, and a ``reassemble`` span."""
        tracer = resolve_tracer(tracer)
        rule = injector.plan.rule_for("shard_exchange") if injector is not None else None
        parts_f: list = []
        parts_h: list = []
        for s, buf in enumerate(part.seg_ids):
            if buf is None:
                continue
            if down is not None and s in down:
                with tracer.span(
                    "failover",
                    lane=f"shard {s}",
                    args={"rows": part.seg_len[s]} if tracer.enabled else None,
                ):
                    feats_s, hit_s = self._failover_gather(
                        s,
                        buf[: part.seg_len[s]],
                        use_kernel=use_kernel,
                        row_block=row_block,
                    )
                parts_f.append(feats_s)
                parts_h.append(hit_s)
                continue
            if rule is not None and (rule.shard is None or rule.shard == s):
                try:
                    injector.check("shard_exchange")
                except InjectedFault as err:
                    if err.shard is None:
                        err.shard = s  # attribute the loss to this exchange
                    raise
            with tracer.span(
                "exchange",
                lane=f"shard {s}",
                args={"rows": part.seg_len[s]} if tracer.enabled else None,
            ):
                shard = self.shards[s]
                ids_dev = torch.from_numpy(buf).to(shard.hot_table.device)
                pf = prefetched.parts[s] if prefetched is not None else None
                feats_s, hit_s = shard.gather(
                    ids_dev,
                    use_kernel=use_kernel,
                    prefetched=pf,
                    row_block=row_block,
                )
                n = part.seg_len[s]
                feats_s, hit_s = feats_s[:n], hit_s[:n]
                if self.assemble_device is not None:
                    feats_s = feats_s.to(self.assemble_device)
                    hit_s = hit_s.to(self.assemble_device)
            parts_f.append(feats_s)
            parts_h.append(hit_s)
        with tracer.span("reassemble", lane="exchange"):
            feats = parts_f[0] if len(parts_f) == 1 else torch.cat(parts_f)
            hit = parts_h[0] if len(parts_h) == 1 else torch.cat(parts_h)
            if part.inv is not None:
                inv = torch.from_numpy(part.inv).to(feats.device)
                feats, hit = feats[inv], hit[inv]
        return feats, hit

    def _failover_gather(
        self, s: int, local: np.ndarray, *, use_kernel: bool, row_block
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Serve a DOWN shard's segment (``local``: its real local ids, the
        pow2 pad trimmed) from its host table, on the assembling device.

        The host table outlives the loss of the shard's device; its rows
        are the bits the device tables hold, and the hit mask is the same
        position-map test (on the host mirror), so failover is bit-for-bit
        the exchange route, with every row a miss.  On the kernel route #1
        (or #2 with ``row_block``) reads the rows over UVA from the shard's
        pinned view, with an all-miss position tensor so no hot table is
        read; the table route stages them as :meth:`FeatureStore.gather`'s
        table route stages misses (a host gather and one copy)."""
        fb = self.shards[s]
        dev = self.assemble_device if self.assemble_device is not None else fb.hot_table.device
        hit = torch.from_numpy(fb.position_np()[local] >= 0).to(dev)
        if not use_kernel:
            staged = fb.host_table.index_select(0, torch.from_numpy(local.astype(np.int64)))
            return staged.to(dev), hit
        from repro_torch.kernels.cached_gather.kernel import cached_gather, cached_gather_blocks

        ids = torch.from_numpy(np.ascontiguousarray(local, np.int32)).to(dev)
        miss = torch.full_like(ids, -1)
        hot = fb.host_table.new_zeros((1, fb.feat_dim), device=dev)  # never read
        if row_block is not None and row_block > 1:
            feats = cached_gather_blocks(hot, fb.host_table, ids, miss, row_block=row_block)
        else:
            feats = cached_gather(hot, fb.host_table, ids, miss)
        return feats, hit
