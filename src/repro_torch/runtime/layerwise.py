"""Layer-wise full-graph inference — the second execution mode beside sampling.

Sampling amortizes per-seed neighborhood explosion; once the whole graph
needs scoring, every node's features are re-gathered once per seed batch
that touches them.  Layer-wise execution inverts the loop: run layer *k*
over ALL nodes before starting layer *k+1*, walking the node range in
fixed-size chunks.  Each node's input rows are then read exactly
``1 + out_degree`` times per layer — once as a chunk member, once per
out-edge — at the price of materializing every intermediate layer.

The executor reuses the whole DCI stack:

  - chunks flow through the staged :class:`~repro_torch.runtime.pipeline.
    PipelinedExecutor` (at ``depth > 1`` the host dispatches chunk *i+1*
    while the card still runs chunk *i*, same clock semantics as the
    sampled engine);
  - layer-0 input rows come from the feature :class:`~repro_torch.graph.
    features.FeatureStore`, delta re-filled for the layer-wise access
    pattern, which is EXACT — ``1 + bincount(row_index)``;
  - layer-*k* outputs spill to a host table (pinned beside a card, so it
    is read in place over UVA) and come back as layer *k+1* inputs through
    a per-layer EMBEDDING cache (:func:`~repro_torch.graph.features.
    build_embedding_cache`) — the same position-map gather, prefetch
    staging and row-block kernel route (#2) as the input features;
  - the budget splits between the two caches by Eq. 1 over probed chunk
    gather laps (:func:`~repro_torch.core.allocation.
    allocate_layerwise_capacity`).

``dedup`` does not apply here — the self block IS sorted-unique and
neighbor lists duplicate only across multi-edges — and is ignored.
``pipeline_depth="auto"`` resolves to 2.

Each chunk's index vector lives on the run's device from the plan on
(``ChunkSpec.device_ids``), and each layer re-points its pad positions
there, so a chunk's gather starts without a host→device copy from
pageable memory, which would wait for the previous chunk's compute.

With a tracer (core/trace.py), a pass's set-up is in spans on the
``layers`` lane: ``plan`` (the chunk plan and the access counts),
``probe`` (Eq. 1's probe laps, each a ``sync:probe`` wait, and the
split), ``refill`` (the layer-0 re-fill), and per layer ``spill-alloc``
(the pinned spill table), ``warm`` (with its ``sync:warm``), ``layer k``
(the chunks through the executor) and ``embed-fill``.  Each chunk's
retire holds two waits of its own: ``sync:spill`` (the copy to the spill
table) and ``sync:hits`` (its hit count).
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core.allocation import LayerwiseAllocation, allocate_layerwise_capacity
from repro_torch.core.config import EngineConfig
from repro_torch.core.policies import PreparedPipeline
from repro_torch.core.trace import NULL_TRACER, WAIT_ARGS, resolve_tracer
from repro_torch.graph.datasets import SyntheticGraphDataset
from repro_torch.graph.features import (
    FeatureStore,
    build_embedding_cache,
    plain_feature_store,
    refresh_feature_cache,
)
from repro_torch.graph.sampling import pow2_bucket
from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK, cached_gather_blocks
from repro_torch.models.gnn.models import forward_layer, out_width
from repro_torch.runtime.gnn_engine import modeled_transfer_seconds
from repro_torch.runtime.pipeline import PipelinedExecutor, Stage
from repro_torch.utils.timing import StageClock, block_until_ready

__all__ = [
    "ChunkPlan",
    "ChunkSpec",
    "LayerwiseReport",
    "layerwise_access_counts",
    "plan_chunks",
    "run_layerwise",
]


def layerwise_access_counts(graph) -> np.ndarray:
    """Exact per-node reads per layer: once as a chunk member plus once per
    out-edge (each appearance in ``row_index`` is one neighbor gather).
    The same counts govern the layer-0 feature cache and every
    intermediate embedding cache."""
    return 1 + np.bincount(graph.row_index, minlength=graph.num_nodes).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """One node-range chunk's layer-invariant geometry.

    The gather reads one concatenated index vector ``[self | neighbors]``:
    ``chunk_size`` self ids (range ``[lo, lo+cnt)``, tail clipped — the
    clipped rows are dropped at spill) followed by the range's in-edge
    sources padded to a pow2 bucket.  Pad positions are marked in
    ``pad_mask`` and re-pointed per layer at that layer's cached pad id;
    their rows land in the dropped extra segment / clipped tail and are
    never read, and ``live`` keeps them out of the hit accounting."""

    lo: int
    cnt: int  # live chunk nodes (== chunk_size except the last chunk)
    n_edges: int  # live in-edges of the range
    base_ids: np.ndarray  # int32[chunk_size + bucket], pads = 0
    pad_mask: np.ndarray  # bool, True at pad positions of base_ids
    seg_ids: torch.Tensor  # int32[bucket] — edge → local dst, pads → chunk_size
    degrees: torch.Tensor  # f32[chunk_size] — true in-degrees, pad tail 0
    live: torch.Tensor  # bool[chunk_size + bucket] — non-pad positions
    device_ids: torch.Tensor  # base_ids on the run's device
    # forward_layer's two-level sum over the live edges: edges per piece
    # (at most ``piece`` each), then pieces per chunk node (int64 each).
    levels: tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """The full chunk schedule, built ONCE and shared by every layer (the
    geometry depends only on the CSC and the chunk size)."""

    chunk_size: int
    chunks: list[ChunkSpec]

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)


def _pieces(deg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split each node's in-edges into pieces of at most ``max(32,
    ceil(sqrt(max deg)))`` rows: ``(pieces per node, rows per piece)``.
    The two sums of ``forward_layer`` then loop at most about twice the
    square root of the largest degree per thread, not the degree."""
    piece = max(32, math.isqrt(max(int(deg.max(initial=0)) - 1, 0)) + 1)
    pieces = -(-deg // piece)
    piece_len = np.full(int(pieces.sum()), piece, np.int64)
    last = np.cumsum(pieces)[deg > 0] - 1
    piece_len[last] = deg[deg > 0] - (pieces[deg > 0] - 1) * piece
    return pieces, piece_len


def plan_chunks(graph, chunk_size: int, *, device: torch.device | str = "cpu") -> ChunkPlan:
    """Cut the node range into chunks of ``chunk_size``; the tensors of
    each :class:`ChunkSpec` live on ``device``."""
    n = graph.num_nodes
    col_ptr = np.asarray(graph.col_ptr)
    row_index = np.asarray(graph.row_index)
    deg = np.diff(col_ptr)
    chunks: list[ChunkSpec] = []

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    for lo in range(0, n, chunk_size):
        hi = min(lo + chunk_size, n)
        cnt = hi - lo
        e0, e1 = int(col_ptr[lo]), int(col_ptr[hi])
        n_edges = e1 - e0
        bucket = pow2_bucket(n_edges)
        ids = np.zeros(chunk_size + bucket, np.int32)
        # Self block: the range itself; the tail past ``cnt`` is padding.
        ids[:chunk_size] = np.minimum(np.arange(lo, lo + chunk_size), n - 1)
        ids[chunk_size : chunk_size + n_edges] = row_index[e0:e1]
        pad_mask = np.ones(chunk_size + bucket, bool)
        pad_mask[:cnt] = False
        pad_mask[chunk_size : chunk_size + n_edges] = False
        seg = np.full(bucket, chunk_size, np.int32)  # pads → the dropped segment
        seg[:n_edges] = np.repeat(np.arange(cnt, dtype=np.int32), deg[lo:hi].astype(np.int64))
        degrees = np.zeros(chunk_size, np.float32)
        degrees[:cnt] = deg[lo:hi]
        pieces, piece_len = _pieces(deg[lo:hi].astype(np.int64))
        per_node = np.zeros(chunk_size, np.int64)
        per_node[:cnt] = pieces
        chunks.append(
            ChunkSpec(
                lo=lo,
                cnt=cnt,
                n_edges=n_edges,
                base_ids=ids,
                pad_mask=pad_mask,
                seg_ids=put(seg),
                degrees=put(degrees),
                live=put(~pad_mask),
                device_ids=put(ids),
                levels=(put(piece_len), put(per_node)),
            )
        )
    return ChunkPlan(chunk_size=chunk_size, chunks=chunks)


@dataclasses.dataclass
class LayerwiseReport:
    """Stage-time / hit-rate report for one layer-wise full-graph run,
    with the feature accounting split by source (layer-0 input rows vs
    intermediate embedding rows)."""

    policy: str
    num_nodes: int
    num_layers: int
    chunk_size: int
    num_chunks: int
    num_edges: int
    gather_seconds: float
    compute_seconds: float
    spill_seconds: float
    fill_seconds: float  # per-layer embedding-cache builds (mid-run)
    prep_seconds: float  # split probe + allocation + layer-0 cache re-fill
    feat_hits: int
    feat_lookups: int
    embed_hits: int
    embed_lookups: int
    feat_row_bytes: int
    embed_row_bytes: int
    pipeline_depth: int = 1
    prefetch_seconds: float = 0.0
    prefetched_rows: int = 0
    allocation: LayerwiseAllocation | None = None
    config: EngineConfig | None = None  # the resolved knobs this run used
    outputs: np.ndarray | None = dataclasses.field(default=None, repr=False)
    # MetricsRegistry.snapshot() at report time when given one; else None.
    metrics: dict | None = None
    device: str = "cpu"

    @property
    def total_seconds(self) -> float:
        return (
            self.gather_seconds
            + self.prefetch_seconds
            + self.compute_seconds
            + self.spill_seconds
            + self.fill_seconds
        )

    @property
    def feat_hit_rate(self) -> float:
        return self.feat_hits / max(self.feat_lookups, 1)

    @property
    def embed_hit_rate(self) -> float:
        return self.embed_hits / max(self.embed_lookups, 1)

    def modeled_transfer_seconds(self) -> float:
        """Byte movement projected on the sampled engine's slow/fast link
        pair.  Every layer moves the edge list once (the chunk schedule's
        adjacency reads are sequential host slices — all misses)."""
        return modeled_transfer_seconds(
            feat_lookups=self.feat_lookups,
            feat_hits=self.feat_hits,
            adj_lookups=self.num_layers * self.num_edges,
            adj_hits=0,
            feat_row_bytes=self.feat_row_bytes,
        ) + modeled_transfer_seconds(
            feat_lookups=self.embed_lookups,
            feat_hits=self.embed_hits,
            adj_lookups=0,
            adj_hits=0,
            feat_row_bytes=self.embed_row_bytes,
        )

    def summary(self) -> dict:
        out = {
            "policy": self.policy,
            "device": self.device,
            "mode": "layerwise",
            "nodes": self.num_nodes,
            "layers": self.num_layers,
            "chunk_size": self.chunk_size,
            "chunks": self.num_chunks,
            "pipeline_depth": self.pipeline_depth,
            "gather_s": self.gather_seconds,
            "prefetch_s": self.prefetch_seconds,
            "compute_s": self.compute_seconds,
            "spill_s": self.spill_seconds,
            "fill_s": self.fill_seconds,
            "total_s": self.total_seconds,
            "prep_s": self.prep_seconds,
            "feat_hit_rate": self.feat_hit_rate,
            "embed_hit_rate": self.embed_hit_rate,
            "modeled_transfer_s": self.modeled_transfer_seconds(),
        }
        if self.config is not None:
            out["config"] = self.config.to_dict()
        if self.metrics is not None:
            out["metrics"] = self.metrics
        return out

    def to_dict(self) -> dict:
        """The report as one JSON-safe dict (the summary)."""
        return self.summary()


def _probe_gather_seconds(
    store: FeatureStore, ids: torch.Tensor, reps: int = 2, *, tracer=NULL_TRACER, **gather_kw
) -> float:
    """Best-of-``reps`` synchronized gather lap over one chunk's index set —
    the layer-wise analogue of presampling's per-stage laps (Eq. 1 input).
    One untimed gather first (a kernel's first launch loads its library).
    Each synchronized lap is a ``sync:probe`` wait span."""
    with tracer.span("sync:probe", args=WAIT_ARGS["device"]):
        block_until_ready(store.gather(ids, **gather_kw)[0])
    best = float("inf")
    for _ in range(reps):
        with tracer.span("sync:probe", args=WAIT_ARGS["device"]):
            t0 = time.perf_counter()
            block_until_ready(store.gather(ids, **gather_kw)[0])
            best = min(best, time.perf_counter() - t0)
    return best


def _intermediate_width(params) -> int:
    """Widest intermediate layer output — what sizes the embedding cache's
    need bound (the spill tables are [N, dims[k]] for k = 1..L-1)."""
    widths = [out_width(p) for p in params[:-1]]
    return max(widths) if widths else out_width(params[-1])


def run_layerwise(
    dataset: SyntheticGraphDataset,
    pipe: PreparedPipeline,
    params,
    *,
    model: str,
    config: EngineConfig,
    tracer=None,
    metrics=None,
    allocation: LayerwiseAllocation | None = None,
) -> LayerwiseReport:
    """Score EVERY node: L chained chunked layer passes over the node range,
    on the device of ``pipe``'s caches.

    ``config`` must be resolved (every knob concrete — the engine's
    dispatch does this); ``config.dedup`` is ignored.  ``params`` is the
    model's list of per-layer weight mappings.  Outputs match an L-layer
    full-neighborhood sampled forward within fp tolerance.

    ``allocation`` replaces the Eq. 1 split, which reads wall-clock probe
    laps: given the same allocation, two runs fill the same caches and
    give the same hit counts.  The engine never passes it; tests and
    ``chip_smoke.py`` pass an earlier run's ``report.allocation``."""
    tracer = resolve_tracer(tracer)
    graph = dataset.graph
    n = graph.num_nodes
    num_layers = len(params)
    chunk_size = min(int(config.chunk_size), n)
    depth = 2 if config.pipeline_depth == "auto" else int(config.pipeline_depth)
    use_kernel = bool(config.use_kernel)
    prefetch = bool(config.prefetch)
    row_block = ROW_BLOCK if use_kernel else None
    dev = pipe.caches.store.hot_table.device
    on_cuda = dev.type == "cuda"

    # Per-pass set-up: each part is a span on the ``layers`` lane.
    with tracer.span("plan", lane="layers"):
        plan = plan_chunks(graph, chunk_size, device=dev)
        access_counts = layerwise_access_counts(graph)

    # ---- Eq. 1 split between the layer-0 feature cache and the (transient,
    # one-live-at-a-time) embedding cache, from probed chunk gather laps.
    # The probe gathers through kernel #2 on a card (the route the run's
    # kernel path takes), like presampling, and the plain version on the CPU.
    t_prep = time.perf_counter()
    total_bytes = pipe.caches.allocation.total_bytes if pipe.caches.allocation else 0
    embed_width = _intermediate_width(params)
    embed_row_bytes = embed_width * 4
    alloc = None
    feat_store = pipe.caches.store
    embed_bytes = 0
    if total_bytes > 0 and num_layers > 1:
        alloc = allocation
        if alloc is None:
            with tracer.span("probe", lane="layers") as probe:
                probe_ids = plan.chunks[0].device_ids
                probe_kw = dict(
                    use_kernel=on_cuda, row_block=ROW_BLOCK if on_cuda else None, tracer=tracer
                )
                t_feat = _probe_gather_seconds(pipe.caches.store, probe_ids, **probe_kw)
                ghost = plain_feature_store(
                    torch.zeros((n, embed_width), dtype=torch.float32, pin_memory=on_cuda),
                    device=dev,
                )
                t_embed = _probe_gather_seconds(ghost, probe_ids, **probe_kw)
                del ghost
                alloc = allocate_layerwise_capacity(
                    [t_feat],
                    [t_embed],
                    total_bytes,
                    feat_need_bytes=dataset.features.nbytes,
                    embed_need_bytes=n * embed_row_bytes,
                )
                if tracer.enabled:
                    probe.args = {
                        "t_feat_s": t_feat,
                        "t_embed_s": t_embed,
                        "feat_bytes": alloc.feat_bytes,
                        "embed_bytes": alloc.embed_bytes,
                    }
        embed_bytes = alloc.embed_bytes
        # Delta re-fill the layer-0 cache for the layer-wise access pattern
        # at its new share.  The pipe's own store is NOT changed.
        with tracer.span("refill", lane="layers"):
            feat_store, _ = refresh_feature_cache(
                pipe.caches.store, access_counts, alloc.feat_bytes
            )
    elif total_bytes > 0:  # single layer: no intermediates, whole budget to feats
        with tracer.span("refill", lane="layers"):
            feat_store, _ = refresh_feature_cache(pipe.caches.store, access_counts, total_bytes)
    prep_seconds = time.perf_counter() - t_prep

    clock = StageClock(overlap=depth > 1)
    state = {
        "feat_hits": 0,
        "feat_lookups": 0,
        "embed_hits": 0,
        "embed_lookups": 0,
        "prefetched_rows": 0,
        "spill_s": 0.0,
        "fill_s": 0.0,
    }
    out_host: torch.Tensor | None = None
    build_store: FeatureStore | None = None

    for layer in range(num_layers):
        store = feat_store if layer == 0 else build_store
        relu = layer < num_layers - 1
        out_dim = out_width(params[layer])
        # The spill table: pinned beside a card, so the next layer's
        # embedding store reads its misses over UVA without another copy.
        with tracer.span("spill-alloc", lane="layers"):
            out_host = torch.empty((n, out_dim), dtype=torch.float32, pin_memory=on_cuda)
        pad_id = max(store.pad_node_id(), 0)
        hits_key = "feat_hits" if layer == 0 else "embed_hits"
        lookups_key = "feat_lookups" if layer == 0 else "embed_lookups"

        def chunk_ids(spec: ChunkSpec, pad_id=pad_id) -> torch.Tensor:
            if pad_id == 0:
                return spec.device_ids
            return torch.where(spec.live, spec.device_ids, pad_id)

        def gather_fn(ctx, store=store, chunk_ids=chunk_ids):
            spec = ctx.payload
            lines = cached_gather_blocks.line_launches
            feats, hit = store.gather(
                chunk_ids(spec),
                use_kernel=use_kernel,
                prefetched=ctx.outputs.get("prefetch"),
                row_block=row_block,
            )
            # As the engine's feature stage: gathers that read by aligned lines.
            tracer.annotate(line_copies=cached_gather_blocks.line_launches - lines)
            return feats, (hit & spec.live).sum()

        def prefetch_fn(ctx, store=store, pad_id=pad_id):
            # Pads point at a cached id, so they never stage phantom miss
            # rows; duplicate live misses stage duplicate rows.
            spec = ctx.payload
            ids = spec.base_ids if pad_id == 0 else np.where(spec.pad_mask, pad_id, spec.base_ids)
            staged = store.prefetch_misses(ids)
            state["prefetched_rows"] += staged.num_miss
            return staged

        def layer_fn(spec: ChunkSpec, feats: torch.Tensor, layer=layer, relu=relu):
            with torch.inference_mode():
                return forward_layer(
                    params[layer],
                    feats[:chunk_size],
                    feats[chunk_size : chunk_size + spec.n_edges],  # the pad rows are not read
                    spec.seg_ids,
                    spec.degrees,
                    model=model,
                    num_dst=chunk_size,
                    relu=relu,
                    levels=spec.levels,
                )

        def compute_fn(ctx, layer_fn=layer_fn):
            return layer_fn(ctx.payload, ctx.outputs["gather"][0])

        def on_retire(ctx, out_host=out_host, hk=hits_key, lk=lookups_key):
            spec = ctx.payload
            t0 = time.perf_counter()
            with tracer.span("sync:spill", args=WAIT_ARGS["read"]):
                out_host[spec.lo : spec.lo + spec.cnt].copy_(ctx.outputs["compute"][: spec.cnt])
            state["spill_s"] += time.perf_counter() - t0
            with tracer.span("sync:hits", args=WAIT_ARGS["read"]):
                state[hk] += int(ctx.outputs["gather"][1])
            state[lk] += spec.cnt + spec.n_edges

        executor = PipelinedExecutor(
            [
                Stage("prefetch", prefetch_fn, lambda c: c.outputs["prefetch"])
                if prefetch
                else None,
                Stage("gather", gather_fn, lambda c: c.outputs["gather"]),
                Stage("compute", compute_fn, lambda c: c.outputs["compute"]),
            ],
            depth=depth,
            clock=clock,
            on_retire=on_retire,
            tracer=tracer,
        )
        # Warm the layer's route on its first chunk, outside the timed laps
        # (a kernel's first launch loads its library; cuBLAS sets up on its
        # first product).  Eager torch compiles nothing per bucket shape.
        first = plan.chunks[0]
        with tracer.span("warm", lane="layers", args={"layer": layer} if tracer.enabled else None):
            feats, _ = store.gather(
                chunk_ids(first),
                use_kernel=use_kernel,
                row_block=row_block,
            )
            warm_out = layer_fn(first, feats)
            with tracer.span("sync:warm", args=WAIT_ARGS["device"]):
                block_until_ready(warm_out)
            del feats, warm_out
        with tracer.span(
            f"layer {layer}",
            lane="layers",
            args={"layer": layer, "chunks": plan.num_chunks} if tracer.enabled else None,
        ):
            executor.run(plan.chunks)

        if relu:
            # Next layer's input store: the spilled table behind a fresh
            # embedding cache.  Only one is live at a time, so it gets the
            # full per-layer embedding share.
            t0 = time.perf_counter()
            with tracer.span("embed-fill", lane="layers", args={"layer": layer}):
                build_store = build_embedding_cache(
                    out_host, access_counts, embed_bytes, device=dev
                )
            state["fill_s"] += time.perf_counter() - t0

    report = LayerwiseReport(
        policy=pipe.name,
        num_nodes=n,
        num_layers=num_layers,
        chunk_size=chunk_size,
        num_chunks=plan.num_chunks,
        num_edges=graph.num_edges,
        gather_seconds=clock.total("gather"),
        compute_seconds=clock.total("compute"),
        spill_seconds=state["spill_s"],
        fill_seconds=state["fill_s"],
        prep_seconds=prep_seconds,
        feat_hits=state["feat_hits"],
        feat_lookups=state["feat_lookups"],
        embed_hits=state["embed_hits"],
        embed_lookups=state["embed_lookups"],
        feat_row_bytes=dataset.feature_nbytes_per_row(),
        embed_row_bytes=embed_row_bytes,
        pipeline_depth=depth,
        prefetch_seconds=clock.total("prefetch"),
        prefetched_rows=state["prefetched_rows"],
        allocation=alloc,
        config=config,
        outputs=out_host.numpy(),
        device=str(dev),
    )
    if metrics is not None:
        metrics.counter("chunks_total", mode="layerwise").inc(num_layers * plan.num_chunks)
        metrics.gauge("feat_hit_rate", mode="layerwise").set(report.feat_hit_rate)
        metrics.gauge("embed_hit_rate", mode="layerwise").set(report.embed_hit_rate)
        for name in ("gather", "prefetch", "compute"):
            metrics.gauge("stage_seconds", mode="layerwise", stage=name).set(clock.total(name))
        report.metrics = metrics.snapshot()
    return report
