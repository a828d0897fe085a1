"""End-to-end sampled GNN inference engine (the system Fig. 5 describes).

Pipeline per mini-batch: sample blocks (adjacency cache aware) → gather
input-frontier features (feature cache aware; RAIN reuses the previous
batch's rows instead) → run the GNN.  The engine
times each stage the way the paper decomposes Fig. 1/7, counts cache hits,
and reports a *modeled* transfer time from the H100's published link
rates.

Batch execution is delegated to the staged executor in
:mod:`repro_torch.runtime.pipeline`: ``pipeline_depth=1`` is the paper's
serial loop (a device sync after every stage), ``depth>1`` keeps that many
batches in flight so batch *i+1*'s sampling/gather overlap batch *i*'s
forward on the CUDA stream.  Four execution knobs — ``prefetch`` (stage
each batch's missed host rows onto the device in a stage of their own,
between sample and feature, copied on a side CUDA stream), ``use_kernel``
(route gathers through the CUDA ``cached_gather`` kernels),
``gather_buffers`` (validated, no effect on the card) and ``dedup``
(sort-and-unique each input frontier on the device and
gather/prefetch/model one row per DISTINCT node, expanding through the
inverse map) — default from the prepared pipeline.  Outputs, hit counts
and batch order are identical under every knob combination.
``EngineConfig(mode="layerwise")`` dispatches to the chunked full-graph
executor (:mod:`repro_torch.runtime.layerwise`) instead.

The RNG seam: slot draws come from one ``torch.Generator`` per stream,
seeded ``seed + 1``, unless :meth:`GNNInferenceEngine.run` is given the
draws (one ``r`` tensor per batch and layer) — which is how the tests
replay the JAX reference's draws.

Not ported yet (each raises when asked for): online refresh, fault
injection / retry / degraded mode.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.policies import PreparedPipeline, prepare
from repro_torch.core.trace import resolve_tracer
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import SyntheticGraphDataset
from repro_torch.graph.sampling import pow2_bucket, sample_blocks
from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK
from repro_torch.models.gnn.models import GNN, init_params
from repro_torch.runtime.pipeline import PipelinedExecutor, Stage
from repro_torch.utils.timing import StageClock, block_until_ready

if TYPE_CHECKING:
    from repro_torch.runtime.layerwise import LayerwiseReport

__all__ = [
    "GNNInferenceEngine",
    "InferenceReport",
    "StreamRuntime",
    "auto_pipeline_depth",
    "modeled_transfer_seconds",
    "stream_stages",
]

# Link rates for the modeled-transfer projection (bytes/s), from NVIDIA's
# H100 SXM data sheet: PCIe Gen5 x16 (128 GB/s both ways, 64 GB/s each
# way) carries the UVA miss path; HBM3 at 3.35 TB/s the cache-hit path.
PCIE5_BW = 64e9
HBM3_BW = 3.35e12

ADJ_ENTRY_BYTES = 4  # one int32 neighbor id per adjacency lookup


def modeled_transfer_seconds(
    *,
    feat_lookups: int,
    feat_hits: int,
    adj_lookups: int,
    adj_hits: int,
    feat_row_bytes: int,
    slow_bw: float = PCIE5_BW,
    fast_bw: float = HBM3_BW,
) -> float:
    """Project byte movement onto a slow (miss) / fast (hit) link pair."""
    miss_bytes = (feat_lookups - feat_hits) * feat_row_bytes + (
        adj_lookups - adj_hits
    ) * ADJ_ENTRY_BYTES
    hit_bytes = feat_hits * feat_row_bytes + adj_hits * ADJ_ENTRY_BYTES
    return miss_bytes / slow_bw + hit_bytes / fast_bw


@dataclasses.dataclass
class InferenceReport:
    policy: str
    num_batches: int
    sample_seconds: float
    feature_seconds: float
    compute_seconds: float
    prep_seconds: float
    adj_hits: int
    adj_lookups: int
    feat_hits: int
    feat_lookups: int
    feat_row_bytes: int
    pipeline_depth: int = 1
    # The prefetch stage (off by default) books the host->device staging
    # of the missed rows; ``prefetched_rows`` counts the rows staged.
    prefetch: bool = False
    prefetch_seconds: float = 0.0
    prefetched_rows: int = 0
    # Unique-frontier accounting: ``unique_rows`` sums each batch's
    # distinct input nodes, ``gathered_rows`` the rows the feature stage
    # actually pulled (the pow2 gather buckets under dedup, every
    # duplicate otherwise).  feat_lookups stays the per-visit count, so
    # hit rates are dedup-invariant.
    dedup: bool = False
    unique_rows: int = 0
    gathered_rows: int = 0
    # The RESOLVED config the run executed with (every knob concrete).
    config: EngineConfig | None = None
    device: str = "cpu"
    # MetricsRegistry.snapshot() at report time when the run was given a
    # registry; None otherwise.
    metrics: dict | None = None

    @property
    def total_seconds(self) -> float:
        return (
            self.sample_seconds
            + self.prefetch_seconds
            + self.feature_seconds
            + self.compute_seconds
        )

    @property
    def adj_hit_rate(self) -> float:
        return self.adj_hits / max(self.adj_lookups, 1)

    @property
    def feat_hit_rate(self) -> float:
        return self.feat_hits / max(self.feat_lookups, 1)

    @property
    def duplication_factor(self) -> float:
        """Mean input-frontier duplication: per-visit lookups over distinct
        rows (1.0 when dedup is off)."""
        if not self.unique_rows:
            return 1.0
        return self.feat_lookups / self.unique_rows

    def modeled_transfer_seconds(
        self, slow_bw: float = PCIE5_BW, fast_bw: float = HBM3_BW
    ) -> float:
        return modeled_transfer_seconds(
            feat_lookups=self.feat_lookups,
            feat_hits=self.feat_hits,
            adj_lookups=self.adj_lookups,
            adj_hits=self.adj_hits,
            feat_row_bytes=self.feat_row_bytes,
            slow_bw=slow_bw,
            fast_bw=fast_bw,
        )

    def summary(self) -> dict:
        out = {
            "policy": self.policy,
            "device": self.device,
            "batches": self.num_batches,
            "pipeline_depth": self.pipeline_depth,
            "prefetch": self.prefetch,
            "dedup": self.dedup,
            "sample_s": self.sample_seconds,
            "prefetch_s": self.prefetch_seconds,
            "feature_s": self.feature_seconds,
            "compute_s": self.compute_seconds,
            "total_s": self.total_seconds,
            "prep_s": self.prep_seconds,
            "adj_hit_rate": self.adj_hit_rate,
            "feat_hit_rate": self.feat_hit_rate,
            "modeled_transfer_s": self.modeled_transfer_seconds(),
        }
        if self.config is not None:
            out["config"] = self.config.to_dict()
        if self.prefetch:
            out["prefetched_rows"] = self.prefetched_rows
        if self.dedup:
            out["unique_rows"] = self.unique_rows
            out["gathered_rows"] = self.gathered_rows
            out["duplication_factor"] = self.duplication_factor
        if self.metrics is not None:
            out["metrics"] = self.metrics
        return out


class StreamRuntime:
    """Cross-batch state and stage logic for ONE stream of mini-batches.

    Owns the stream's slot-draw source (a generator, or the given per-batch
    draws), RAIN's previous-batch reuse state, the hit counters and
    (optionally) the collected logits.  Stage methods are invoked in batch
    order at any pipeline depth, which is what the generator's sequence and
    the reuse state rely on."""

    def __init__(
        self,
        pipe: PreparedPipeline,
        model: GNN,
        *,
        fanouts: tuple[int, ...],
        generator: torch.Generator | None = None,
        draws: Sequence[Sequence[torch.Tensor]] | None = None,
        collect_outputs: bool = False,
        prefetch: bool | None = None,
        use_kernel: bool | None = None,
        gather_buffers: int | None = None,
        dedup: bool | None = None,
    ):
        if generator is None and draws is None:
            raise ValueError("StreamRuntime needs a generator or the per-batch draws")
        self.pipe = pipe
        self.model = model
        self.fanouts = tuple(fanouts)
        self.generator = generator
        self.draws = draws
        self.prefetch = pipe.prefetch if prefetch is None else prefetch
        self.use_kernel = pipe.use_kernel if use_kernel is None else use_kernel
        self.gather_buffers = pipe.gather_buffers if gather_buffers is None else gather_buffers
        # RAIN's reuse map addresses individual frontier positions of the
        # previous batch, the layout dedup collapses, so the two are
        # mutually exclusive and reuse wins.
        self.dedup = (pipe.dedup if dedup is None else dedup) and not pipe.reuse_prev_batch
        self.adj_hits = 0
        self.adj_lookups = 0
        self.feat_hits = 0
        self.feat_lookups = 0
        self.prefetched_rows = 0
        self.unique_rows = 0  # sum of per-batch distinct input nodes (dedup)
        self.gathered_rows = 0  # rows the feature stage actually gathered
        self.outputs: list[np.ndarray] | None = [] if collect_outputs else None
        # RAIN cross-batch reuse state (only touched when the policy asks).
        self._prev_map = np.full(pipe.caches.store.num_nodes, -1, np.int64)
        self._prev_feats: torch.Tensor | None = None
        self._prev_nodes: np.ndarray | None = None

    # ------------------------------------------------------------- stages
    def sample(self, ctx):
        caches = self.pipe.caches
        block = sample_blocks(
            caches.dgraph,
            ctx.payload,
            self.fanouts,
            generator=self.generator,
            draws=None if self.draws is None else self.draws[ctx.index],
            dedup=self.dedup,
            # Pad the unique bucket's tail with a known-cached id, so pad
            # slots are feature-cache hits, never phantom miss rows.
            dedup_pad_id=caches.store.pad_node_id() if self.dedup else None,
        )
        bh, bt = block.adj_hit_stats()
        if self.dedup:
            # The one forced sync of the dedup path (reading num_unique)
            # is booked to the stage that produced it.
            self._resolve_dedup(ctx, block)
        return block, bh, bt

    def _resolve_dedup(self, ctx, block):
        """Cache the batch's unique-frontier view on its context:
        ``(dedup, num_unique, bucket, unique_ids[:bucket])``.  The bucket
        is the batch's own pow2 ceiling, so ``gathered_rows <= 2 *
        unique_rows`` per batch."""
        dd = block.dedup
        nu = int(dd.num_unique)
        bucket = pow2_bucket(nu, int(dd.unique_ids.shape[0]))
        view = (dd, nu, bucket, dd.unique_ids[:bucket])
        ctx.outputs["_dedup"] = view
        return view

    def prefetch_stage(self, ctx):
        """Stage the batch's MISSED host rows onto the device.

        Sits between ``sample`` and ``feature``: the copy runs on a side
        stream, and the feature stage then reads misses from the staged
        pack.  The stage first reads the batch's ids back to the host,
        which waits for the compute stream's queued work, so even at
        ``depth > 1`` the staging does not overlap the previous batch's
        forward.  The hit mask (and all accounting) still comes from
        ``position_map``, so hit counts are identical with prefetch on or
        off.  Under ``dedup`` only the batch's DISTINCT missed rows are
        staged (the live prefix of the unique bucket)."""
        store = self.pipe.caches.store
        if self.dedup:
            _, nu, _, uids = ctx.outputs["_dedup"]
            staged = store.prefetch_misses(uids, num_live=nu)
        else:
            staged = store.prefetch_misses(ctx.outputs["sample"][0].input_nodes)
        self.prefetched_rows += staged.num_miss
        return staged

    def feature(self, ctx):
        block = ctx.outputs["sample"][0]
        store = self.pipe.caches.store
        gather_kw = dict(
            use_kernel=self.use_kernel,
            gather_buffers=self.gather_buffers,
            prefetched=ctx.outputs.get("prefetch"),
        )
        if self.dedup:
            # Gather each distinct row once (sorted ids → the row-block
            # kernel's contiguous runs on the kernel route); the per-visit
            # hit mask is the unique mask expanded through the inverse map.
            dd, nu, bucket, uids = ctx.outputs["_dedup"]
            feats_u, hit_u = store.gather(
                uids, row_block=ROW_BLOCK if self.use_kernel else None, **gather_kw
            )
            hit = hit_u[dd.inverse.to(torch.int64)]
            self.unique_rows += nu
            self.gathered_rows += bucket
            return feats_u, hit, hit.sum()
        self.gathered_rows += int(block.input_nodes.shape[0])
        nodes = None
        if self.pipe.reuse_prev_batch:
            nodes = block.input_nodes.cpu().numpy()  # the reuse lookup runs on the host
        if self._prev_feats is not None:
            # RAIN: a row the previous batch loaded is taken from its
            # features.  As in the reference, every row is still gathered
            # and the reused ones are selected afterwards, so the feature
            # stage moves all of the frontier's bytes.
            pos = self._prev_map[nodes]
            hit_np = pos >= 0
            device = block.input_nodes.device
            reused = self._prev_feats[torch.from_numpy(np.maximum(pos, 0)).to(device)]
            fresh, _ = store.gather(block.input_nodes, **gather_kw)
            hit = torch.from_numpy(hit_np).to(device)
            feats = torch.where(hit[:, None], reused, fresh)
        else:
            feats, hit = store.gather(block.input_nodes, **gather_kw)
        if nodes is not None:
            # The NEXT batch's feature stage reads this state, so it is
            # updated here and not at retire: at depth > 1 batch i retires
            # only after batch i+1 has dispatched.
            if self._prev_nodes is not None:
                self._prev_map[self._prev_nodes] = -1
            self._prev_nodes = nodes
            self._prev_map[nodes] = np.arange(len(nodes))
            self._prev_feats = feats
        return feats, hit, hit.sum()

    def compute(self, ctx):
        feats = ctx.outputs["feature"][0]
        inverse = ctx.outputs["_dedup"][0].inverse if self.dedup else None
        with torch.inference_mode():
            return self.model(feats, inverse_index=inverse)

    def record(self, ctx) -> None:
        """Host-side accounting; runs per batch, in order, after the batch's
        stage outputs are ready, so the int() reads are cheap."""
        _, bh, bt = ctx.outputs["sample"]
        hit, hsum = ctx.outputs["feature"][1], ctx.outputs["feature"][2]
        self.adj_hits += int(bh)
        self.adj_lookups += int(bt)
        self.feat_hits += int(hsum)
        self.feat_lookups += int(hit.shape[0])
        if self.outputs is not None:
            self.outputs.append(ctx.outputs["compute"].cpu().numpy())


def stream_stages(runtime_of, *, prefetch: bool = False) -> list[Stage]:
    """The sample → [prefetch] → feature → compute pipeline over
    :class:`StreamRuntime`s.

    ``runtime_of(ctx)`` resolves the runtime a batch belongs to.  Sync
    values are what each stage leaves in flight (tuples of tensors) — what
    the serial clock blocks on and the overlap clock drains.
    ``prefetch=True`` inserts the miss-row staging stage between sample
    and feature; off, the executor drops the ``None`` placeholder."""
    return [
        Stage(
            "sample",
            lambda c: runtime_of(c).sample(c),
            lambda c: (c.outputs["sample"][0].frontiers[-1], c.outputs["sample"][1]),
        ),
        Stage(
            "prefetch",
            lambda c: runtime_of(c).prefetch_stage(c),
            lambda c: c.outputs["prefetch"],
        )
        if prefetch
        else None,
        Stage(
            "feature",
            lambda c: runtime_of(c).feature(c),
            lambda c: (c.outputs["feature"][0], c.outputs["feature"][2]),
        ),
        Stage("compute", lambda c: runtime_of(c).compute(c), lambda c: c.outputs["compute"]),
    ]


# Below this, a measured stage lap is indistinguishable from clock noise.
DEGENERATE_LAP_SECONDS = 1e-6


def auto_pipeline_depth(prep_seconds: float, compute_seconds: float, *, max_depth: int = 4) -> int:
    """Pick an executor window from the measured compute:prep ratio.

    ``depth=2`` already hides prep when compute >= prep; when prep
    dominates, roughly one extra slot per compute-sized chunk of prep,
    saturating at ``max_depth``.  A ~zero prep lap returns 1 (nothing to
    hide); a ~zero compute lap with real prep returns 2."""
    if prep_seconds <= DEGENERATE_LAP_SECONDS:
        return 1
    if compute_seconds <= DEGENERATE_LAP_SECONDS:
        return 2
    return max(2, min(max_depth, 1 + round(prep_seconds / compute_seconds)))


class GNNInferenceEngine:
    """DCI's sampled inference for one request stream, on ``device``
    (CUDA unless ``device="cpu"``; raises when no card is found)."""

    def __init__(
        self,
        dataset: SyntheticGraphDataset,
        *,
        model: str = "graphsage",
        fanouts: tuple[int, ...] = (15, 10, 5),
        batch_size: int = 1024,
        seed: int = 0,
        params=None,
        pipeline_depth: int | str = 1,
        device: torch.device | str | None = None,
    ):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.model_name = model
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        self.seed = seed
        self.pipeline_depth = pipeline_depth
        if params is None:
            # Drawn on a CPU generator, so a seed gives the same weights
            # on every device.
            params = init_params(
                torch.Generator().manual_seed(seed),
                model,
                dataset.spec.feat_dim,
                dataset.spec.num_classes,
            )
        self.model = GNN(
            [{k: v.to(self.device) for k, v in layer.items()} for layer in params],
            model=model,
            fanouts=self.fanouts,
        )
        self.pipeline: PreparedPipeline | None = None
        self.last_outputs: list[np.ndarray] | None = None
        self._auto_depth: int | None = None

    # ------------------------------------------------------------ prepare
    def prepare(
        self,
        policy: str,
        *,
        config: EngineConfig | None = None,
        total_cache_bytes: int = 0,
        n_presample: int = 8,
        pipeline_depth: int = 1,
    ) -> PreparedPipeline:
        """Presample, split and fill the caches on the engine's device; the
        config's gather knobs become the pipeline's run defaults."""
        cfg = config if config is not None else EngineConfig()
        self.pipeline = prepare(
            policy,
            self.dataset,
            total_cache_bytes=total_cache_bytes,
            fanouts=self.fanouts,
            batch_size=self.batch_size,
            n_presample=n_presample,
            seed=self.seed,
            pipeline_depth=pipeline_depth,
            prefetch=bool(cfg.prefetch),
            use_kernel=bool(cfg.use_kernel),
            gather_buffers=2 if cfg.gather_buffers is None else cfg.gather_buffers,
            dedup=bool(cfg.dedup),
            device=self.device,
        )
        return self.pipeline

    # ---------------------------------------------------------------- run
    def _batches(self, max_batches: int | None) -> list[np.ndarray]:
        test = self.dataset.test_idx
        nb = max(len(test) // self.batch_size, 1)
        need = nb * self.batch_size
        if len(test) < need:  # tiny datasets: cycle to fill one batch
            reps = -(-need // max(len(test), 1))
            test = np.tile(test, reps)
        arr = test[:need].reshape(nb, self.batch_size)
        order = (
            self.pipeline.batch_order
            if self.pipeline is not None and self.pipeline.batch_order is not None
            else np.arange(nb)
        )
        if max_batches is not None:
            order = order[:max_batches]
        return [arr[i] for i in order]

    def _seeds(self, seeds: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(seeds, np.int32)).to(self.device)

    def warmup(
        self,
        seeds: np.ndarray,
        *,
        prefetch: bool | None = None,
        use_kernel: bool | None = None,
        gather_buffers: int | None = None,
        dedup: bool | None = None,
    ) -> None:
        """Run one batch through the route the run will use, outside any
        timed region: the first kernel launch builds and loads the CUDA
        library, cuBLAS sets up on its first product, and with prefetch
        the side stream, the pinned-buffer pool and the pack worker start.
        Draws come from a generator of its own, so the run's sequence is
        untouched.  (The reference also warms every pow2 pack bucket,
        because each compiles its own gather program; eager torch compiles
        nothing per shape.)"""
        if self.pipeline is None:
            raise RuntimeError("call prepare() first")
        pipe = self.pipeline
        prefetch = pipe.prefetch if prefetch is None else prefetch
        use_kernel = pipe.use_kernel if use_kernel is None else use_kernel
        gather_buffers = pipe.gather_buffers if gather_buffers is None else gather_buffers
        dedup = (pipe.dedup if dedup is None else dedup) and not pipe.reuse_prev_batch
        store = pipe.caches.store
        wblock = sample_blocks(
            pipe.caches.dgraph,
            self._seeds(seeds),
            self.fanouts,
            generator=torch.Generator(device=self.device).manual_seed(self.seed + 1),
            dedup=dedup,
            dedup_pad_id=store.pad_node_id() if dedup else None,
        )
        if dedup:
            nu = int(wblock.dedup.num_unique)
            bucket = pow2_bucket(nu, int(wblock.input_nodes.shape[0]))
            gather_ids = wblock.dedup.unique_ids[:bucket]
            inverse = wblock.dedup.inverse
            row_block = ROW_BLOCK if use_kernel else None
        else:
            nu = None
            gather_ids, inverse, row_block = wblock.input_nodes, None, None
        prefetched = store.prefetch_misses(gather_ids, num_live=nu) if prefetch else None
        wfeats, _ = store.gather(
            gather_ids,
            use_kernel=use_kernel,
            gather_buffers=gather_buffers,
            prefetched=prefetched,
            row_block=row_block,
        )
        with torch.inference_mode():
            block_until_ready(self.model(wfeats, inverse_index=inverse))

    # ------------------------------------------------------ adaptive depth
    def resolve_pipeline_depth(self, depth=None, *, seeds=None) -> int:
        """Resolve the ``pipeline_depth`` knob, including ``"auto"``: one
        synchronized probe batch (after a warmup) gives the compute:prep
        ratio.  A degenerate probe resolves to 1 and is not cached."""
        if depth is None:
            depth = self.pipeline_depth
        if depth != "auto":
            return int(depth)
        if self._auto_depth is None:
            if self.pipeline is None:
                raise RuntimeError("call prepare() before resolving pipeline_depth='auto'")
            if seeds is None:
                seeds = self._batches(1)[0]
            sample_s, feature_s, compute_s = self._probe_stage_seconds(np.asarray(seeds))
            derived = auto_pipeline_depth(sample_s + feature_s, compute_s)
            if derived < 2:
                return 1
            self._auto_depth = derived
        return self._auto_depth

    def _probe_stage_seconds(self, seeds: np.ndarray) -> tuple[float, float, float]:
        """Fully synchronized per-stage seconds for one batch (best of 2)."""
        self.warmup(seeds)
        pipe = self.pipeline
        best = None
        for rep in range(2):
            gen = torch.Generator(device=self.device).manual_seed(self.seed + 1000 + rep)
            t0 = time.perf_counter()
            block = sample_blocks(pipe.caches.dgraph, self._seeds(seeds), self.fanouts, generator=gen)
            block_until_ready(block.frontiers[-1])
            t1 = time.perf_counter()
            feats, _ = pipe.caches.store.gather(block.input_nodes)
            block_until_ready(feats)
            t2 = time.perf_counter()
            with torch.inference_mode():
                block_until_ready(self.model(feats))
            t3 = time.perf_counter()
            lap = (t1 - t0, t2 - t1, t3 - t2)
            best = lap if best is None or sum(lap) < sum(best) else best
        return best

    def run(
        self,
        *,
        config: EngineConfig | None = None,
        max_batches: int | None = None,
        warmup: bool = True,
        collect_outputs: bool = False,
        batches: list[np.ndarray] | None = None,
        draws: Sequence[Sequence[torch.Tensor]] | None = None,
        tracer=None,
        metrics=None,
    ) -> "InferenceReport | LayerwiseReport":
        """Run inference over the dataset's test batches (or explicit seed
        ``batches``) and return the stage-time / hit-rate report.

        ``draws[b][l]`` (optional) is batch ``b``'s slot-draw tensor for
        expansion layer ``l``; without it the stream draws from a
        generator seeded ``seed + 1``.  ``config`` carries the knobs; its
        unset ones default from the prepared pipeline (the reference's
        deprecated loose keywords are not carried over).  ``batches``
        overrides the dataset's schedule (and RAIN's ``batch_order``).
        ``metrics`` (a :class:`~repro_torch.core.trace.MetricsRegistry`)
        is folded with the run's outcomes and snapshotted onto the report.

        ``config.mode="layerwise"`` scores EVERY node through the chunked
        full-graph executor (:func:`~repro_torch.runtime.layerwise.
        run_layerwise`) and returns its report (``batches``,
        ``max_batches`` and ``draws`` do not apply; ``"auto"`` depth
        resolves to 2)."""
        if self.pipeline is None:
            raise RuntimeError("call prepare() first")
        pipe = self.pipeline
        cfg = config if config is not None else EngineConfig()
        cfg.refresh_config()  # raises unless refresh is off
        requested = self.pipeline_depth if cfg.pipeline_depth is None else cfg.pipeline_depth
        if cfg.mode == "layerwise":
            from repro_torch.runtime.layerwise import run_layerwise

            depth = 2 if requested == "auto" else int(requested)
            report = run_layerwise(
                self.dataset,
                pipe,
                list(self.model.layers),
                model=self.model_name,
                config=cfg.resolved(pipe, pipeline_depth=depth),
                tracer=tracer,
                metrics=metrics,
            )
            self.last_outputs = [report.outputs]
            return report
        tracer = resolve_tracer(tracer)
        if batches is None:
            batches = self._batches(max_batches)
        if draws is not None and len(draws) < len(batches):
            raise ValueError(f"draws cover {len(draws)} batches, the run has {len(batches)}")
        depth = self.resolve_pipeline_depth(requested, seeds=batches[0] if batches else None)
        if warmup and batches:
            self.warmup(
                batches[0],
                prefetch=cfg.prefetch,
                use_kernel=cfg.use_kernel,
                gather_buffers=cfg.gather_buffers,
                dedup=cfg.dedup,
            )
        rt = StreamRuntime(
            pipe,
            self.model,
            fanouts=self.fanouts,
            generator=(
                None
                if draws is not None
                else torch.Generator(device=self.device).manual_seed(self.seed + 1)
            ),
            draws=draws,
            collect_outputs=collect_outputs,
            prefetch=cfg.prefetch,
            use_kernel=cfg.use_kernel,
            gather_buffers=cfg.gather_buffers,
            dedup=cfg.dedup,
        )
        clock = StageClock(overlap=depth > 1)
        executor = PipelinedExecutor(
            stream_stages(lambda c: rt, prefetch=rt.prefetch),
            depth=depth,
            clock=clock,
            on_retire=rt.record,
            tracer=tracer,
        )
        executor.run(self._seeds(b) for b in batches)
        self.last_outputs = rt.outputs
        resolved = cfg.resolved(pipe, pipeline_depth=depth).replace(
            prefetch=rt.prefetch,
            use_kernel=rt.use_kernel,
            gather_buffers=rt.gather_buffers,
            dedup=rt.dedup,
        )
        report = InferenceReport(
            policy=pipe.name,
            num_batches=len(batches),
            sample_seconds=clock.total("sample"),
            feature_seconds=clock.total("feature"),
            compute_seconds=clock.total("compute"),
            prep_seconds=pipe.prep_seconds,
            adj_hits=rt.adj_hits,
            adj_lookups=rt.adj_lookups,
            feat_hits=rt.feat_hits,
            feat_lookups=rt.feat_lookups,
            feat_row_bytes=self.dataset.feature_nbytes_per_row(),
            pipeline_depth=depth,
            prefetch=rt.prefetch,
            prefetch_seconds=clock.total("prefetch"),
            prefetched_rows=rt.prefetched_rows,
            dedup=rt.dedup,
            unique_rows=rt.unique_rows,
            gathered_rows=rt.gathered_rows,
            config=resolved,
            device=str(self.device),
        )
        if metrics is not None:
            metrics.counter("batches_total", policy=pipe.name).inc(report.num_batches)
            metrics.gauge("feat_hit_rate", policy=pipe.name).set(report.feat_hit_rate)
            metrics.gauge("adj_hit_rate", policy=pipe.name).set(report.adj_hit_rate)
            for name in ("sample", "prefetch", "feature", "compute"):
                metrics.gauge("stage_seconds", policy=pipe.name, stage=name).set(
                    clock.total(name)
                )
            report.metrics = metrics.snapshot()
        return report
