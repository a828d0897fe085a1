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
forward on the CUDA stream.  The gather route is three knobs —
``prefetch`` (stage each batch's missed host rows onto the device in a
stage of their own, between sample and feature, copied on a side CUDA
stream), ``use_kernel`` (route gathers through the CUDA ``cached_gather``
kernels) and ``dedup`` (sort-and-unique each input frontier on the device
and gather/prefetch/model one row per DISTINCT node, expanding through the
inverse map) — resolved once against the prepared pipeline by
:meth:`~repro_torch.core.config.EngineConfig.resolved`; each
:class:`StreamRuntime` takes that resolved config as its ``route``.
Outputs, hit counts and batch order are identical under every route.
Warm-up and the ``"auto"`` depth probe run one batch through a scratch
runtime's own stages (:meth:`StreamRuntime.run_batch`).

Overlapped on a card (``pipeline_depth > 1``, a CUDA device), no stage
waits on the whole device.  The sample stage copies the seeds and samples
on a high-priority stream of the runtime's own, so its one read
(``num_unique``, under dedup) waits for the sampling alone and not for the
previous batch's gather and forward queued on the compute stream, which
waits for the sample's event before the batch's feature stage.  Each stage
records a CUDA event at the end of its dispatch, and retire waits on those
events (:mod:`repro_torch.runtime.pipeline`).  The compute stage copies the
batch's hit counts and logits into pinned host buffers before its event,
so ``record`` reads host memory and makes no blocking read.  The draws,
the ops and their order are the same, so the outputs and counts are the
same bits.  Serial runs (depth 1) and the CPU keep one stream and the
whole-device synchronize.
``EngineConfig(mode="layerwise")`` dispatches to the chunked full-graph
executor (:mod:`repro_torch.runtime.layerwise`) instead.

The RNG seam: slot draws come from one ``torch.Generator`` per stream,
seeded ``seed + 1``, unless :meth:`GNNInferenceEngine.run` is given the
draws (one ``r`` tensor per batch and layer) — which is how the tests
replay the JAX reference's draws.  A stream counts its own batches, so a
stream served beside others (:mod:`repro_torch.runtime.gnn_serve`) reads
its own draws.

Fault tolerance (:mod:`repro_torch.core.faults`,
:mod:`repro_torch.core.retry`): with an injector, the sample, prefetch
and feature stages charge their fault sites and run under the retry
policy; a ``kernel_gather`` fault reroutes that gather to the table route
(counted in ``kernel_fallbacks``), and under ``degraded_mode`` a dead
miss path serves cache-only rows.  A real error, from a CUDA build or
launch included, is never retried or rerouted.

Online refresh (``EngineConfig.refresh_mode`` or ``run(refresh=...)``,
:mod:`repro_torch.runtime.cache_refresh`): the retire path records each
batch into a telemetry window, and the refresh manager re-allocates and
delta re-fills the shared ``DualCache`` between batches.  A batch reads
the caches at the points the reference reads them — the adjacency cache
at sample time (where its epoch is stamped), the feature store at
prefetch and feature time — so its hits land in the epoch the reference
books them to.  Logits are the same with refresh on or off; hit counts
come per epoch in ``InferenceReport.epoch_hits``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.core.faults import InjectedFault
from repro_torch.core.policies import PreparedPipeline, prepare
from repro_torch.core.retry import RetryExhausted, StageTimeout, call_with_retry
from repro_torch.core.trace import NULL_TRACER, WAIT_ARGS, resolve_tracer
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import SyntheticGraphDataset
from repro_torch.graph.sampling import pow2_bucket, sample_blocks
from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK, cached_gather_blocks
from repro_torch.kernels.sample_layer.kernel import sample_layer
from repro_torch.models.gnn.models import GNN, init_params
from repro_torch.runtime.pipeline import PipelinedExecutor, Stage
from repro_torch.utils.timing import StageClock

if TYPE_CHECKING:
    from repro_torch.runtime.layerwise import LayerwiseReport

__all__ = [
    "FAULT_ERRORS",
    "GNNInferenceEngine",
    "InferenceReport",
    "StreamRuntime",
    "auto_pipeline_depth",
    "host_seeds",
    "modeled_transfer_seconds",
    "stream_stages",
    "summarize_epoch_counters",
]

# Link rates for the modeled-transfer projection (bytes/s), from NVIDIA's
# H100 SXM data sheet: PCIe Gen5 x16 (128 GB/s both ways, 64 GB/s each
# way) carries the UVA miss path; HBM3 at 3.35 TB/s the cache-hit path.
PCIE5_BW = 64e9
HBM3_BW = 3.35e12

ADJ_ENTRY_BYTES = 4  # one int32 neighbor id per adjacency lookup

# The errors of the fault subsystem: the only ones a retry, a degraded
# fallback or a shedding server handles; any other error propagates.
FAULT_ERRORS = (InjectedFault, RetryExhausted, StageTimeout)

# ``ctx.outputs`` key of the CUDA event a stage records at the end of its
# dispatch (overlapped on a card), by stage name.
_DONE = "_done:"


def host_seeds(seeds: np.ndarray) -> torch.Tensor:
    """A batch's seeds as the int32 host tensor the executor carries: the
    sample stage copies them to the card on the stream it samples on."""
    return torch.from_numpy(np.ascontiguousarray(seeds, np.int32))


def _fault_site(err: BaseException) -> str | None:
    """The site of a fault-subsystem error (of the last attempt, when the
    retries ran out).  Handlers read the site through this and keep no
    local that refers to the error: its traceback holds the frames below
    the handler's, whose ``f_back`` chain leads back to the handler's
    frame, so such a local would keep the batch's tensors in a cycle
    until the next garbage collection."""
    return getattr(err.last if isinstance(err, RetryExhausted) else err, "site", None)


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
    # Batches whose model layer 0 ran in one kernel, reading its rows
    # through the inverse map where there is one (``GNN.fused_forwards``):
    # every batch on a card, none on the CPU.
    fused_batches: int = 0
    # Online-refresh accounting (empty/None with refresh off, leaving the
    # report as it was):
    refresh_events: list = dataclasses.field(default_factory=list)
    epoch_hits: dict | None = None  # epoch -> per-epoch hit-rate summary
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
        if self.fused_batches:
            out["fused_batches"] = self.fused_batches
        if self.refresh_events:
            # Per-epoch rates beside the lifetime ones: a lifetime mean
            # hides the recovery a refresh exists to produce.
            out["refresh_events"] = [e.summary() for e in self.refresh_events]
            out["per_epoch"] = self.epoch_hits
        if self.metrics is not None:
            out["metrics"] = self.metrics
        return out


class StreamRuntime:
    """Cross-batch state and stage logic for ONE stream of mini-batches.

    Owns the stream's slot-draw source (a generator, or the given per-batch
    draws, indexed by the stream's own batch count), RAIN's previous-batch
    reuse state, the hit and fault counters and (optionally) the collected
    logits.  The engine runs one; the multi-stream server
    (:mod:`repro_torch.runtime.gnn_serve`) runs one per stream against a
    single shared cache, which the stages only read, so each stream's
    draws, reuse and counts equal its solo run.  Stage methods are invoked
    in the stream's batch order at any pipeline depth, which is what the
    generator's sequence, the batch count and the reuse state rely on.

    Hits are also counted per cache epoch (``epoch_counters``), and with
    online refresh on, each retired batch is recorded into the refresh
    manager's ``telemetry`` sink.

    ``route`` is the gather route, an :class:`EngineConfig` resolved
    against ``pipe`` (:meth:`EngineConfig.resolved`); ``prefetch``,
    ``use_kernel`` and ``dedup`` are reads of it."""

    def __init__(
        self,
        pipe: PreparedPipeline,
        model: GNN,
        *,
        fanouts: tuple[int, ...],
        route: EngineConfig,
        generator: torch.Generator | None = None,
        draws: Sequence[Sequence[torch.Tensor]] | None = None,
        collect_outputs: bool = False,
        injector=None,
        retry_policy=None,
        degraded_mode: bool = False,
    ):
        if generator is None and draws is None:
            raise ValueError("StreamRuntime needs a generator or the per-batch draws")
        self.pipe = pipe
        self.model = model
        self.fanouts = tuple(fanouts)
        self.generator = generator
        self.draws = draws
        self.route = route
        self.prefetch = route.prefetch
        self.use_kernel = route.use_kernel
        self.dedup = route.dedup
        # Fault tolerance: with no injector and no retry policy every guard
        # below is one ``is None`` test and the stages are the plain ones.
        self.injector = injector
        self.retry_policy = retry_policy
        self.degraded_mode = degraded_mode
        self.stage_retries = 0  # backoff retries across all sites
        self.degraded_batches = 0  # batches served cache-only (miss path down)
        self.kernel_fallbacks = 0  # kernel_gather faults rerouted to the table route
        self._retry_seq = 0  # per-stream retry-key sequence (deterministic jitter)
        self._batch = 0  # this stream's batches sampled so far: indexes ``draws``
        self.tracer = NULL_TRACER  # installed by the owning engine/server
        self.adj_hits = 0
        self.adj_lookups = 0
        self.feat_hits = 0
        self.feat_lookups = 0
        self.prefetched_rows = 0
        self.unique_rows = 0  # sum of per-batch distinct input nodes (dedup)
        self.gathered_rows = 0  # rows the feature stage actually gathered
        self.fused_batches = 0  # batches the model counts in fused_forwards
        # Per-cache-epoch counters: epoch -> [adj_hits, adj_lookups,
        # feat_hits, feat_lookups, batches].  With refresh off everything
        # lands in epoch 0.
        self.epoch_counters: dict[int, list[int]] = {}
        # Serve-time telemetry sink (set by the refresh manager's owner);
        # None records nothing at retire.
        self.telemetry = None
        self.outputs: list[np.ndarray] | None = [] if collect_outputs else None
        # RAIN cross-batch reuse state (allocated only when the policy asks).
        self._prev_map = (
            np.full(pipe.caches.store.num_nodes, -1, np.int64) if pipe.reuse_prev_batch else None
        )
        self._prev_feats: torch.Tensor | None = None
        self._prev_nodes: np.ndarray | None = None
        # Overlapped on a card: the sampling stream, the pinned num_unique
        # scalar, the cache epoch last sampled, and per window slot the
        # pinned buffers ``compute`` copies the counts and logits into.
        self._sample_stream: torch.cuda.Stream | None = None
        self._nu_host: torch.Tensor | None = None
        self._sampled_epoch: int | None = None
        self._retire_bufs: dict[int, list] = {}

    # ---------------------------------------------------- fault tolerance
    def _with_retry(self, ctx, site: str, fn):
        """Run ``fn`` under the stream's retry policy, charging backoff
        retries to ``site``.  Only injected faults and per-attempt timeouts
        are retried; any other error propagates on the first attempt.  The
        jitter key is ``(site, seq)`` with a per-stream sequence, so the
        delay schedule depends on the policy seed and the order the faults
        land, never on the clock.  A timeout bounds the host side of an
        attempt (its dispatch and any injected delay): a launch returns
        before the card has run it, and no attempt waits for the card."""
        if self.retry_policy is None:
            return fn()
        self._retry_seq += 1
        seq = self._retry_seq

        def _on_retry(attempt, delay, err):
            self.stage_retries += 1
            ctx.outputs["_retried"] = ctx.outputs.get("_retried", 0) + 1
            if self.tracer.enabled:
                self.tracer.complete(
                    "retry",
                    lane="faults",
                    ts_us=self.tracer.now_us(),
                    dur_us=delay * 1e6,
                    args={"site": site, "attempt": attempt},
                )

        return call_with_retry(
            fn,
            policy=self.retry_policy,
            key=(site, seq),
            retryable=(InjectedFault, StageTimeout),
            on_retry=_on_retry,
        )

    def _mark_degraded(self, ctx) -> None:
        """Flag the batch as served degraded (cache-only hit rows, zero
        miss rows) for the retire-time accounting."""
        self.degraded_batches += 1
        ctx.outputs["_degraded"] = True
        if self.tracer.enabled:
            self.tracer.complete(
                "degraded",
                lane="faults",
                ts_us=self.tracer.now_us(),
                dur_us=0.0,
                args={"site": "host_fetch"},
            )

    # ------------------------------------------------------- streams, events
    def _on_streams(self, ctx) -> bool:
        """Whether the batch runs on events and the sampling stream: its
        clock drains at retire (depth > 1) and it samples on a card."""
        return ctx.overlap and self._sample_graph().device.type == "cuda"

    def _done(self, ctx, name: str, device) -> None:
        """Record the event that marks stage ``name``'s dispatch done, on
        ``device``'s current stream (what the stage's sync hands retire)."""
        if self._on_streams(ctx):
            ctx.outputs[_DONE + name] = torch.cuda.current_stream(device).record_event()

    def _sampling_stream(self, device) -> torch.cuda.Stream:
        """The runtime's sampling stream, high priority so its blocks are
        scheduled ahead of the previous batch's gather grid."""
        if self._sample_stream is None:
            self._sample_stream = torch.cuda.Stream(device, priority=-1)
            self._nu_host = torch.empty((), dtype=torch.int64, pin_memory=True)
        return self._sample_stream

    # ------------------------------------------------------------- stages
    def sample(self, ctx):
        # The cache epoch the batch samples against: its hits are booked
        # to it at retire even if a refresh lands while it is in flight.
        ctx.epoch = self.pipe.caches.epoch
        if self.injector is not None and self.injector.active("adj_fetch"):
            # Charged BEFORE the draw, so a retried attempt samples the same
            # batch.  Adjacency has no degraded fallback: exhausted retries
            # propagate.
            self._with_retry(ctx, "adj_fetch", lambda: self.injector.check("adj_fetch"))
        draws = None if self.draws is None else self.draws[self._batch]
        self._batch += 1
        graph = self._sample_graph()
        if not self._on_streams(ctx):
            return self._sample(ctx, graph, ctx.payload, draws)
        main = torch.cuda.current_stream(graph.device)
        side = self._sampling_stream(graph.device)
        with torch.cuda.stream(side):
            seeds = ctx.payload
            if seeds.is_cuda:
                side.wait_stream(main)  # made on the compute stream
            else:
                # Copied first, while the sampling stream is idle: a copy
                # from pageable memory waits for its stream.
                seeds = seeds.to(graph.device)
            if ctx.epoch != self._sampled_epoch:
                # The caches may have been rewritten on the compute stream
                # (a refresh, between batches): sample after those writes.
                side.wait_stream(main)
                self._sampled_epoch = ctx.epoch
            out = self._sample(ctx, graph, seeds, draws)
            done = side.record_event()
        block, bh, _ = out
        # Every frontier is a view of the deepest one's buffer.
        for t in (block.input_nodes, *block.neighbor_hits, *block.edge_slots, bh):
            t.record_stream(main)  # read on the compute stream: not reused before
        if block.dedup is not None:
            for t in (block.dedup.unique_ids, block.dedup.inverse, block.dedup.num_unique):
                t.record_stream(main)
        main.wait_event(done)
        ctx.outputs[_DONE + "sample"] = done
        return out

    def _sample(self, ctx, graph, seeds, draws):
        launches = sample_layer.launches
        block = sample_blocks(
            graph,
            seeds,
            self.fanouts,
            generator=self.generator,
            draws=draws,
            dedup=self.dedup,
            # Pad the unique bucket's tail with a known-cached id, so pad
            # slots are feature-cache hits, never phantom miss rows.
            dedup_pad_id=self.pipe.caches.store.pad_node_id() if self.dedup else None,
        )
        # The layers this batch sampled through the kernel (none on the CPU).
        self.tracer.annotate(kernel_layers=sample_layer.launches - launches)
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
        unique_rows`` per batch.  On the sampling stream the count is
        copied into a pinned scalar and the host waits on that stream's
        event alone."""
        dd = block.dedup
        if self._on_streams(ctx):
            with self.tracer.span("sync:num_unique", args=WAIT_ARGS["event"]):
                self._nu_host.copy_(dd.num_unique, non_blocking=True)
                torch.cuda.current_stream(dd.num_unique.device).record_event().synchronize()
                nu = int(self._nu_host)
        else:
            with self.tracer.span("sync:num_unique", args=WAIT_ARGS["read"]):
                nu = int(dd.num_unique)
        bucket = pow2_bucket(nu, int(dd.unique_ids.shape[0]))
        view = (dd, nu, bucket, dd.unique_ids[:bucket])
        ctx.outputs["_dedup"] = view
        return view

    def _dedup_view(self, ctx):
        return ctx.outputs["_dedup"]

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
        staged (the live prefix of the unique bucket).

        The ids are read back before the fault envelope, so a timed
        attempt covers the host pack and the copies' dispatch, not the
        wait for the card."""
        nu = None
        if self.dedup:
            _, nu, _, nodes = self._dedup_view(ctx)
        else:
            nodes = ctx.outputs["sample"][0].input_nodes
        with self.tracer.span("sync:prefetch_ids", args=WAIT_ARGS["read"]):
            nodes = nodes.cpu().numpy()  # the id sync: one device->host copy
        stage = lambda: self._prefetch(ctx, nodes, num_live=nu)  # noqa: E731
        staged = None
        if self.injector is None:
            staged = stage()
        else:
            try:
                staged = self._with_retry(ctx, "prefetch", stage)
            except FAULT_ERRORS as err:
                if _fault_site(err) != "prefetch" or not self.degraded_mode:
                    raise
                # Prefetch down: skip the staging and let the feature stage
                # read the misses over the ordinary host path.  Outputs and
                # hit counts are the same (prefetch only moves bytes early),
                # so the batch is NOT marked degraded.
        if staged is not None:
            self.prefetched_rows += staged.num_miss
        self._done(ctx, "prefetch", self._sample_graph().device)
        return staged

    # ------------------------------------------------- cache-access hooks
    # The sharded server (runtime/sharded_serve.py) overrides these four,
    # and only these, so every stage's control flow, draws and accounting
    # stay the same across layouts.
    def _sample_graph(self):
        """The DeviceGraph the sample stage expands against (the stream's
        adjacency replica in the sharded path)."""
        return self.pipe.caches.dgraph

    def _prefetch(self, ctx, nodes, num_live=None):
        """Stage a batch's missed host rows (``nodes`` on the host); the
        result, with its ``num_miss``, is what the consuming ``_gather``
        takes as ``prefetched``."""
        del ctx
        return self.pipe.caches.store.prefetch_misses(
            nodes, num_live=num_live, injector=self.injector
        )

    def _gather(self, ctx, indices, **gather_kw):
        """Two-source feature gather over ``indices`` → ``(feats, hit)``."""
        del ctx
        return self.pipe.caches.store.gather(indices, injector=self.injector, **gather_kw)

    def _gather_cache_only(self, ctx, indices):
        """Degraded-mode gather: cached rows only, miss rows zero."""
        del ctx
        return self.pipe.caches.store.gather_cache_only(indices)

    def _gather_ft(self, ctx, indices, **gather_kw):
        """The feature store's gather under the fault-tolerance envelope.

        With no injector this IS the gather.  With one, the gather runs
        under retry; when the retries are spent (or the policy fails fast)
        the recovery depends on the site whose fault ended it:

        * ``kernel_gather`` — the same gather on the table route, which
          gives the same bits, so the batch is NOT degraded; only
          ``kernel_fallbacks`` counts it.  This is the recovery from an
          injected fault: a real error from the kernel's build or launch
          is no fault of the plan and propagates unchanged;
        * ``host_fetch`` under ``degraded_mode`` — cache-only rows (miss
          rows zero), the batch marked degraded;
        * otherwise — propagate."""
        if self.injector is None:
            return self._gather(ctx, indices, **gather_kw)
        try:
            return self._with_retry(
                ctx, "host_fetch", lambda: self._gather(ctx, indices, **gather_kw)
            )
        except FAULT_ERRORS as err:
            site = _fault_site(err)
            if site == "kernel_gather":
                self.kernel_fallbacks += 1
                if self.tracer.enabled:
                    self.tracer.complete(
                        "kernel-fallback",
                        lane="faults",
                        ts_us=self.tracer.now_us(),
                        dur_us=0.0,
                        args={"site": site},
                    )
                fallback_kw = dict(gather_kw, use_kernel=False)
                fallback_kw.pop("row_block", None)
                return self._gather(ctx, indices, **fallback_kw)
            if site == "host_fetch" and self.degraded_mode:
                self._mark_degraded(ctx)
                return self._gather_cache_only(ctx, indices)
            raise

    def feature(self, ctx):
        lines = cached_gather_blocks.line_launches
        out = self._feature(ctx)
        # The gathers of this batch that read long pinned miss rows by
        # aligned lines (none on the CPU).
        self.tracer.annotate(line_copies=cached_gather_blocks.line_launches - lines)
        self._done(ctx, "feature", out[0].device)
        return out

    def _feature(self, ctx):
        block = ctx.outputs["sample"][0]
        gather_kw = dict(use_kernel=self.use_kernel, prefetched=ctx.outputs.get("prefetch"))
        if self.dedup:
            # Gather each distinct row once (sorted ids → the row-block
            # kernel's contiguous runs on the kernel route); the per-visit
            # hit mask is the unique mask expanded through the inverse map.
            dd, nu, bucket, uids = self._dedup_view(ctx)
            feats_u, hit_u = self._gather_ft(
                ctx, uids, row_block=ROW_BLOCK if self.use_kernel else None, **gather_kw
            )
            hit = hit_u[dd.inverse.to(torch.int64)]
            self.unique_rows += nu
            self.gathered_rows += bucket
            return feats_u, hit, hit.sum(), hit_u
        self.gathered_rows += int(block.input_nodes.shape[0])
        nodes = None
        if self.pipe.reuse_prev_batch:
            with self.tracer.span("sync:reuse_ids", args=WAIT_ARGS["read"]):
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
            fresh, _ = self._gather_ft(ctx, block.input_nodes, **gather_kw)
            hit = torch.from_numpy(hit_np).to(device)
            feats = torch.where(hit[:, None], reused, fresh)
        else:
            feats, hit = self._gather_ft(ctx, block.input_nodes, **gather_kw)
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
        inverse = num_rows = None
        if self.dedup:
            dd, num_rows, _, _ = self._dedup_view(ctx)
            inverse = dd.inverse
        fused = self.model.fused_forwards
        with torch.inference_mode():
            out = self.model(feats, inverse_index=inverse, num_rows=num_rows, tracer=self.tracer)
        self.fused_batches += self.model.fused_forwards - fused
        if self._on_streams(ctx):
            self._stage_for_record(ctx, out)
            self._done(ctx, "compute", out.device)
        return out

    def _stage_for_record(self, ctx, out) -> None:
        """Copy the batch's adjacency and feature hit counts (one stacked
        device tensor) and, when collected, its logits into the pinned
        buffers of its window slot, ``non_blocking`` on the compute stream:
        the compute event, recorded next, covers them.  The slot's next
        batch writes them only after this one's ``record`` has read them."""
        bh = ctx.outputs["sample"][1]
        hsum = ctx.outputs["feature"][2]
        bufs = self._retire_bufs.setdefault(ctx.slot, [None, None])
        if bufs[0] is None:
            bufs[0] = torch.empty(2, dtype=torch.int64, pin_memory=True)
        bufs[0].copy_(torch.stack((bh.to(hsum.device), hsum)), non_blocking=True)
        logits = None
        if self.outputs is not None:
            if bufs[1] is None or bufs[1].shape != out.shape or bufs[1].dtype != out.dtype:
                bufs[1] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            logits = bufs[1].copy_(out, non_blocking=True)
        ctx.outputs["_host"] = (bufs[0], logits)

    def _read(self, value) -> int:
        """``int(value)``: one blocking device-to-host read, traced as a
        ``sync:record`` wait span of its own."""
        with self.tracer.span("sync:record", args=WAIT_ARGS["read"]):
            return int(value)

    def record(self, ctx) -> None:
        """Host-side accounting; runs per batch, in order, after the batch's
        stage outputs are ready.  Overlapped on a card the counts and
        logits are read from the pinned buffers ``compute`` filled, after
        retire waited on the compute event: no read of the card.
        Otherwise the int() reads are cheap, since the batch is done.  With
        a telemetry sink it also reads the batch's frontier, hit mask and
        edge slots back to the host (the reference's semantics: one
        device-to-host read of each per retired batch; those reads have
        no wait span)."""
        block, bh, bt = ctx.outputs["sample"]
        feature_out = ctx.outputs["feature"]
        hit, hsum = feature_out[1], feature_out[2]
        staged = ctx.outputs.get("_host")
        if staged is not None:
            bh, hsum = staged[0].tolist()  # bt is a host int
        else:
            bh, bt, hsum = self._read(bh), self._read(bt), self._read(hsum)
        lookups = int(hit.shape[0])
        self.adj_hits += bh
        self.adj_lookups += bt
        self.feat_hits += hsum
        self.feat_lookups += lookups
        per_epoch = self.epoch_counters.setdefault(ctx.epoch, [0, 0, 0, 0, 0])
        per_epoch[0] += bh
        per_epoch[1] += bt
        per_epoch[2] += hsum
        per_epoch[3] += lookups
        per_epoch[4] += 1
        if self.telemetry is not None:
            slots = [s.cpu().numpy() for s in block.edge_slots]
            if self.dedup:
                # One scatter per unique node, weighted by its visit
                # multiplicity: the same counters as the per-visit form.
                dd, nu, _, uids = self._dedup_view(ctx)
                mult = np.bincount(dd.inverse.cpu().numpy(), minlength=nu)[:nu]
                self.telemetry.observe_batch(
                    uids[:nu].cpu().numpy(),
                    feature_out[3][:nu].cpu().numpy(),
                    slots,
                    multiplicities=mult,
                )
            else:
                self.telemetry.observe_batch(
                    block.input_nodes.cpu().numpy(), hit.cpu().numpy(), slots
                )
        if self.outputs is not None:
            if staged is not None:
                self.outputs.append(staged[1].numpy().copy())
            else:
                with self.tracer.span("sync:outputs", args=WAIT_ARGS["read"]):
                    self.outputs.append(ctx.outputs["compute"].cpu().numpy())

    def epoch_hit_rates(self) -> dict[int, dict]:
        """Per-epoch hit-rate summary (one entry per cache epoch served)."""
        return summarize_epoch_counters(self.epoch_counters)

    def run_batch(self, seeds: np.ndarray, clock: StageClock | None = None) -> None:
        """Run one batch through this runtime's stages, each synchronized
        at its boundary (the serial executor over one batch, without
        ``record``), traced on the runtime's tracer: warm-up and the depth
        probe.  ``clock``, when given, takes the stage laps."""
        stages = stream_stages(lambda c: self, prefetch=self.prefetch)
        PipelinedExecutor(stages, clock=clock, tracer=self.tracer).run([host_seeds(seeds)])


def _sync(name: str, values):
    """A stage's sync: the event it recorded where it recorded one
    (overlapped on a card), else ``values(ctx)``, the tensors it left in
    flight."""
    key = _DONE + name

    def sync(ctx):
        done = ctx.outputs.get(key)
        return values(ctx) if done is None else done

    return sync


def stream_stages(runtime_of, *, prefetch: bool = False) -> list[Stage]:
    """The sample → [prefetch] → feature → compute pipeline over
    :class:`StreamRuntime`s.

    ``runtime_of(ctx)`` resolves the runtime a batch belongs to.  Sync
    values are what the serial clock blocks on and the overlap clock
    drains: each stage's CUDA event where it recorded one (overlapped on a
    card), else what it leaves in flight (tuples of tensors).
    ``prefetch=True`` inserts the miss-row staging stage between sample
    and feature; off, the executor drops the ``None`` placeholder."""
    return [
        Stage(
            "sample",
            lambda c: runtime_of(c).sample(c),
            _sync(
                "sample", lambda c: (c.outputs["sample"][0].frontiers[-1], c.outputs["sample"][1])
            ),
        ),
        Stage(
            "prefetch",
            lambda c: runtime_of(c).prefetch_stage(c),
            _sync("prefetch", lambda c: c.outputs["prefetch"]),
        )
        if prefetch
        else None,
        Stage(
            "feature",
            lambda c: runtime_of(c).feature(c),
            _sync("feature", lambda c: (c.outputs["feature"][0], c.outputs["feature"][2])),
        ),
        Stage(
            "compute",
            lambda c: runtime_of(c).compute(c),
            _sync("compute", lambda c: c.outputs["compute"]),
        ),
    ]


def summarize_epoch_counters(counters: dict[int, list[int]]) -> dict[int, dict]:
    """Per-epoch hit-rate summary from ``[adj_hits, adj_lookups, feat_hits,
    feat_lookups, batches]`` counter lists (the StreamRuntime layout),
    shared by the per-stream and the serve-aggregate reports."""
    return {
        epoch: {
            "batches": c[4],
            "adj_hit_rate": round(c[0] / max(c[1], 1), 4),
            "feat_hit_rate": round(c[2] / max(c[3], 1), 4),
        }
        for epoch, c in sorted(counters.items())
    }


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
        stream_seeds: list[int] | None = None,
    ) -> PreparedPipeline:
        """Presample, split and fill the caches on the engine's device; the
        config's gather route becomes the pipeline's run default.
        ``stream_seeds`` profiles the union workload of several request
        streams (multi-stream serving) at the same total presample budget."""
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
            stream_seeds=stream_seeds,
            prefetch=bool(cfg.prefetch),
            use_kernel=bool(cfg.use_kernel),
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
        return host_seeds(seeds).to(self.device)

    def _scratch_runtime(self, route: EngineConfig, seed: int) -> StreamRuntime:
        """A runtime outside any run, drawing from a generator of its own
        seeded ``seed``: no injector, retry policy or telemetry."""
        return StreamRuntime(
            self.pipeline,
            self.model,
            fanouts=self.fanouts,
            route=route,
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

    def warmup(self, seeds: np.ndarray, route: EngineConfig | None = None) -> None:
        """Run one batch through ``route`` (default: the prepared
        pipeline's) outside any timed region: the first kernel launch
        builds and loads the CUDA library, cuBLAS sets up on its first
        product, and with prefetch the side stream, the pinned-buffer pool
        and the pack worker start.  The batch runs through a scratch
        runtime's stages, drawing from a generator of its own seeded
        ``seed + 1``, so the run's sequence is untouched.  (The reference
        also warms every pow2 pack bucket, because each compiles its own
        gather program; eager torch compiles nothing per shape.)"""
        if self.pipeline is None:
            raise RuntimeError("call prepare() first")
        if route is None:
            route = EngineConfig().resolved(self.pipeline)
        self._scratch_runtime(route, self.seed + 1).run_batch(seeds)

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
        """Fully synchronized (sample, feature, compute) seconds for one
        batch on the plain route (table gathers, no dedup, no prefetch),
        best of 2."""
        self.warmup(seeds)
        plain = EngineConfig(prefetch=False, use_kernel=False, dedup=False).resolved(self.pipeline)
        best = None
        for rep in range(2):
            clock = StageClock()
            self._scratch_runtime(plain, self.seed + 1000 + rep).run_batch(seeds, clock)
            lap = (clock.total("sample"), clock.total("feature"), clock.total("compute"))
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
        refresh=None,
        injector=None,
        retry_policy=None,
        degraded_mode: bool = False,
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
        ``injector`` (a :class:`~repro_torch.core.faults.FaultInjector`),
        ``retry_policy`` and ``degraded_mode`` arm the stream's fault
        envelope (see :class:`StreamRuntime`); without an injector the run
        is the plain one.  The injector also charges the ``refresh_fill``
        site of each refresh.

        ``refresh`` takes a :class:`~repro_torch.runtime.cache_refresh.
        RefreshConfig` (default: the one the config's ``refresh_*`` fields
        describe): an enabled mode re-allocates and delta re-fills the
        caches from live telemetry on the retire path.  Logits are the
        same with refresh on or off; hits come per epoch in
        ``report.epoch_hits``.  With ``"auto"`` depth and refresh both on,
        each refresh re-derives the window from the refreshed stage laps
        and applies it to the live executor.

        ``config.mode="layerwise"`` scores EVERY node through the chunked
        full-graph executor (:func:`~repro_torch.runtime.layerwise.
        run_layerwise`) and returns its report (``batches``,
        ``max_batches`` and ``draws`` do not apply; ``"auto"`` depth
        resolves to 2)."""
        if self.pipeline is None:
            raise RuntimeError("call prepare() first")
        pipe = self.pipeline
        cfg = config if config is not None else EngineConfig()
        if refresh is None:
            refresh = cfg.refresh_config()
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
        route = cfg.resolved(pipe, pipeline_depth=depth)
        if warmup and batches:
            self.warmup(batches[0], route)
        rt = StreamRuntime(
            pipe,
            self.model,
            fanouts=self.fanouts,
            route=route,
            generator=(
                None
                if draws is not None
                else torch.Generator(device=self.device).manual_seed(self.seed + 1)
            ),
            draws=draws,
            collect_outputs=collect_outputs,
            injector=injector,
            retry_policy=retry_policy,
            degraded_mode=degraded_mode,
        )
        rt.tracer = tracer
        clock = StageClock(overlap=depth > 1)
        manager = None
        if refresh is not None and refresh.enabled:
            from repro_torch.runtime.cache_refresh import CacheRefreshManager

            manager = CacheRefreshManager(
                pipe,
                self.dataset,
                fanouts=self.fanouts,
                batch_size=self.batch_size,
                config=refresh,
            )
            manager.register_clock(clock, key=0)
            manager.tracer = tracer
            manager.injector = injector
            rt.telemetry = manager.telemetry_for(0)
        auto_depth = requested == "auto" and manager is not None

        def on_retire(ctx):
            # Retire runs between batch dispatches, so a refresh lands
            # here: in-flight batches keep the old epoch's tensors, the
            # next dispatch reads the new epoch.
            rt.record(ctx)
            if manager is not None:
                event = manager.note_retired()
                if event is not None and auto_depth and manager.suggested_depth:
                    # The executor re-reads ``depth`` between batches; the
                    # window never drops below 2, keeping the clock's
                    # overlap semantics.
                    executor.depth = manager.suggested_depth

        executor = PipelinedExecutor(
            stream_stages(lambda c: rt, prefetch=route.prefetch),
            depth=depth,
            clock=clock,
            on_retire=on_retire,
            tracer=tracer,
        )
        executor.run(host_seeds(b) for b in batches)
        self.last_outputs = rt.outputs
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
            prefetch=route.prefetch,
            prefetch_seconds=clock.total("prefetch"),
            prefetched_rows=rt.prefetched_rows,
            dedup=route.dedup,
            unique_rows=rt.unique_rows,
            gathered_rows=rt.gathered_rows,
            fused_batches=rt.fused_batches,
            refresh_events=list(manager.events) if manager is not None else [],
            epoch_hits=rt.epoch_hit_rates() if manager is not None else None,
            config=route,
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
            for epoch, rates in (report.epoch_hits or {}).items():
                metrics.gauge("feat_hit_rate", policy=pipe.name, epoch=epoch).set(
                    rates["feat_hit_rate"]
                )
            report.metrics = metrics.snapshot()
        return report
