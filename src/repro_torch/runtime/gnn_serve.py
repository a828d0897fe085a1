"""Multi-stream GNN serving over one shared DualCache.

DCI's premise is that a workload-aware dual cache amortizes redundant
loading across many inference requests — which only pays off when several
request *streams* actually share it.  This layer runs N independent batch
streams through ONE :class:`~repro_torch.runtime.pipeline.PipelinedExecutor`
schedule against a single shared :class:`~repro_torch.core.cache.DualCache`:

  - each stream owns a seed-batch queue, its own slot-draw source (a CUDA
    generator seeded ``seed + 1``, or given per-batch draws) and RAIN
    reuse state (a :class:`~repro_torch.runtime.gnn_engine.StreamRuntime`),
    and its own overlap-aware :class:`~repro_torch.utils.timing.StageClock`;
  - an admission policy interleaves the queues round-robin with a
    per-stream in-flight cap (backpressure): a saturated stream is skipped,
    not waited on, and admission never stalls batches already in flight;
  - per-stream hit/latency/fault accounting plus shared aggregate
    accounting come out in a :class:`ServeReport`.

Because every stream's state is private to its ``StreamRuntime``, each
stream's outputs, draws and hit counters are identical to running that
stream's batches alone through :class:`~repro_torch.runtime.gnn_engine.
GNNInferenceEngine` with the same seed.  What sharing buys is systemic:
one presample + allocation + fill (and one kernel build) amortized over
all streams, and one budget-B cache serving everyone instead of N private
B/N caches.

A batch's latency is admit → retire: retire runs after the executor has
waited for the batch's stage outputs (every stage's at depth > 1, on a
card through the events the stages recorded; each stage's at the serial
depth 1), so it includes the card's time.

Fault handling (:mod:`repro_torch.core.faults`, :mod:`repro_torch.core.
retry`): ``ServeConfig.fault_policy`` is ``"fail"`` (the first unrecovered
fault ends the run), ``"retry"`` (bounded backoff, then fail) or
``"shed"`` (retry, then drop just the failing batch and keep serving).
Only fault-subsystem errors are shed; any other error, a kernel's
included, propagates.

Online refresh (``ServeConfig.engine.refresh_mode``, or ``refresh=``)
closes the loop for long-lived serving: the retire path records each
batch into a telemetry window, and a :class:`~repro_torch.runtime.
cache_refresh.CacheRefreshManager` re-allocates (Eq. 1) and delta
re-fills the shared ``DualCache`` on the interval, on a stream's join
(``add_stream`` after serving began) or leave (``remove_stream``), or on
the miss-rate threshold.  Logits stay those of the refresh-free serve;
hits come per epoch.  With refresh off the caches never change.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.config import ServeConfig
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.retry import RetryExhausted, StageTimeout
from repro_torch.core.trace import resolve_tracer
from repro_torch.runtime.gnn_engine import (
    FAULT_ERRORS,
    HBM3_BW,
    PCIE5_BW,
    GNNInferenceEngine,
    StreamRuntime,
    host_seeds,
    modeled_transfer_seconds,
    stream_stages,
    summarize_epoch_counters,
)
from repro_torch.runtime.pipeline import PipelinedExecutor
from repro_torch.utils.timing import StageClock

__all__ = [
    "MultiStreamServer",
    "ServeReport",
    "StreamReport",
    "StreamState",
    "make_stream_batches",
]

def _latency_stats(latencies) -> tuple[float, float, float, float, float]:
    """(mean, max, p50, p95, p99) of a latency list — zeros when empty.

    Percentiles use numpy's default linear interpolation; with the small
    per-stream sample counts typical of a serve run the p99 of n < 100
    latencies interpolates toward the max, the conservative direction for
    an SLO report."""
    if not latencies:
        return 0.0, 0.0, 0.0, 0.0, 0.0
    arr = np.asarray(latencies, np.float64)
    p50, p95, p99 = np.percentile(arr, [50, 95, 99])
    return float(arr.mean()), float(arr.max()), float(p50), float(p95), float(p99)


@dataclasses.dataclass
class StreamState:
    """One request stream: queue + per-stream runtime/clock/accounting."""

    stream_id: int
    seed: int
    runtime: StreamRuntime
    clock: StageClock
    queue: collections.deque  # of np.ndarray seed batches
    submitted: int = 0  # batches admitted into the pipeline so far
    retired: int = 0  # batches fully completed so far
    inflight: int = 0  # batches currently inside the executor window
    max_inflight_seen: int = 0
    seeds_served: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    # Fault-tolerance accounting (zeros without an injector):
    batches_shed: int = 0  # dropped by the shed policy after retries exhausted
    batches_timed_out: int = 0  # shed batches whose terminal error was a timeout
    batches_retried: int = 0  # retired batches that needed >= 1 backoff retry
    batches_degraded: int = 0  # retired batches served cache-only (miss path down)
    _admit_times: dict = dataclasses.field(default_factory=dict)
    _flow_ids: dict = dataclasses.field(default_factory=dict)  # batch idx -> trace flow id


@dataclasses.dataclass
class StreamReport:
    stream_id: int
    seed: int
    num_batches: int
    num_seeds: int
    sample_seconds: float
    feature_seconds: float
    compute_seconds: float
    adj_hits: int
    adj_lookups: int
    feat_hits: int
    feat_lookups: int
    mean_latency_s: float
    max_latency_s: float
    prefetch_seconds: float = 0.0
    prefetched_rows: int = 0
    unique_rows: int = 0  # distinct input rows (dedup; 0 when off)
    gathered_rows: int = 0  # rows the feature stage actually gathered
    epoch_hits: dict | None = None  # per-cache-epoch rates (refresh on)
    # Latency distribution (admit→retire for queue serves; the request
    # front-end overwrites the samples with enqueue→retire):
    p50_latency_s: float = 0.0
    p95_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    # Request-level accounting (request_queue front-end; zeros otherwise):
    requests_shed: int = 0
    deadline_hits: int = 0
    deadline_total: int = 0
    # Fault-tolerance accounting (zeros without an injector):
    requests_timed_out: int = 0
    requests_retried: int = 0
    requests_degraded: int = 0
    stage_retries: int = 0  # individual backoff retries across all sites
    kernel_fallbacks: int = 0  # kernel_gather faults rerouted to the table route

    @property
    def adj_hit_rate(self) -> float:
        return self.adj_hits / max(self.adj_lookups, 1)

    @property
    def feat_hit_rate(self) -> float:
        return self.feat_hits / max(self.feat_lookups, 1)

    def summary(self) -> dict:
        out = {
            "stream": self.stream_id,
            "batches": self.num_batches,
            "adj_hit_rate": self.adj_hit_rate,
            "feat_hit_rate": self.feat_hit_rate,
            "sample_s": self.sample_seconds,
            "prefetch_s": self.prefetch_seconds,
            "feature_s": self.feature_seconds,
            "compute_s": self.compute_seconds,
            "mean_latency_s": self.mean_latency_s,
            "max_latency_s": self.max_latency_s,
            "p50_latency_s": self.p50_latency_s,
            "p95_latency_s": self.p95_latency_s,
            "p99_latency_s": self.p99_latency_s,
        }
        for key in ("requests_shed", "requests_timed_out", "requests_retried",
                    "requests_degraded", "stage_retries", "kernel_fallbacks"):
            if getattr(self, key):
                out[key] = getattr(self, key)
        if self.deadline_total:
            out["deadline_hits"] = self.deadline_hits
            out["deadline_total"] = self.deadline_total
        if self.epoch_hits is not None:
            out["per_epoch"] = self.epoch_hits
        return out


@dataclasses.dataclass
class ServeReport:
    """Aggregate + per-stream outcome of one multi-stream serve run.

    Aggregate hit counters are sums over the per-stream reports;
    ``wall_seconds`` is the serve loop's wall clock (warmup and preparation
    excluded — those are the amortized costs)."""

    policy: str
    num_streams: int
    depth: int
    max_inflight_per_stream: int
    wall_seconds: float
    feat_row_bytes: int
    streams: list[StreamReport]
    prefetch: bool = False
    dedup: bool = False
    device: str = "cpu"
    # Online-refresh accounting (refresh off: empty/None, summary as before):
    refresh_events: list = dataclasses.field(default_factory=list)
    epochs: dict | None = None  # aggregate per-epoch hit rates across streams
    # Global latency distribution over every stream's samples pooled:
    p50_latency_s: float = 0.0
    p95_latency_s: float = 0.0
    p99_latency_s: float = 0.0
    # Request-level accounting (request_queue front-end; None/zeros otherwise):
    admission: str | None = None
    requests_shed: int = 0
    deadline_hits: int = 0
    deadline_total: int = 0
    # Fault-tolerance accounting (None/zeros without an injector):
    requests_timed_out: int = 0
    requests_retried: int = 0
    requests_degraded: int = 0
    unserved: int = 0  # requests/batches still queued when the loop ended
    fault_policy: str = "fail"
    faults: dict | None = None  # FaultInjector.counts() at report time
    error: str | None = None  # terminal error repr (run(raise_on_error=False))
    failovers: list = dataclasses.field(default_factory=list)  # shard-loss log
    # Sharded serving (runtime/sharded_serve.py): per-shard hit/byte/
    # allocation accounting; the unsharded server leaves the defaults.
    num_shards: int = 1
    shards: list | None = None
    # The RESOLVED ServeConfig the serve loop ran with (knobs and caps read
    # back off the live server at report time).
    config: ServeConfig | None = None
    # MetricsRegistry.snapshot() taken at report time when the server was
    # given a registry; None otherwise.
    metrics: dict | None = None

    @property
    def total_batches(self) -> int:
        return sum(s.num_batches for s in self.streams)

    @property
    def total_seeds(self) -> int:
        return sum(s.num_seeds for s in self.streams)

    @property
    def adj_hits(self) -> int:
        return sum(s.adj_hits for s in self.streams)

    @property
    def adj_lookups(self) -> int:
        return sum(s.adj_lookups for s in self.streams)

    @property
    def feat_hits(self) -> int:
        return sum(s.feat_hits for s in self.streams)

    @property
    def feat_lookups(self) -> int:
        return sum(s.feat_lookups for s in self.streams)

    @property
    def unique_rows(self) -> int:
        return sum(s.unique_rows for s in self.streams)

    @property
    def gathered_rows(self) -> int:
        return sum(s.gathered_rows for s in self.streams)

    @property
    def stage_retries(self) -> int:
        return sum(s.stage_retries for s in self.streams)

    @property
    def kernel_fallbacks(self) -> int:
        return sum(s.kernel_fallbacks for s in self.streams)

    @property
    def duplication_factor(self) -> float:
        """Aggregate input-frontier duplication removed by dedup (1.0 off)."""
        if not self.unique_rows:
            return 1.0
        return self.feat_lookups / self.unique_rows

    @property
    def adj_hit_rate(self) -> float:
        return self.adj_hits / max(self.adj_lookups, 1)

    @property
    def feat_hit_rate(self) -> float:
        return self.feat_hits / max(self.feat_lookups, 1)

    @property
    def throughput_seeds_per_s(self) -> float:
        return self.total_seeds / max(self.wall_seconds, 1e-12)

    @property
    def deadline_hit_rate(self) -> float:
        """Fraction of deadline-carrying requests retired on time (shed and
        late requests both count as misses); 1.0 when no request carried a
        deadline.  Timed-out requests are excluded from the denominator —
        they are reported separately as ``requests_timed_out``."""
        if not self.deadline_total:
            return 1.0
        return self.deadline_hits / self.deadline_total

    @property
    def availability(self) -> float:
        """Fraction of *offered* work that completed (degraded service
        counts as available — the request was answered, and marked).
        Offered = completed + shed + still-queued-at-exit."""
        completed = self.total_batches
        offered = completed + self.requests_shed + self.unserved
        if not offered:
            return 1.0
        return completed / offered

    def modeled_transfer_seconds(
        self, slow_bw: float = PCIE5_BW, fast_bw: float = HBM3_BW
    ) -> float:
        """Project aggregate byte movement onto a slow-miss / fast-hit link
        pair (the H100's published rates by default, as the engine's)."""
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
            "streams": self.num_streams,
            "depth": self.depth,
            "prefetch": self.prefetch,
            "dedup": self.dedup,
            "batches": self.total_batches,
            "wall_s": self.wall_seconds,
            "throughput_seeds_per_s": self.throughput_seeds_per_s,
            "adj_hit_rate": self.adj_hit_rate,
            "feat_hit_rate": self.feat_hit_rate,
            "modeled_transfer_s": self.modeled_transfer_seconds(),
            "p50_latency_s": self.p50_latency_s,
            "p95_latency_s": self.p95_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "per_stream": [s.summary() for s in self.streams],
        }
        if self.config is not None:
            out["config"] = self.config.to_dict()
        if self.admission is not None:
            out["admission"] = self.admission
            out["requests_shed"] = self.requests_shed
            if self.deadline_total:
                out["deadline_hit_rate"] = self.deadline_hit_rate
        if self.faults is not None:
            out["fault_policy"] = self.fault_policy
            out["faults"] = self.faults
            out["availability"] = self.availability
            out["requests_timed_out"] = self.requests_timed_out
            out["requests_retried"] = self.requests_retried
            out["requests_degraded"] = self.requests_degraded
            out["requests_shed"] = self.requests_shed
            out["stage_retries"] = self.stage_retries
            out["kernel_fallbacks"] = self.kernel_fallbacks
            out["unserved"] = self.unserved
        if self.failovers:
            out["failovers"] = self.failovers
        if self.error is not None:
            out["error"] = self.error
        if self.dedup:
            out["unique_rows"] = self.unique_rows
            out["gathered_rows"] = self.gathered_rows
            out["duplication_factor"] = self.duplication_factor
        if self.epochs is not None:
            # With refresh on, the lifetime aggregate above hides the
            # post-refresh recovery: the per-epoch split is the headline.
            out["per_epoch"] = self.epochs
            out["refresh_events"] = [e.summary() for e in self.refresh_events]
        if self.shards is not None:
            out["num_shards"] = self.num_shards
            out["per_shard"] = self.shards
        if self.metrics is not None:
            out["metrics"] = self.metrics
        return out


class MultiStreamServer:
    """Serve N seed-batch streams through one pipelined executor + caches.

    Built on a *prepared* :class:`~repro_torch.runtime.gnn_engine.
    GNNInferenceEngine` (its ``pipeline`` holds the shared DualCache and
    the policy metadata; its model holds the shared weights).

    Every knob comes in one :class:`ServeConfig`.  Its
    ``engine.pipeline_depth`` is the executor window (1 = serial, >1 keeps
    that many batches in flight across streams).  ``max_inflight`` is the
    backpressure cap: round-robin admission skips a stream that already
    occupies that many window slots, so one deep queue cannot monopolize
    the pipeline.  When every stream with pending work is at its cap the
    least-loaded one is admitted anyway — admission must make progress
    (retires only happen after the next dispatch), so the cap bounds
    *relative* occupancy rather than deadlocking the window.

    ``engine.prefetch`` (default: the prepared pipeline's knob) inserts the
    miss-row staging stage into the shared schedule; a stream's staged
    buffers live in its admitted batches' contexts and are released at
    retire, so the cap also bounds its staged buffers.

    ``refresh`` (default: the RefreshConfig that ``config.engine``'s
    refresh fields describe) puts a refresh manager on the retire path.
    ``config.mesh`` is read by :class:`~repro_torch.runtime.sharded_serve.
    ShardedServer` (and the CLI, which builds one); this class serves
    unsharded.
    """

    def __init__(
        self,
        engine: GNNInferenceEngine,
        *,
        config: ServeConfig | None = None,
        refresh=None,
        tracer=None,
        metrics=None,
        injector=None,
    ):
        if engine.pipeline is None:
            raise RuntimeError("prepare() the engine before constructing the server")
        # Live observability handles — keyword-only and NOT part of
        # ServeConfig, which stays a frozen, JSON-round-trippable value.
        self.tracer = resolve_tracer(tracer)
        self.metrics = metrics
        cfg = config or ServeConfig()
        self.config = cfg
        # The injector is a live handle like tracer/metrics — pass one in,
        # or point ``cfg.faults`` at a FaultPlan JSON.  With neither, every
        # guard is one ``is None`` test and the serve path is the plain one.
        if injector is None and cfg.faults is not None:
            injector = FaultInjector(FaultPlan.load(cfg.faults))
        if injector is not None and not injector.tracer.enabled:
            injector.tracer = self.tracer
        self.injector = injector
        self.retry_policy = cfg.retry_policy()
        self.degraded_mode = cfg.degraded_mode
        self.fault_policy = cfg.fault_policy
        self._last_error: str | None = None
        depth = 2 if cfg.engine.pipeline_depth is None else cfg.engine.pipeline_depth
        self._auto_depth = depth == "auto"
        if depth == "auto":
            depth = engine.resolve_pipeline_depth("auto")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.engine = engine
        self.depth = depth
        pipe = engine.pipeline
        if refresh is None:
            refresh = cfg.engine.refresh_config()
        self.refresh_manager = None
        if refresh is not None and refresh.enabled:
            from repro_torch.runtime.cache_refresh import CacheRefreshManager

            self.refresh_manager = CacheRefreshManager(
                pipe,
                engine.dataset,
                fanouts=engine.fanouts,
                batch_size=engine.batch_size,
                config=refresh,
            )
            # Weighted telemetry merges (stream_weighting != "none") ask the
            # server for each stream's live pressure at refresh time.
            self.refresh_manager.set_weight_fn(self._stream_weight)
            self.refresh_manager.tracer = self.tracer
            self.refresh_manager.injector = self.injector
        self._started = False  # join/leave events fire only once serving began
        self._executor = None  # the live executor during run() (auto-depth hook)
        self._serve_t0 = None  # perf_counter at serve start (arrival clock origin)
        # Every stream's gather route, resolved once against the pipeline.
        self.route = cfg.engine.resolved(pipe)
        # A defaulted cap follows the window when refresh-aware auto depth
        # resizes it mid-run; an explicit cap is the caller's and stays.
        self._explicit_inflight_cap = cfg.max_inflight is not None
        self.max_inflight = cfg.max_inflight if cfg.max_inflight is not None else depth
        if self.max_inflight < 1:
            raise ValueError("max_inflight_per_stream must be >= 1")
        self.streams: list[StreamState] = []
        self.admission_log: list[tuple[int, int]] = []  # (stream_id, per-stream batch idx)
        self._rr = 0  # round-robin cursor

    # ------------------------------------------------------------- intake
    def add_stream(
        self,
        batches: Sequence[np.ndarray],
        *,
        seed: int | None = None,
        collect_outputs: bool = False,
        draws: Sequence[Sequence[torch.Tensor]] | None = None,
    ) -> StreamState:
        """Register a stream with its full seed-batch queue.

        ``seed`` fixes the stream's draws: its results equal
        ``GNNInferenceEngine(seed=seed, ...)`` running the same ``batches``
        alone against the same prepared pipeline.  ``draws[b][l]``
        (optional) is the stream's batch ``b`` slot-draw tensor for layer
        ``l``, as :meth:`GNNInferenceEngine.run` takes them — the seam the
        tests replay the JAX reference's draws through.

        With online refresh on, a stream added AFTER serving began is a
        serve-time join: the refresh manager presamples its seed, merges
        the profile into its history and (in the event modes) refreshes
        the shared cache for the new union workload."""
        sid = len(self.streams)
        if seed is None:
            seed = self.engine.seed + sid
        if draws is not None and len(draws) < len(batches):
            raise ValueError(f"draws cover {len(draws)} batches, the stream has {len(batches)}")
        runtime = self._make_runtime(sid, seed, collect_outputs=collect_outputs, draws=draws)
        runtime.tracer = self.tracer
        state = StreamState(
            stream_id=sid,
            seed=seed,
            runtime=runtime,
            clock=StageClock(overlap=self.depth > 1),
            queue=collections.deque(np.asarray(b) for b in batches),
        )
        self.streams.append(state)
        if self.refresh_manager is not None:
            # Under weighting "none" telemetry_for returns the shared sink;
            # otherwise each stream records into its own, weighted at
            # refresh time.
            runtime.telemetry = self.refresh_manager.telemetry_for(sid)
            self.refresh_manager.register_clock(state.clock, key=sid)
            if self._started:
                self.refresh_manager.on_stream_join(seed)
        return state

    def _make_runtime(
        self, sid: int, seed: int, *, collect_outputs: bool, draws=None
    ) -> StreamRuntime:
        """Construct one stream's :class:`StreamRuntime` (the sharded
        server overrides this).  The generator is
        seeded ``seed + 1`` on the engine's device, as the engine's own."""
        del sid
        eng = self.engine
        return StreamRuntime(
            eng.pipeline,
            eng.model,
            fanouts=eng.fanouts,
            route=self.route,
            generator=(
                None
                if draws is not None
                else torch.Generator(device=eng.device).manual_seed(seed + 1)
            ),
            draws=draws,
            collect_outputs=collect_outputs,
            injector=self.injector,
            retry_policy=self.retry_policy,
            degraded_mode=self.degraded_mode,
        )

    def remove_stream(self, stream_id: int) -> StreamState:
        """Serve-time leave: drop the stream's remaining queue (batches in
        flight still retire) and, with refresh on, merge the workload
        without it and refresh the shared cache."""
        state = self.streams[stream_id]
        state.queue.clear()
        if self.refresh_manager is not None and self._started:
            self.refresh_manager.on_stream_leave(state.seed)
        return state

    # ---------------------------------------------------------- admission
    def _next_stream(self, eligible: Sequence[StreamState]) -> StreamState:
        """Round-robin over ``eligible`` streams, honoring the in-flight
        cap; falls back to the least-loaded eligible stream when everyone
        is saturated (see class docstring).

        ``eligible`` is whichever subset has admissible work right now —
        every stream with a non-empty queue here, the streams whose head
        request has *arrived* in the request front-end.  Cursor mechanics
        are identical either way."""
        n = len(self.streams)
        keys = {s.stream_id for s in eligible}
        for off in range(n):
            s = self.streams[(self._rr + off) % n]
            if s.stream_id in keys and s.inflight < self.max_inflight:
                self._rr = (s.stream_id + 1) % n
                return s
        s = min(eligible, key=lambda s: (s.inflight, (s.stream_id - self._rr) % n))
        self._rr = (s.stream_id + 1) % n
        return s

    def _admit(self, s: StreamState, seeds: np.ndarray):
        """Book one admission of stream ``s`` and return the executor item."""
        self.admission_log.append((s.stream_id, s.submitted))
        s._admit_times[s.submitted] = time.perf_counter()
        s.submitted += 1
        s.inflight += 1
        s.max_inflight_seen = max(s.max_inflight_seen, s.inflight)
        if self.tracer.enabled:
            self._trace_admit(s, batch=s.submitted - 1)
        return (s, host_seeds(seeds))

    def _admission(self):
        """Lazy (stream, seeds) generator for the executor: pulled exactly
        when a window slot opens, so the in-flight counts it reads are live."""
        while True:
            pending = [s for s in self.streams if s.queue]
            if not pending:
                return
            s = self._next_stream(pending)
            yield self._admit(s, s.queue.popleft())

    # ---------------------------------------------------------- tracing
    def _enqueue_ts_us(self, s: StreamState, batch: int) -> float:
        """Tracer timestamp at which batch ``batch`` of stream ``s`` was
        enqueued: serve start here, the request's arrival in the request
        front-end."""
        del s, batch
        return self.tracer.ts_from(self._serve_t0) if self._serve_t0 is not None else 0.0

    def _trace_admit(self, s: StreamState, *, batch: int) -> None:
        """A ``queued`` span (enqueue → admit) on the stream's request
        lane, the start of the batch's flow, and queue/inflight counters."""
        tr = self.tracer
        now = tr.now_us()
        lane = f"req:s{s.stream_id}"
        enq = min(self._enqueue_ts_us(s, batch), now)
        tr.complete("queued", lane=lane, ts_us=enq, dur_us=now - enq, args={"batch": batch})
        fid = tr.next_flow_id()
        s._flow_ids[batch] = fid
        tr.flow_start(fid, "req", lane=lane, ts_us=(enq + now) / 2)
        tr.counter(
            "queue_depth", {f"s{st.stream_id}": float(len(st.queue)) for st in self.streams}
        )
        tr.counter("inflight", {"batches": float(sum(st.inflight for st in self.streams))})

    def _trace_retire(self, ctx, s: StreamState, admit_t: float, now_t: float) -> None:
        """A ``service`` span (admit → retire), a flow step through the
        executor's batch span and the flow end."""
        tr = self.tracer
        lane = f"req:s{s.stream_id}"
        admit_us, now_us = tr.ts_from(admit_t), tr.ts_from(now_t)
        tr.complete(
            "service",
            lane=lane,
            ts_us=admit_us,
            dur_us=now_us - admit_us,
            args={"batch": s.retired},
        )
        fid = s._flow_ids.pop(s.retired, None)
        if fid is not None:
            tr.flow_step(fid, "req", lane=f"slot {ctx.slot}", ts_us=ctx.trace_t0 + 1.0)
            tr.flow_end(fid, "req", lane=lane, ts_us=(admit_us + now_us) / 2)
        tr.counter("inflight", {"batches": float(sum(st.inflight for st in self.streams))})

    def _on_retire(self, ctx) -> None:
        s: StreamState = ctx.stream
        s.runtime.record(ctx)
        if ctx.outputs.get("_retried"):
            s.batches_retried += 1
            if self.metrics is not None:
                self.metrics.counter("requests_retried_total", stream=s.stream_id).inc()
        if ctx.outputs.get("_degraded"):
            s.batches_degraded += 1
            if self.metrics is not None:
                self.metrics.counter("requests_degraded_total", stream=s.stream_id).inc()
        # The executor has waited for the batch's outputs before retire, so
        # this stamp comes after its device work.
        now_t = time.perf_counter()
        admit_t = s._admit_times.pop(s.retired)
        latency = now_t - admit_t
        s.latencies.append(latency)
        n_seeds = int(ctx.payload.shape[0])
        s.seeds_served += n_seeds
        s.inflight -= 1
        if self.tracer.enabled:
            self._trace_retire(ctx, s, admit_t, now_t)
        if self.metrics is not None:
            self.metrics.histogram("request_latency_ms", stream=s.stream_id).observe(
                latency * 1e3
            )
            self.metrics.counter("batches_retired_total", stream=s.stream_id).inc()
            self.metrics.counter("seeds_served_total", stream=s.stream_id).inc(n_seeds)
        s.retired += 1
        if self.refresh_manager is not None:
            # Retire runs between dispatches, so a refresh lands here:
            # in-flight batches keep the old epoch's tensors.
            event = self.refresh_manager.note_retired()
            if event is not None:
                self._apply_refresh_event(event)

    # ------------------------------------------------------ fault shedding
    @staticmethod
    def _fault_root(err: BaseException) -> BaseException:
        """The underlying fault behind a retry-exhausted wrapper."""
        return err.last if isinstance(err, RetryExhausted) else err

    def _on_batch_error(self, ctx, err: BaseException) -> bool:
        """Executor hook under ``fault_policy="shed"``: drop JUST the
        failing batch (after its retries exhausted) and keep serving.

        Only fault-subsystem errors are shed — injected faults, retry
        exhaustion and stage timeouts; anything else (a kernel's error
        included) propagates.  The dying batch is the most recently
        admitted (stages dispatch at admission), so its per-stream index is
        ``submitted - 1``; rolling ``submitted`` back keeps the retire-side
        bookkeeping contiguous, and a batch counts shed XOR completed."""
        if not isinstance(err, FAULT_ERRORS):
            return False
        s: StreamState = ctx.stream
        root = self._fault_root(err)
        idx = s.submitted - 1
        self._shed_inflight(s, idx, root)
        if self.tracer.enabled:
            self.tracer.complete(
                "shed",
                lane="faults",
                ts_us=self.tracer.now_us(),
                dur_us=0.0,
                args={
                    "stream": s.stream_id,
                    "batch": idx,
                    "error": type(root).__name__,
                    "site": getattr(root, "site", None),
                },
            )
        return True

    def _shed_inflight(self, s: StreamState, idx: int, root: BaseException) -> None:
        """Undo batch ``idx``'s admission-side bookkeeping and count it
        shed.  The request front-end extends this to mark the riding
        request shed/timed-out as well."""
        s._admit_times.pop(idx, None)
        s._flow_ids.pop(idx, None)
        s.submitted -= 1
        s.inflight -= 1
        s.batches_shed += 1
        if isinstance(root, StageTimeout):
            s.batches_timed_out += 1
            if self.metrics is not None:
                self.metrics.counter("requests_timed_out_total", stream=s.stream_id).inc()
        if self.metrics is not None:
            self.metrics.counter("requests_shed_total", stream=s.stream_id).inc()

    def _note_failed_admission(self, err: BaseException) -> None:
        """After a terminal executor error: the failing batch was admitted
        but never retired — roll its bookkeeping back so shed XOR completed
        still holds in the partial report."""
        root = self._fault_root(err)
        for s in self.streams:
            while s.inflight > 0 and s.submitted > s.retired:
                self._shed_inflight(s, s.submitted - 1, root)

    def _apply_refresh_event(self, event) -> None:
        """React to a refresh that just fired on the retire path: resize
        the auto-depth window (the sharded server also repartitions its
        per-shard stores to the new epoch)."""
        del event
        depth = self.refresh_manager.suggested_depth
        if self._auto_depth and self._executor is not None and depth:
            # Applies at the next admission.
            self._executor.depth = self.depth = depth
            if not self._explicit_inflight_cap:
                self.max_inflight = depth

    # ----------------------------------------------------------------- run
    def _warmup_seeds(self) -> np.ndarray | None:
        """Seed batch to warm up on before the timed loop (the first
        queued batch); None → nothing queued, skip."""
        for s in self.streams:
            if s.queue:
                return s.queue[0]
        return None

    def _stream_weight(self, key) -> float:
        """Live pressure of stream ``key`` for weighted telemetry merges:
        1 + queued batches + batches in flight (the request front-end
        adds SLO pressure)."""
        s = self.streams[key]
        return 1.0 + len(s.queue) + s.inflight

    def run(self, *, warmup: bool = True, raise_on_error: bool = True) -> ServeReport:
        """Serve every queued batch and return the :class:`ServeReport`.

        ``raise_on_error=False`` turns a terminal fault-subsystem error
        (one escaping the executor under ``fault_policy != "shed"``) into
        a PARTIAL report: in-flight batches drain with full accounting,
        the error lands on ``report.error``, and unserved batches count
        against ``report.availability``.  Any other error propagates."""
        if not self.streams:
            raise RuntimeError("add_stream() at least one stream before run()")
        self._started = True
        if warmup:
            seeds = self._warmup_seeds()
            if seeds is not None:
                self.engine.warmup(seeds, self.route)
        executor = PipelinedExecutor(
            stream_stages(lambda c: c.stream.runtime, prefetch=self.route.prefetch),
            depth=self.depth,
            clock_for=lambda c: c.stream.clock,
            on_retire=self._on_retire,
            on_batch_error=self._on_batch_error if self.fault_policy == "shed" else None,
            tracer=self.tracer,
        )
        self._executor = executor
        self._last_error = None
        self._serve_t0 = t0 = time.perf_counter()
        if self.tracer.enabled:
            self.tracer.instant("serve-start", lane="serve", args={"streams": len(self.streams)})
        try:
            executor.run_tagged(self._admission())
        except FAULT_ERRORS as err:
            # The executor already drained in-flight batches; the failing
            # batch itself never retired — undo its admission bookkeeping.
            self._note_failed_admission(err)
            if raise_on_error:
                raise
            self._last_error = repr(err)
        wall = time.perf_counter() - t0
        self._executor = None
        report = self._serve_report(wall)
        if self.metrics is not None:
            self._record_metrics(report)
            report.metrics = self.metrics.snapshot()
        return report

    def _record_metrics(self, report: ServeReport) -> None:
        """Fold the run's aggregate outcomes into the metrics registry."""
        m = self.metrics
        m.gauge("throughput_seeds_per_s").set(report.throughput_seeds_per_s)
        for sr in report.streams:
            m.gauge("feat_hit_rate", stream=sr.stream_id).set(sr.feat_hit_rate)
            m.gauge("adj_hit_rate", stream=sr.stream_id).set(sr.adj_hit_rate)
            if sr.requests_shed:
                m.counter("requests_shed_total", stream=sr.stream_id).inc(sr.requests_shed)
            for epoch, rates in (sr.epoch_hits or {}).items():
                m.gauge("feat_hit_rate", stream=sr.stream_id, epoch=epoch).set(
                    rates["feat_hit_rate"]
                )
        for ev in report.refresh_events:
            m.counter("refresh_epochs_total", reason=ev.reason).inc()

    def _resolved_config(self) -> ServeConfig:
        """The ServeConfig the serve loop ACTUALLY ran with: auto depth
        resolved (and any refresh-driven resize), knobs defaulted from the
        prepared pipeline, the cap's follow-the-window default applied."""
        return self.config.replace(
            max_inflight=self.max_inflight, engine=self.route.replace(pipeline_depth=self.depth)
        )

    def _serve_report(self, wall: float) -> ServeReport:
        pooled: list[float] = []
        for s in self.streams:
            pooled.extend(s.latencies)
        _, _, p50, p95, p99 = _latency_stats(pooled)
        stream_reports = [self._stream_report(s) for s in self.streams]
        return ServeReport(
            policy=self.engine.pipeline.name,
            num_streams=len(self.streams),
            depth=self.depth,
            max_inflight_per_stream=self.max_inflight,
            wall_seconds=wall,
            feat_row_bytes=self.engine.dataset.feature_nbytes_per_row(),
            streams=stream_reports,
            prefetch=self.route.prefetch,
            dedup=self.route.dedup,
            device=str(self.engine.device),
            refresh_events=(
                list(self.refresh_manager.events) if self.refresh_manager is not None else []
            ),
            epochs=self._aggregate_epochs() if self.refresh_manager is not None else None,
            p50_latency_s=p50,
            p95_latency_s=p95,
            p99_latency_s=p99,
            config=self._resolved_config(),
            requests_shed=sum(r.requests_shed for r in stream_reports),
            requests_timed_out=sum(r.requests_timed_out for r in stream_reports),
            requests_retried=sum(r.requests_retried for r in stream_reports),
            requests_degraded=sum(r.requests_degraded for r in stream_reports),
            unserved=self._unserved(),
            fault_policy=self.fault_policy,
            faults=self.injector.counts() if self.injector is not None else None,
            error=self._last_error,
        )

    def _unserved(self) -> int:
        """Work still queued when the serve loop ended; the availability
        denominator counts it as offered-but-not-served."""
        return sum(len(s.queue) for s in self.streams)

    def _aggregate_epochs(self) -> dict[int, dict]:
        """Per-epoch counters summed across streams: the shared cache's view."""
        totals: dict[int, list[int]] = {}
        for s in self.streams:
            for epoch, c in s.runtime.epoch_counters.items():
                agg = totals.setdefault(epoch, [0, 0, 0, 0, 0])
                for i, v in enumerate(c):
                    agg[i] += v
        return summarize_epoch_counters(totals)

    def _stream_report(self, s: StreamState) -> StreamReport:
        rt = s.runtime
        mean, mx, p50, p95, p99 = _latency_stats(s.latencies)
        return StreamReport(
            stream_id=s.stream_id,
            seed=s.seed,
            num_batches=s.retired,
            num_seeds=s.seeds_served,
            sample_seconds=s.clock.total("sample"),
            feature_seconds=s.clock.total("feature"),
            compute_seconds=s.clock.total("compute"),
            adj_hits=rt.adj_hits,
            adj_lookups=rt.adj_lookups,
            feat_hits=rt.feat_hits,
            feat_lookups=rt.feat_lookups,
            mean_latency_s=mean,
            max_latency_s=mx,
            p50_latency_s=p50,
            p95_latency_s=p95,
            p99_latency_s=p99,
            prefetch_seconds=s.clock.total("prefetch"),
            prefetched_rows=rt.prefetched_rows,
            unique_rows=rt.unique_rows,
            gathered_rows=rt.gathered_rows,
            epoch_hits=rt.epoch_hit_rates() if self.refresh_manager is not None else None,
            requests_shed=s.batches_shed,
            requests_timed_out=s.batches_timed_out,
            requests_retried=s.batches_retried,
            requests_degraded=s.batches_degraded,
            stage_retries=rt.stage_retries,
            kernel_fallbacks=rt.kernel_fallbacks,
        )


def make_stream_batches(
    dataset,
    *,
    num_streams: int,
    batches_per_stream: int,
    batch_size: int,
    seed: int = 0,
) -> list[list[np.ndarray]]:
    """Per-stream seed-batch queues over the dataset's test nodes.

    Each stream draws its batches from its own shuffled permutation of the
    test set (rng ``seed + stream_id``) — independent request streams over
    the same graph, with the overlapping hot set that makes a *shared*
    cache worth more than N private ones."""
    out: list[list[np.ndarray]] = []
    need = batches_per_stream * batch_size
    for sid in range(num_streams):
        rng = np.random.default_rng(seed + sid)
        ids = rng.permutation(dataset.test_idx)
        if len(ids) < need:  # tiny datasets: cycle to fill the queue
            ids = np.tile(ids, -(-need // max(len(ids), 1)))
        out.append(list(ids[:need].reshape(batches_per_stream, batch_size)))
    return out
