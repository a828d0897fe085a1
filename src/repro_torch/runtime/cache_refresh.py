"""Online cache refresh: serve-time re-allocation + delta re-fill.

DCI allocates and fills both caches once, from pre-sampling statistics
(§IV-A Eq. 1, §IV-B).  Long-lived serving breaks the one-shot assumption:
the seed distribution drifts and request streams join/leave, so the
pre-sampled ranking goes stale and hit rates decay.  This module closes
the loop at serve time:

  telemetry window          re-allocation               delta re-fill
  (core/telemetry.py)  ──►  Eq. 1 on measured     ──►  DualCache.refresh
  miss/visit counts,        serve-time stage ratio      (epoch += 1, only
  stage laps                (core/allocation.py)        changed rows/segments
                                                        move)

``CacheRefreshManager`` owns the loop.  It keeps a *decayed history* of
visit counts seeded from the preparation-time presample profile: each
refresh folds the latest telemetry window in as

    history = history_decay * history + window_counts

so sustained drift re-ranks the caches within a few windows while
one-window noise cannot evict the steady hot set.  Stage-time history is
blended the same way, so the Eq. 1 split follows the measured serve-time
sample:feature ratio.

Refresh triggers (``RefreshConfig.mode``):

  * ``interval`` — every ``interval_batches`` retired batches;
  * ``events``   — on stream join/leave (the serving layer's hooks);
  * ``all``      — both; ``off`` — never (the default; the serve path then
    records no telemetry and is bit-for-bit identical to a refresh-free
    build).

``miss_threshold`` (CLI: ``--refresh-miss-threshold``) adds an SLO-aware
trigger that composes with any enabled mode: the manager polls the live
telemetry window's feature miss rate once per retired batch and fires a
refresh as soon as it crosses the threshold (subject to
``min_window_batches``), instead of waiting out the interval — the knob
for "refresh when service quality degrades", not "refresh on a timer".

A refresh runs *between* batch dispatches (the executor's retire path), so
up to ``depth-1`` in-flight batches may straddle an epoch boundary: they
keep the previous epoch's tensors, which the refresh never writes into
(``DualCache.refresh``), and retire normally, while the next dispatched
stage reads the new epoch.  That is safe because a refresh never changes
sampled blocks or gathered rows — the two-level sort order and the host
tables are frozen at build time — only hit accounting and byte movement
(pinned by tests/test_torch_cache_refresh.py).

Each :class:`RefreshEvent` splits its pause into the telemetry pull (the
window's snapshot and merge), Eq. 1 (re-allocation and step clamp), and
the adjacency and feature re-fills, in host seconds.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.allocation import reallocate_capacity
from repro_torch.core.cache import CacheRefreshDelta
from repro_torch.core.presample import run_presampling
from repro_torch.core.telemetry import WorkloadTelemetry, merge_windows
from repro_torch.core.trace import NULL_TRACER
from repro_torch.graph.csc import BYTES_PER_ADJ_ELEMENT

__all__ = ["RefreshConfig", "RefreshEvent", "RefreshFailure", "CacheRefreshManager"]

MODES = ("off", "interval", "events", "all")
STREAM_WEIGHTINGS = ("none", "queue-depth", "slo-pressure")


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Knobs for the online refresh loop (CLI: --refresh-mode/-interval)."""

    mode: str = "off"  # off | interval | events | all
    interval_batches: int = 0  # refresh period, in retired batches
    history_decay: float = 0.5  # weight of prior counts per refresh
    min_window_batches: int = 1  # skip interval refreshes on thinner windows
    join_presample_batches: int = 2  # presample budget for a joining stream
    # Bounded re-allocation: the adj share may move at most this fraction
    # of the total budget per refresh.  Serve-time stage laps are noisier
    # than the synchronized presample profile (and at depth>1 they are
    # dispatch times), so an unclamped Eq. 1 re-run can slosh the whole
    # budget between the caches on one noisy window; the step bound turns
    # that into a damped walk toward the measured ratio.  None = unclamped.
    max_split_step: float | None = 0.15
    # SLO-aware trigger: fire a refresh as soon as the live window's
    # feature miss rate crosses this value (None = disabled).  Composes
    # with the interval/event triggers in any enabled mode.
    miss_threshold: float | None = None
    # Per-stream telemetry merging.  "none" keeps the single shared
    # accumulator (every stream records into one union window — the
    # pre-existing behavior, bit-for-bit).  "queue-depth" / "slo-pressure"
    # give each stream its OWN accumulator; at refresh time the windows
    # are folded with weights the serving layer supplies
    # (:meth:`CacheRefreshManager.set_weight_fn` — queue depth + in-flight
    # occupancy, plus deadline urgency under "slo-pressure"), so the
    # re-ranking follows the streams that are actually backed up rather
    # than weighting every stream by raw batch count.
    stream_weighting: str = "none"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"refresh mode must be one of {MODES}, got {self.mode!r}")
        if self.stream_weighting not in STREAM_WEIGHTINGS:
            raise ValueError(
                f"stream_weighting must be one of {STREAM_WEIGHTINGS}, "
                f"got {self.stream_weighting!r}"
            )
        if self.mode in ("interval", "all") and self.interval_batches < 1:
            raise ValueError("interval/all refresh modes need interval_batches >= 1")
        if not 0.0 <= self.history_decay <= 1.0:
            raise ValueError("history_decay must be in [0, 1]")
        if self.max_split_step is not None and not 0.0 < self.max_split_step <= 1.0:
            raise ValueError("max_split_step must be in (0, 1] or None")
        if self.miss_threshold is not None and not 0.0 < self.miss_threshold <= 1.0:
            raise ValueError("miss_threshold must be in (0, 1] or None")

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    @property
    def on_interval(self) -> bool:
        return self.mode in ("interval", "all")

    @property
    def on_events(self) -> bool:
        return self.mode in ("events", "all")


@dataclasses.dataclass(frozen=True)
class RefreshEvent:
    """One completed refresh: trigger, outcome, and pause cost."""

    epoch: int
    reason: str  # "interval" | "miss-threshold" | "stream-join" | "stream-leave" | "manual"
    delta: CacheRefreshDelta
    pause_seconds: float  # wall time the re-allocation + delta re-fill took
    window_batches: int  # telemetry batches folded into this refresh
    window_miss_rate: float  # feature miss rate of the folded window
    suggested_depth: int | None = None  # re-derived "auto" window (None: no compute laps yet)
    # pause_seconds by part: "telemetry", "eq1", "adj", "feat" (host seconds)
    pause_split: dict | None = None

    def summary(self) -> dict:
        return {
            "epoch": self.epoch,
            "reason": self.reason,
            "pause_s": round(self.pause_seconds, 4),
            "pause_split_s": self.pause_split,
            "window_batches": self.window_batches,
            "window_miss_rate": round(self.window_miss_rate, 4),
            "suggested_depth": self.suggested_depth,
            "adj_bytes": self.delta.allocation.adj_bytes,
            "feat_bytes": self.delta.allocation.feat_bytes,
            "feat_rows_inserted": self.delta.feat.rows_inserted,
            "feat_rows_evicted": self.delta.feat.rows_evicted,
            "feat_rows_kept": self.delta.feat.rows_kept,
            "adj_nodes_changed": self.delta.adj.nodes_changed,
            "adj_elements_regathered": self.delta.adj.elements_regathered,
        }


@dataclasses.dataclass(frozen=True)
class RefreshFailure:
    """One refresh that failed mid-apply and rolled back.

    ``DualCache.refresh`` is transactional, so a failure leaves the cache
    byte-for-byte on the old (still servable) epoch — ``epoch`` here is
    that stale epoch, unchanged.  The telemetry window folded into history
    before the apply STAYS folded: the next trigger retries the
    re-allocation from the richer history rather than replaying the lost
    window."""

    reason: str  # the trigger that fired the failed refresh
    error: str  # repr of the exception that aborted the apply
    epoch: int  # the epoch still being served (pre-refresh, post-rollback)
    pause_seconds: float
    window_batches: int

    def summary(self) -> dict:
        return {
            "reason": self.reason,
            "error": self.error,
            "epoch": self.epoch,
            "pause_s": round(self.pause_seconds, 4),
            "window_batches": self.window_batches,
        }


class CacheRefreshManager:
    """Drives telemetry → Eq. 1 re-allocation → DualCache delta re-fills.

    One manager per served pipeline.  The engine/serving layer calls
    :meth:`note_retired` once per retired batch (the interval trigger) and
    the stream hooks on membership changes (the event trigger); both
    funnel into :meth:`refresh`.
    """

    def __init__(self, pipeline, dataset, *, fanouts, batch_size, config: RefreshConfig):
        if not config.enabled:
            raise ValueError("CacheRefreshManager needs an enabled RefreshConfig")
        if not pipeline.caches.refreshable:
            raise ValueError(
                f"policy {pipeline.name!r} built no refreshable caches; online refresh "
                "needs a presampled dual cache (dci/sci/aci/ducati)"
            )
        self.pipeline = pipeline
        self.dataset = dataset
        self.fanouts = tuple(fanouts)
        self.batch_size = batch_size
        self.config = config
        # Settable observability handle (core/trace.py): the owning
        # engine/server installs its tracer; refreshes then land as epoch
        # spans + allocation-split counters on the "refresh" lane.
        self.tracer = NULL_TRACER
        # Settable fault-injection handle (core/faults.py): when the
        # owning server installs one, each apply charges a ``refresh_fill``
        # site call; a triggered fault rolls back (see RefreshFailure).
        self.injector = None
        self.failures: list[RefreshFailure] = []
        self.telemetry = WorkloadTelemetry(dataset.num_nodes, dataset.graph.num_edges)
        # Weighted-merge mode: per-stream accumulators keyed by the
        # serving layer's stream key; empty under "none" (shared sink).
        self._stream_telemetry: dict = {}
        self._weight_fn = None
        self.events: list[RefreshEvent] = []
        self._clocks: list = []
        self._retired_since_refresh = 0
        # Decayed count/stage-time history, seeded from the preparation
        # profile so the first refresh starts from the same ranking the
        # build used.
        stats = pipeline.presample
        if stats is not None:
            self._node_counts = stats.node_counts.astype(np.float64)
            self._edge_counts = stats.edge_counts.astype(np.float64)
            self._sample_s = float(sum(stats.sample_times))
            self._feature_s = float(sum(stats.feature_times))
        else:
            self._node_counts = np.zeros(dataset.num_nodes, np.float64)
            self._edge_counts = np.zeros(dataset.graph.num_edges, np.float64)
            self._sample_s = self._feature_s = 0.0
        # Compute-lap history (serve-time only — presampling runs no
        # forward) and the "auto" executor window it implies.  Updated per
        # refresh; consumers with pipeline_depth="auto" apply
        # ``suggested_depth`` to the live executor between batches.
        self._compute_s = 0.0
        self.suggested_depth: int | None = None
        # Per-seed presample contributions for join/leave re-merging
        # (populated on join; initial streams' individual profiles were
        # merged away during preparation, so a leave before any join
        # relies on decay).  Each entry is decayed in lockstep with the
        # history, so a leave subtracts exactly the remnant of the join
        # that is still IN the history — not the original raw counts.
        self._stream_stats: dict[int, dict] = {}

    # ----------------------------------------------------------- triggers
    def register_clock(self, clock, key=None) -> None:
        """Track a stream's StageClock so its laps feed the Eq. 1 ratio.

        ``key`` is accepted for symmetry with :meth:`telemetry_for`; laps
        always pool into the shared accumulator — a stage lap is a
        wall-clock fact shared by the whole pipeline, only the COUNT
        merge is weighted."""
        del key
        if clock not in self._clocks:
            self._clocks.append(clock)

    def telemetry_for(self, key) -> WorkloadTelemetry:
        """The sink a stream's retire path should record into.

        Shared accumulator under ``stream_weighting="none"`` (the
        pre-existing union-window behavior); otherwise one accumulator
        per stream key, folded by :func:`merge_windows` with the serving
        layer's weights at each refresh."""
        if self.config.stream_weighting == "none":
            return self.telemetry
        sink = self._stream_telemetry.get(key)
        if sink is None:
            sink = self._stream_telemetry[key] = WorkloadTelemetry(
                self.dataset.num_nodes, self.dataset.graph.num_edges
            )
        return sink

    def set_weight_fn(self, fn) -> None:
        """``fn(key) -> float`` supplies each stream's merge weight at
        refresh time (the serving layer's queue-depth / SLO-pressure
        view).  Ignored under ``stream_weighting="none"``."""
        self._weight_fn = fn

    def shard_allocations(self, plan):
        """Eq. 1 per shard on the decayed workload history, sliced by the
        plan's node-id ranges (the sharded serving layer calls this after
        every refresh so each shard's capacity follows ITS range's share
        of the traffic).  The per-shard split fractions all equal the
        global ``sample_fraction`` (Eq. 1 is scale-invariant), which is
        what keeps the globally-coordinated fill partitionable — see
        ``repro_torch.core.allocation.shard_allocations``."""
        from repro_torch.core.allocation import shard_allocations

        weights = [
            float(self._node_counts[lo:hi].sum())
            for lo, hi in (plan.bounds(s) for s in range(plan.num_shards))
        ]
        if not any(weights):
            weights = [float(hi - lo) for lo, hi in (plan.bounds(s) for s in range(plan.num_shards))]
        return shard_allocations(
            self.pipeline.caches.allocation,
            weights,
            sample_times=[self._sample_s],
            feature_times=[self._feature_s],
            adj_need_bytes=self.dataset.graph.num_edges * BYTES_PER_ADJ_ELEMENT,
            feat_need_bytes=self.dataset.features.nbytes,
        )

    def _window_batches(self) -> int:
        return self.telemetry.batches + sum(
            t.batches for t in self._stream_telemetry.values()
        )

    def _window_miss_rate(self) -> float:
        lookups = self.telemetry.feat_lookups
        misses = self.telemetry.feat_misses
        for t in self._stream_telemetry.values():
            lookups += t.feat_lookups
            misses += t.feat_misses
        return misses / max(lookups, 1)

    def note_retired(self) -> RefreshEvent | None:
        """Per-retired-batch triggers: SLO miss-rate threshold, then interval.

        The miss-threshold check runs first (in any enabled mode — it is a
        quality signal, not a schedule) so a degrading window refreshes as
        soon as it crosses the SLO instead of waiting out the interval;
        the interval trigger then proceeds as before.  Both share
        ``min_window_batches`` so one thin noisy window cannot fire either.
        """
        self._retired_since_refresh += 1
        cfg = self.config
        if (
            cfg.miss_threshold is not None
            and self._window_batches() >= cfg.min_window_batches
            and self._window_miss_rate() >= cfg.miss_threshold
        ):
            return self.refresh("miss-threshold")
        if not cfg.on_interval:
            return None
        if self._retired_since_refresh < cfg.interval_batches:
            return None
        if self._window_batches() < cfg.min_window_batches:
            return None
        return self.refresh("interval")

    def on_stream_join(self, seed: int) -> RefreshEvent | None:
        """A stream joined at serve time: presample its seed, fold the
        profile into the merged history, and (in event modes) refresh so
        the shared cache serves the NEW union workload."""
        stats = run_presampling(
            self.dataset,
            fanouts=self.fanouts,
            batch_size=self.batch_size,
            n_batches=self.config.join_presample_batches,
            seed=seed,
            device=self.pipeline.caches.dgraph.device,
        )
        self._stream_stats[seed] = {
            "node_counts": stats.node_counts.astype(np.float64),
            "edge_counts": stats.edge_counts.astype(np.float64),
            "sample_s": float(sum(stats.sample_times)),
            "feature_s": float(sum(stats.feature_times)),
        }
        self._node_counts += stats.node_counts
        self._edge_counts += stats.edge_counts
        self._sample_s += float(sum(stats.sample_times))
        self._feature_s += float(sum(stats.feature_times))
        if not self.config.on_events:
            return None
        return self.refresh("stream-join")

    def on_stream_leave(self, seed: int) -> RefreshEvent | None:
        """A stream left: subtract what REMAINS of its join-time presample
        contribution (the stored profile is decayed in lockstep with the
        history, so shared hot nodes' counts from other streams are
        untouched) and refresh; departed live traffic also washes out of
        the decayed history over subsequent windows.

        Every subtraction is clamped elementwise at zero.  The lockstep
        decay makes history − remnant non-negative in exact arithmetic,
        but the two sides round differently in floating point (the
        history decays ``decay*(h+P)+w`` as a sum, the remnant decays
        ``decay*P`` alone), so an unclamped subtraction can leave tiny
        negative per-node counts — which the next Eq. 1 re-allocation and
        hot-row selection would silently treat as anti-visits.  The clamp
        is the invariant the join→serve→leave regression test pins."""
        remnant = self._stream_stats.pop(seed, None)
        if remnant is not None:
            self._node_counts = np.maximum(self._node_counts - remnant["node_counts"], 0.0)
            self._edge_counts = np.maximum(self._edge_counts - remnant["edge_counts"], 0.0)
            self._sample_s = max(self._sample_s - remnant["sample_s"], 0.0)
            self._feature_s = max(self._feature_s - remnant["feature_s"], 0.0)
        if not self.config.on_events:
            return None
        return self.refresh("stream-leave")

    def _clamp_step(self, current, desired):
        """Bound the per-refresh budget move (see RefreshConfig.max_split_step)."""
        from repro_torch.core.allocation import CacheAllocation

        step = self.config.max_split_step
        total = desired.total_bytes
        if step is None or total <= 0:
            return desired
        bound = int(step * total)
        adj = int(min(max(desired.adj_bytes, current.adj_bytes - bound), current.adj_bytes + bound))
        adj = max(0, min(adj, total, self.dataset.graph.num_edges * BYTES_PER_ADJ_ELEMENT))
        feat = min(total - adj, self.dataset.features.nbytes)
        return CacheAllocation(
            total_bytes=total,
            adj_bytes=adj,
            feat_bytes=feat,
            sample_fraction=desired.sample_fraction,
        )

    # ------------------------------------------------------------ refresh
    def refresh(self, reason: str = "manual") -> RefreshEvent | None:
        """Fold the current telemetry window into history, re-run Eq. 1 on
        the measured stage ratio, and apply the delta re-fill.

        Returns ``None`` when the apply failed and rolled back (recorded
        in :attr:`failures`) — the caches are byte-for-byte on the old
        epoch and serving continues against it."""
        with self.tracer.span("refresh", lane="refresh", args={"reason": reason}):
            event = self._refresh(reason)
        if event is None:
            return None
        if self.tracer.enabled:
            # The Eq. 1 split the epoch landed on, as counter tracks — the
            # timeline shows allocation drift across refreshes at a glance.
            self.tracer.counter(
                "allocation_bytes",
                {
                    "adj": float(event.delta.allocation.adj_bytes),
                    "feat": float(event.delta.allocation.feat_bytes),
                },
            )
            self.tracer.counter(
                "refresh_window", {"miss_rate": float(event.window_miss_rate)}
            )
            self.tracer.instant(
                "epoch", lane="refresh", args={"epoch": event.epoch, "reason": reason}
            )
        return event

    def _refresh(self, reason: str) -> RefreshEvent | None:
        t0 = time.perf_counter()
        for clock in self._clocks:
            self.telemetry.pull_times(clock)
        if self._stream_telemetry:
            # Weighted merge: counts from the per-stream accumulators,
            # tilted by the serving layer's pressure weights; laps/batches
            # pooled unweighted (see merge_windows).
            parts = [self.telemetry.snapshot()]
            weights = [1.0]
            for key, sink in self._stream_telemetry.items():
                parts.append(sink.snapshot())
                weights.append(1.0 if self._weight_fn is None else self._weight_fn(key))
                sink.reset()
            window = merge_windows(parts, weights)
        else:
            window = self.telemetry.snapshot()
        self.telemetry.reset()
        self._retired_since_refresh = 0
        decay = self.config.history_decay
        if window.batches:
            self._node_counts = decay * self._node_counts + window.node_counts
            self._edge_counts = decay * self._edge_counts + window.edge_counts
            self._sample_s = decay * self._sample_s + float(sum(window.sample_times))
            self._feature_s = decay * self._feature_s + float(sum(window.feature_times))
            self._compute_s = decay * self._compute_s + float(sum(window.compute_times))
            # Decay the recorded per-stream join contributions in lockstep,
            # so a later leave subtracts only what the history still holds.
            for remnant in self._stream_stats.values():
                remnant["node_counts"] *= decay
                remnant["edge_counts"] *= decay
                remnant["sample_s"] *= decay
                remnant["feature_s"] *= decay
        t_window = time.perf_counter()
        caches = self.pipeline.caches
        allocation = reallocate_capacity(
            caches.allocation,
            [self._sample_s],
            [self._feature_s],
            adj_need_bytes=self.dataset.graph.num_edges * BYTES_PER_ADJ_ELEMENT,
            feat_need_bytes=self.dataset.features.nbytes,
        )
        allocation = self._clamp_step(caches.allocation, allocation)
        t_eq1 = time.perf_counter()
        try:
            delta = caches.refresh(
                allocation=allocation,
                node_counts=self._node_counts,
                edge_counts=self._edge_counts,
                injector=self.injector,
            )
        except Exception as err:
            # DualCache.refresh already rolled its state back; record the
            # failure and keep serving the stale epoch (see RefreshFailure).
            failure = RefreshFailure(
                reason=reason,
                error=repr(err),
                epoch=caches.epoch,
                pause_seconds=time.perf_counter() - t0,
                window_batches=window.batches,
            )
            self.failures.append(failure)
            if self.tracer.enabled:
                self.tracer.instant(
                    "refresh-rollback",
                    lane="refresh",
                    args={"reason": reason, "epoch": caches.epoch, "error": type(err).__name__},
                )
            return None
        if self._compute_s > 0.0:
            # Refresh-aware "auto" pipeline depth: re-derive the executor
            # window from the refreshed prep:compute ratio (the same
            # formula the warmup-time probe uses), so a refresh that
            # shifts the stage balance also resizes the overlap window.
            from repro_torch.runtime.gnn_engine import auto_pipeline_depth

            derived = auto_pipeline_depth(
                self._sample_s + self._feature_s, self._compute_s
            )
            # A degenerate window (~zero measured prep → depth 1) is not a
            # usable live resize: mid-run the clocks are already in overlap
            # mode, so keep the previous suggestion and re-derive from the
            # next window's laps instead.
            if derived >= 2:
                self.suggested_depth = derived
        event = RefreshEvent(
            epoch=delta.epoch,
            reason=reason,
            delta=delta,
            pause_seconds=time.perf_counter() - t0,
            window_batches=window.batches,
            window_miss_rate=window.miss_rate,
            suggested_depth=self.suggested_depth,
            pause_split={
                "telemetry": t_window - t0,
                "eq1": t_eq1 - t_window,
                "adj": delta.adj_seconds,
                "feat": delta.feat_seconds,
            },
        )
        self.events.append(event)
        return event
