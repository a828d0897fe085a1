"""Serve-time workload telemetry — the runtime half of DCI's profile.

DCI profiles the workload once, before serving, with ~8 pre-sampling
batches (core/presample.py).  Long-lived multi-stream serving breaks that
assumption: the seed distribution drifts and streams join/leave, so the
pre-sampled visit counts and the Eq. 1 stage-time ratio go stale.  This
module accumulates the same three signals the presampler measures — but
from the *live* serve path, at retire time, out of accounting the executor
already produces:

  * per-node feature visit AND miss counts (from the gather's hit mask);
  * per-element adjacency fetch counts (from the sampler's edge slots);
  * per-batch sample/feature/compute stage laps (from the stream
    StageClocks — sample:feature feeds the Eq. 1 split, prep:compute
    feeds the refresh-aware ``pipeline_depth="auto"`` re-derivation).

``WorkloadTelemetry`` is windowed: the refresh manager
(runtime/cache_refresh.py) snapshots a window, folds it into its decayed
history, and resets it.  Recording costs one device→host transfer of the
hit mask and edge slots per batch, so it is only attached when a refresh
mode is enabled — the default serve path records nothing and stays
bit-for-bit identical to a telemetry-free build.

The module is numpy throughout, a copy of the reference's: the serve path
hands it host arrays (the retire path reads the batch's tensors back to
the host once, in ``StreamRuntime.record``).

Deduped batches (the unique-frontier feature path) record through the same
entry point with ``multiplicities``: counts are scatter-added once per
UNIQUE node, weighted by how often the batch visited it, which produces
bit-identical counters to the per-visit form at a fraction of the scatter
width.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TelemetryWindow", "WorkloadTelemetry", "merge_windows"]

STAGE_LAPS = ("sample", "feature", "compute")


@dataclasses.dataclass(frozen=True)
class TelemetryWindow:
    """An immutable snapshot of one accumulation window.

    Count arrays are int64 from a single accumulator; a weighted
    :func:`merge_windows` produces float64 (the decayed history consuming
    them is float either way)."""

    node_counts: np.ndarray  # [N] feature-row visits
    node_miss_counts: np.ndarray  # [N] feature-row misses (drift signal)
    edge_counts: np.ndarray  # [E] adjacency-element fetches
    sample_times: list[float]
    feature_times: list[float]
    compute_times: list[float]
    batches: int

    @property
    def feat_lookups(self) -> int:
        return int(self.node_counts.sum())

    @property
    def feat_misses(self) -> int:
        return int(self.node_miss_counts.sum())

    @property
    def miss_rate(self) -> float:
        return self.feat_misses / max(self.feat_lookups, 1)

    def shard_slice(self, lo: int, hi: int) -> "TelemetryWindow":
        """The window as shard ``[lo, hi)`` of a node-id-range partition
        sees it (sharded serving, runtime/sharded_serve.py).

        Node-indexed arrays are sliced to the range — the shard's own
        feature traffic.  The adjacency cache is *replicated* per shard,
        so ``edge_counts`` passes through whole (every replica serves the
        full edge workload).  Stage laps are wall-clock facts of the whole
        pipeline, not per-shard observables, so they pass through too;
        per-shard Eq. 1 scales them by the shard's visit share instead
        (:func:`repro_torch.core.allocation.shard_allocations`)."""
        return TelemetryWindow(
            node_counts=self.node_counts[lo:hi],
            node_miss_counts=self.node_miss_counts[lo:hi],
            edge_counts=self.edge_counts,
            sample_times=self.sample_times,
            feature_times=self.feature_times,
            compute_times=self.compute_times,
            batches=self.batches,
        )


def merge_windows(windows, weights=None) -> TelemetryWindow:
    """Fold several streams' windows into one, optionally weighted.

    The count arrays are summed with per-window ``weights`` (float64 —
    the decayed history they feed is float anyway); stage-lap lists are
    concatenated UNweighted (a lap is a wall-clock fact, not a vote) and
    ``batches`` summed, so the Eq. 1 stage ratio and the refresh-window
    bookkeeping stay physical while the *ranking* signal tilts toward
    pressured streams.  ``weights=None`` (or all-1) reproduces the shared
    single-accumulator counts exactly.  Negative weights are clamped to 0
    — a merge can emphasize a stream, never subtract one (leave-time
    subtraction is the refresh manager's remnant path).
    """
    windows = list(windows)
    if not windows:
        raise ValueError("merge_windows needs at least one window")
    if weights is None:
        weights = [1.0] * len(windows)
    if len(weights) != len(windows):
        raise ValueError(f"{len(windows)} windows but {len(weights)} weights")
    node = np.zeros_like(windows[0].node_counts, np.float64)
    miss = np.zeros_like(windows[0].node_miss_counts, np.float64)
    edge = np.zeros_like(windows[0].edge_counts, np.float64)
    sample_times: list[float] = []
    feature_times: list[float] = []
    compute_times: list[float] = []
    batches = 0
    for win, w in zip(windows, weights):
        w = max(float(w), 0.0)
        node += w * win.node_counts
        miss += w * win.node_miss_counts
        edge += w * win.edge_counts
        sample_times.extend(win.sample_times)
        feature_times.extend(win.feature_times)
        compute_times.extend(win.compute_times)
        batches += win.batches
    return TelemetryWindow(
        node_counts=node,
        node_miss_counts=miss,
        edge_counts=edge,
        sample_times=sample_times,
        feature_times=feature_times,
        compute_times=compute_times,
        batches=batches,
    )


class WorkloadTelemetry:
    """Mutable per-window accumulator fed from the executor's retire path.

    One instance can be shared by several streams (the counts are the
    union workload — exactly what the shared cache is filled for); stage
    laps are pulled from each stream's own clock by :meth:`pull_times`
    with per-clock cursors, so laps are never double-counted across
    windows.  ``miss_rate`` is maintained as two running scalars so the
    SLO trigger can poll it per retired batch without an O(N) reduction.
    """

    def __init__(self, num_nodes: int, num_edges: int):
        self.num_nodes = num_nodes
        self.num_edges = num_edges
        self._lap_cursors: dict[int, dict[str, int]] = {}
        self.reset()

    def reset(self) -> None:
        """Start a new accumulation window (lap cursors persist)."""
        self.node_counts = np.zeros(self.num_nodes, np.int64)
        self.node_miss_counts = np.zeros(self.num_nodes, np.int64)
        self.edge_counts = np.zeros(self.num_edges, np.int64)
        self.sample_times: list[float] = []
        self.feature_times: list[float] = []
        self.compute_times: list[float] = []
        self.batches = 0
        self._lookups = 0
        self._misses = 0

    # ---------------------------------------------------------- recording
    def observe_batch(self, nodes, feat_hit, edge_slots, *, multiplicities=None) -> None:
        """Fold one retired batch's accounting into the current window.

        ``nodes`` is the batch's input frontier, ``feat_hit`` the gather's
        boolean hit mask over it, ``edge_slots`` the per-layer global
        adjacency positions the sampler touched.  All three already exist
        on the retire path — telemetry adds the host conversion and two
        scatter-adds, nothing new on the device.

        With ``multiplicities``, ``nodes``/``feat_hit`` cover only the
        batch's UNIQUE input nodes and ``multiplicities[i]`` is how many
        frontier positions visited ``nodes[i]`` — the deduped feature
        path's form.  Every counter (visits, misses, the running
        lookup/miss scalars) comes out bit-identical to the per-visit
        call, because a node's hit bit is the same for every one of its
        visits in a batch.
        """
        nodes = np.asarray(nodes)
        hit = np.asarray(feat_hit)
        if multiplicities is None:
            np.add.at(self.node_counts, nodes, 1)
            miss_nodes = nodes[~hit]
            if miss_nodes.size:
                np.add.at(self.node_miss_counts, miss_nodes, 1)
            self._lookups += int(nodes.size)
            self._misses += int(miss_nodes.size)
        else:
            mult = np.asarray(multiplicities, np.int64)
            np.add.at(self.node_counts, nodes, mult)
            miss = ~hit
            if miss.any():
                np.add.at(self.node_miss_counts, nodes[miss], mult[miss])
            self._lookups += int(mult.sum())
            self._misses += int(mult[miss].sum())
        for slots in edge_slots:
            idx = np.asarray(slots).reshape(-1)
            # A zero-degree node at the CSC tail emits slot == num_edges;
            # the presample path drops out-of-bounds slots when it counts
            # (graph/sampling.py) — match it (np.add.at would raise).
            np.add.at(self.edge_counts, idx[idx < self.num_edges], 1)
        self.batches += 1

    def pull_times(self, clock) -> None:
        """Append the clock's NEW stage laps since the last pull.

        In serial mode (depth=1) laps are fully synchronized stage times —
        the exact Eq. 1 semantics.  At depth>1 they are dispatch times;
        the ratio still tracks where host-side prep time goes, which is
        the signal the re-allocation needs (documented in
        docs/ARCHITECTURE.md).  Compute laps feed the refresh-aware
        ``pipeline_depth="auto"`` re-derivation, not the Eq. 1 split.
        """
        cursors = self._lap_cursors.setdefault(
            id(clock), {name: 0 for name in STAGE_LAPS}
        )
        for name, out in (
            ("sample", self.sample_times),
            ("feature", self.feature_times),
            ("compute", self.compute_times),
        ):
            laps = clock.laps.get(name, [])
            out.extend(laps[cursors[name] :])
            cursors[name] = len(laps)

    # ----------------------------------------------------------- live view
    @property
    def feat_lookups(self) -> int:
        return self._lookups

    @property
    def feat_misses(self) -> int:
        return self._misses

    @property
    def miss_rate(self) -> float:
        """Feature miss rate of the window accumulated SO FAR — the live
        signal the SLO-aware refresh trigger polls per retired batch."""
        return self._misses / max(self._lookups, 1)

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> TelemetryWindow:
        return TelemetryWindow(
            node_counts=self.node_counts.copy(),
            node_miss_counts=self.node_miss_counts.copy(),
            edge_counts=self.edge_counts.copy(),
            sample_times=list(self.sample_times),
            feature_times=list(self.feature_times),
            compute_times=list(self.compute_times),
            batches=self.batches,
        )
