"""Workload-aware cache-capacity allocation (paper §IV-A, Eq. 1).

Two decisions happen here:

1. *How much memory is available for caching at all* — run a few
   pre-sampling batches, observe the peak workload footprint, subtract it
   plus a safety reserve (the paper reserves 1 GB, following PaGraph) from
   total device memory.
2. *How to split that budget between the two caches* — proportionally to
   the measured stage times (Eq. 1):

       C_adj  = Σ t_sample  / Σ (t_sample + t_feature) · C
       C_feat = Σ t_feature / Σ (t_sample + t_feature) · C
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "CacheAllocation",
    "LayerwiseAllocation",
    "allocate_capacity",
    "allocate_layerwise_capacity",
    "available_budget",
    "reallocate_capacity",
    "shard_allocations",
    "DEFAULT_RESERVE_BYTES",
]

DEFAULT_RESERVE_BYTES = 1 << 30  # 1 GB, the paper's reference reserve


@dataclasses.dataclass(frozen=True)
class CacheAllocation:
    total_bytes: int
    adj_bytes: int
    feat_bytes: int
    sample_fraction: float  # Σt_sample / Σ(t_sample+t_feature)

    def __post_init__(self):
        assert self.adj_bytes + self.feat_bytes <= self.total_bytes + 1


def available_budget(
    device_memory_bytes: int,
    peak_workload_bytes: int,
    reserve_bytes: int = DEFAULT_RESERVE_BYTES,
) -> int:
    """Workload-aware total budget C: what's left after the live workload."""
    return max(device_memory_bytes - peak_workload_bytes - reserve_bytes, 0)


def allocate_capacity(
    sample_times: list[float],
    feature_times: list[float],
    total_bytes: int,
    *,
    adj_need_bytes: int | None = None,
    feat_need_bytes: int | None = None,
) -> CacheAllocation:
    """Eq. 1: split ``total_bytes`` by the measured stage-time ratio.

    Saturation-aware spill (beyond-paper refinement): when the Eq. 1 share
    of one cache exceeds what that cache can usefully hold (``*_need``),
    the excess spills to the other.  With a budget covering the whole
    dataset both caches saturate — matching the paper's Fig. 9 observation
    that all strategies coincide once everything fits.
    """
    if len(sample_times) != len(feature_times) or not sample_times:
        raise ValueError("need equal, non-empty per-batch stage time lists")
    t_s = float(sum(sample_times))
    t_f = float(sum(feature_times))
    denom = t_s + t_f
    frac = 0.5 if denom <= 0 else t_s / denom
    total = int(total_bytes)
    adj = int(total * frac)
    feat = total - adj
    if adj_need_bytes is not None and adj > adj_need_bytes:
        feat += adj - adj_need_bytes
        adj = adj_need_bytes
    if feat_need_bytes is not None and feat > feat_need_bytes:
        spill = feat - feat_need_bytes
        feat = feat_need_bytes
        adj = min(adj + spill, adj_need_bytes) if adj_need_bytes is not None else adj + spill
    return CacheAllocation(
        total_bytes=total,
        adj_bytes=adj,
        feat_bytes=feat,
        sample_fraction=frac,
    )


def reallocate_capacity(
    base: CacheAllocation,
    sample_times: list[float],
    feature_times: list[float],
    *,
    adj_need_bytes: int | None = None,
    feat_need_bytes: int | None = None,
) -> CacheAllocation:
    """Eq. 1 re-run at serve time: same total budget, measured stage ratio.

    The online cache-refresh subsystem (runtime/cache_refresh.py) calls
    this with the *serve-time* stage laps — pre-sampling laps plus the
    runtime telemetry window — so the adj/feat split follows the workload
    as it drifts instead of staying frozen at the preprocessing-time
    ratio.  The total budget is the one decision that does NOT move: it
    was sized against device memory (available_budget), which serving
    does not change."""
    return allocate_capacity(
        sample_times,
        feature_times,
        base.total_bytes,
        adj_need_bytes=adj_need_bytes,
        feat_need_bytes=feat_need_bytes,
    )


@dataclasses.dataclass(frozen=True)
class LayerwiseAllocation:
    """Eq. 1's split re-targeted at the layer-wise mode's two caches.

    In layer-wise full-graph inference the two device caches competing for
    the budget are the layer-0 INPUT-FEATURE cache and the intermediate
    EMBEDDING cache (layer-k outputs re-read as layer-k+1 inputs).  Only
    one embedding cache is ever live at a time — each layer's store is
    transient — so ``embed_bytes`` is the full per-layer embedding budget,
    not a per-layer slice."""

    total_bytes: int
    feat_bytes: int  # layer-0 input-feature cache share
    embed_bytes: int  # per-layer intermediate-embedding cache share
    feat_fraction: float  # Σt_feat_gather / Σ(t_feat_gather + t_embed_gather)

    def __post_init__(self):
        assert self.feat_bytes + self.embed_bytes <= self.total_bytes + 1


def allocate_layerwise_capacity(
    feat_gather_times: list[float],
    embed_gather_times: list[float],
    total_bytes: int,
    *,
    feat_need_bytes: int | None = None,
    embed_need_bytes: int | None = None,
) -> LayerwiseAllocation:
    """Eq. 1 over the layer-wise mode's probed chunk gather laps.

    Same proportional-to-measured-stage-time split (and the same
    saturation-aware spill) as :func:`allocate_capacity`, with the roles
    re-mapped: the "sample" slot carries the layer-0 feature-gather laps,
    the "feature" slot the intermediate embedding-gather laps.  The probe
    chunks play presampling's part — a few chunks' synchronized gather
    laps at each source's row width — so the cache that moves more bytes
    per chunk gets the proportionally larger share."""
    alloc = allocate_capacity(
        feat_gather_times,
        embed_gather_times,
        total_bytes,
        adj_need_bytes=feat_need_bytes,
        feat_need_bytes=embed_need_bytes,
    )
    return LayerwiseAllocation(
        total_bytes=alloc.total_bytes,
        feat_bytes=alloc.adj_bytes,
        embed_bytes=alloc.feat_bytes,
        feat_fraction=alloc.sample_fraction,
    )


def shard_allocations(
    base: CacheAllocation,
    shard_weights,
    *,
    sample_times: list[float],
    feature_times: list[float],
    adj_need_bytes: int | None = None,
    feat_need_bytes: int | None = None,
) -> list[CacheAllocation]:
    """Eq. 1 run per shard on per-shard telemetry (sharded serving).

    Each shard re-runs :func:`allocate_capacity` on its own slice of the
    workload: ``shard_weights`` carries the shard's share of the
    telemetry window (its range's visit counts — see
    ``TelemetryWindow.shard_slice``), which scales both its budget share
    of ``base.total_bytes`` and its stage times.  Because Eq. 1's split
    fraction is invariant under uniform time scaling, every shard lands
    on the *same* ``sample_fraction`` as the global allocation — the
    coordination property that lets the globally-ranked fill be
    partitioned by id range without changing a single cached row
    (tested in tests/test_allocation.py / tests/test_sharded_serve.py).
    The per-shard ``total_bytes`` sum to the global budget (remainder
    bytes go to the last shard).
    """
    weights = [max(float(w), 0.0) for w in shard_weights]
    if not weights:
        raise ValueError("shard_allocations needs at least one shard weight")
    denom = sum(weights)
    fracs = [w / denom if denom > 0 else 1.0 / len(weights) for w in weights]
    t_s = float(sum(sample_times))
    t_f = float(sum(feature_times))
    allocs: list[CacheAllocation] = []
    spent = 0
    for i, f in enumerate(fracs):
        budget = base.total_bytes - spent if i == len(fracs) - 1 else int(base.total_bytes * f)
        spent += budget
        allocs.append(
            allocate_capacity(
                [t_s * f] if t_s or t_f else [0.0],
                [t_f * f] if t_s or t_f else [0.0],
                budget,
                adj_need_bytes=None if adj_need_bytes is None else int(adj_need_bytes * f),
                feat_need_bytes=None if feat_need_bytes is None else int(feat_need_bytes * f),
            )
        )
    return allocs
