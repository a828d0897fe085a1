"""Cache/preparation policies: DCI and the baselines the paper compares.

Each ``prepare_*`` returns a :class:`PreparedPipeline` — the caches (or
none) and the measured preprocessing wall time, itself a headline metric
in the paper (Tables IV, Fig. 10).  One prepared pipeline serves every run
against it at any ``pipeline_depth``.

  - ``dci``     the paper's system: Eq. 1 split + lightweight fill
  - ``sci``     single-cache baseline: whole budget to node features
  - ``aci``     ablation: whole budget to the adjacency cache
  - ``dgl``     no caches (DGL's stock pipeline)

``ducati`` and ``rain`` are not ported yet (ROADMAP.md, item 12).
Presampling runs on the pipeline's device; ``stream_seeds`` splits the
presample budget over several streams' seeds and merges the profiles.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.allocation import CacheAllocation, allocate_capacity
from repro_torch.core.cache import DualCache
from repro_torch.core.presample import PresampleStats, merge_stats, run_presampling
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import SyntheticGraphDataset

__all__ = [
    "POLICIES",
    "PreparedPipeline",
    "prepare",
    "prepare_aci",
    "prepare_dci",
    "prepare_dgl",
    "prepare_sci",
]


@dataclasses.dataclass(frozen=True)
class PreparedPipeline:
    name: str
    caches: DualCache
    prep_seconds: float
    presample: PresampleStats | None = None
    # Default execution knobs for runs against this pipeline (overridable
    # per run; outputs and hit accounting are knob-invariant):
    prefetch: bool = False  # stage missed host rows onto the device before the gather
    use_kernel: bool = False  # route gathers through the CUDA cached_gather kernels
    gather_buffers: int = 2  # validated for parity with the reference; no effect
    dedup: bool = False  # gather/model on sorted-unique frontiers only


def _presample_profile(
    dataset: SyntheticGraphDataset,
    *,
    fanouts: tuple[int, ...],
    batch_size: int,
    n_presample: int,
    seed: int,
    pipeline_depth: int,
    stream_seeds,
    device: torch.device,
) -> PresampleStats:
    """One workload profile, single- or multi-stream (the total
    ``n_presample`` budget split across ``stream_seeds``, remainder
    batches to the first streams, at least one batch each)."""
    kw = dict(fanouts=fanouts, batch_size=batch_size, pipeline_depth=pipeline_depth, device=device)
    if not stream_seeds:
        return run_presampling(dataset, n_batches=n_presample, seed=seed, **kw)
    base, extra = divmod(n_presample, len(stream_seeds))
    return merge_stats(
        [
            run_presampling(
                dataset, n_batches=max(1, base + (1 if i < extra else 0)), seed=s, **kw
            )
            for i, s in enumerate(stream_seeds)
        ]
    )


def prepare_dci(
    dataset: SyntheticGraphDataset,
    *,
    total_cache_bytes: int,
    fanouts: tuple[int, ...],
    batch_size: int,
    n_presample: int = 8,
    seed: int = 0,
    pipeline_depth: int = 1,
    stream_seeds=None,
    device: torch.device | str | None = None,
    _feat_only: bool = False,
    _adj_only: bool = False,
) -> PreparedPipeline:
    dev = resolve_device(device)
    stats = _presample_profile(
        dataset,
        fanouts=fanouts,
        batch_size=batch_size,
        n_presample=n_presample,
        seed=seed,
        pipeline_depth=pipeline_depth,
        stream_seeds=stream_seeds,
        device=dev,
    )
    # Preprocessing cost = steady-state pre-sampling work + allocation +
    # cache filling (the untimed presampling warmup is excluded).
    t0 = time.perf_counter() - sum(stats.sample_times) - sum(stats.feature_times)
    if _feat_only:  # SCI: the single-cache state of the art
        alloc = CacheAllocation(
            total_bytes=total_cache_bytes,
            adj_bytes=0,
            feat_bytes=total_cache_bytes,
            sample_fraction=0.0,
        )
    elif _adj_only:  # ACI ablation: adjacency-only cache
        alloc = CacheAllocation(
            total_bytes=total_cache_bytes,
            adj_bytes=total_cache_bytes,
            feat_bytes=0,
            sample_fraction=1.0,
        )
    else:
        alloc = allocate_capacity(
            stats.sample_times,
            stats.feature_times,
            total_cache_bytes,
            adj_need_bytes=dataset.graph.num_edges * 4,
            feat_need_bytes=dataset.features.nbytes,
        )
    caches = DualCache.build(
        dataset,
        node_counts=stats.node_counts,
        edge_counts=stats.edge_counts,
        allocation=alloc,
        device=dev,
    )
    name = "sci" if _feat_only else "aci" if _adj_only else "dci"
    return PreparedPipeline(
        name=name,
        caches=caches,
        prep_seconds=time.perf_counter() - t0,
        presample=stats,
    )


def prepare_sci(dataset, **kw) -> PreparedPipeline:
    return prepare_dci(dataset, _feat_only=True, **kw)


def prepare_aci(dataset, **kw) -> PreparedPipeline:
    """Ablation: the whole budget to the ADJACENCY cache (no feature cache)."""
    return prepare_dci(dataset, _adj_only=True, **kw)


def prepare_dgl(
    dataset: SyntheticGraphDataset, *, device: torch.device | str | None = None, **_kw
) -> PreparedPipeline:
    t0 = time.perf_counter()
    caches = DualCache.none(dataset, device=device)
    return PreparedPipeline(name="dgl", caches=caches, prep_seconds=time.perf_counter() - t0)


POLICIES = {
    "dci": prepare_dci,
    "sci": prepare_sci,
    "aci": prepare_aci,
    "dgl": prepare_dgl,
}
NOT_PORTED = ("ducati", "rain")


def prepare(policy: str, dataset: SyntheticGraphDataset, **kw) -> PreparedPipeline:
    """Dispatch to a policy's ``prepare_*`` on ``device`` (CUDA unless
    ``device="cpu"``).

    Execution knobs (``prefetch``, ``use_kernel``, ``gather_buffers``,
    ``dedup``) are policy-independent: they are recorded on the returned
    pipeline as the defaults every run resolves against, without changing
    what gets cached."""
    if policy in NOT_PORTED:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet (ROADMAP.md, A-item 12)"
        )
    if policy not in POLICIES:
        raise KeyError(f"unknown policy {policy!r}; have {sorted(POLICIES)}")
    if kw.get("pipeline_depth") == "auto":
        # "auto" sizes the RUN-time executor window; presampling stays
        # serial (Eq. 1's stage-time ratio assumes synchronized stages).
        kw["pipeline_depth"] = 1
    exec_kw = {
        "prefetch": bool(kw.pop("prefetch", False)),
        "use_kernel": bool(kw.pop("use_kernel", False)),
        "gather_buffers": int(kw.pop("gather_buffers", 2)),
        "dedup": bool(kw.pop("dedup", False)),
    }
    if exec_kw["gather_buffers"] < 1:
        raise ValueError(f"gather_buffers must be >= 1, got {exec_kw['gather_buffers']}")
    fn = POLICIES[policy]
    if policy == "dgl":
        pipe = fn(dataset, device=kw.get("device"))
    else:
        pipe = fn(dataset, **kw)
    return dataclasses.replace(pipe, **exec_kw)
