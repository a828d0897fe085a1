"""Pre-sampling workload profiler (paper §IV-A/B).

Runs ``n`` mini-batches through the *uncached* pipeline (a plain feature
store: every row a miss), measuring per-batch sampling and
feature-loading wall time (the Eq. 1 inputs) and accumulating node /
adjacency-element visit counts on the device (the cache-filling inputs).
The paper shows hit rates stabilize at ~8 pre-sampling batches (Fig. 11).

On a CUDA device the feature stage gathers through the kernel route: the
``cached_gather`` kernel reads the all-miss frontier's rows in place from
the pinned host table over UVA, which is where the paper's presampler
reads them and where the reference's presampler gathers (on its device).
The table route would instead gather the rows on the host CPU, a cost no
served batch on the kernel route pays.  On the CPU the route is the plain
version.  Gathers are copies, so the counts do not depend on the route;
only the timed feature stage, and with it Eq. 1's split, does.

Batches run through the same staged executor as inference
(:mod:`repro_torch.runtime.pipeline`).  ``pipeline_depth=1`` (the default)
keeps every stage fully synchronized, which is what Eq. 1's stage-time
ratio assumes.  :func:`merge_stats` combines per-stream profiles (visit
counts sum, stage laps concatenate).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graph.datasets import SyntheticGraphDataset
from repro_torch.graph.features import plain_feature_store
from repro_torch.graph.sampling import add_visits, device_graph, sample_blocks
# A module import: runtime.pipeline imports core.trace, which runs this
# package's __init__ (and so this module) first when pipeline is imported alone.
from repro_torch.runtime import pipeline
from repro_torch.utils.timing import StageClock, block_until_ready

__all__ = ["PresampleStats", "merge_stats", "run_presampling"]


@dataclasses.dataclass
class PresampleStats:
    node_counts: np.ndarray  # int[N]  feature-row visit counts
    edge_counts: np.ndarray  # int[E]  adjacency-element visit counts
    sample_times: list[float]
    feature_times: list[float]
    peak_workload_bytes: int
    n_batches: int

    @property
    def mean_node_visits(self) -> float:
        return float(self.node_counts.mean())


def merge_stats(stats: "list[PresampleStats]") -> PresampleStats:
    """Combine per-stream presampling profiles into one shared profile:
    visit counts sum, stage-time laps concatenate, and the peak live
    workload is the max across streams."""
    if not stats:
        raise ValueError("merge_stats needs at least one PresampleStats")
    return PresampleStats(
        node_counts=np.sum([s.node_counts for s in stats], axis=0),
        edge_counts=np.sum([s.edge_counts for s in stats], axis=0),
        sample_times=[t for s in stats for t in s.sample_times],
        feature_times=[t for s in stats for t in s.feature_times],
        peak_workload_bytes=max(s.peak_workload_bytes for s in stats),
        n_batches=sum(s.n_batches for s in stats),
    )


def _batch_seeds(test_idx: np.ndarray, batch_size: int, i: int) -> np.ndarray:
    """Cyclic, padded batch slicing (every batch has ``batch_size`` seeds)."""
    start = (i * batch_size) % max(len(test_idx), 1)
    seeds = test_idx[start : start + batch_size]
    if len(seeds) < batch_size:
        seeds = np.concatenate([seeds, test_idx[: batch_size - len(seeds)]])
    return seeds


def run_presampling(
    dataset: SyntheticGraphDataset,
    *,
    fanouts: tuple[int, ...],
    batch_size: int,
    n_batches: int = 8,
    seed: int = 0,
    pipeline_depth: int = 1,
    device: torch.device,
) -> PresampleStats:
    """Profile ``n_batches`` batches on ``device``.  Slot draws come from a
    ``torch.Generator`` on the device seeded with ``seed``."""
    g = device_graph(dataset.graph, device=device)
    store = plain_feature_store(dataset.features, device=device)
    use_kernel = store.hot_table.is_cuda  # the kernel route on a card

    def seeds_of(i: int) -> torch.Tensor:
        return torch.from_numpy(_batch_seeds(dataset.test_idx, batch_size, i)).to(device)

    # Untimed warmup on its own generator, so Eq. 1's stage-time ratio
    # measures steady-state work, not first-use setup.
    warm_gen = torch.Generator(device=device).manual_seed(seed)
    wblock = sample_blocks(g, seeds_of(0), tuple(fanouts), generator=warm_gen)
    block_until_ready(store.gather(wblock.input_nodes, use_kernel=use_kernel)[0])

    gen = torch.Generator(device=device).manual_seed(seed)
    node_counts = torch.zeros(dataset.num_nodes, dtype=torch.int32, device=device)
    edge_counts = torch.zeros(dataset.graph.num_edges, dtype=torch.int32, device=device)
    peak = {"bytes": 0}

    def sample_stage(ctx):
        return sample_blocks(g, ctx.payload, tuple(fanouts), generator=gen)

    def feature_stage(ctx):
        feats, _ = store.gather(ctx.outputs["sample"].input_nodes, use_kernel=use_kernel)
        return feats

    def on_retire(ctx):
        block, feats = ctx.outputs["sample"], ctx.outputs["feature"]
        add_visits(node_counts, edge_counts, block)
        # Live workload footprint of this batch (frontier ids + gathered
        # features) — the "workload-aware" part of the budget.
        batch_bytes = feats.numel() * feats.element_size() + sum(
            f.numel() * 4 for f in block.frontiers
        )
        peak["bytes"] = max(peak["bytes"], batch_bytes)

    clock = StageClock(overlap=pipeline_depth > 1)
    executor = pipeline.PipelinedExecutor(
        [
            pipeline.Stage("sample", sample_stage, lambda c: c.outputs["sample"].frontiers[-1]),
            pipeline.Stage("feature", feature_stage, lambda c: c.outputs["feature"]),
        ],
        depth=pipeline_depth,
        clock=clock,
        on_retire=on_retire,
    )
    executor.run(seeds_of(i) for i in range(n_batches))

    return PresampleStats(
        node_counts=node_counts.cpu().numpy(),
        edge_counts=edge_counts.cpu().numpy(),
        sample_times=list(clock.laps.get("sample", [])),
        feature_times=list(clock.laps.get("feature", [])),
        peak_workload_bytes=peak["bytes"],
        n_batches=n_batches,
    )
