"""Cache/preparation policies: DCI and the baselines the paper compares.

Each ``prepare_*`` returns a :class:`PreparedPipeline` — the caches (or
none) and the measured preprocessing wall time, itself a headline metric
in the paper (Tables IV, Fig. 10).  One prepared pipeline serves every run
against it at any ``pipeline_depth``.

  - ``dci``     the paper's system: Eq. 1 split + lightweight fill
  - ``sci``     single-cache baseline: whole budget to node features
  - ``aci``     ablation: whole budget to the adjacency cache
  - ``dgl``     no caches (DGL's stock pipeline)
  - ``ducati``  DUCATI's dual-cache population: value curves + slope fit +
                knapsack-style density fill (heavier preprocessing, the
                paper's point)
  - ``rain``    RAIN: LSH clustering of batches + cross-batch feature reuse

Presampling runs on the pipeline's device; ``stream_seeds`` splits the
presample budget over several streams' seeds and merges the profiles.

The admission policies (round-robin, EDF, SLO) order the requests the
serving front-end (:mod:`repro_torch.runtime.request_queue`) admits.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.allocation import CacheAllocation, allocate_capacity
from repro_torch.core.cache import DualCache
from repro_torch.core.presample import PresampleStats, merge_stats, run_presampling
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import SyntheticGraphDataset

__all__ = [
    "ADMISSION_POLICIES",
    "AdmissionPolicy",
    "EDFAdmission",
    "POLICIES",
    "PreparedPipeline",
    "RoundRobinAdmission",
    "SLOAdmission",
    "prepare",
    "prepare_aci",
    "prepare_dci",
    "prepare_dgl",
    "prepare_ducati",
    "prepare_rain",
    "prepare_sci",
    "ducati_caches",
]


@dataclasses.dataclass(frozen=True)
class PreparedPipeline:
    name: str
    caches: DualCache
    prep_seconds: float
    presample: PresampleStats | None = None
    batch_order: np.ndarray | None = None  # RAIN: inference-order permutation of batches
    reuse_prev_batch: bool = False  # RAIN: reuse the previous batch's feature rows
    # Default execution knobs for runs against this pipeline (overridable
    # per run; outputs and hit accounting are knob-invariant):
    prefetch: bool = False  # stage missed host rows onto the device before the gather
    use_kernel: bool = False  # route gathers through the CUDA cached_gather kernels
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


def prepare_ducati(
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
) -> PreparedPipeline:
    """DUCATI's dual-cache population, adapted to inference.

    DUCATI (training-oriented) profiles over 4x DCI's presampling batches,
    builds *value curves* for feature rows and adjacency lists (a global
    sort of each population), fits their slopes, and fills one joint
    knapsack by value density: the capacity split emerges from the
    knapsack instead of Eq. 1.  Its preprocessing time counts the
    presampling's steady-state laps, as DCI's does."""
    dev = resolve_device(device)
    stats = _presample_profile(
        dataset,
        fanouts=fanouts,
        batch_size=batch_size,
        n_presample=4 * n_presample,
        seed=seed,
        pipeline_depth=pipeline_depth,
        stream_seeds=stream_seeds,
        device=dev,
    )
    t0 = time.perf_counter() - sum(stats.sample_times) - sum(stats.feature_times)
    caches = ducati_caches(dataset, stats, total_cache_bytes=total_cache_bytes, device=dev)
    return PreparedPipeline(
        name="ducati",
        caches=caches,
        prep_seconds=time.perf_counter() - t0,
        presample=stats,
    )


def ducati_caches(
    dataset: SyntheticGraphDataset,
    stats: PresampleStats,
    *,
    total_cache_bytes: int,
    device: torch.device | str | None = None,
) -> DualCache:
    """DUCATI's fill from a presampling profile: value curves, ``np.polyfit``
    slope fits (kept for their cost: the fit itself is not used), the
    density knapsack over both populations, then :meth:`DualCache.build`.

    As in the reference, the feature side is filled through the
    knapsack's picks with their counts biased by +1 (so exactly they rank
    on top), and the adjacency side by the ordinary fill from
    ``stats.edge_counts`` at the knapsack's ``adj_bytes`` — not from its
    chosen lists."""
    graph = dataset.graph
    row_bytes = dataset.feature_nbytes_per_row()
    deg = np.diff(graph.col_ptr)

    # --- value curves + slope fitting (the expensive part) -----------------
    nfeat_curve = np.sort(stats.node_counts)[::-1].astype(np.float64)
    starts = np.minimum(graph.col_ptr[:-1], max(graph.num_edges - 1, 0))
    node_totals = np.add.reduceat(stats.edge_counts.astype(np.int64), starts)
    node_totals = np.where(deg > 0, node_totals, 0)
    adj_curve = np.sort(node_totals)[::-1].astype(np.float64)
    for curve in (nfeat_curve, adj_curve):
        x = np.arange(1, curve.shape[0] + 1, dtype=np.float64)
        with np.errstate(divide="ignore"):
            np.polyfit(np.log(x), np.log(curve + 1.0), deg=2)  # slope fit

    # --- joint knapsack by value density ------------------------------------
    # feature entry v: value = visits, size = row_bytes;
    # adjacency entry v: value = total visits of v's list, size = deg[v]*4.
    n = dataset.num_nodes
    sizes = np.concatenate([np.full(n, row_bytes, np.int64), deg.astype(np.int64) * 4])
    values = np.concatenate(
        [stats.node_counts.astype(np.float64), node_totals.astype(np.float64)]
    )
    density = values / np.maximum(sizes, 1)
    order = np.argsort(-density, kind="stable")  # global O(n log n) sort
    csum = np.cumsum(sizes[order])
    chosen = order[csum <= total_cache_bytes]
    feat_nodes = chosen[chosen < n]
    adj_nodes = chosen[chosen >= n] - n

    feat_bytes = int(len(feat_nodes) * row_bytes)
    adj_bytes = int(deg[adj_nodes].sum() * 4)
    alloc = CacheAllocation(
        total_bytes=total_cache_bytes,
        adj_bytes=adj_bytes,
        feat_bytes=min(feat_bytes, total_cache_bytes - adj_bytes),
        sample_fraction=float(adj_bytes) / max(total_cache_bytes, 1),
    )
    node_counts_sel = np.zeros(n, np.int64)
    node_counts_sel[feat_nodes] = stats.node_counts[feat_nodes].astype(np.int64) + 1
    return DualCache.build(
        dataset,
        node_counts=node_counts_sel,
        edge_counts=stats.edge_counts.copy(),
        allocation=alloc,
        device=device,
    )


def _minhash_signatures(batches: np.ndarray, num_hashes: int, seed: int) -> np.ndarray:
    """MinHash signature per batch over its seed set (RAIN's LSH front end)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 2**31 - 1, num_hashes, dtype=np.int64)
    b = rng.integers(0, 2**31 - 1, num_hashes, dtype=np.int64)
    p = np.int64(2**31 - 1)
    # batches: [num_batches, batch_size] node ids
    h = (batches[:, None, :] * a[None, :, None] + b[None, :, None]) % p
    return h.min(axis=2)  # [num_batches, num_hashes]


def prepare_rain(
    dataset: SyntheticGraphDataset,
    *,
    batch_size: int,
    num_hashes: int = 32,
    bands: int = 8,
    seed: int = 0,
    device: torch.device | str | None = None,
    **_kw,
) -> PreparedPipeline:
    """RAIN: LSH-cluster similar batches, run them adjacently, reuse features.

    No device cache is built (the budget is ignored); the win comes from
    cross-batch reuse.  The preprocessing cost is the signature + banding
    pass over *every* test batch — O(#batches · batch_size · num_hashes),
    the linear-but-heavy term of Table IV."""
    t0 = time.perf_counter()
    test = dataset.test_idx
    nb = max(len(test) // batch_size, 1)
    if len(test) < nb * batch_size:  # tiny datasets: cycle to fill one batch
        test = np.tile(test, -(-nb * batch_size // max(len(test), 1)))
    trimmed = test[: nb * batch_size].reshape(nb, batch_size).astype(np.int64)
    sig = _minhash_signatures(trimmed, num_hashes, seed)
    # Band the signatures; batches sharing any band bucket are "similar".
    per_band = num_hashes // bands
    buckets: dict[tuple, list[int]] = {}
    for i in range(nb):
        for band in range(bands):
            k = (band, *sig[i, band * per_band : (band + 1) * per_band].tolist())
            buckets.setdefault(k, []).append(i)
    # Greedy cluster ordering: walk buckets, emit unseen members together.
    order: list[int] = []
    seen = np.zeros(nb, bool)
    for members in buckets.values():
        for m in members:
            if not seen[m]:
                seen[m] = True
                order.append(m)
    caches = DualCache.none(dataset, device=device)
    return PreparedPipeline(
        name="rain",
        caches=caches,
        prep_seconds=time.perf_counter() - t0,
        batch_order=np.asarray(order, np.int64),
        reuse_prev_batch=True,
    )


POLICIES = {
    "dci": prepare_dci,
    "sci": prepare_sci,
    "aci": prepare_aci,
    "dgl": prepare_dgl,
    "ducati": prepare_ducati,
    "rain": prepare_rain,
}


# ------------------------------------------------------- admission policies
#
# Cache policies above decide WHAT to keep on device; admission policies
# decide WHICH queued request the serving front-end
# (runtime/request_queue.py) dispatches next.  They are pure ordering
# logic over duck-typed requests (``arrival_s``, optional ``deadline_s``,
# and ``admission_deadline_s`` — the deadline as admission should see it,
# None for a deferred/blown request): the server applies the mechanical
# parts — in-flight caps, the progress fallback, and the round-robin
# cursor — so a policy here never touches runtime state and stays
# property-testable in isolation (tests/test_torch_request_queue.py).


class AdmissionPolicy:
    """Order the admissible requests of one serving step.

    ``order(candidates, now)`` receives ``(stream_key, head_request)``
    pairs — one per stream whose head request has arrived by ``now`` —
    and returns them in service-preference order (most urgent first), or
    ``None`` to defer to the server's own round-robin cursor.  ``sheds``
    marks policies that drop (or defer) requests whose deadline has
    already passed before selecting."""

    name = "fifo"
    sheds = False

    def order(self, candidates, now):
        del now
        return sorted(candidates, key=lambda c: (c[1].arrival_s, c[0]))


class RoundRobinAdmission(AdmissionPolicy):
    """The bit-for-bit baseline: defer entirely to the server's
    round-robin cursor (returning ``None``), so a request-queue serve
    with zero arrival offsets reproduces ``MultiStreamServer``'s
    admission log — and outputs — exactly."""

    name = "round-robin"

    def order(self, candidates, now):
        del candidates, now
        return None


class EDFAdmission(AdmissionPolicy):
    """Earliest-deadline-first.

    Deadline-free requests sort last (a deadline is a promise; absence of
    one is best-effort), ties break by arrival then stream key, so the
    order is total and deterministic.  For a single machine serving
    sequential batches EDF minimizes maximum lateness (Jackson's rule) —
    under a burst this approximates global FCFS over the backlog, which
    is what beats round-robin's interleaving on p99."""

    name = "edf"

    def order(self, candidates, now):
        del now
        inf = float("inf")

        def key(c):
            stream_key, req = c
            dl = getattr(req, "admission_deadline_s", req.deadline_s)
            return (inf if dl is None else dl, req.arrival_s, stream_key)

        return sorted(candidates, key=key)


class SLOAdmission(EDFAdmission):
    """EDF plus SLO enforcement at admission time.

    Before selecting, the server drops every arrived request whose
    deadline has already passed (``blown="shed"`` — the request never
    runs and is accounted as shed) or demotes it to best-effort
    (``blown="defer"`` — it keeps its batch but sorts after every
    deadline-carrying request, via ``admission_deadline_s = None``).
    Either way a blown request can no longer delay ones that can still
    meet their deadlines."""

    name = "slo"
    sheds = True

    def __init__(self, blown: str = "shed"):
        if blown not in ("shed", "defer"):
            raise ValueError(f"blown must be 'shed' or 'defer', got {blown!r}")
        self.blown = blown


ADMISSION_POLICIES = {
    "round-robin": RoundRobinAdmission,
    "edf": EDFAdmission,
    "slo": SLOAdmission,
}


def prepare(policy: str, dataset: SyntheticGraphDataset, **kw) -> PreparedPipeline:
    """Dispatch to a policy's ``prepare_*`` on ``device`` (CUDA unless
    ``device="cpu"``).

    Execution knobs (``prefetch``, ``use_kernel``, ``dedup``) are
    policy-independent: they are recorded on the returned pipeline as the
    defaults every run resolves against (``EngineConfig.resolved``),
    without changing what gets cached."""
    if policy not in POLICIES:
        raise KeyError(f"unknown policy {policy!r}; have {sorted(POLICIES)}")
    if kw.get("pipeline_depth") == "auto":
        # "auto" sizes the RUN-time executor window; presampling stays
        # serial (Eq. 1's stage-time ratio assumes synchronized stages).
        kw["pipeline_depth"] = 1
    exec_kw = {
        "prefetch": bool(kw.pop("prefetch", False)),
        "use_kernel": bool(kw.pop("use_kernel", False)),
        "dedup": bool(kw.pop("dedup", False)),
    }
    fn = POLICIES[policy]
    if policy == "dgl":
        pipe = fn(dataset, device=kw.get("device"))
    elif policy == "rain":  # builds no cache: the budget and presampling do not apply
        pipe = fn(
            dataset,
            batch_size=kw["batch_size"],
            seed=kw.get("seed", 0),
            device=kw.get("device"),
        )
    else:
        pipe = fn(dataset, **kw)
    return dataclasses.replace(pipe, **exec_kw)
