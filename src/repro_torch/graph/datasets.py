"""Synthetic power-law graph datasets calibrated to the paper's Table II.

The paper evaluates on Reddit / Yelp / Amazon / Ogbn-products /
Ogbn-papers100M.  Those datasets are not shippable in this container, so we
generate *statistically matched* stand-ins: same average degree, feature
width, class count and train/val/test split, power-law in-degree and
popularity (the property DCI's long-tail argument rests on), scaled down by
a configurable node-count factor.  Generation is deterministic per seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.csc import CSCGraph

__all__ = ["DatasetSpec", "SyntheticGraphDataset", "DATASETS", "load_dataset"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int  # full-size node count (Table II)
    avg_degree: float
    feat_dim: int
    num_classes: int
    split: tuple[float, float, float]  # train/val/test fractions
    pareto_alpha: float = 1.3  # in-degree tail heaviness
    popularity_gamma: float = 0.9  # zipf exponent for endpoint popularity


# Table II of the paper.
DATASETS: dict[str, DatasetSpec] = {
    "reddit": DatasetSpec("reddit", 232_965, 50.0, 602, 41, (0.66, 0.10, 0.24)),
    "yelp": DatasetSpec("yelp", 716_480, 10.0, 300, 100, (0.75, 0.10, 0.15)),
    "amazon": DatasetSpec("amazon", 1_598_960, 83.0, 200, 107, (0.85, 0.05, 0.10)),
    "ogbn-products": DatasetSpec("ogbn-products", 2_449_029, 25.0, 100, 47, (0.08, 0.02, 0.90)),
    "ogbn-papers100m": DatasetSpec(
        "ogbn-papers100m", 111_059_956, 29.1, 128, 172, (0.78, 0.08, 0.14)
    ),
}


@dataclasses.dataclass(frozen=True)
class SyntheticGraphDataset:
    spec: DatasetSpec
    graph: CSCGraph
    features: np.ndarray  # float32[N, F]
    labels: np.ndarray  # int32[N]
    train_idx: np.ndarray
    val_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    def feature_nbytes_per_row(self) -> int:
        return self.features.shape[1] * self.features.dtype.itemsize


def _power_law_degrees(rng: np.random.Generator, n: int, avg: float, alpha: float) -> np.ndarray:
    raw = rng.pareto(alpha, n) + 1.0
    deg = raw * (avg / raw.mean())
    return np.clip(np.round(deg), 1, max(2, n - 1)).astype(np.int64)


def load_dataset(
    name: str,
    *,
    scale: float = 0.01,
    seed: int = 0,
    max_nodes: int | None = None,
) -> SyntheticGraphDataset:
    """Build the scaled synthetic stand-in for dataset ``name``.

    ``scale`` multiplies the Table II node count (default 1% keeps CI
    fast); ``max_nodes`` caps it (papers100M at 1% would still be 1.1M).
    """
    spec = DATASETS[name]
    rng = np.random.default_rng(seed + hash(name) % (2**31))
    n = max(int(spec.num_nodes * scale), 64)
    if max_nodes is not None:
        n = min(n, max_nodes)

    deg = _power_law_degrees(rng, n, spec.avg_degree, spec.pareto_alpha)
    e = int(deg.sum())
    col_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=col_ptr[1:])

    # Endpoint popularity: zipf over a random permutation of node ids, so
    # "hot" nodes are spread across the id space (as in real graphs).
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pop = ranks ** (-spec.popularity_gamma)
    pop /= pop.sum()
    perm = rng.permutation(n)
    # Draw endpoints from the popularity distribution (with replacement;
    # multi-edges are possible and harmless for sampling workloads).
    draws = rng.choice(n, size=e, p=pop)
    row_index = perm[draws].astype(np.int32)

    graph = CSCGraph(col_ptr=col_ptr, row_index=row_index)

    features = rng.standard_normal((n, spec.feat_dim), dtype=np.float32)
    labels = rng.integers(0, spec.num_classes, n).astype(np.int32)

    order = rng.permutation(n)
    n_train = int(n * spec.split[0])
    n_val = int(n * spec.split[1])
    return SyntheticGraphDataset(
        spec=spec,
        graph=graph,
        features=features,
        labels=labels,
        train_idx=np.sort(order[:n_train]).astype(np.int32),
        val_idx=np.sort(order[n_train : n_train + n_val]).astype(np.int32),
        test_idx=np.sort(order[n_train + n_val :]).astype(np.int32),
    )
