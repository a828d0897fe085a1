"""The Table II stand-in graph, made on the device from a seed.

The same distributions as ``repro_torch.graph.datasets.load_dataset``, in
torch, so that the 61 M endpoints of ogbn-products are drawn on the card
in a few large calls instead of by ``np.random.Generator.choice`` on the
host:

  * in-degrees: Pareto with tail index ``pareto_alpha`` (numpy's
    ``pareto(a) + 1`` is ``U ** (-1 / a)``), scaled to the average degree,
    rounded and clipped to ``[1, n - 1]``.  They are *stratified*: the
    distribution's quantiles at ``(i + 1/2) / n``, handed to the nodes in
    an order drawn from the seed, so every seed has the same degree
    multiset and the same edge total, and only which node has which
    degree changes;
  * endpoints: Zipf popularity with exponent ``popularity_gamma`` over a
    random permutation of the node ids (the hot nodes spread over the id
    space), drawn with replacement by inverse transform;
  * features: standard normal float32; labels uniform over the classes;
  * the train / validation / test split of Table II over a random
    permutation, each part in ascending id order.

Nothing here imports the program: the reference and the port both read
the arrays this module makes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["GraphData", "make_graph", "sub_seed"]


def sub_seed(seed: int, k: int) -> int:
    """A seed for stream ``k`` of a run seeded ``seed`` (any size of seed)."""
    return (int(seed) * 1_000_003 + 7919 * (k + 1)) % (2**63 - 1)


@dataclasses.dataclass(frozen=True)
class GraphData:
    """A CSC graph with features and a split, as host arrays."""

    col_ptr: np.ndarray  # int64[N+1]
    row_index: np.ndarray  # int32[E]
    features: np.ndarray  # float32[N, F]
    labels: np.ndarray  # int32[N]
    train_idx: np.ndarray  # int32, ascending
    val_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.col_ptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.row_index.shape[0]


def stratified_degrees(n: int, avg: float, alpha: float) -> torch.Tensor:
    """The Pareto in-degree quantiles at ``(i + 1/2) / n``, descending,
    scaled to mean ``avg``, rounded half to even and clipped as
    ``datasets._power_law_degrees`` clips its draws."""
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    raw = q ** (-1.0 / alpha)
    deg = raw * (avg / raw.mean())
    return deg.round().clamp(1, max(2, n - 1)).to(torch.int64)


def make_graph(dataset: dict, seed: int, *, device: torch.device | str, scale: float = 1.0) -> GraphData:
    """Build the stand-in for ``dataset`` (a configuration's ``dataset``
    entry) on ``device`` from ``seed``; ``scale`` multiplies the node count
    (1.0 is Table II's size)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    n = max(int(dataset["num_nodes"] * scale), 64)

    deg = stratified_degrees(n, dataset["avg_degree"], dataset["pareto_alpha"]).to(device)
    deg = deg[torch.randperm(n, generator=gen, device=device)]
    col_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=col_ptr[1:])
    e = int(col_ptr[-1])

    ranks = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** (-dataset["popularity_gamma"]), 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(n, generator=gen, device=device)
    u = torch.rand(e, generator=gen, dtype=torch.float64, device=device)
    draws = torch.searchsorted(cdf, u, right=True).clamp_max_(n - 1)
    del u
    row_index = perm[draws].to(torch.int32)
    del draws

    features = torch.randn(
        (n, dataset["feat_dim"]), generator=gen, dtype=torch.float32, device=device
    )
    labels = torch.randint(
        0, dataset["num_classes"], (n,), generator=gen, device=device, dtype=torch.int32
    )
    order = torch.randperm(n, generator=gen, device=device)
    n_train = int(n * dataset["split"][0])
    n_val = int(n * dataset["split"][1])

    def part(ids: torch.Tensor) -> np.ndarray:
        return torch.sort(ids).values.to(torch.int32).cpu().numpy()

    return GraphData(
        col_ptr=col_ptr.cpu().numpy(),
        row_index=row_index.cpu().numpy(),
        features=features.cpu().numpy(),
        labels=labels.cpu().numpy(),
        train_idx=part(order[:n_train]),
        val_idx=part(order[n_train : n_train + n_val]),
        test_idx=part(order[n_train + n_val :]),
    )
