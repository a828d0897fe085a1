"""The plain reference (bench/reference.py) and the comparison that decides
``correct`` (bench/check.py), on the CPU at a small size."""

import numpy as np
import pytest
import torch

from bench import reference as ref
from bench.check import LIMITS
from bench.data import make_graph
from bench.harness import cell_spec, run_cell
from repro_torch.core.allocation import allocate_capacity
from repro_torch.graph.csc import CSCGraph, _prefix_lengths, node_visit_totals, two_level_sort
from repro_torch.graph.features import FeatureStore, select_hot_rows

PRODUCTS = "sage-products.offline4096"


@pytest.fixture(scope="module")
def graph():
    return make_graph(cell_spec(PRODUCTS)[2]["dataset"], 3, device="cpu", scale=0.002)


@pytest.fixture(scope="module")
def counts(graph):
    rng = np.random.default_rng(0)
    # Many ties, as presampling's small counts have.
    return rng.integers(0, 3, graph.num_edges), rng.integers(0, 4, graph.num_nodes)


def test_two_level_order_is_the_ports(graph, counts):
    csc = CSCGraph(col_ptr=graph.col_ptr, row_index=graph.row_index)
    rows, totals = two_level_sort(csc, counts[0])
    col_ptr = torch.as_tensor(graph.col_ptr)
    edge_counts = torch.as_tensor(counts[0])
    got = ref.two_level_rows(col_ptr, torch.as_tensor(graph.row_index), edge_counts)
    np.testing.assert_array_equal(got.numpy(), rows)
    np.testing.assert_array_equal(ref.node_totals(col_ptr, edge_counts).numpy(), totals)


@pytest.mark.parametrize("capacity", [0, 4096, 40_000, 10**9])
def test_alg1_prefix_lengths_are_the_ports(graph, counts, capacity):
    csc = CSCGraph(col_ptr=graph.col_ptr, row_index=graph.row_index)
    totals = node_visit_totals(csc, counts[0])
    deg = torch.as_tensor(np.diff(graph.col_ptr))
    got = ref.adj_prefix_lengths(deg, torch.as_tensor(totals), capacity)
    np.testing.assert_array_equal(got.numpy(), _prefix_lengths(csc, totals, capacity))


@pytest.mark.parametrize("budget", [0, 5, 300, 2000, 10**6])
def test_hot_rows_are_the_ports(counts, budget):
    got = ref.hot_rows(torch.as_tensor(counts[1]), budget)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(select_hot_rows(counts[1], budget)))


@pytest.mark.parametrize("laps", [([0.1, 0.2], [0.3, 0.9]), ([0.0], [0.0]), ([5.0], [0.01])])
def test_eq1_split_is_the_ports(laps):
    for need in (10**9, 1000):
        alloc = allocate_capacity(*laps, 256_000, adj_need_bytes=need, feat_need_bytes=200_000)
        assert ref.eq1_split(*laps, 256_000, adj_need=need, feat_need=200_000) == (
            alloc.adj_bytes, alloc.feat_bytes
        )


@pytest.mark.parametrize("cell", [PRODUCTS, "gcn-reddit.offline4096", "sage-products.layerwise"])
def test_program_matches_the_reference(cell, small):
    result = run_cell(cell, 2**31 + 5, 0.3, False, device="cpu", overrides=small,
                      log=lambda msg: None)
    checks = result["checks"]
    assert result["correct"], checks
    assert checks["logit_gap"]["value"] < LIMITS["logit_gap"] / 10
    assert checks.get("count_gap", {"value": 0})["value"] == 0
    assert result["attempted"] > 0 and result["failed"] == 0


def test_served_program_matches_the_reference(served):
    result = run_cell("sage-products.poisson", 2**31 + 6, 0.5, False, device="cpu",
                      overrides=served, log=lambda msg: None)
    assert result["correct"], result["checks"]
    assert result["checks"]["count_gap"]["value"] == 0
    assert result["attempted"] >= 16 and result["failed"] == 0


def test_a_bfloat16_feature_table_fails(monkeypatch, small):
    """The control: the program's features rounded through bfloat16, the
    next precision below float32 that a CPU has, fails the comparison
    while every count still matches."""
    gather = FeatureStore.gather

    def bf16_gather(self, indices, **kw):
        feats, hit = gather(self, indices, **kw)
        return feats.to(torch.bfloat16).to(feats.dtype), hit

    monkeypatch.setattr(FeatureStore, "gather", bf16_gather)
    result = run_cell(PRODUCTS, 2**31 + 7, 0.3, False, device="cpu", overrides=small,
                      log=lambda msg: None)
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > 3 * LIMITS["logit_gap"]
    assert result["checks"]["count_gap"]["value"] == 0
