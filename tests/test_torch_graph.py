"""The port's graph layer against the JAX reference, exactly.

Datasets, the two-level sort and the adjacency cache, the sampler (given
the reference's slot draws, recovered as ``edge_slots - col_ptr[frontier]``),
dedup, visit counting, the hot-row fill and ``DualCache.build`` — all of it
is integer bookkeeping or pure copies, so every comparison is bit-exact.
Arrays cross between the packages as numpy arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.allocation import CacheAllocation as JaxCacheAllocation
from repro.core.cache import DualCache as JaxDualCache
from repro.core.presample import run_presampling as jax_run_presampling
from repro.graph import csc as jcsc
from repro.graph import datasets as jdatasets
from repro.graph import features as jfeatures
from repro.graph import sampling as jsampling
from repro_torch.core.allocation import CacheAllocation
from repro_torch.core.cache import DualCache
from repro_torch.graph import csc as tcsc
from repro_torch.graph import datasets as tdatasets
from repro_torch.graph import features as tfeatures
from repro_torch.graph import sampling as tsampling

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
FANOUTS = (3, 2)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recover_draws(jg, block) -> list[torch.Tensor]:
    """The reference's per-layer slot draws: r = edge_slots - col_ptr[frontier]."""
    col_ptr = np.asarray(jg.col_ptr)
    return [
        torch.from_numpy(np.asarray(slots) - col_ptr[np.asarray(block.frontiers[i])][:, None])
        for i, slots in enumerate(block.edge_slots)
    ]


def _port_graph(graph) -> tcsc.CSCGraph:
    return tcsc.CSCGraph(col_ptr=graph.col_ptr, row_index=graph.row_index)


@pytest.fixture(scope="module")
def both(small_dataset):
    """(reference dataset, port dataset) — same call, same process."""
    return small_dataset, tdatasets.load_dataset("ogbn-products", scale=0.002, seed=0)


@pytest.fixture(scope="module")
def cached_graphs(both):
    """Reference and port DeviceGraphs over one adjacency cache, filled
    from counts of a real presampling pass."""
    jds, tds = both
    jg0 = jsampling.device_graph(jds.graph)
    block = jsampling.sample_blocks(
        jax.random.PRNGKey(3), jg0, jnp.asarray(jds.test_idx[:64]), FANOUTS
    )
    _, edge_counts = jsampling.count_visits(jds.num_nodes, jds.graph.num_edges, [block])
    jsorted, jtot = jcsc.two_level_sort(jds.graph, edge_counts)
    jcache = jcsc.build_adj_cache(jds.graph, jsorted, jtot, 4 * 3000)
    tsorted, ttot = tcsc.two_level_sort(tds.graph, edge_counts)
    tcache = tcsc.build_adj_cache(tds.graph, tsorted, ttot, 4 * 3000)
    jg = jsampling.device_graph(jds.graph, sorted_row_index=jsorted, adj_cache=jcache)
    tg = tsampling.device_graph(tds.graph, device=CPU, sorted_row_index=tsorted, adj_cache=tcache)
    return jg, tg


@pytest.mark.parametrize(
    "name,scale,seed", [("ogbn-products", 0.002, 0), ("reddit", 0.001, 1), ("yelp", 0.0005, 2)]
)
def test_datasets_equal(name, scale, seed):
    j = jdatasets.load_dataset(name, scale=scale, seed=seed)
    t = tdatasets.load_dataset(name, scale=scale, seed=seed)
    for field in ("features", "labels", "train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    np.testing.assert_array_equal(t.graph.col_ptr, j.graph.col_ptr)
    np.testing.assert_array_equal(t.graph.row_index, j.graph.row_index)
    assert t.spec == tdatasets.DATASETS[name] and t.feature_nbytes_per_row() == j.feature_nbytes_per_row()


@pytest.mark.parametrize("capacity", [0, 4 * 500, 4 * 5000, 10**9])
def test_two_level_sort_and_adj_cache_equal(both, capacity):
    jds, tds = both
    counts = np.random.default_rng(capacity).integers(0, 9, jds.graph.num_edges)
    jsorted, jtot = jcsc.two_level_sort(jds.graph, counts)
    tsorted, ttot = tcsc.two_level_sort(tds.graph, counts)
    np.testing.assert_array_equal(tsorted, jsorted)
    np.testing.assert_array_equal(ttot, jtot)
    jc = jcsc.build_adj_cache(jds.graph, jsorted, jtot, capacity)
    tc = tcsc.build_adj_cache(tds.graph, tsorted, ttot, capacity)
    for field in ("cache_ptr", "cache_row_index", "cached_len"):
        np.testing.assert_array_equal(getattr(tc, field), getattr(jc, field))


@pytest.mark.parametrize("fanout", [1, 4])
@pytest.mark.parametrize("cached", [False, True])
def test_sample_neighbors_equal_given_draws(both, cached_graphs, fanout, cached):
    jds, tds = both
    jg, tg = cached_graphs if cached else (
        jsampling.device_graph(jds.graph), tsampling.device_graph(tds.graph, device=CPU)
    )
    # Test seeds plus nodes that always miss (no cached prefix) and nodes
    # that always hit (whole list cached), whatever graph the hash seed gave.
    deg, clen = np.diff(np.asarray(jg.col_ptr)), np.asarray(jg.cached_len)
    seeds = np.concatenate([
        jds.test_idx[:96],
        np.flatnonzero((deg > 0) & (clen == 0))[:8],
        np.flatnonzero((deg > 0) & (clen >= deg))[:8],
    ]).astype(np.int32)
    jn, jh, js = jsampling.sample_neighbors(jax.random.PRNGKey(fanout), jg, jnp.asarray(seeds), fanout)
    r = np.asarray(js) - np.asarray(jg.col_ptr)[seeds][:, None]
    tn, th, ts = tsampling.sample_neighbors(tg, torch.from_numpy(seeds), fanout, r=torch.from_numpy(r))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    if cached:
        assert _np(th).any() and not _np(th).all()


def test_sample_blocks_needs_one_draw_tensor_per_layer(both):
    _, tds = both
    tg = tsampling.device_graph(tds.graph, device=CPU)
    seeds = torch.from_numpy(tds.test_idx[:8])
    with pytest.raises(ValueError):
        tsampling.sample_blocks(tg, seeds, FANOUTS, draws=[torch.zeros((8, 2), dtype=torch.int32)])


@pytest.mark.parametrize("dedup", [False, True])
def test_sample_blocks_equal_given_draws(both, cached_graphs, dedup):
    jds, _ = both
    jg, tg = cached_graphs
    seeds = jds.test_idx[:64]
    pad = int(np.asarray(jds.test_idx)[5])
    jb = jsampling.sample_blocks(
        jax.random.PRNGKey(11), jg, jnp.asarray(seeds), FANOUTS, dedup=dedup,
        dedup_pad_id=pad if dedup else None,
    )
    tb = tsampling.sample_blocks(
        tg, torch.from_numpy(seeds), FANOUTS, draws=_recover_draws(jg, jb), dedup=dedup,
        dedup_pad_id=pad if dedup else None,
    )
    for name in ("frontiers", "neighbor_hits", "edge_slots"):
        for a, b in zip(getattr(tb, name), getattr(jb, name)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    jh, jt = jb.adj_hit_stats()
    th, tt = tb.adj_hit_stats()
    assert int(th) == int(jh) and tt == int(jt)
    if dedup:
        np.testing.assert_array_equal(_np(tb.dedup.unique_ids), np.asarray(jb.dedup.unique_ids))
        np.testing.assert_array_equal(_np(tb.dedup.inverse), np.asarray(jb.dedup.inverse))
        assert int(tb.dedup.num_unique) == int(jb.dedup.num_unique)
    else:
        assert tb.dedup is None


def test_sample_blocks_generator_draws_are_valid(both):
    """Without draws the port samples from its generator: every neighbor
    is a real in-neighbor (or the seed itself for isolated nodes)."""
    _, tds = both
    tg = tsampling.device_graph(tds.graph, device=CPU)
    seeds = tds.test_idx[:40]
    gen = torch.Generator().manual_seed(0)
    nbr, hit, slots = tsampling.sample_neighbors(tg, torch.from_numpy(seeds), 7, generator=gen)
    col_ptr = tds.graph.col_ptr
    for i, v in enumerate(seeds):
        lo, hi = col_ptr[v], col_ptr[v + 1]
        assert ((_np(slots)[i] >= lo) & (_np(slots)[i] < max(hi, lo + 1))).all()
        assert set(_np(nbr)[i].tolist()) <= set(tds.graph.row_index[lo:hi].tolist())
    with pytest.raises(ValueError):
        tsampling.sample_neighbors(tg, torch.from_numpy(seeds), 2)


@pytest.mark.parametrize("pad_id", [None, -1, 0, 17])
def test_dedup_frontier_equal(pad_id):
    ids = np.random.default_rng(4).integers(0, 40, 200).astype(np.int32)
    j = jsampling.dedup_frontier(jnp.asarray(ids), pad_id)
    t = tsampling.dedup_frontier(torch.from_numpy(ids), pad_id)
    np.testing.assert_array_equal(_np(t.unique_ids), np.asarray(j.unique_ids))
    np.testing.assert_array_equal(_np(t.inverse), np.asarray(j.inverse))
    assert int(t.num_unique) == int(j.num_unique)
    np.testing.assert_array_equal(_np(t.unique_ids)[_np(t.inverse)], ids)


def test_pow2_bucket_equal():
    for n in (0, 1, 2, 3, 5, 64, 65, 1000):
        for cap in (None, 7, 512):
            assert tsampling.pow2_bucket(n, cap) == jsampling.pow2_bucket(n, cap)


def test_count_visits_equal_with_trailing_isolated_node():
    """A middle and a trailing zero-degree node: the middle one's slot is
    the next node's first edge (counted), the trailing one's slot is E
    (dropped by the reference's scatter, dropped by the port)."""
    col_ptr = np.array([0, 2, 2, 5, 6, 6], np.int64)  # nodes 1 and 4 isolated
    row_index = np.array([1, 3, 0, 2, 4, 0], np.int32)
    jgraph = jcsc.CSCGraph(col_ptr=col_ptr, row_index=row_index)
    jg = jsampling.device_graph(jgraph)
    tg = tsampling.device_graph(_port_graph(jgraph), device=CPU)
    seeds = np.array([0, 1, 2, 3, 4, 4, 1], np.int32)
    jb = jsampling.sample_blocks(jax.random.PRNGKey(5), jg, jnp.asarray(seeds), (2, 3))
    tb = tsampling.sample_blocks(tg, torch.from_numpy(seeds), (2, 3), draws=_recover_draws(jg, jb))
    assert (np.asarray(jb.edge_slots[0]) == 6).any()  # the trailing node's slot is E
    jn, je = jsampling.count_visits(5, 6, [jb, jb])
    tn, te = tsampling.count_visits(5, 6, [tb, tb])
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(te, je)
    for a, b in zip(tb.frontiers, jb.frontiers):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


@pytest.mark.parametrize("budget", [0, 3, 50, 10**6])
def test_select_hot_rows_and_feature_cache_equal(both, budget):
    jds, tds = both
    counts = np.random.default_rng(budget).poisson(0.7, jds.num_nodes).astype(np.int32)
    np.testing.assert_array_equal(
        tfeatures.select_hot_rows(counts, budget), jfeatures.select_hot_rows(counts, budget)
    )
    cap = budget * tds.feature_nbytes_per_row()
    js = jfeatures.build_feature_cache(jds.features, counts, cap)
    ts = tfeatures.build_feature_cache(tds.features, counts, cap, device=CPU)
    np.testing.assert_array_equal(_np(ts.position_map), np.asarray(js.position_map))
    np.testing.assert_array_equal(_np(ts.hot_table), np.asarray(js.hot_table))
    assert ts.pad_node_id() == js.pad_node_id() and ts.num_cached == js.num_cached
    np.testing.assert_array_equal(ts.host_np(), js.host_np())
    np.testing.assert_array_equal(ts.position_np(), js.position_np())


@pytest.mark.parametrize("use_kernel,row_block", [(False, None), (True, None), (True, 8)])
def test_feature_store_gather_equal(both, use_kernel, row_block):
    jds, tds = both
    counts = np.random.default_rng(1).poisson(1.0, jds.num_nodes).astype(np.int32)
    js = jfeatures.build_feature_cache(jds.features, counts, 200_000)
    ts = tfeatures.build_feature_cache(tds.features, counts, 200_000, device=CPU)
    ids = np.random.default_rng(2).integers(0, jds.num_nodes, 300).astype(np.int32)
    jf, jh = js.gather(jnp.asarray(ids))
    tf, th = ts.gather(torch.from_numpy(ids), use_kernel=use_kernel, row_block=row_block)
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    jc, jch = js.gather_cache_only(jnp.asarray(ids))
    tc, tch = ts.gather_cache_only(torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tch), np.asarray(jch))
    plain = tfeatures.plain_feature_store(tds.features, device=CPU)
    pf, ph = plain.gather(torch.from_numpy(ids), use_kernel=use_kernel, row_block=row_block)
    np.testing.assert_array_equal(_np(pf), tds.features[ids])
    assert not _np(ph).any() and plain.pad_node_id() == -1


@pytest.mark.parametrize("use_kernel,row_block", [(False, None), (True, None), (True, 8)])
def test_gather_clamps_ids_past_the_last_node_like_the_reference(use_kernel, row_block):
    """An id >= N reads node N - 1 (its hit flag and its row) on every
    route and in ``gather_cache_only``, as the reference's JAX gather
    clamps it; a negative id keeps wrapping."""
    n, f = 50, 8
    feats = np.random.default_rng(7).standard_normal((n, f)).astype(np.float32)
    counts = np.arange(n)
    js = jfeatures.build_feature_cache(feats, counts, 320)
    ts = tfeatures.build_feature_cache(feats, counts, 320, device=CPU)
    ids = np.array([50, 55, 3], np.int32)
    jf, jh = js.gather(jnp.asarray(ids))
    tf, th = ts.gather(torch.from_numpy(ids), use_kernel=use_kernel, row_block=row_block)
    np.testing.assert_array_equal(np.asarray(jh), [True, True, False])
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    np.testing.assert_array_equal(_np(tf), np.asarray(jf))
    np.testing.assert_array_equal(_np(tf), feats[[49, 49, 3]])
    jc, jch = js.gather_cache_only(jnp.asarray(ids))
    tc, tch = ts.gather_cache_only(torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tch), np.asarray(jch))
    neg = np.array([-1, -45], np.int32)  # hit flags of nodes 49 and 5
    np.testing.assert_array_equal(_np(ts.gather(torch.from_numpy(neg), use_kernel=use_kernel,
                                                row_block=row_block)[1]),
                                  np.asarray(js.gather(jnp.asarray(neg))[1]))


@pytest.mark.parametrize("num_live", [None, 150])
@pytest.mark.parametrize("use_kernel,row_block", [(False, None), (True, None), (True, 8)])
def test_prefetch_misses_and_prefetched_gather_equal(both, use_kernel, row_block, num_live):
    """The staged pack (rows, batch positions, inverse map, miss count)
    equals the reference's, and a gather that reads misses from it gives
    the reference's rows and hit mask on every route — with a cache, and
    all-miss without one."""
    jds, tds = both
    counts = np.random.default_rng(1).poisson(1.0, jds.num_nodes).astype(np.int32)
    ids = np.random.default_rng(3).integers(0, jds.num_nodes, 300).astype(np.int32)
    stores = [
        (jfeatures.build_feature_cache(jds.features, counts, 200_000),
         tfeatures.build_feature_cache(tds.features, counts, 200_000, device=CPU)),
        (jfeatures.build_feature_cache(jds.features, counts, 0),
         tfeatures.plain_feature_store(tds.features, device=CPU)),
    ]
    for js, ts in stores:
        jp = js.prefetch_misses(ids, num_live=num_live)
        for nodes in (torch.from_numpy(ids), ids):
            tp = ts.prefetch_misses(nodes, num_live=num_live)
            assert tp.num_miss == jp.num_miss > 0 and tp.ready is None
            np.testing.assert_array_equal(_np(tp.rows), np.asarray(jp.rows))
            for field in ("idx", "pack_pos"):
                want = getattr(jp, field)
                got = getattr(tp, field)
                assert (got is None) == (want is None)
                if want is not None:
                    np.testing.assert_array_equal(_np(got), np.asarray(want))
        jf, jh = js.gather(jnp.asarray(ids), prefetched=jp)
        tf, th = ts.gather(torch.from_numpy(ids), use_kernel=use_kernel, row_block=row_block,
                           prefetched=tp)
        live = slice(None, num_live)
        np.testing.assert_array_equal(_np(tf)[live], np.asarray(jf)[live])
        np.testing.assert_array_equal(_np(tf)[live], tds.features[ids][live])
        np.testing.assert_array_equal(_np(th), np.asarray(jh))
    with pytest.raises(NotImplementedError, match="fault injection"):
        ts.prefetch_misses(ids, injector=object())


def test_presample_counts_equal_across_gather_routes(both, monkeypatch):
    """Presampling's kernel route (the one it takes on a card) and table
    route count the same visits: gathers are copies, so only the timed
    feature stage depends on the route."""
    from repro_torch.core.presample import run_presampling
    from repro_torch.graph.features import FeatureStore

    _, tds = both
    kw = dict(fanouts=FANOUTS, batch_size=64, n_batches=2, seed=5, device=CPU)
    gather, routes = FeatureStore.gather, []

    def run(force):
        def routed(self, indices, *, use_kernel=False, **gkw):
            routes.append(use_kernel)
            return gather(self, indices, use_kernel=use_kernel if force is None else force, **gkw)

        routes.clear()
        monkeypatch.setattr(FeatureStore, "gather", routed)
        return run_presampling(tds, **kw)

    default = run(None)
    assert routes and not any(routes)  # on the CPU presampling takes the table route
    table, kernel = run(False), run(True)
    for stats in (kernel, default):
        np.testing.assert_array_equal(stats.node_counts, table.node_counts)
        np.testing.assert_array_equal(stats.edge_counts, table.edge_counts)
        assert (stats.peak_workload_bytes, stats.n_batches) == (table.peak_workload_bytes, 2)
        assert len(stats.sample_times) == len(stats.feature_times) == 2
    assert table.node_counts.sum() > 0 and table.edge_counts.sum() > 0


def test_dual_cache_build_equal_from_reference_stats(both):
    """The reference's PresampleStats and CacheAllocation fill the port's
    caches byte for byte."""
    jds, tds = both
    stats = jax_run_presampling(jds, fanouts=FANOUTS, batch_size=64, n_batches=2, seed=0)
    jalloc = JaxCacheAllocation(total_bytes=150_000, adj_bytes=50_000, feat_bytes=100_000,
                                sample_fraction=1 / 3)
    jc = JaxDualCache.build(jds, node_counts=stats.node_counts, edge_counts=stats.edge_counts,
                            allocation=jalloc)
    tc = DualCache.build(
        tds, node_counts=stats.node_counts, edge_counts=stats.edge_counts,
        allocation=CacheAllocation(**dataclasses.asdict(jalloc)), device="cpu",
    )
    for field in ("col_ptr", "row_index", "cache_ptr", "cache_row_index", "cached_len"):
        np.testing.assert_array_equal(_np(getattr(tc.dgraph, field)),
                                      np.asarray(getattr(jc.dgraph, field)))
    for field in ("host_table", "hot_table", "position_map"):
        np.testing.assert_array_equal(_np(getattr(tc.store, field)),
                                      np.asarray(getattr(jc.store, field)))
    assert tc.adj_cached_elements == jc.adj_cached_elements > 0
    assert tc.feat_cached_rows == jc.feat_cached_rows > 0
    none = DualCache.none(tds, device="cpu")
    assert none.allocation is None and none.feat_cached_rows == 0
