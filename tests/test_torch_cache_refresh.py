"""The port's online cache refresh on the CPU (``repro_torch.core.telemetry``,
``DualCache.refresh``, ``repro_torch.runtime.cache_refresh`` and the
refresh paths of the engine and the servers), held to the JAX package.

  * against the reference — the same inputs give bit-identical telemetry
    windows, refresh deltas, adjacency arrays, hot-row sets, events
    (epoch, reason, window), per-epoch hit counts at depths 1 and 2 and
    decayed histories; logits within 1e-4.  Eq. 1 reads wall clocks, so
    both packages' ``reallocate_capacity`` is pinned to the identity, as
    the reference's own tests pin it, except where both managers are fed
    the same made-up laps; a serve-time join's presampling
    draws from each package's own RNG, so both take the same profile;
  * within the port — refresh on or off gives the same logits on every
    route, per-epoch counters partition the lifetime ones, and a refresh
    never writes into the previous epoch's tensors: a rolled-back one
    leaves the same objects holding the same bytes.
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from _torch_serving import (
    BATCH,
    FANOUTS,
    STREAM_SEEDS,
    assert_close_outputs,
    assert_same_outputs,
    port_dataset,
    port_engine,
    ref_pair,
    replay_draws,
    solo_engine,
)

import repro.runtime.cache_refresh as jcr
from repro.core import telemetry as jtelemetry
from repro.core.allocation import CacheAllocation as JaxAllocation
from repro.core.cache import DualCache as JaxDualCache
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.config import ServeConfig as JaxServeConfig
from repro.graph import csc as jcsc
from repro.graph import features as jfeatures
from repro.runtime.gnn_serve import MultiStreamServer as JaxServer
from repro.runtime.gnn_serve import make_stream_batches as jax_make_stream_batches
import repro_torch.runtime.cache_refresh as tcr
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.allocation import CacheAllocation
from repro_torch.core.cache import DualCache
from repro_torch.core.config import REFRESH_MODES, EngineConfig, ServeConfig
from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule, InjectedFault
from repro_torch.graph import csc as tcsc
from repro_torch.graph import features as tfeatures
from repro_torch.launch import infer_gnn
from repro_torch.runtime.cache_refresh import CacheRefreshManager, RefreshConfig
from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches
from repro_torch.utils.timing import StageClock

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset():
    return port_dataset()


@pytest.fixture()
def pinned_eq1(monkeypatch):
    """Eq. 1 at the identity in both packages (it reads wall clocks)."""
    for mod in (jcr, tcr):
        monkeypatch.setattr(mod, "reallocate_capacity", lambda alloc, *a, **k: alloc)


def _queues(dataset, n=3, batches=3, seed=7):
    return make_stream_batches(
        dataset, num_streams=n, batches_per_stream=batches, batch_size=BATCH, seed=seed
    )


def _alloc(a):
    return (a.total_bytes, a.adj_bytes, a.feat_bytes, a.sample_fraction)


def assert_same_caches(jc, tc):
    """A reference DualCache and a port one hold the same caches, bit for
    bit: epoch, allocation, adjacency arrays (padding included), position
    map, hot-table size and every cached row."""
    assert jc.epoch == tc.epoch
    assert _alloc(jc.allocation) == _alloc(tc.allocation)
    for name in ("cache_ptr", "cache_row_index", "cached_len"):
        np.testing.assert_array_equal(np.asarray(getattr(jc.dgraph, name)),
                                      getattr(tc.dgraph, name).numpy(), err_msg=name)
    pos = np.asarray(jc.store.position_map)
    np.testing.assert_array_equal(pos, tc.store.position_map.numpy())
    np.testing.assert_array_equal(pos, tc.store.position_np())
    assert jc.store.hot_table.shape == tuple(tc.store.hot_table.shape)
    cached = np.nonzero(pos >= 0)[0]
    np.testing.assert_array_equal(np.asarray(jc.store.hot_table)[pos[cached]],
                                  tc.store.hot_table.numpy()[pos[cached]])


def assert_same_events(jevents, tevents):
    assert len(jevents) == len(tevents)
    for je, te in zip(jevents, tevents):
        assert (te.epoch, te.reason, te.window_batches) == (je.epoch, je.reason, je.window_batches)
        assert te.window_miss_rate == je.window_miss_rate
        assert _alloc(te.delta.allocation) == _alloc(je.delta.allocation)
        assert dataclasses.asdict(te.delta.feat) == dataclasses.asdict(je.delta.feat)
        assert dataclasses.asdict(te.delta.adj) == dataclasses.asdict(je.delta.adj)
        assert set(te.pause_split) == {"telemetry", "eq1", "adj", "feat"}
        assert all(v >= 0 for v in te.pause_split.values())


def _snapshot(tc):
    """Every tensor of a port DualCache, with the objects that hold them."""
    objs = (tc.dgraph, tc.store, tc.allocation, tc._adj_cache, tc.epoch)
    tensors = [getattr(tc.dgraph, f.name) for f in dataclasses.fields(tc.dgraph)]
    tensors += [tc.store.host_table, tc.store.hot_table, tc.store.position_map]
    return objs, tensors, [t.clone() for t in tensors], tc.store.position_np().copy()


def _assert_unchanged(tc, snap):
    objs, tensors, clones, pos_np = snap
    assert (tc.dgraph, tc.store, tc.allocation, tc._adj_cache, tc.epoch) == objs
    assert all(a is b for a, b in zip((tc.dgraph, tc.store, tc.allocation, tc._adj_cache), objs))
    for t, c in zip(tensors, clones):
        assert torch.equal(t, c)
    np.testing.assert_array_equal(tc.store.position_np(), pos_np)


# ------------------------------------------------------------------ telemetry


def _observe(t, batches):
    for nodes, hit, slots, mult in batches:
        t.observe_batch(nodes, hit, slots, multiplicities=mult)


def test_telemetry_accumulates_and_windows_like_the_reference():
    batches = [
        (np.array([1, 2, 2, 5]), np.array([True, False, False, True]),
         [np.array([[0, 1]]), np.array([[5]])], None),
        (np.array([3, 9]), np.array([False, True]), [np.array([[2, 6]])], np.array([2, 1])),
    ]
    windows = []
    for mod in (jtelemetry, ttelemetry):
        t = mod.WorkloadTelemetry(num_nodes=10, num_edges=6)
        _observe(t, batches)
        assert t.batches == 2 and t.feat_lookups == 7 and t.feat_misses == 4
        windows.append(t.snapshot())
        t.reset()
        assert t.batches == 0 and t.node_counts.sum() == 0
        assert windows[-1].node_counts[2] == 2  # the snapshot is a copy
    jw, tw = windows
    for name in ("node_counts", "node_miss_counts", "edge_counts"):
        np.testing.assert_array_equal(getattr(tw, name), getattr(jw, name))
        assert getattr(tw, name).dtype == getattr(jw, name).dtype
    assert (tw.feat_lookups, tw.feat_misses, tw.miss_rate) == (
        jw.feat_lookups, jw.feat_misses, jw.miss_rate)
    # a trailing isolated node's slot == num_edges is dropped, not an error
    assert tw.edge_counts[5] == 1 and tw.edge_counts.sum() == 4


def test_telemetry_multiplicities_equal_the_per_visit_form():
    """The dedup path's form (unique nodes with visit counts) gives every
    counter the per-visit call gives."""
    rng = np.random.default_rng(0)
    nodes = rng.integers(0, 20, 60)
    hot = rng.random(20) < 0.5
    uids, inverse = np.unique(nodes, return_inverse=True)
    a = ttelemetry.WorkloadTelemetry(num_nodes=20, num_edges=4)
    b = ttelemetry.WorkloadTelemetry(num_nodes=20, num_edges=4)
    a.observe_batch(nodes, hot[nodes], [])
    b.observe_batch(uids, hot[uids], [], multiplicities=np.bincount(inverse))
    for name in ("node_counts", "node_miss_counts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.feat_lookups, a.feat_misses) == (b.feat_lookups, b.feat_misses)


def test_telemetry_pull_times_uses_cursors():
    t = ttelemetry.WorkloadTelemetry(num_nodes=4, num_edges=2)
    clock = StageClock(overlap=True)
    for _ in range(3):
        for name in ("sample", "feature", "compute"):
            with clock.stage(name):
                pass
    t.pull_times(clock)
    assert len(t.sample_times) == len(t.feature_times) == len(t.compute_times) == 3
    t.pull_times(clock)  # no new laps: nothing counted twice
    assert len(t.sample_times) == 3
    with clock.stage("sample"):
        pass
    t.pull_times(clock)
    assert len(t.sample_times) == 4
    t.reset()  # the window resets, the cursors persist
    t.pull_times(clock)
    assert len(t.sample_times) == 0


def test_merge_windows_matches_the_reference():
    def windows(mod):
        a = mod.WorkloadTelemetry(num_nodes=6, num_edges=4)
        b = mod.WorkloadTelemetry(num_nodes=6, num_edges=4)
        a.observe_batch(np.array([0, 1]), np.array([True, False]), [np.array([[0]])])
        b.observe_batch(np.array([1, 2]), np.array([False, True]), [np.array([[1]])])
        a.sample_times.append(0.5)
        b.sample_times.append(0.25)
        return a.snapshot(), b.snapshot()

    for weights in (None, [1.0, 3.0], [1.0, -5.0]):
        jm = jtelemetry.merge_windows(windows(jtelemetry), weights)
        tm = ttelemetry.merge_windows(windows(ttelemetry), weights)
        for name in ("node_counts", "node_miss_counts", "edge_counts"):
            np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
        assert (tm.sample_times, tm.batches) == (jm.sample_times, jm.batches)
    tm = ttelemetry.merge_windows(windows(ttelemetry), [1.0, 3.0])
    assert tm.node_counts[1] == 4.0 and tm.node_counts[0] == 1.0 and tm.edge_counts[1] == 3.0
    with pytest.raises(ValueError):
        ttelemetry.merge_windows([])
    with pytest.raises(ValueError):
        ttelemetry.merge_windows(list(windows(ttelemetry))[:1], [1.0, 2.0])


def test_telemetry_shard_slice_partitions_the_window():
    windows = []
    for mod in (jtelemetry, ttelemetry):
        t = mod.WorkloadTelemetry(num_nodes=10, num_edges=6)
        t.observe_batch(np.array([1, 2, 2, 7, 9]), np.array([True, False, False, True, False]),
                        [np.array([[0, 1]]), np.array([[5]])])
        windows.append(t.snapshot())
    jw, tw = windows
    for lo, hi in ((0, 4), (4, 7), (7, 10)):
        js, ts = jw.shard_slice(lo, hi), tw.shard_slice(lo, hi)
        np.testing.assert_array_equal(ts.node_counts, js.node_counts)
        np.testing.assert_array_equal(ts.node_miss_counts, js.node_miss_counts)
        np.testing.assert_array_equal(ts.edge_counts, tw.edge_counts)  # replicated
        assert ts.sample_times == tw.sample_times and ts.batches == tw.batches
    np.testing.assert_array_equal(
        np.concatenate([tw.shard_slice(lo, hi).node_counts for lo, hi in ((0, 4), (4, 10))]),
        tw.node_counts)


# ----------------------------------------------------------- the two re-fills


@pytest.mark.parametrize("start,after", [(10, 40), (40, 5), (20, 20)])
def test_feature_refresh_matches_the_reference(start, after):
    rng = np.random.default_rng(start)
    feats = rng.standard_normal((100, 4)).astype(np.float32)
    c0, c1 = rng.integers(0, 50, 100), rng.integers(0, 50, 100)
    js = jfeatures.build_feature_cache(feats, c0, start * 16)
    ts = tfeatures.build_feature_cache(feats, c0, start * 16, device=torch.device("cpu"))
    jn, jstats = jfeatures.refresh_feature_cache(js, c1, after * 16)
    tn, tstats = tfeatures.refresh_feature_cache(ts, c1, after * 16)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    pos = np.asarray(jn.position_map)
    np.testing.assert_array_equal(tn.position_map.numpy(), pos)
    assert tuple(tn.hot_table.shape) == jn.hot_table.shape
    cached = np.nonzero(pos >= 0)[0]
    np.testing.assert_array_equal(tn.hot_table.numpy()[pos[cached]], feats[cached])


def test_feature_refresh_same_counts_shares_the_tensors():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((100, 4)).astype(np.float32)
    counts = rng.integers(0, 50, 100)
    store = tfeatures.build_feature_cache(feats, counts, 20 * 16, device=torch.device("cpu"))
    refreshed, stats = tfeatures.refresh_feature_cache(store, counts, 20 * 16)
    assert not stats.changed
    assert refreshed.hot_table is store.hot_table  # nothing written, nothing copied
    assert refreshed.position_map is store.position_map


def test_adj_refresh_matches_the_reference(small_dataset, rng):
    g = port_dataset().graph
    ec0 = rng.integers(0, 9, g.num_edges).astype(np.int64)
    ec1 = rng.integers(0, 9, g.num_edges).astype(np.int64)
    out = []
    for csc, graph in ((jcsc, small_dataset.graph), (tcsc, g)):
        sorted_row, totals0 = csc.two_level_sort(graph, ec0)
        old = csc.build_adj_cache(graph, sorted_row, totals0, 4 * 1500)
        out.append(csc.refresh_adj_cache(graph, sorted_row, old, csc.node_visit_totals(graph, ec1),
                                         4 * 1500))
    (jn, jstats), (tn, tstats) = out
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    for name in ("cache_ptr", "cache_row_index", "cached_len"):
        np.testing.assert_array_equal(getattr(tn, name), getattr(jn, name))


# ------------------------------------------------------------ DualCache epochs


@pytest.mark.parametrize("adj,feat,adj2,feat2", [
    (50_000, 50_000, 30_000, 70_000),  # the hot table grows
    (20_000, 80_000, 60_000, 40_000),  # it shrinks
])
def test_dual_cache_refresh_matches_the_reference(small_dataset, adj, feat, adj2, feat2):
    ds = port_dataset()
    rng = np.random.default_rng(adj)
    nc0, ec0 = rng.integers(0, 9, ds.num_nodes), rng.integers(0, 9, ds.graph.num_edges)
    nc1, ec1 = rng.integers(0, 9, ds.num_nodes), rng.integers(0, 9, ds.graph.num_edges)
    alloc = (100_000, adj, feat, 0.5)
    new = (100_000, adj2, feat2, 0.5)
    jc = JaxDualCache.build(small_dataset, node_counts=nc0, edge_counts=ec0,
                            allocation=JaxAllocation(*alloc))
    tc = DualCache.build(ds, node_counts=nc0, edge_counts=ec0,
                         allocation=CacheAllocation(*alloc), device="cpu")
    assert tc.epoch == 0 and tc.refreshable
    assert_same_caches(jc, tc)
    jd = jc.refresh(allocation=JaxAllocation(*new), node_counts=nc1, edge_counts=ec1)
    td = tc.refresh(allocation=CacheAllocation(*new), node_counts=nc1, edge_counts=ec1)
    assert td.epoch == jd.epoch == tc.epoch == 1
    assert dataclasses.asdict(td.feat) == dataclasses.asdict(jd.feat)
    assert dataclasses.asdict(td.adj) == dataclasses.asdict(jd.adj)
    assert td.changed == jd.changed and td.adj_seconds >= 0 and td.feat_seconds >= 0
    assert_same_caches(jc, tc)
    assert tc.feat_cached_rows * ds.feature_nbytes_per_row() <= feat2
    assert tc.adj_cached_elements * 4 <= adj2


def test_cacheless_dual_cache_rejects_refresh():
    ds = port_dataset()
    dc = DualCache.none(ds, device="cpu")
    assert not dc.refreshable
    with pytest.raises(ValueError):
        dc.refresh(allocation=CacheAllocation(0, 0, 0, 0.5),
                   node_counts=np.zeros(ds.num_nodes), edge_counts=np.zeros(ds.graph.num_edges))


def _fresh_caches(ds, seed=0):
    rng = np.random.default_rng(seed)
    tc = DualCache.build(ds, node_counts=rng.integers(0, 9, ds.num_nodes),
                         edge_counts=rng.integers(0, 9, ds.graph.num_edges),
                         allocation=CacheAllocation(100_000, 30_000, 70_000, 0.3), device="cpu")
    grow = CacheAllocation(400_000, 100_000, 300_000, 0.25)  # grows the hot table
    return tc, grow, rng.integers(0, 9, ds.num_nodes), rng.integers(0, 9, ds.graph.num_edges)


@pytest.mark.parametrize("failure", ["refresh_fill", "feature_fill_error"])
def test_rolled_back_refresh_keeps_the_same_objects_and_bytes(monkeypatch, failure):
    """A refresh that dies mid-apply — an injected ``refresh_fill`` fault,
    charged after dgraph and store were swapped, or any other error —
    leaves the cache holding the same objects with unchanged contents."""
    tc, grow, nc, ec = _fresh_caches(port_dataset())
    snap = _snapshot(tc)
    injector = None
    if failure == "refresh_fill":
        injector = FaultInjector(FaultPlan(rules=(FaultRule("refresh_fill", max_faults=2),)))
        expect = InjectedFault
    else:
        def broken(*a, **k):
            raise MemoryError("feature fill failed")

        monkeypatch.setattr("repro_torch.core.cache.refresh_feature_cache", broken)
        expect = MemoryError
    for _ in range(2):
        with pytest.raises(expect):
            tc.refresh(allocation=grow, node_counts=nc, edge_counts=ec, injector=injector)
        _assert_unchanged(tc, snap)
    monkeypatch.undo()
    delta = tc.refresh(allocation=grow, node_counts=nc, edge_counts=ec, injector=injector)
    assert tc.epoch == delta.epoch == 1 and delta.feat.rows_inserted > 0


def test_a_committed_refresh_never_writes_into_the_previous_epoch():
    """In-flight batches keep reading the old epoch's tensors: a growing,
    inserting refresh makes new tensors and leaves the old ones as they
    were."""
    tc, grow, nc, ec = _fresh_caches(port_dataset(), seed=3)
    snap = _snapshot(tc)
    old_dgraph, old_store = tc.dgraph, tc.store
    delta = tc.refresh(allocation=grow, node_counts=nc, edge_counts=ec)
    assert delta.feat.rows_inserted > 0 and delta.adj.changed
    assert tc.store is not old_store and tc.dgraph is not old_dgraph
    assert tc.store.host_table is old_store.host_table  # shared, never written
    assert tc.dgraph.row_index is old_dgraph.row_index
    _, tensors, clones, pos_np = snap
    for t, c in zip(tensors, clones):
        assert torch.equal(t, c)
    np.testing.assert_array_equal(old_store.position_np(), pos_np)


# -------------------------------------------------------------- configuration


def test_refresh_config_validation_matches_the_reference():
    assert tcr.MODES == jcr.MODES == REFRESH_MODES
    assert tcr.STREAM_WEIGHTINGS == jcr.STREAM_WEIGHTINGS
    bad = [dict(mode="sometimes"), dict(mode="interval"), dict(mode="events", history_decay=1.5),
           dict(mode="events", max_split_step=0.0), dict(mode="events", miss_threshold=0.0),
           dict(mode="events", miss_threshold=1.5),
           dict(mode="interval", interval_batches=2, stream_weighting="bogus")]
    for kw in bad:
        for cls in (jcr.RefreshConfig, RefreshConfig):
            with pytest.raises(ValueError):
                cls(**kw)
    assert not RefreshConfig().enabled
    assert RefreshConfig(mode="all", interval_batches=2).on_interval
    cfg = RefreshConfig(mode="events", miss_threshold=0.3)
    assert cfg.enabled and not cfg.on_interval and cfg.on_events


@pytest.mark.parametrize("mode,interval,threshold", [
    ("off", 8, None), ("interval", 3, None), ("all", 2, 0.4), ("events", 8, 0.1)])
def test_engine_config_refresh_config_matches_the_reference(mode, interval, threshold):
    kw = dict(refresh_mode=mode, refresh_interval=interval, refresh_miss_threshold=threshold)
    got = EngineConfig(**kw).refresh_config()
    want = JaxEngineConfig(**kw).refresh_config()
    assert (got is None) == (want is None)
    if got is not None:
        assert isinstance(got, RefreshConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_manager_rejects_disabled_config_and_cacheless_policy(dataset):
    eng = port_engine(dataset)
    with pytest.raises(ValueError):
        CacheRefreshManager(eng.pipeline, dataset, fanouts=FANOUTS, batch_size=BATCH,
                            config=RefreshConfig())
    dgl = port_engine(dataset, "dgl")
    with pytest.raises(ValueError, match="refreshable"):
        CacheRefreshManager(dgl.pipeline, dataset, fanouts=FANOUTS, batch_size=BATCH,
                            config=RefreshConfig(mode="events"))


def test_eq1_walk_on_the_same_laps_matches_the_reference(small_dataset):
    """Eq. 1 unpinned: fed the same stage laps, the two managers walk the
    same allocations refresh after refresh.  Laps whose sample:feature
    ratio differs from the preparation profile's move the budget toward
    the laps' ratio, by at most ``max_split_step`` of it per refresh, as
    the decayed history lets the laps outweigh the profile."""
    ref, eng = ref_pair(small_dataset)
    cfg = dict(mode="interval", interval_batches=1)
    jm = jcr.CacheRefreshManager(ref.pipeline, small_dataset, fanouts=FANOUTS, batch_size=BATCH,
                                 config=jcr.RefreshConfig(**cfg))
    tm = CacheRefreshManager(eng.pipeline, eng.dataset, fanouts=FANOUTS, batch_size=BATCH,
                             config=RefreshConfig(**cfg))
    laps = {"sample": [], "feature": [], "compute": []}
    clock = types.SimpleNamespace(laps=laps)
    for m in (jm, tm):
        m.register_clock(clock)
    rng = np.random.default_rng(5)
    n, e = small_dataset.num_nodes, small_dataset.graph.num_edges
    adj = [eng.pipeline.caches.allocation.adj_bytes]
    for _ in range(4):
        laps["sample"] += [0.001] * 4
        laps["feature"] += [0.009] * 4
        laps["compute"] += [0.002] * 4
        nodes = rng.integers(0, n, 200)
        hit, slots = rng.random(200) < 0.8, [rng.integers(0, e, (64, 3))]
        for m in (jm, tm):
            m.telemetry.observe_batch(nodes, hit, slots)
        je, te = jm.refresh("interval"), tm.refresh("interval")
        assert_same_events([je], [te])
        adj.append(te.delta.allocation.adj_bytes)
    assert_same_caches(ref.pipeline.caches, eng.pipeline.caches)
    bound = int(RefreshConfig.max_split_step * eng.pipeline.caches.allocation.total_bytes)
    assert all(0 < a - b <= bound for a, b in zip(adj, adj[1:]))


def test_manager_telemetry_for_routes_by_weighting(dataset):
    eng = port_engine(dataset)
    shared = CacheRefreshManager(eng.pipeline, dataset, fanouts=FANOUTS, batch_size=BATCH,
                                 config=RefreshConfig(mode="interval", interval_batches=2))
    assert shared.telemetry_for(0) is shared.telemetry
    weighted = CacheRefreshManager(
        eng.pipeline, dataset, fanouts=FANOUTS, batch_size=BATCH,
        config=RefreshConfig(mode="interval", interval_batches=2, stream_weighting="queue-depth"))
    s0, s1 = weighted.telemetry_for(0), weighted.telemetry_for(1)
    assert s0 is not weighted.telemetry and s0 is not s1 and weighted.telemetry_for(0) is s0


# ----------------------------------------------------- engine, against the JAX


def _engine_pair_run(small_dataset, refresh_kw, *, depth, n_batches=6, dedup=False):
    ref, eng = ref_pair(small_dataset)
    batches = jax_make_stream_batches(small_dataset, num_streams=1, batches_per_stream=n_batches,
                                      batch_size=BATCH, seed=3)[0]
    jrep = ref.run(batches=list(batches), config=JaxEngineConfig(pipeline_depth=depth, dedup=dedup),
                   collect_outputs=True, refresh=jcr.RefreshConfig(**refresh_kw))
    trep = eng.run(batches=list(batches), draws=replay_draws(ref, 0, batches),
                   config=EngineConfig(pipeline_depth=depth, dedup=dedup), collect_outputs=True,
                   refresh=RefreshConfig(**refresh_kw))
    return ref, eng, jrep, trep


@pytest.mark.parametrize("depth", [1, 2])
def test_engine_refresh_matches_the_reference(small_dataset, pinned_eq1, depth):
    ref, eng, jrep, trep = _engine_pair_run(
        small_dataset, dict(mode="interval", interval_batches=2), depth=depth)
    assert len(trep.refresh_events) >= 2
    assert_same_events(jrep.refresh_events, trep.refresh_events)
    assert trep.epoch_hits == jrep.epoch_hits and len(trep.epoch_hits) >= 2
    assert (trep.feat_hits, trep.adj_hits) == (jrep.feat_hits, jrep.adj_hits)
    assert_close_outputs(eng.last_outputs, ref.last_outputs)
    assert_same_caches(ref.pipeline.caches, eng.pipeline.caches)
    summary = trep.summary()
    assert summary["per_epoch"] == trep.epoch_hits
    assert [e["epoch"] for e in summary["refresh_events"]] == [
        e.epoch for e in trep.refresh_events]
    json.dumps(summary)


def test_engine_refresh_dedup_matches_the_reference_at_depth_2(small_dataset, pinned_eq1):
    """Under dedup the telemetry scatters once per unique node, weighted
    by multiplicity: the same windows, hence the same refreshes."""
    ref, eng, jrep, trep = _engine_pair_run(
        small_dataset, dict(mode="interval", interval_batches=2), depth=2, dedup=True)
    assert_same_events(jrep.refresh_events, trep.refresh_events)
    assert trep.epoch_hits == jrep.epoch_hits
    assert_same_caches(ref.pipeline.caches, eng.pipeline.caches)


def test_miss_threshold_matches_the_reference(small_dataset, pinned_eq1):
    """A high-miss window refreshes on the threshold (events mode: no
    interval trigger at all), at the same batches as the reference."""
    ref, eng, jrep, trep = _engine_pair_run(
        small_dataset, dict(mode="events", miss_threshold=0.05), depth=1, n_batches=4)
    assert trep.refresh_events, "the threshold never fired"
    assert all(e.reason == "miss-threshold" and e.window_miss_rate >= 0.05
               for e in trep.refresh_events)
    assert_same_events(jrep.refresh_events, trep.refresh_events)
    assert trep.epoch_hits == jrep.epoch_hits


def test_miss_threshold_composes_with_interval(dataset):
    eng = port_engine(dataset, total_cache_bytes=40_000)
    rep = eng.run(max_batches=6, config=EngineConfig(pipeline_depth=1),
                  refresh=RefreshConfig(mode="interval", interval_batches=3, miss_threshold=0.05))
    reasons = {e.reason for e in rep.refresh_events}
    assert reasons and reasons <= {"miss-threshold", "interval"}


def test_a_threshold_above_the_miss_rate_never_fires(dataset):
    eng = port_engine(dataset)
    rep = eng.run(max_batches=6, config=EngineConfig(pipeline_depth=1),
                  refresh=RefreshConfig(mode="interval", interval_batches=3, miss_threshold=0.999))
    assert rep.refresh_events and all(e.reason == "interval" for e in rep.refresh_events)


# --------------------------------------------------------- engine, the port


@pytest.mark.parametrize("use_kernel,dedup,prefetch", [
    (False, False, False), (True, False, True), (True, True, False), (True, True, True)])
def test_engine_refresh_keeps_logits_and_partitions_epochs(dataset, use_kernel, dedup, prefetch):
    eng = port_engine(dataset)
    eng.run(max_batches=6, config=EngineConfig(pipeline_depth=1), collect_outputs=True)
    base = eng.last_outputs
    other = solo_engine(eng, 0)
    rep = other.run(max_batches=6, collect_outputs=True,
                    config=EngineConfig(pipeline_depth=2, use_kernel=use_kernel, dedup=dedup,
                                        prefetch=prefetch),
                    refresh=RefreshConfig(mode="interval", interval_batches=2))
    assert eng.pipeline.caches.epoch >= 2 and len(rep.refresh_events) >= 2
    for e in rep.refresh_events:  # every re-fill is a delta: something stayed put
        assert e.delta.feat.rows_kept > 0 or e.delta.adj.elements_kept > 0
        assert e.pause_seconds >= sum(e.pause_split.values()) - 1e-3
    assert_same_outputs(base, other.last_outputs)
    assert sum(v["batches"] for v in rep.epoch_hits.values()) == rep.num_batches


def test_engine_refresh_off_is_the_default_path(dataset):
    eng = port_engine(dataset)
    rep = eng.run(max_batches=3, config=EngineConfig(pipeline_depth=1),
                  refresh=RefreshConfig(mode="off"))
    assert rep.refresh_events == [] and rep.epoch_hits is None
    assert eng.pipeline.caches.epoch == 0 and "refresh_events" not in rep.summary()


def test_refresh_rederives_auto_depth(dataset):
    """With depth "auto" and refresh on, each refresh derives a window from
    the serve-time laps and applies it to the live executor; logits stay
    those of the serial run."""
    eng = port_engine(dataset)
    eng.run(max_batches=6, config=EngineConfig(pipeline_depth=1), collect_outputs=True)
    other = solo_engine(eng, 0)
    rep = other.run(max_batches=6, collect_outputs=True,
                    config=EngineConfig(pipeline_depth="auto", refresh_mode="interval",
                                        refresh_interval=2))
    depths = [e.suggested_depth for e in rep.refresh_events]
    assert depths and all(d is None or 2 <= d <= 4 for d in depths)
    assert any(d is not None for d in depths)
    assert_same_outputs(eng.last_outputs, other.last_outputs)


# ------------------------------------------------------ serving, against the JAX


def _fixed_presample(dataset, seed):
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(
        node_counts=rng.integers(0, 5, dataset.num_nodes).astype(np.int64),
        edge_counts=rng.integers(0, 3, dataset.graph.num_edges).astype(np.int64),
        sample_times=[1e-3], feature_times=[2e-3])


def _server_pair(small_dataset, refresh_kw, *, depth=2, n=3, batches=3):
    ref, eng = ref_pair(small_dataset)
    queues = jax_make_stream_batches(small_dataset, num_streams=n, batches_per_stream=batches,
                                     batch_size=BATCH, seed=7)
    jsrv = JaxServer(ref, config=JaxServeConfig(engine=JaxEngineConfig(pipeline_depth=depth)),
                     refresh=jcr.RefreshConfig(**refresh_kw))
    tsrv = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(pipeline_depth=depth)),
                             refresh=RefreshConfig(**refresh_kw))
    return ref, eng, queues, jsrv, tsrv


def _add(ref, jsrv, tsrv, queue, seed):
    js = jsrv.add_stream(queue, seed=seed, collect_outputs=True)
    ts = tsrv.add_stream(queue, seed=seed, collect_outputs=True,
                         draws=replay_draws(ref, seed, queue))
    return js, ts


def _assert_same_serve(jrep, trep, jsrv, tsrv):
    assert tsrv.admission_log == jsrv.admission_log
    assert_same_events(jrep.refresh_events, trep.refresh_events)
    assert trep.epochs == jrep.epochs
    for s, js, st, jst in zip(trep.streams, jrep.streams, tsrv.streams, jsrv.streams):
        assert (s.adj_hits, s.adj_lookups, s.feat_hits, s.feat_lookups) == (
            js.adj_hits, js.adj_lookups, js.feat_hits, js.feat_lookups)
        assert s.epoch_hits == js.epoch_hits
        assert_close_outputs(st.runtime.outputs, jst.runtime.outputs)


@pytest.mark.parametrize("weighting", ["none", "queue-depth"])
def test_serve_interval_refresh_matches_the_reference(small_dataset, pinned_eq1, weighting):
    ref, eng, queues, jsrv, tsrv = _server_pair(
        small_dataset, dict(mode="interval", interval_batches=3, stream_weighting=weighting))
    for i, q in enumerate(queues):
        _add(ref, jsrv, tsrv, q, STREAM_SEEDS[i])
    jrep, trep = jsrv.run(), tsrv.run()
    assert len(trep.refresh_events) >= 2
    _assert_same_serve(jrep, trep, jsrv, tsrv)
    mgr, jmgr = tsrv.refresh_manager, jsrv.refresh_manager
    np.testing.assert_array_equal(mgr._node_counts, jmgr._node_counts)
    np.testing.assert_array_equal(mgr._edge_counts, jmgr._edge_counts)
    if weighting != "none":
        assert set(mgr._stream_telemetry) == {0, 1, 2}
    assert_same_caches(ref.pipeline.caches, eng.pipeline.caches)


def test_serve_join_leave_matches_the_reference(small_dataset, pinned_eq1, monkeypatch):
    """A stream added after serving began is a join, its removal a leave:
    each refreshes (mode "all": the interval too), and the history, the
    events, the per-epoch hits and the caches follow the reference's."""
    for mod in (jcr, tcr):
        monkeypatch.setattr(mod, "run_presampling",
                            lambda ds, *, seed, **kw: _fixed_presample(ds, seed))
    ref, eng, queues, jsrv, tsrv = _server_pair(
        small_dataset, dict(mode="all", interval_batches=2))
    for i in range(2):
        _add(ref, jsrv, tsrv, queues[i], STREAM_SEEDS[i])
    jsrv.run(), tsrv.run()
    assert eng.pipeline.caches.epoch == ref.pipeline.caches.epoch  # adds before a run: no join
    _add(ref, jsrv, tsrv, queues[2], STREAM_SEEDS[2])
    assert tsrv.refresh_manager.events[-1].reason == "stream-join"
    jrep, trep = jsrv.run(), tsrv.run()
    jsrv.remove_stream(2), tsrv.remove_stream(2)
    assert tsrv.refresh_manager.events[-1].reason == "stream-leave"
    assert 102 not in tsrv.refresh_manager._stream_stats
    assert (tsrv.refresh_manager._node_counts >= 0).all()
    assert_same_events(jsrv.refresh_manager.events, tsrv.refresh_manager.events)
    _assert_same_serve(jrep, trep, jsrv, tsrv)
    np.testing.assert_array_equal(tsrv.refresh_manager._node_counts,
                                  jsrv.refresh_manager._node_counts)
    assert_same_caches(ref.pipeline.caches, eng.pipeline.caches)


# ------------------------------------------------------------ serving, the port


def test_serve_join_leave_keeps_streams_serial_equivalent(dataset, monkeypatch):
    monkeypatch.setattr(tcr, "run_presampling",
                        lambda ds, *, seed, **kw: _fixed_presample(ds, seed))
    eng = port_engine(dataset)
    queues = _queues(dataset)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(
        pipeline_depth=2, refresh_mode="events")))
    s0 = server.add_stream(queues[0], seed=100, collect_outputs=True)
    s1 = server.add_stream(queues[1], seed=101, collect_outputs=True)
    server.run()
    assert eng.pipeline.caches.epoch == 0
    s2 = server.add_stream(queues[2], seed=102, collect_outputs=True)
    assert eng.pipeline.caches.epoch == 1
    server.run()
    server.remove_stream(s2.stream_id)
    assert eng.pipeline.caches.epoch == 2
    assert [e.reason for e in server.refresh_manager.events] == ["stream-join", "stream-leave"]
    for state, queue, seed in ((s0, queues[0], 100), (s1, queues[1], 101), (s2, queues[2], 102)):
        solo = solo_engine(eng, seed)
        solo.run(batches=list(queue), config=EngineConfig(pipeline_depth=1), collect_outputs=True)
        assert_same_outputs(solo.last_outputs, state.runtime.outputs)


def test_serve_interval_refresh_reports_per_epoch(dataset):
    eng = port_engine(dataset)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(
        pipeline_depth=2, refresh_mode="interval", refresh_interval=3)))
    for i, q in enumerate(_queues(dataset, n=2, batches=4)):
        server.add_stream(q, seed=100 + i)
    rep = server.run()
    assert rep.epochs is not None and rep.refresh_events
    assert sum(v["batches"] for v in rep.epochs.values()) == rep.total_batches
    for epoch, agg in rep.epochs.items():
        assert agg["batches"] == sum(s.epoch_hits[epoch]["batches"] for s in rep.streams
                                     if epoch in s.epoch_hits)
    summary = rep.summary()
    assert "per_epoch" in summary and "per_epoch" in summary["per_stream"][0]
    json.dumps(summary)


def test_serve_refresh_off_report_unchanged(dataset):
    eng = port_engine(dataset)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(pipeline_depth=1)))
    server.add_stream(_queues(dataset, n=1, batches=2)[0], seed=100)
    rep = server.run()
    assert rep.epochs is None and rep.refresh_events == [] and server.refresh_manager is None
    assert "per_epoch" not in rep.summary() and "per_epoch" not in rep.streams[0].summary()


def test_serve_refresh_rederives_auto_depth(dataset):
    eng = port_engine(dataset)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(
        pipeline_depth="auto", refresh_mode="interval", refresh_interval=3)))
    for sid, q in enumerate(_queues(dataset, n=2, batches=3)):
        server.add_stream(q, seed=sid)
    rep = server.run()
    events = server.refresh_manager.events
    assert events
    derived = [e.suggested_depth for e in events if e.suggested_depth is not None]
    if derived:
        assert rep.depth == derived[-1] and server.max_inflight == derived[-1]


def test_join_serve_leave_history_never_negative(dataset):
    eng = port_engine(dataset)
    queues = _queues(dataset)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(
        pipeline_depth=2, refresh_mode="all", refresh_interval=2)))
    server.add_stream(queues[0], seed=100)
    server.add_stream(queues[1], seed=101)
    server.run()
    s2 = server.add_stream(queues[2], seed=102)  # join: a refresh, the remnant stored
    mgr = server.refresh_manager
    assert 102 in mgr._stream_stats
    server.run()  # interval refreshes decay the history and the remnant together
    assert any(e.reason == "interval" for e in mgr.events)
    server.remove_stream(s2.stream_id)
    assert 102 not in mgr._stream_stats
    assert (mgr._node_counts >= 0).all() and (mgr._edge_counts >= 0).all()
    assert mgr._sample_s >= 0 and mgr._feature_s >= 0
    assert mgr.refresh("manual").delta.epoch == eng.pipeline.caches.epoch


def test_request_queue_stream_weight_adds_slo_pressure(dataset):
    from repro_torch.runtime.request_queue import RequestQueueServer, poisson_trace

    eng = port_engine(dataset)
    trace = poisson_trace(dataset, num_streams=2, requests_per_stream=3, batch_size=BATCH,
                          mean_interarrival_s=0.0, slo_s=1e-9, seed=0)
    server = RequestQueueServer(eng, config=ServeConfig(engine=EngineConfig(
        pipeline_depth=2, refresh_mode="interval", refresh_interval=2)))
    for sid, reqs in enumerate(trace):
        server.add_request_stream(reqs, seed=sid)
    server._serve_t0 = 0.0  # every request has arrived and is past its deadline
    assert server._stream_weight(0) == 1.0 + 3 + 0 + 3
    rep = server.run()
    assert rep.refresh_events and rep.epochs is not None


# ------------------------------------------------------------------------ CLI


B = ["--device", "cpu", "--dataset", "reddit", "--scale", "0.002", "--fanouts", "4,3",
     "--batch-size", "128", "--presample", "2", "--cache-mb", "0.5"]


@pytest.mark.parametrize("extra", [
    ["--streams", "3", "--batches-per-stream", "2", "--refresh-mode", "all",
     "--refresh-interval", "2"],
    ["--batch-size", "32", "--max-batches", "4", "--pipeline-depth", "auto",
     "--refresh-mode", "interval", "--refresh-interval", "2", "--use-kernel"],
    ["--batch-size", "32", "--max-batches", "3", "--refresh-mode", "events",
     "--refresh-miss-threshold", "0.01"],
])
def test_cli_refreshes(capsys, extra):
    infer_gnn.main([*B, *extra])
    rep = json.loads(capsys.readouterr().out)
    assert rep["refresh_events"] and rep["per_epoch"]
    assert sum(v["batches"] for v in rep["per_epoch"].values()) == rep["batches"]
    if "--streams" in extra:
        assert rep["streams"] == 3 and rep["config"]["engine"]["refresh_mode"] == "all"
    if "events" in extra:
        assert {e["reason"] for e in rep["refresh_events"]} == {"miss-threshold"}
