"""The port's sharded serving (``repro_torch.runtime.sharded_serve``) on the
CPU.

  * against the reference — the reference's ``ShardedServer`` and the
    port's, on the same caches with the reference's draws replayed, give
    the same admission log, per-stream and per-shard hit and lookup
    counters, gathered and prefetched rows per shard, shard allocations
    and (with refresh, Eq. 1 pinned) the same events, repartition log and
    caches; logits within 1e-4;
  * within the port — a ``ShardedServer`` at any shard count is
    bit-for-bit the unsharded ``MultiStreamServer`` over the same engine
    across dedup x prefetch x use_kernel, per-shard hits tile the global
    counters, one shard is the base server verbatim, and a list of four
    CPU devices is the co-resident layout (the reference runs its mesh
    tests on four virtual CPU devices).
"""

import json

import numpy as np
import pytest
import torch
from _torch_serving import (
    BATCH,
    STREAM_SEEDS,
    assert_close_outputs,
    assert_same_outputs,
    port_dataset,
    port_engine,
    ref_pair,
    replay_draws,
)

import repro.runtime.cache_refresh as jcr
from repro.core import telemetry as jtelemetry
from repro.core.config import EngineConfig as JaxEngineConfig
from repro.core.config import ServeConfig as JaxServeConfig
from repro.runtime.gnn_serve import make_stream_batches as jax_make_stream_batches
from repro.runtime.sharded_serve import ShardedServer as JaxShardedServer
import repro_torch.runtime.cache_refresh as tcr
from repro_torch.core import telemetry as ttelemetry
from repro_torch.core.config import EngineConfig, ServeConfig
from repro_torch.graph.shard import make_shard_plan
from repro_torch.launch import infer_gnn
from repro_torch.runtime.cache_refresh import RefreshConfig
from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches
from repro_torch.runtime.sharded_serve import ShardedServer

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
COUNTERS = ("adj_hits", "adj_lookups", "feat_hits", "feat_lookups", "num_batches", "num_seeds",
            "prefetched_rows", "unique_rows", "gathered_rows")
SHARD_KEYS = ("rows_cached", "feat_hits", "feat_lookups", "adj_hits", "adj_lookups",
              "gathered_rows", "prefetched_rows", "allocation")


@pytest.fixture(scope="module")
def dataset():
    return port_dataset()


@pytest.fixture(scope="module")
def engine(dataset):
    return port_engine(dataset)


@pytest.fixture()
def pinned_eq1(monkeypatch):
    for mod in (jcr, tcr):
        monkeypatch.setattr(mod, "reallocate_capacity", lambda alloc, *a, **k: alloc)


def _queues(dataset, n=3, batches=3):
    return make_stream_batches(
        dataset, num_streams=n, batches_per_stream=batches, batch_size=BATCH, seed=7
    )


def _cfg(**engine_kw):
    return ServeConfig(engine=EngineConfig(**{"pipeline_depth": 2, **engine_kw}))


def _serve(server_cls, eng, queues, cfg, **kw):
    srv = server_cls(eng, config=cfg, **kw)
    for sid, q in enumerate(queues):
        srv.add_stream(q, seed=STREAM_SEEDS[sid], collect_outputs=True)
    rep = srv.run()
    return srv, rep, [s.runtime.outputs for s in srv.streams]


def _assert_equivalent(rb, ob, rs, os_):
    for sb, ss in zip(rb.streams, rs.streams):
        for k in COUNTERS:
            assert getattr(sb, k) == getattr(ss, k), k
    for a, b in zip(ob, os_):
        assert_same_outputs(a, b)


def _assert_shard_sums(rb, rs):
    per = rs.shards
    assert rs.num_shards == len(per)
    for key in ("feat_hits", "feat_lookups", "adj_hits", "adj_lookups"):
        assert sum(p[key] for p in per) == getattr(rb, key), key


# ----------------------------------------------------------- the base server


def test_one_shard_is_bit_for_bit_the_base_server(engine, dataset):
    queues = _queues(dataset)
    _, rb, ob = _serve(MultiStreamServer, engine, queues, _cfg(dedup=True))
    srv, rs, os_ = _serve(ShardedServer, engine, queues, _cfg(dedup=True), num_shards=1)
    assert rs.num_shards == 1 and len(rs.shards) == 1
    _assert_equivalent(rb, ob, rs, os_)
    only = rs.shards[0]
    assert (only["feat_hits"], only["feat_lookups"]) == (rb.feat_hits, rb.feat_lookups)
    assert only["rows_cached"] == engine.pipeline.caches.store.num_cached
    assert srv.sharded.plan.row_starts.tolist() == [0, dataset.num_nodes]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("prefetch", [False, True])
def test_sharded_equivalence_knob_grid(engine, dataset, use_kernel, dedup, prefetch):
    queues = _queues(dataset)
    cfg = _cfg(use_kernel=use_kernel, dedup=dedup, prefetch=prefetch)
    _, rb, ob = _serve(MultiStreamServer, engine, queues, cfg)
    srv, rs, os_ = _serve(ShardedServer, engine, queues, cfg, num_shards=4)
    _assert_equivalent(rb, ob, rs, os_)
    _assert_shard_sums(rb, rs)
    # every non-empty segment of every batch is one gather (one launch on
    # the kernel route), and none is empty at this frontier size
    assert [p["gathers"] for p in rs.shards] == [rs.total_batches] * 4
    summary = rs.summary()
    assert summary["num_shards"] == 4 and len(summary["per_shard"]) == 4
    assert summary["config"]["mesh"] == 4
    json.dumps(summary)


# -------------------------------------------------------- against the JAX


def _sharded_pair(small_dataset, *, dedup, prefetch=False, refresh_kw=None, k=4):
    ref, eng = ref_pair(small_dataset)
    queues = jax_make_stream_batches(small_dataset, num_streams=3, batches_per_stream=3,
                                     batch_size=BATCH, seed=7)
    engine_kw = dict(pipeline_depth=2, dedup=dedup, prefetch=prefetch)
    jrefresh = None if refresh_kw is None else jcr.RefreshConfig(**refresh_kw)
    trefresh = None if refresh_kw is None else RefreshConfig(**refresh_kw)
    jsrv = JaxShardedServer(ref, config=JaxServeConfig(engine=JaxEngineConfig(**engine_kw)),
                            num_shards=k, refresh=jrefresh)
    tsrv = ShardedServer(eng, config=ServeConfig(engine=EngineConfig(**engine_kw)),
                         num_shards=k, refresh=trefresh)
    for sid, q in enumerate(queues):
        seed = STREAM_SEEDS[sid]
        jsrv.add_stream(q, seed=seed, collect_outputs=True)
        tsrv.add_stream(q, seed=seed, collect_outputs=True, draws=replay_draws(ref, seed, q))
    return ref, eng, jsrv, tsrv, jsrv.run(), tsrv.run()


@pytest.mark.parametrize("dedup,prefetch", [(False, False), (True, False), (True, True)])
def test_sharded_server_matches_the_reference(small_dataset, dedup, prefetch):
    _, _, jsrv, tsrv, jrep, trep = _sharded_pair(small_dataset, dedup=dedup, prefetch=prefetch)
    assert tsrv.admission_log == jsrv.admission_log
    for s, js in zip(trep.streams, jrep.streams):
        for k in COUNTERS:
            assert getattr(s, k) == getattr(js, k), k
    for st, jst in zip(tsrv.streams, jsrv.streams):
        assert_close_outputs(st.runtime.outputs, jst.runtime.outputs)
        for name in ("shard_feat_hits", "shard_feat_lookups", "shard_gathered_rows",
                     "shard_prefetched_rows"):
            np.testing.assert_array_equal(getattr(st.runtime, name), getattr(jst.runtime, name))
    for p, jp in zip(trep.shards, jrep.shards):
        for key in SHARD_KEYS:
            assert p[key] == jp[key], key
    np.testing.assert_array_equal(tsrv.sharded.plan.row_starts, jsrv.sharded.plan.row_starts)


def test_sharded_refresh_matches_the_reference(small_dataset, pinned_eq1, monkeypatch):
    # The per-shard Eq. 1 reads the history's stage laps (wall clocks):
    # with no laps pulled, both keep the presample profile's.
    for mod in (jtelemetry, ttelemetry):
        monkeypatch.setattr(mod.WorkloadTelemetry, "pull_times", lambda self, clock: None)
    ref, eng, jsrv, tsrv, jrep, trep = _sharded_pair(
        small_dataset, dedup=True, refresh_kw=dict(mode="interval", interval_batches=2))
    assert len(trep.refresh_events) >= 2
    assert [(e.epoch, e.reason, e.window_batches) for e in trep.refresh_events] == [
        (e.epoch, e.reason, e.window_batches) for e in jrep.refresh_events]
    assert trep.epochs == jrep.epochs
    assert tsrv.repartition_log == jsrv.repartition_log
    assert [vars(a) for a in tsrv.shard_allocations] == [vars(a) for a in jsrv.shard_allocations]
    for p, jp in zip(trep.shards, jrep.shards):
        for key in SHARD_KEYS:
            assert p[key] == jp[key], key
    for st, jst in zip(tsrv.streams, jsrv.streams):
        assert_close_outputs(st.runtime.outputs, jst.runtime.outputs)


# ------------------------------------------------------------------ refresh


def test_sharded_refresh_equivalence(dataset, pinned_eq1):
    """With Eq. 1 pinned, a refreshing sharded serve is bit-for-bit the
    refreshing base serve, and the shards repartition on every epoch."""
    eng = port_engine(dataset)
    stats, init = eng.pipeline.presample, eng.pipeline.caches.allocation
    queues = _queues(dataset)
    cfg = _cfg(dedup=True, refresh_mode="interval", refresh_interval=2)
    _, rb, ob = _serve(MultiStreamServer, eng, queues, cfg)
    assert rb.refresh_events
    # back to the first fill (a refresh at the presample counts and the
    # first allocation re-selects it), so the sharded run starts there too
    eng.pipeline.caches.refresh(allocation=init, node_counts=stats.node_counts,
                                edge_counts=stats.edge_counts)
    srv, rs, os_ = _serve(ShardedServer, eng, queues, cfg, num_shards=4)
    _assert_equivalent(rb, ob, rs, os_)
    _assert_shard_sums(rb, rs)
    assert len(rs.refresh_events) == len(rb.refresh_events) == len(srv.repartition_log)
    for entry in srv.repartition_log:
        assert entry["reason"] == "interval"
        assert sum(entry["rows_after"]) == eng.pipeline.caches.store.num_cached


def test_sharded_serve_refresh_outputs_bit_identical(dataset):
    """Refresh on the sharded path moves bytes, never values; per-epoch
    counters partition the lifetime counters; the last repartition tiles
    the base fill."""
    eng = port_engine(dataset)
    queues = _queues(dataset, n=2, batches=4)
    _, r_off, off = _serve(ShardedServer, eng, queues, _cfg(dedup=True), num_shards=4)
    assert r_off.refresh_events == []
    srv, r_on, on = _serve(ShardedServer, eng, queues,
                           _cfg(dedup=True, refresh_mode="interval", refresh_interval=2),
                           num_shards=4)
    assert r_on.refresh_events and eng.pipeline.caches.epoch >= 1
    assert len(srv.repartition_log) == len(r_on.refresh_events)
    assert sum(srv.repartition_log[-1]["rows_after"]) == eng.pipeline.caches.store.num_cached
    assert [e["epoch"] for e in srv.repartition_log] == [e.epoch for e in r_on.refresh_events]
    for a, b in zip(off, on):
        assert_same_outputs(a, b)
    assert sum(v["batches"] for v in r_on.epochs.values()) == r_on.total_batches


def test_refresh_manager_shard_allocations_partition_the_global(dataset):
    eng = port_engine(dataset)
    srv, _, _ = _serve(ShardedServer, eng, _queues(dataset, n=2, batches=4),
                       _cfg(refresh_mode="interval", refresh_interval=2), num_shards=4)
    mgr = srv.refresh_manager
    assert mgr.events
    base = eng.pipeline.caches.allocation
    for k in (1, 3, 4):
        allocs = mgr.shard_allocations(make_shard_plan(dataset.num_nodes, k))
        assert len(allocs) == k and sum(a.total_bytes for a in allocs) == base.total_bytes
        for a in allocs:
            if a.total_bytes:
                assert a.sample_fraction == pytest.approx(base.sample_fraction, abs=1e-9)
    assert sum(a.total_bytes for a in srv.shard_allocations) == base.total_bytes


# ---------------------------------------------------------- per-shard Eq. 1


def test_per_shard_allocations_partition_the_global_one(engine):
    srv = ShardedServer(engine, num_shards=4)
    base = engine.pipeline.caches.allocation
    assert len(srv.shard_allocations) == 4
    assert sum(a.total_bytes for a in srv.shard_allocations) == base.total_bytes
    for a in srv.shard_allocations:
        assert a.sample_fraction == pytest.approx(base.sample_fraction, abs=1e-9)


def test_shard_weights_follow_presample_traffic(engine):
    srv = ShardedServer(engine, config=ServeConfig(mesh=4))
    assert srv.num_shards == 4
    counts = np.asarray(engine.pipeline.presample.node_counts, np.float64)
    plan = srv.sharded.plan
    weights = np.array([counts[lo:hi].sum() for lo, hi in map(plan.bounds, range(4))])
    totals = np.array([a.total_bytes for a in srv.shard_allocations], np.float64)
    expect = weights / weights.sum() * engine.pipeline.caches.allocation.total_bytes
    assert np.all(np.abs(totals - expect) <= len(totals) + 1)


# ------------------------------------------------------ four devices, one host


def test_four_cpu_devices_are_the_co_resident_layout(engine, dataset):
    """The reference's four-device mesh test, over four ``cpu`` devices:
    one physical device, so the shards co-reside and share the adjacency
    tensors, and the serve is the base server's."""
    queues = _queues(dataset)
    _, rb, ob = _serve(MultiStreamServer, engine, queues, _cfg(dedup=True))
    srv, rs, os_ = _serve(ShardedServer, engine, queues, _cfg(dedup=True), mesh=[CPU] * 4,
                          num_shards=4)
    assert srv.sharded.devices is None and srv.sharded.store.assemble_device is None
    assert srv.sharded.adj_replicas == [engine.pipeline.caches.dgraph]
    for fs in srv.sharded.store.shards:
        assert fs.hot_table.device == CPU
    _assert_equivalent(rb, ob, rs, os_)
    _assert_shard_sums(rb, rs)


@pytest.mark.parametrize("dedup", [False, True])
def test_placed_layout_gives_the_co_resident_bits(engine, dataset, dedup):
    """The placed layout's code path (a device per shard: replicas per
    device, exchanged rows and the dedup inverse copied to the assembling
    device), run with every shard placed on the CPU, serves the base
    server's bits."""
    from repro_torch.runtime.sharded_serve import ShardedDualCache

    queues = _queues(dataset)
    _, rb, ob = _serve(MultiStreamServer, engine, queues, _cfg(dedup=dedup))
    srv = ShardedServer(engine, config=_cfg(dedup=dedup), num_shards=4)
    srv.sharded = ShardedDualCache.build(engine.pipeline.caches, 4, [CPU] * 4)
    assert srv.sharded.store.assemble_device == CPU
    assert srv.sharded.adj_replicas == [engine.pipeline.caches.dgraph] * 4
    for sid, q in enumerate(queues):
        srv.add_stream(q, seed=STREAM_SEEDS[sid], collect_outputs=True)
    rs = srv.run()
    _assert_equivalent(rb, ob, rs, [s.runtime.outputs for s in srv.streams])
    _assert_shard_sums(rb, rs)


def test_four_cpu_devices_with_prefetch_and_refresh(dataset, pinned_eq1):
    eng = port_engine(dataset)
    stats, init = eng.pipeline.presample, eng.pipeline.caches.allocation
    queues = _queues(dataset)
    cfg = _cfg(dedup=True, prefetch=True, refresh_mode="interval", refresh_interval=2)
    _, rb, ob = _serve(MultiStreamServer, eng, queues, cfg)
    eng.pipeline.caches.refresh(allocation=init, node_counts=stats.node_counts,
                                edge_counts=stats.edge_counts)
    srv, rs, os_ = _serve(ShardedServer, eng, queues, cfg, mesh=[CPU] * 4, num_shards=4)
    _assert_equivalent(rb, ob, rs, os_)
    _assert_shard_sums(rb, rs)
    assert len(srv.repartition_log) == len(rs.refresh_events) > 0


# ----------------------------------------------------------------------- CLI


def test_cli_mesh(capsys):
    infer_gnn.main(["--device", "cpu", "--dataset", "reddit", "--scale", "0.002",
                    "--fanouts", "4,3", "--batch-size", "128", "--presample", "2",
                    "--cache-mb", "0.5", "--mesh", "4", "--use-kernel", "--dedup",
                    "--refresh-mode", "interval", "--refresh-interval", "1"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["num_shards"] == 4 and len(rep["per_shard"]) == 4
    assert rep["streams"] == 1 and rep["config"]["mesh"] == 4
    assert sum(p["feat_lookups"] for p in rep["per_shard"]) > 0
