"""The port's layer-wise full-graph mode against the JAX reference, on the CPU.

Chunk geometry, access counts, the delta re-fill and the embedding-cache
fill are integer bookkeeping or copies, so they must equal the
reference's bits.  ``forward_layer`` and whole runs are float compute,
held at the reference's own tolerance (``TOL``, tests/test_layerwise.py),
except GraphSAGE over the products graph, whose hub sums reach ~3e5:
there each row is held within 1e-5 of its largest output.
Eq. 1's split reads wall-clock probe laps, so the port's run is given
the reference report's ``allocation``; hits and lookups must then be
exact.  Within the port, outputs are bit-identical across prefetch ×
use_kernel × depth, and on a d-regular graph the layer-wise outputs
equal the full-neighborhood sampled forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import EngineConfig as JaxEngineConfig
from repro.graph import csc as jcsc
from repro.graph import features as jfeatures
from repro.graph import sampling as jsampling
from repro.models import gnn as jgnn
from repro.runtime import layerwise as jlayerwise
from repro.runtime.gnn_engine import GNNInferenceEngine as JaxEngine
from repro_torch.core.allocation import CacheAllocation, LayerwiseAllocation
from repro_torch.core.cache import DualCache
from repro_torch.core.config import EngineConfig
from repro_torch.core.policies import PreparedPipeline
from repro_torch.graph import csc as tcsc
from repro_torch.graph import features as tfeatures
from repro_torch.graph import sampling as tsampling
from repro_torch.graph.datasets import DatasetSpec, SyntheticGraphDataset, load_dataset
from repro_torch.models.gnn import models as tmodels
from repro_torch.runtime import layerwise as tlayerwise
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-5)  # the reference's own (tests/test_layerwise.py)
CHUNK = 1024


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want) -> None:
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def both(small_dataset):
    """(reference dataset, port dataset) — same call, same process."""
    return small_dataset, load_dataset("ogbn-products", scale=0.002, seed=0)


def _regular_graph(n: int, d: int) -> tcsc.CSCGraph:
    """Every node's in-neighbors are the next ``d`` nodes (mod n)."""
    col_ptr = np.arange(n + 1, dtype=np.int64) * d
    row_index = np.asarray([(v + k + 1) % n for v in range(n) for k in range(d)], np.int32)
    return tcsc.CSCGraph(col_ptr=col_ptr, row_index=row_index)


def _ragged_graph() -> tcsc.CSCGraph:
    """Small arbitrary graph with a zero-degree node and a multi-edge."""
    nbrs = [[1, 2], [0, 3, 4, 4], [], [2], [0, 1, 2, 3, 5], [4], [0]]
    col_ptr = np.cumsum([0] + [len(x) for x in nbrs]).astype(np.int64)
    row_index = np.concatenate([np.asarray(x, np.int32) for x in nbrs if x])
    return tcsc.CSCGraph(col_ptr=col_ptr, row_index=row_index)


def _dataset_from_graph(graph, feat_dim: int = 8, num_classes: int = 4, seed: int = 0):
    n = graph.num_nodes
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    spec = DatasetSpec("custom", n, graph.num_edges / max(n, 1), feat_dim, num_classes,
                       (0.5, 0.2, 0.3))
    return SyntheticGraphDataset(
        spec=spec,
        graph=graph,
        features=rng.standard_normal((n, feat_dim)).astype(np.float32),
        labels=rng.integers(0, num_classes, n).astype(np.int32),
        train_idx=idx[: n // 2],
        val_idx=idx[n // 2 : (7 * n) // 10],
        test_idx=idx[(7 * n) // 10 :],
    )


def _engine(ds, *, model="graphsage", fanouts=(3, 3), cache_bytes=4096, policy="dci"):
    params = tmodels.init_params(torch.Generator().manual_seed(0), model, ds.spec.feat_dim,
                                 ds.spec.num_classes, hidden=6, n_layers=len(fanouts))
    eng = GNNInferenceEngine(ds, model=model, fanouts=fanouts, batch_size=8, params=params,
                             device="cpu")
    eng.prepare(policy, total_cache_bytes=cache_bytes, n_presample=2)
    return eng


def _dense_reference(dataset, params, model: str) -> np.ndarray:
    """Straight numpy layer chain over full in-neighborhoods."""
    g = dataset.graph
    deg = np.diff(g.col_ptr).astype(np.float64)
    h = dataset.features.astype(np.float64)
    for li, p in enumerate(params):
        p = {k: v.numpy().astype(np.float64) for k, v in p.items()}
        agg = np.zeros_like(h)
        for v in range(g.num_nodes):
            agg[v] = h[g.row_index[g.col_ptr[v] : g.col_ptr[v + 1]]].sum(axis=0)
        if model == "graphsage":
            out = h @ p["w_self"] + agg @ p["w_nbr"] + p["b"]
        else:
            out = ((h + agg) / (deg[:, None] + 1.0)) @ p["w_self"] + p["b"]
        h = np.maximum(out, 0.0) if li < len(params) - 1 else out
    return h


# ------------------------------------------------------------ access pattern


@pytest.mark.parametrize("chunk_size", [700, 2048])
def test_plan_chunks_and_access_counts_equal(both, chunk_size):
    jds, tds = both
    np.testing.assert_array_equal(tlayerwise.layerwise_access_counts(tds.graph),
                                  jlayerwise.layerwise_access_counts(jds.graph))
    jplan = jlayerwise.plan_chunks(jds.graph, chunk_size)
    tplan = tlayerwise.plan_chunks(tds.graph, chunk_size, device=CPU)
    assert tplan.num_chunks == jplan.num_chunks == -(-tds.num_nodes // chunk_size)
    for t, j in zip(tplan.chunks, jplan.chunks):
        assert (t.lo, t.cnt, t.n_edges) == (j.lo, j.cnt, j.n_edges)
        for field in ("base_ids", "pad_mask", "seg_ids", "degrees", "live"):
            np.testing.assert_array_equal(_np(getattr(t, field)), np.asarray(getattr(j, field)))
        np.testing.assert_array_equal(_np(t.device_ids), j.base_ids)
        # The two-level sum's lengths: pieces of the live edges, whose
        # counts per node add up to each node's degree.
        pieces, per_node = (_np(x) for x in t.levels)
        assert pieces.sum() == t.n_edges and per_node.sum() == pieces.size
        assert per_node.size == chunk_size and pieces.max(initial=1) >= 1
        owner = np.repeat(np.arange(chunk_size), per_node)
        np.testing.assert_array_equal(
            np.bincount(owner, weights=pieces, minlength=chunk_size)[: t.cnt],
            np.bincount(np.asarray(j.seg_ids)[: j.n_edges], minlength=chunk_size)[: t.cnt])


# ------------------------------------------------------------ cache fills


@pytest.mark.parametrize("start,cap", [(50, 120), (200, 30), (0, 90), (300, 300)])
def test_refresh_feature_cache_equal(both, start, cap):
    """The delta re-fill keeps, evicts, grows and inserts as the reference
    does; the store it started from is left as it was."""
    jds, tds = both
    row = tds.feature_nbytes_per_row()
    rng = np.random.default_rng(start + cap)
    before = rng.poisson(1.0, tds.num_nodes).astype(np.int32)
    after = rng.poisson(1.0, tds.num_nodes).astype(np.int32)
    js = jfeatures.build_feature_cache(jds.features, before, start * row)
    ts = tfeatures.build_feature_cache(tds.features, before, start * row, device=CPU)
    pos0, hot0 = ts.position_map.clone(), ts.hot_table.clone()
    jn, jstats = jfeatures.refresh_feature_cache(js, after, cap * row)
    tn, tstats = tfeatures.refresh_feature_cache(ts, after, cap * row)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.changed == jstats.changed
    np.testing.assert_array_equal(_np(tn.position_map), np.asarray(jn.position_map))
    np.testing.assert_array_equal(tn.position_np(), np.asarray(jn.position_map))
    np.testing.assert_array_equal(_np(tn.hot_table), np.asarray(jn.hot_table))
    assert tn.host_table is ts.host_table
    assert torch.equal(ts.position_map, pos0) and torch.equal(ts.hot_table, hot0)
    ids = torch.from_numpy(rng.integers(0, tds.num_nodes, 500).astype(np.int32))
    feats, hit = tn.gather(ids)
    np.testing.assert_array_equal(_np(feats), tds.features[_np(ids)])
    assert int(hit.sum()) == int((tn.position_np()[_np(ids)] >= 0).sum())


@pytest.mark.parametrize("rows", [0, 10, 800, 10**6])
def test_build_embedding_cache_equal(both, rows):
    jds, tds = both
    counts = tlayerwise.layerwise_access_counts(tds.graph)
    table = np.random.default_rng(rows).standard_normal((tds.num_nodes, 16)).astype(np.float32)
    js = jfeatures.build_embedding_cache(table, counts, rows * 64)
    host = torch.from_numpy(table.copy())
    ts = tfeatures.build_embedding_cache(host, counts, rows * 64, device=CPU)
    assert ts.host_table is host  # the spill table is the host table, no copy
    np.testing.assert_array_equal(_np(ts.position_map), np.asarray(js.position_map))
    np.testing.assert_array_equal(_np(ts.hot_table), np.asarray(js.hot_table))
    assert ts.pad_node_id() == js.pad_node_id() and ts.num_cached == js.num_cached


# ------------------------------------------------------------ model and sampler


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
@pytest.mark.parametrize("relu", [False, True])
def test_forward_layer_equal(model, relu):
    rng = np.random.default_rng(5)
    num_dst, f, out, bucket = 9, 12, 7, 64
    deg = rng.integers(0, 9, num_dst)
    deg[3] = 0
    n_edges = int(deg.sum())
    seg = np.full(bucket, num_dst, np.int32)
    seg[:n_edges] = np.repeat(np.arange(num_dst, dtype=np.int32), deg)
    self_feats = rng.standard_normal((num_dst, f)).astype(np.float32)
    nbr_feats = rng.standard_normal((bucket, f)).astype(np.float32)
    params = {"w_self": rng.standard_normal((f, out)).astype(np.float32),
              "b": rng.standard_normal(out).astype(np.float32)}
    if model == "graphsage":
        params["w_nbr"] = rng.standard_normal((f, out)).astype(np.float32)
    want = jgnn.forward_layer({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(self_feats), jnp.asarray(nbr_feats), jnp.asarray(seg),
                              jnp.asarray(deg.astype(np.float32)), model=model,
                              num_dst=num_dst, relu=relu)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    args = (tp, torch.from_numpy(self_feats), torch.from_numpy(nbr_feats), torch.from_numpy(seg),
            torch.from_numpy(deg.astype(np.float32)))
    got = tmodels.forward_layer(*args, model=model, num_dst=num_dst, relu=relu)
    _close(got, want)
    # Two levels over the live edges only (pieces of at most 3 rows here)
    # give the same sums in another fixed order.
    pieces = [min(3, d - k) for d in deg for k in range(0, d, 3)]
    per_node = [-(-d // 3) for d in deg]
    levels = (torch.tensor(pieces), torch.tensor(per_node))
    two = tmodels.forward_layer(tp, args[1], args[2][:n_edges], *args[3:], model=model,
                                num_dst=num_dst, relu=relu, levels=levels)
    _close(two, want)
    one = (torch.from_numpy(np.bincount(seg, minlength=num_dst + 1)),)
    again = tmodels.forward_layer(*args, model=model, num_dst=num_dst, relu=relu, levels=one)
    assert torch.equal(again, got)


@pytest.mark.parametrize("cached", [False, True])
def test_full_neighborhood_sample_blocks_equal(both, cached):
    jds, tds = both
    if cached:
        counts = np.random.default_rng(1).poisson(1.0, jds.graph.num_edges).astype(np.int32)
        jsorted, jtot = jcsc.two_level_sort(jds.graph, counts)
        tsorted, ttot = tcsc.two_level_sort(tds.graph, counts)
        jg = jsampling.device_graph(jds.graph, sorted_row_index=jsorted,
                                    adj_cache=jcsc.build_adj_cache(jds.graph, jsorted, jtot, 8000))
        tg = tsampling.device_graph(tds.graph, device=CPU, sorted_row_index=tsorted,
                                    adj_cache=tcsc.build_adj_cache(tds.graph, tsorted, ttot, 8000))
    else:
        jg = jsampling.device_graph(jds.graph)
        tg = tsampling.device_graph(tds.graph, device=CPU)
    seeds = np.concatenate([jds.test_idx[:40], [tds.num_nodes - 1]]).astype(np.int32)
    jb = jsampling.sample_blocks(jax.random.PRNGKey(0), jg, jnp.asarray(seeds), (4, 6),
                                 full_neighborhood=True)
    tb = tsampling.sample_blocks(tg, torch.from_numpy(seeds), (4, 6), full_neighborhood=True)
    for field in ("frontiers", "neighbor_hits", "edge_slots"):
        for a, b in zip(getattr(tb, field), getattr(jb, field)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


# ------------------------------------------------------------ whole runs


def _jax_twin(ds):
    """The reference's dataset over the same arrays."""
    from repro.graph.csc import CSCGraph as JaxCSC
    from repro.graph.datasets import DatasetSpec as JaxSpec
    from repro.graph.datasets import SyntheticGraphDataset as JaxDataset

    return JaxDataset(spec=JaxSpec(*dataclasses.astuple(ds.spec)),
                      graph=JaxCSC(col_ptr=ds.graph.col_ptr, row_index=ds.graph.row_index),
                      **{k: getattr(ds, k) for k in ("features", "labels", "train_idx",
                                                    "val_idx", "test_idx")})


def _bounded_graph(n: int = 3000, max_deg: int = 8) -> tcsc.CSCGraph:
    """Random in-neighbors, 1 to ``max_deg`` per node: no hub."""
    rng = np.random.default_rng(11)
    deg = rng.integers(1, max_deg + 1, n)
    col_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return tcsc.CSCGraph(col_ptr=col_ptr,
                         row_index=rng.integers(0, n, int(deg.sum())).astype(np.int32))


# (model, graph): sums over the products graph's hubs (in-degree up to
# N - 1) grow GraphSAGE's outputs to ~3e5, where float32 rounding alone is
# past the reference's atol; a graph of bounded degree holds it at TOL.
RUNS = [("graphsage", "products"), ("gcn", "products"), ("graphsage", "bounded")]


@pytest.fixture(scope="module", params=RUNS, ids=["-".join(r) for r in RUNS])
def run_pair(request, both):
    """(model, reference report, port pipeline, port params, port dataset)
    at the reference's allocation, with a budget under both caches' needs."""
    model, graph = request.param
    if graph == "products":
        jds, tds = both
        budget = 200_000
    else:
        tds = _dataset_from_graph(_bounded_graph(), feat_dim=16, num_classes=5)
        jds, budget = _jax_twin(tds), 60_000
    ref = JaxEngine(jds, model=model, fanouts=(3, 2), batch_size=64, seed=0)
    ref.prepare("dci", total_cache_bytes=budget, n_presample=2)
    ref_rep = ref.run(config=JaxEngineConfig(mode="layerwise", chunk_size=CHUNK))
    stats = ref.pipeline.presample
    caches = DualCache.build(
        tds, node_counts=stats.node_counts, edge_counts=stats.edge_counts,
        allocation=CacheAllocation(**dataclasses.asdict(ref.pipeline.caches.allocation)),
        device="cpu",
    )
    pipe = PreparedPipeline(name="dci", caches=caches, prep_seconds=0.0)
    params = tmodels.params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                      for p in ref.params])
    return model, ref_rep, pipe, params, tds


def _run(run_pair, **knobs):
    model, ref_rep, pipe, params, ds = run_pair
    cfg = EngineConfig(mode="layerwise", chunk_size=knobs.pop("chunk_size", CHUNK), **knobs)
    depth = cfg.pipeline_depth or 1
    return tlayerwise.run_layerwise(
        ds, pipe, params, model=model, config=cfg.resolved(pipe, pipeline_depth=depth),
        allocation=LayerwiseAllocation(**dataclasses.asdict(ref_rep.allocation)),
    )


def test_run_layerwise_matches_reference(run_pair):
    model, ref_rep, _, _, ds = run_pair
    rep = _run(run_pair)
    if model == "graphsage" and ds.spec.name != "custom":
        # Outputs up to ~3e5: each row within 1e-5 of its largest entry
        # (float32 keeps 6e-8 of it per rounding).
        scale = np.abs(ref_rep.outputs).max(axis=1, keepdims=True)
        assert (np.abs(rep.outputs - ref_rep.outputs) <= 1e-5 * scale).all()
    else:
        _close(rep.outputs, ref_rep.outputs)
    assert rep.outputs.shape == (ds.num_nodes, ds.spec.num_classes)
    assert (rep.feat_hits, rep.feat_lookups) == (ref_rep.feat_hits, ref_rep.feat_lookups)
    assert (rep.embed_hits, rep.embed_lookups) == (ref_rep.embed_hits, ref_rep.embed_lookups)
    assert 0 < rep.feat_hits < rep.feat_lookups and 0 < rep.embed_hits < rep.embed_lookups
    assert (rep.num_chunks, rep.embed_row_bytes) == (ref_rep.num_chunks, ref_rep.embed_row_bytes)
    assert dataclasses.asdict(rep.allocation) == dataclasses.asdict(ref_rep.allocation)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_outputs_identical_across_knobs(run_pair, prefetch, use_kernel, depth):
    base = _run(run_pair)
    rep = _run(run_pair, prefetch=prefetch, use_kernel=use_kernel, pipeline_depth=depth,
               dedup=True)
    np.testing.assert_array_equal(rep.outputs, base.outputs)
    assert (rep.feat_hits, rep.feat_lookups) == (base.feat_hits, base.feat_lookups)
    assert (rep.embed_hits, rep.embed_lookups) == (base.embed_hits, base.embed_lookups)
    assert (rep.prefetched_rows > 0) == prefetch and rep.pipeline_depth == depth
    assert rep.config.use_kernel == use_kernel


def test_chunk_size_moves_no_lookup(run_pair):
    base = _run(run_pair)
    other = _run(run_pair, chunk_size=777)
    scale = np.abs(base.outputs).max(axis=1, keepdims=True)
    assert (np.abs(other.outputs - base.outputs) <= 1e-5 * scale).all()
    ds = run_pair[-1]
    n, e = ds.num_nodes, ds.graph.num_edges
    assert other.feat_lookups == base.feat_lookups == n + e
    assert other.embed_lookups == base.embed_lookups == 2 * (n + e)


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_matches_full_neighborhood_sampled_forward(model):
    """On a d-regular graph with fanout == d the deterministic enumeration
    takes every in-edge once, so the sampled forward IS the full-graph
    computation."""
    d = 3
    ds = _dataset_from_graph(_regular_graph(24, d))
    eng = _engine(ds, model=model, fanouts=(d, d))
    rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=8))
    dgraph, store = eng.pipeline.caches.dgraph, eng.pipeline.caches.store
    params = list(eng.model.layers)
    for lo in range(0, ds.num_nodes, 8):
        seeds = torch.arange(lo, min(lo + 8, ds.num_nodes), dtype=torch.int32)
        block = tsampling.sample_blocks(dgraph, seeds, (d, d), full_neighborhood=True)
        feats, _ = store.gather(block.input_nodes)
        with torch.inference_mode():
            logits = tmodels.forward(params, feats, model=model, fanouts=(d, d))
        _close(rep.outputs[lo : lo + 8], logits)


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_matches_dense_reference_on_a_ragged_graph(model):
    ds = _dataset_from_graph(_ragged_graph())
    eng = _engine(ds, model=model, fanouts=(2, 2), cache_bytes=2048)
    rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=3))
    _close(rep.outputs, _dense_reference(ds, list(eng.model.layers), model))
    dgl = _engine(ds, model=model, fanouts=(2, 2), policy="dgl")  # no budget at all
    rep = dgl.run(config=EngineConfig(mode="layerwise", chunk_size=4))
    assert rep.allocation is None and rep.feat_hits == rep.embed_hits == 0
    _close(rep.outputs, _dense_reference(ds, list(dgl.model.layers), model))


def test_engine_dispatch_and_summary_keys_match_reference():
    ds = _dataset_from_graph(_regular_graph(24, 3))
    eng = _engine(ds)
    cfg = dict(mode="layerwise", chunk_size=8, pipeline_depth="auto")
    rep = eng.run(config=EngineConfig(**cfg))
    assert isinstance(rep, tlayerwise.LayerwiseReport) and eng.last_outputs[0] is rep.outputs
    ref = JaxEngine(_jax_twin(ds), fanouts=(3, 3), batch_size=8, seed=0,
                    params=jgnn.init_params(jax.random.PRNGKey(0), "graphsage", 8, 4,
                                            hidden=6, n_layers=2))
    ref.prepare("dci", total_cache_bytes=4096, n_presample=2)
    ref_rep = ref.run(config=JaxEngineConfig(**cfg))
    s, want = rep.summary(), ref_rep.summary()
    assert set(s) - {"device"} == set(want) and s["device"] == "cpu"
    assert set(s["config"]) == set(want["config"]) - {"gather_buffers"}
    for key in ("mode", "nodes", "layers", "chunk_size", "chunks", "pipeline_depth"):
        assert s[key] == want[key]
    assert s["pipeline_depth"] == 2 and s["config"]["dedup"] is False
    assert all(s["config"][k] is not None for k in ("prefetch", "use_kernel", "dedup"))
    n, e = ds.num_nodes, ds.graph.num_edges
    assert (rep.feat_lookups, rep.embed_lookups) == (n + e, (rep.num_layers - 1) * (n + e))
    assert rep.to_dict() == s and rep.modeled_transfer_seconds() > 0
    assert rep.total_seconds == pytest.approx(rep.gather_seconds + rep.prefetch_seconds +
                                              rep.compute_seconds + rep.spill_seconds +
                                              rep.fill_seconds)


def test_layerwise_metrics_gauges():
    from repro_torch.core.trace import MetricsRegistry

    ds = _dataset_from_graph(_regular_graph(24, 3))
    eng = _engine(ds)
    metrics = MetricsRegistry()
    rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=8), metrics=metrics)
    snap = rep.summary()["metrics"]
    assert snap["counters"]['chunks_total{mode="layerwise"}'] == 2 * 3
    assert snap["gauges"]['embed_hit_rate{mode="layerwise"}'] == rep.embed_hit_rate
