"""The port's whole slice against the JAX reference engine, on the CPU.

The reference engine draws its slots from ``PRNGKey(seed + 1)``, split once
per batch (``gnn_engine.py:357``) and once per layer inside
``sample_blocks``.  Replaying that key sequence recovers its draws, which
the port's engine takes through ``run(draws=...)``.  The port's pipeline
is built from the reference's ``PresampleStats`` and ``CacheAllocation``
(Eq. 1 reads wall clocks, so two preparations never agree).  Hit counts
must then be equal and logits close (``rtol = atol = 1e-4``: XLA:CPU and
torch sum in different orders); within the port, every knob combination
must give identical outputs.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import EngineConfig as JaxEngineConfig
from repro.graph.sampling import sample_blocks as jax_sample_blocks
from repro.runtime.gnn_engine import GNNInferenceEngine as JaxEngine
from repro_torch.core.allocation import CacheAllocation
from repro_torch.core.cache import DualCache
from repro_torch.core.config import EngineConfig
from repro_torch.core.policies import PreparedPipeline, prepare
from repro_torch.graph.datasets import load_dataset
from repro_torch.models.gnn.models import params_from_jax
from repro_torch.runtime.gnn_engine import (
    GNNInferenceEngine,
    InferenceReport,
    auto_pipeline_depth,
    modeled_transfer_seconds,
)
from repro_torch.runtime.pipeline import PipelinedExecutor, Stage
from repro_torch.utils.timing import StageClock, Stopwatch, block_until_ready

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

FANOUTS = (3, 2)
BATCH = 64
BATCHES = 3


def _replay_draws(ref_eng, batches):
    """The reference run's slot draws, per batch and layer."""
    dgraph = ref_eng.pipeline.caches.dgraph
    col_ptr = np.asarray(dgraph.col_ptr)
    key = jax.random.PRNGKey(ref_eng.seed + 1)
    draws = []
    for seeds in batches:
        key, sub = jax.random.split(key)
        block = jax_sample_blocks(sub, dgraph, jnp.asarray(seeds), ref_eng.fanouts)
        draws.append([
            torch.from_numpy(np.asarray(slots) - col_ptr[np.asarray(block.frontiers[i])][:, None])
            for i, slots in enumerate(block.edge_slots)
        ])
    return draws


@pytest.fixture(scope="module", params=["graphsage", "gcn"])
def slice_pair(request, small_dataset):
    """(reference engine, its report, port engine, replayed draws)."""
    model = request.param
    ref = JaxEngine(small_dataset, model=model, fanouts=FANOUTS, batch_size=BATCH, seed=0)
    ref.prepare("dci", total_cache_bytes=200_000, n_presample=2)
    ref_rep = ref.run(max_batches=BATCHES, collect_outputs=True)

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    stats = ref.pipeline.presample
    caches = DualCache.build(
        ds,
        node_counts=stats.node_counts,
        edge_counts=stats.edge_counts,
        allocation=CacheAllocation(**dataclasses.asdict(ref.pipeline.caches.allocation)),
        device="cpu",
    )
    eng = GNNInferenceEngine(
        ds, model=model, fanouts=FANOUTS, batch_size=BATCH, seed=0, device="cpu",
        params=params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in ref.params]),
    )
    eng.pipeline = PreparedPipeline(name="dci", caches=caches, prep_seconds=0.0)
    draws = _replay_draws(ref, ref._batches(BATCHES))
    return ref, ref_rep, eng, draws


def test_slice_matches_reference_engine(slice_pair):
    ref, ref_rep, eng, draws = slice_pair
    rep = eng.run(max_batches=BATCHES, collect_outputs=True, draws=draws)
    assert rep.num_batches == ref_rep.num_batches == BATCHES
    assert (rep.adj_hits, rep.adj_lookups) == (ref_rep.adj_hits, ref_rep.adj_lookups)
    assert (rep.feat_hits, rep.feat_lookups) == (ref_rep.feat_hits, ref_rep.feat_lookups)
    assert 0 < rep.adj_hits < rep.adj_lookups and 0 < rep.feat_hits < rep.feat_lookups
    assert len(eng.last_outputs) == len(ref.last_outputs) == BATCHES
    for got, want in zip(eng.last_outputs, ref.last_outputs):
        torch.testing.assert_close(
            torch.from_numpy(got), torch.from_numpy(np.array(want)), rtol=1e-4, atol=1e-4
        )


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_port_outputs_identical_across_knobs(slice_pair, use_kernel, dedup, depth, prefetch):
    _, ref_rep, eng, draws = slice_pair
    base = eng.run(max_batches=BATCHES, collect_outputs=True, draws=draws)
    base_out = eng.last_outputs
    cfg = EngineConfig(use_kernel=use_kernel, dedup=dedup, pipeline_depth=depth,
                       prefetch=prefetch)
    rep = eng.run(config=cfg, max_batches=BATCHES, collect_outputs=True, draws=draws)
    for a, b in zip(eng.last_outputs, base_out):
        np.testing.assert_array_equal(a, b)
    assert (rep.feat_hits, rep.adj_hits) == (ref_rep.feat_hits, ref_rep.adj_hits)
    assert rep.pipeline_depth == depth and rep.dedup == dedup
    assert rep.config.use_kernel == use_kernel and rep.config.prefetch == rep.prefetch == prefetch
    assert (rep.prefetched_rows > 0) == prefetch and (rep.prefetch_seconds > 0) == prefetch
    if prefetch and not dedup:
        assert rep.prefetched_rows == rep.feat_lookups - rep.feat_hits
    if dedup:
        assert rep.unique_rows <= rep.gathered_rows <= 2 * rep.unique_rows
        assert rep.duplication_factor > 1.0


@pytest.mark.parametrize("dedup", [False, True])
def test_prefetch_matches_reference_engine(slice_pair, dedup):
    """Prefetch on in both engines: the same rows staged, the same hit
    counts, logits within 1e-4."""
    ref, _, eng, draws = slice_pair
    ref_rep = ref.run(config=JaxEngineConfig(prefetch=True, dedup=dedup), max_batches=BATCHES,
                      collect_outputs=True)
    rep = eng.run(config=EngineConfig(prefetch=True, dedup=dedup, use_kernel=True),
                  max_batches=BATCHES, collect_outputs=True, draws=draws)
    assert ref_rep.prefetch and rep.prefetch
    assert rep.prefetched_rows == ref_rep.prefetched_rows > 0
    assert (rep.adj_hits, rep.adj_lookups) == (ref_rep.adj_hits, ref_rep.adj_lookups)
    assert (rep.feat_hits, rep.feat_lookups) == (ref_rep.feat_hits, ref_rep.feat_lookups)
    for got, want in zip(eng.last_outputs, ref.last_outputs):
        torch.testing.assert_close(
            torch.from_numpy(got), torch.from_numpy(np.array(want)), rtol=1e-4, atol=1e-4
        )
    summary = rep.summary()
    assert summary["prefetch"] and summary["prefetched_rows"] == rep.prefetched_rows
    assert rep.total_seconds == pytest.approx(
        rep.sample_seconds + rep.prefetch_seconds + rep.feature_seconds + rep.compute_seconds)


def test_generator_run_is_deterministic_and_prepare_runs_on_cpu(small_dataset):
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=FANOUTS, batch_size=BATCH, seed=3, device="cpu")
    pipe = eng.prepare("dci", total_cache_bytes=200_000, n_presample=2)
    assert pipe.caches.allocation.adj_bytes + pipe.caches.allocation.feat_bytes == 200_000
    assert pipe.presample.n_batches == 2 and pipe.presample.node_counts.sum() > 0
    a = eng.run(max_batches=2, collect_outputs=True)
    out_a = eng.last_outputs
    b = eng.run(config=EngineConfig(pipeline_depth=2, use_kernel=True), max_batches=2,
                collect_outputs=True)
    for x, y in zip(eng.last_outputs, out_a):
        np.testing.assert_array_equal(x, y)
    assert (a.feat_hits, a.adj_hits) == (b.feat_hits, b.adj_hits)
    s = a.summary()
    assert s["device"] == "cpu" and 0 < s["feat_hit_rate"] < 1 and s["total_s"] > 0
    json.dumps(s)
    from repro_torch.core.trace import MetricsRegistry

    c = eng.run(max_batches=2, metrics=MetricsRegistry())
    snap = c.summary()["metrics"]
    assert snap["counters"]['batches_total{policy="dci"}'] == 2
    assert snap["gauges"]['feat_hit_rate{policy="dci"}'] == c.feat_hit_rate
    assert "metrics" not in s


# policy -> (feature rows cached, adjacency elements cached) at 100 KB
CACHED = {"sci": (True, False), "aci": (False, True), "dgl": (False, False),
          "ducati": (True, True), "rain": (False, False)}


@pytest.mark.parametrize("policy", sorted(CACHED))
def test_other_policies_prepare(policy):
    ds = load_dataset("reddit", scale=0.001, seed=1)
    pipe = prepare(policy, ds, total_cache_bytes=100_000, fanouts=FANOUTS, batch_size=32,
                   n_presample=1, device="cpu", use_kernel=True, dedup=True)
    assert pipe.name == policy and pipe.use_kernel and pipe.dedup
    rows, elems = pipe.caches.feat_cached_rows, pipe.caches.adj_cached_elements
    assert ((rows > 0), (elems > 0)) == CACHED[policy]
    assert pipe.reuse_prev_batch == (policy == "rain")
    assert (pipe.batch_order is not None) == (policy == "rain")


def test_unported_options_raise():
    """Online refresh and fault injection are still unported, and raise;
    every policy and both modes are ported."""
    ds = load_dataset("reddit", scale=0.001, seed=1)
    pipe = prepare("dci", ds, total_cache_bytes=1000, fanouts=FANOUTS, batch_size=32,
                   device="cpu", prefetch=True)
    assert pipe.prefetch  # ported: recorded as the runs' default
    eng = GNNInferenceEngine(ds, fanouts=FANOUTS, batch_size=32, device="cpu")
    eng.prepare("dgl")
    for cfg in (EngineConfig(refresh_mode="interval"),
                EngineConfig(mode="layerwise", refresh_mode="events")):
        with pytest.raises(NotImplementedError, match="refresh"):
            eng.run(config=cfg, max_batches=1)
    with pytest.raises(NotImplementedError, match="fault injection"):
        pipe.caches.store.prefetch_misses(np.arange(4), injector=object())
    rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=64))
    assert rep.outputs.shape == (ds.num_nodes, ds.spec.num_classes)


def test_auto_depth_and_modeled_transfer():
    assert auto_pipeline_depth(0.0, 1.0) == 1
    assert auto_pipeline_depth(1.0, 0.0) == 2
    assert auto_pipeline_depth(3.0, 1.0) == 4 and auto_pipeline_depth(30.0, 1.0) == 4
    # 1 GB of misses over PCIe Gen5 x16 one way, 3.35 GB of hits over HBM3
    t = modeled_transfer_seconds(feat_lookups=2000, feat_hits=1000, adj_lookups=0, adj_hits=0,
                                 feat_row_bytes=1_000_000)
    assert t == pytest.approx(1e9 / 64e9 + 1e9 / 3.35e12)
    rep = InferenceReport("dci", 1, 0.1, 0.2, 0.3, 0.0, 1, 2, 3, 4, 400)
    assert rep.total_seconds == pytest.approx(0.6) and rep.feat_hit_rate == 0.75
    ds = load_dataset("reddit", scale=0.001, seed=1)
    eng = GNNInferenceEngine(ds, fanouts=FANOUTS, batch_size=32, device="cpu", pipeline_depth="auto")
    eng.prepare("dci", total_cache_bytes=50_000, n_presample=1)
    assert eng.run(max_batches=2).pipeline_depth >= 1


def test_stage_clock_waits_on_tuples_of_tensors():
    clock = StageClock()
    with clock.stage("x", sync=lambda: (torch.ones(2), (torch.zeros(1), None))):
        pass
    assert clock.laps["x"][0] >= 0
    value = (torch.ones(1),)
    assert block_until_ready(value) is value
    watch = Stopwatch()
    with watch.track("y", sync=lambda: value):
        pass
    watch.add("y", 1.0)
    assert watch.counts["y"] == 2 and watch.total("y") >= 1.0
    ex = PipelinedExecutor(
        [Stage("a", lambda c: c.payload * 2, lambda c: c.outputs["a"])], depth=2
    )
    assert len(ex.run(torch.arange(3))) == 3


@pytest.mark.parametrize("args,want", [
    (["--policy", "rain"], {"policy": "rain", "dedup": False}),
    (["--policy", "ducati", "--dedup"], {"policy": "ducati", "dedup": True}),
    (["--mode", "layerwise", "--chunk-size", "100"], {"mode": "layerwise", "chunk_size": 100}),
])
def test_cli_takes_every_policy_and_both_modes(args, want):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.infer_gnn", "--device", "cpu",
         "--dataset", "reddit", "--scale", "0.001", "--fanouts", "3,2", "--batch-size", "16",
         "--presample", "1", "--max-batches", "2", "--use-kernel", "--cache-mb", "0.05", *args],
        capture_output=True, text=True, check=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    rep = json.loads(out.stdout)
    assert rep["device"] == "cpu" and rep["config"]["use_kernel"]
    assert {k: rep[k] for k in want} == want


def test_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.infer_gnn", "--device", "cpu",
         "--dataset", "reddit", "--scale", "0.001", "--fanouts", "3,2", "--batch-size", "16",
         "--presample", "1", "--max-batches", "2", "--use-kernel", "--dedup",
         "--pipeline-depth", "2", "--prefetch", "--cache-mb", "0.05"],
        capture_output=True, text=True, check=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    rep = json.loads(out.stdout)
    assert rep["device"] == "cpu" and rep["batches"] == 2 and rep["dedup"] and rep["prefetch"]
    assert rep["prefetched_rows"] > 0
