"""The port's DUCATI and RAIN policies against the JAX reference, on the CPU.

DUCATI's fill is fed the reference's ``PresampleStats`` (JAX's threefry
draws cannot be reproduced, so two presamplings never agree): its
``CacheAllocation``, feature cache and adjacency cache must then be the
same bits.  RAIN's batch order and MinHash signatures are pure numpy and
must be equal.  A RAIN engine run with the reference's draws replayed
(as in tests/test_torch_engine.py) must give its reuse hits exactly and
its logits within 1e-4; within the port, every knob gives the same bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as jpolicies
from repro.graph.sampling import sample_blocks as jax_sample_blocks
from repro.runtime.gnn_engine import GNNInferenceEngine as JaxEngine
from repro_torch.core import policies as tpolicies
from repro_torch.core.cache import DualCache
from repro_torch.core.config import EngineConfig
from repro_torch.core.policies import PreparedPipeline, prepare
from repro_torch.graph.datasets import load_dataset
from repro_torch.models.gnn.models import params_from_jax
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

FANOUTS = (3, 2)
BATCH = 64
BATCHES = 4


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


@pytest.fixture(scope="module")
def port_dataset(small_dataset):
    del small_dataset  # the reference's twin: same call, same process
    return load_dataset("ogbn-products", scale=0.002, seed=0)


@pytest.mark.parametrize("budget", [0, 60_000, 400_000, 10**9])
def test_ducati_fill_equals_reference_given_its_stats(small_dataset, port_dataset, budget):
    ref = jpolicies.prepare_ducati(small_dataset, total_cache_bytes=budget, fanouts=FANOUTS,
                                   batch_size=BATCH, n_presample=1)
    assert ref.presample.n_batches == 4  # DUCATI profiles 4x DCI's batches
    caches = tpolicies.ducati_caches(port_dataset, ref.presample, total_cache_bytes=budget,
                                     device="cpu")
    assert dataclasses.asdict(caches.allocation) == dataclasses.asdict(ref.caches.allocation)
    for field in ("position_map", "hot_table"):
        np.testing.assert_array_equal(_np(getattr(caches.store, field)),
                                      np.asarray(getattr(ref.caches.store, field)))
    for field in ("row_index", "cache_ptr", "cache_row_index", "cached_len"):
        np.testing.assert_array_equal(_np(getattr(caches.dgraph, field)),
                                      np.asarray(getattr(ref.caches.dgraph, field)))
    assert caches.feat_cached_rows == ref.caches.feat_cached_rows
    assert caches.adj_cached_elements == ref.caches.adj_cached_elements
    if 0 < budget < 10**9:
        assert 0 < caches.feat_cached_rows and 0 < caches.adj_cached_elements


def test_prepare_ducati_profiles_four_times_and_times_its_fill(port_dataset):
    pipe = prepare("ducati", port_dataset, total_cache_bytes=200_000, fanouts=FANOUTS,
                   batch_size=BATCH, n_presample=2, device="cpu", dedup=True)
    assert pipe.name == "ducati" and pipe.dedup and pipe.batch_order is None
    assert pipe.presample.n_batches == 8 and len(pipe.presample.sample_times) == 8
    # prep_seconds counts the presampling's steady-state laps and the fill.
    laps = sum(pipe.presample.sample_times) + sum(pipe.presample.feature_times)
    assert pipe.prep_seconds >= laps > 0
    alloc = pipe.caches.allocation
    assert alloc.adj_bytes + alloc.feat_bytes <= 200_000 and not pipe.reuse_prev_batch


@pytest.mark.parametrize("num_hashes,seed", [(32, 0), (8, 3)])
def test_minhash_signatures_equal(small_dataset, num_hashes, seed):
    batches = small_dataset.test_idx[: 20 * 16].reshape(20, 16).astype(np.int64)
    np.testing.assert_array_equal(
        tpolicies._minhash_signatures(batches, num_hashes, seed),
        jpolicies._minhash_signatures(batches, num_hashes, seed),
    )


@pytest.mark.parametrize("batch_size", [BATCH, 7])
def test_rain_batch_order_equal(small_dataset, port_dataset, batch_size):
    ref = jpolicies.prepare("rain", small_dataset, batch_size=batch_size,
                            total_cache_bytes=10**6, fanouts=FANOUTS)
    pipe = prepare("rain", port_dataset, batch_size=batch_size, total_cache_bytes=10**6,
                   fanouts=FANOUTS, device="cpu", use_kernel=True)
    np.testing.assert_array_equal(pipe.batch_order, ref.batch_order)
    assert sorted(pipe.batch_order) == list(range(len(port_dataset.test_idx) // batch_size))
    assert pipe.reuse_prev_batch and pipe.use_kernel and pipe.presample is None
    # The budget is ignored: RAIN builds no cache.
    assert pipe.caches.allocation is None and pipe.caches.feat_cached_rows == 0
    assert pipe.caches.adj_cached_elements == 0


@pytest.fixture(scope="module", params=["graphsage", "gcn"])
def rain_pair(request, small_dataset, port_dataset):
    """(reference engine, its report, port engine, replayed draws) under RAIN."""
    model = request.param
    ref = JaxEngine(small_dataset, model=model, fanouts=FANOUTS, batch_size=BATCH, seed=0)
    ref.prepare("rain")
    ref_rep = ref.run(max_batches=BATCHES, collect_outputs=True)
    eng = GNNInferenceEngine(
        port_dataset, model=model, fanouts=FANOUTS, batch_size=BATCH, seed=0, device="cpu",
        params=params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in ref.params]),
    )
    eng.pipeline = PreparedPipeline(
        name="rain", caches=DualCache.none(port_dataset, device="cpu"), prep_seconds=0.0,
        batch_order=ref.pipeline.batch_order, reuse_prev_batch=True,
    )
    draws = _replay_draws(ref, ref._batches(BATCHES))
    return ref, ref_rep, eng, draws


def test_rain_engine_matches_reference(rain_pair):
    ref, ref_rep, eng, draws = rain_pair
    for a, b in zip(eng._batches(BATCHES), ref._batches(BATCHES)):
        np.testing.assert_array_equal(a, b)  # the batches follow RAIN's order
    rep = eng.run(max_batches=BATCHES, collect_outputs=True, draws=draws)
    assert (rep.feat_hits, rep.feat_lookups) == (ref_rep.feat_hits, ref_rep.feat_lookups)
    assert (rep.adj_hits, rep.adj_lookups) == (ref_rep.adj_hits, ref_rep.adj_lookups)
    assert 0 < rep.feat_hits < rep.feat_lookups  # reuse hits: the rows the previous batch had
    assert rep.gathered_rows == rep.feat_lookups  # every row is still gathered
    for got, want in zip(eng.last_outputs, ref.last_outputs):
        torch.testing.assert_close(
            torch.from_numpy(got), torch.from_numpy(np.array(want)), rtol=1e-4, atol=1e-4
        )


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_rain_outputs_identical_across_knobs_and_dedup_resolves_off(rain_pair, use_kernel, depth,
                                                                    prefetch):
    _, ref_rep, eng, draws = rain_pair
    eng.run(max_batches=BATCHES, collect_outputs=True, draws=draws)
    base = eng.last_outputs
    cfg = EngineConfig(use_kernel=use_kernel, pipeline_depth=depth, prefetch=prefetch,
                       dedup=True)
    rep = eng.run(config=cfg, max_batches=BATCHES, collect_outputs=True, draws=draws)
    for a, b in zip(eng.last_outputs, base):
        np.testing.assert_array_equal(a, b)
    assert (rep.feat_hits, rep.adj_hits) == (ref_rep.feat_hits, ref_rep.adj_hits)
    # RAIN's reuse and dedup are exclusive, and reuse wins.
    assert not rep.dedup and rep.config.dedup is False and rep.unique_rows == 0
    assert rep.summary()["dedup"] is False
    assert (rep.prefetched_rows == rep.feat_lookups) == prefetch  # no cache: every row stages
