"""Shared set-up of the port's serving tests (test_torch_serve.py,
test_torch_request_queue.py, test_torch_faults.py), on the CPU.

Two kinds of engine:

  * ``port_engine`` — the port alone, prepared on its own (its Eq. 1 split
    reads wall clocks, so outputs are compared only within the port);
  * ``ref_pair`` — a JAX reference engine prepared with ``stream_seeds``
    and a port engine built from the reference's presample profile, split
    and weights, so the two serve the same caches (and an online refresh
    starts from the same history); ``replay_draws``
    recovers a reference stream's slot draws (its runtime splits
    ``PRNGKey(seed + 1)`` once per batch), which the port's streams take
    through ``add_stream(draws=...)``.

``spy_runtimes`` lists every ``StreamRuntime`` built while it is in place
(the engine's run, its warm-up and probe runtimes, each server stream's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.graph.sampling import sample_blocks as jax_sample_blocks
from repro.runtime.gnn_engine import GNNInferenceEngine as JaxEngine
from repro_torch.core.allocation import CacheAllocation
from repro_torch.core.cache import DualCache
from repro_torch.core.policies import PreparedPipeline
from repro_torch.core.presample import PresampleStats
from repro_torch.graph.datasets import load_dataset
from repro_torch.models.gnn.models import params_from_jax
from repro_torch.runtime.gnn_engine import GNNInferenceEngine, StreamRuntime

FANOUTS = (3, 2)
BATCH = 64
KW = dict(total_cache_bytes=200_000, n_presample=2)
STREAM_SEEDS = [100, 101, 102]


def port_dataset():
    """The port's twin of conftest's ``small_dataset`` (the same graph
    within one process: both packages seed it through ``hash(name)``)."""
    return load_dataset("ogbn-products", scale=0.002, seed=0)


def port_engine(dataset, policy="dci", **prepare_kw):
    eng = GNNInferenceEngine(dataset, fanouts=FANOUTS, batch_size=BATCH, device="cpu")
    eng.prepare(policy, stream_seeds=STREAM_SEEDS, **{**KW, **prepare_kw})
    return eng


def solo_engine(engine, seed):
    """An engine of ``seed`` sharing ``engine``'s weights and pipeline."""
    solo = GNNInferenceEngine(
        engine.dataset, fanouts=FANOUTS, batch_size=BATCH, seed=seed, device="cpu",
        params=[dict(layer) for layer in engine.model.layers],
    )
    solo.pipeline = engine.pipeline
    return solo


def ref_pair(small_dataset, policy="dci"):
    """(reference engine, port engine on the same caches and weights)."""
    ref = JaxEngine(small_dataset, fanouts=FANOUTS, batch_size=BATCH)
    ref.prepare(policy, stream_seeds=STREAM_SEEDS, **KW)
    ds = port_dataset()
    rpipe = ref.pipeline
    if rpipe.presample is not None:
        caches = DualCache.build(
            ds,
            node_counts=rpipe.presample.node_counts,
            edge_counts=rpipe.presample.edge_counts,
            allocation=CacheAllocation(**dataclasses.asdict(rpipe.caches.allocation)),
            device="cpu",
        )
    else:
        caches = DualCache.none(ds, device="cpu")
    eng = GNNInferenceEngine(
        ds, fanouts=FANOUTS, batch_size=BATCH, device="cpu",
        params=params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in ref.params]),
    )
    presample = None
    if rpipe.presample is not None:
        rs = rpipe.presample
        presample = PresampleStats(
            node_counts=np.asarray(rs.node_counts), edge_counts=np.asarray(rs.edge_counts),
            sample_times=list(rs.sample_times), feature_times=list(rs.feature_times),
            peak_workload_bytes=rs.peak_workload_bytes, n_batches=rs.n_batches,
        )
    eng.pipeline = PreparedPipeline(
        name=rpipe.name, caches=caches, prep_seconds=0.0, presample=presample,
        reuse_prev_batch=rpipe.reuse_prev_batch,
    )
    return ref, eng


def spy_runtimes(monkeypatch) -> list:
    """The list every ``StreamRuntime`` (sharded ones included) is appended
    to as it is built, until ``monkeypatch`` undoes the patch."""
    made = []
    init = StreamRuntime.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(StreamRuntime, "__init__", spy)
    return made


def replay_draws(ref, seed, batches):
    """A reference stream's slot draws, per batch and layer."""
    dgraph = ref.pipeline.caches.dgraph
    col_ptr = np.asarray(dgraph.col_ptr)
    key = jax.random.PRNGKey(seed + 1)
    draws = []
    for seeds in batches:
        key, sub = jax.random.split(key)
        block = jax_sample_blocks(sub, dgraph, jnp.asarray(seeds), ref.fanouts)
        draws.append([
            torch.from_numpy(np.asarray(slots) - col_ptr[np.asarray(block.frontiers[i])][:, None])
            for i, slots in enumerate(block.edge_slots)
        ])
    return draws


def assert_close_outputs(got, want):
    """Per-batch logits of the port against the reference's, within 1e-4
    (XLA:CPU and torch sum in different orders)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(
            torch.from_numpy(np.asarray(g)), torch.from_numpy(np.array(w)), rtol=1e-4, atol=1e-4
        )


def assert_same_outputs(a_list, b_list):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_array_equal(a, b)
