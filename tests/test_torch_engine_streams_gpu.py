"""The sampled engine overlapped on the card (marked ``gpu``): events and a
sampling stream of its own, no whole-device synchronize.

At depth 2 on a CUDA device the sample stage runs on the runtime's
sampling stream, every stage hands retire the CUDA event it recorded, and
``record`` reads the counts and logits from pinned buffers.  These tests
hold that route to the serial one's bits (depth 1, a whole-device
synchronize at every stage) across dedup x use_kernel x prefetch for
GraphSAGE, GCN, GAT and GraphSAGE-LSTM; an online refresh between batches to the
per-epoch counts of the same depth drained on the whole device; and its
trace to no whole-device wait at all.  Run on the H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_engine_streams_gpu.py
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.cache import DualCache
from repro_torch.core.config import EngineConfig
from repro_torch.core.trace import Tracer, summarize_trace
from repro_torch.graph.datasets import load_dataset
from repro_torch.models.gnn import models as gm
from repro_torch.runtime import cache_refresh
from repro_torch.runtime.cache_refresh import RefreshConfig
from repro_torch.runtime.gnn_engine import GNNInferenceEngine, StreamRuntime

pytestmark = pytest.mark.gpu

BATCHES = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine(cuda, model):
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    params = None
    if model in ("gat", "graphsage_lstm"):
        params = gm.init_params(torch.Generator().manual_seed(3), model, 100, 47, n_layers=2)
    eng = GNNInferenceEngine(ds, model=model, fanouts=(4, 3), batch_size=128, params=params,
                             device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    return eng


def _counts(rep):
    return (rep.adj_hits, rep.adj_lookups, rep.feat_hits, rep.feat_lookups,
            rep.unique_rows, rep.gathered_rows, rep.prefetched_rows, rep.fused_batches)


@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat", "graphsage_lstm"])
def test_depth_2_gives_the_serial_bits_on_the_card(cuda, model):
    eng = _engine(cuda, model)
    for dedup, use_kernel, prefetch in itertools.product((False, True), repeat=3):
        cfg = EngineConfig(dedup=dedup, use_kernel=use_kernel, prefetch=prefetch)
        runs = []
        for depth in (1, 2):
            rep = eng.run(config=cfg.replace(pipeline_depth=depth), max_batches=BATCHES,
                          collect_outputs=True)
            runs.append((_counts(rep), np.stack(eng.last_outputs)))
        (serial_counts, serial_out), (counts, out) = runs
        assert counts == serial_counts, (dedup, use_kernel, prefetch)
        assert 0 < counts[0] < counts[1] and 0 < counts[2] < counts[3]
        np.testing.assert_array_equal(out, serial_out)


def _fresh_pipeline(eng, cuda, pipe):
    """``pipe`` on freshly built caches: its presampled counts and split."""
    caches = DualCache.build(
        eng.dataset,
        node_counts=pipe.presample.node_counts,
        edge_counts=pipe.presample.edge_counts,
        allocation=pipe.caches.allocation,
        device=cuda,
    )
    return dataclasses.replace(pipe, caches=caches)


def test_a_refresh_between_batches_gives_the_whole_device_drains_counts(cuda, monkeypatch):
    """Interval refreshes at depth 2 (Eq. 1 pinned: it reads wall clocks):
    the event route gives the per-epoch counts, logits and refreshes of
    the same run drained on the whole device."""
    monkeypatch.setattr(cache_refresh, "reallocate_capacity", lambda alloc, *a, **k: alloc)
    eng = _engine(cuda, "graphsage")
    pipe = eng.pipeline
    cfg = EngineConfig(dedup=True, use_kernel=True, pipeline_depth=2)
    refresh = RefreshConfig(mode="interval", interval_batches=2)
    runs = {}
    for streams in (False, True):
        with monkeypatch.context() as m:
            if not streams:
                m.setattr(StreamRuntime, "_on_streams", lambda self, ctx: False)
            eng.pipeline = _fresh_pipeline(eng, cuda, pipe)
            rep = eng.run(config=cfg, max_batches=8, collect_outputs=True, refresh=refresh)
            runs[streams] = (rep, np.stack(eng.last_outputs))
    (drained, drained_out), (evented, evented_out) = runs[False], runs[True]
    assert len(evented.refresh_events) >= 2
    assert [e.epoch for e in evented.refresh_events] == [e.epoch for e in drained.refresh_events]
    assert evented.epoch_hits == drained.epoch_hits and len(evented.epoch_hits) >= 2
    assert _counts(evented) == _counts(drained)
    np.testing.assert_array_equal(evented_out, drained_out)


@pytest.mark.parametrize("prefetch", [False, True])
def test_the_offline_route_never_waits_on_the_whole_device(cuda, prefetch):
    """The cells' route (dedup, kernel, depth 2, logits collected) waits on
    events only: three drains and the num_unique read a batch (prefetch
    adds its drain and its id read)."""
    eng = _engine(cuda, "graphsage")
    cfg = EngineConfig(dedup=True, use_kernel=True, prefetch=prefetch, pipeline_depth=2)
    tracer = Tracer()
    eng.run(config=cfg, max_batches=BATCHES, collect_outputs=True, tracer=tracer)
    s = summarize_trace(tracer.events)
    assert s["stages"]["batch"]["count"] == BATCHES
    assert s["device_syncs"] == 0
    if prefetch:
        assert s["wait_kinds"] == {"event": 5 * BATCHES, "read": BATCHES}
    else:
        assert s["wait_kinds"] == {"event": 4 * BATCHES}
        assert s["waits"] / BATCHES <= 4
    assert all(name not in s["stages"] for name in ("sync:record", "sync:outputs"))
