"""A run with the timed path broken underneath must come out not correct.

Each test skips the harness's look for a card, drives the rest of a run on
the CPU at a small size, and plants one fault in the program: an answer
altered where it is produced, a step that hands back its previous answer,
half of the neighbours left out with the mean taken over the rest, and
missed feature rows read as zeros.  (One card: no exchange between chips
to leave out.)"""

import pytest

from bench.harness import run_cell
from repro_torch.graph.features import FeatureStore
from repro_torch.models.gnn import models
from repro_torch.runtime import gnn_engine, layerwise

SEED = 2**31 + 77


def _run(cell, overrides, seconds=0.3):
    return run_cell(cell, SEED, seconds, False, device="cpu", overrides=overrides,
                    log=lambda msg: None)


def _altered_answer(monkeypatch):
    compute = gnn_engine.StreamRuntime.compute

    def altered(self, ctx):
        out = compute(self, ctx).clone()
        out[0, 0] += 1.0
        return out

    monkeypatch.setattr(gnn_engine.StreamRuntime, "compute", altered)


def _stale_answer(monkeypatch):
    # The previous answer, across runs: the window's first batch hands back
    # the last answer of set-up's warm-up run.
    compute = gnn_engine.StreamRuntime.compute
    last = []

    def stale(self, ctx):
        out = compute(self, ctx)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(gnn_engine.StreamRuntime, "compute", stale)


def _half_the_neighbours(monkeypatch):
    def half(params, h, num_dst, fanout):
        self_h, nbr = h[:num_dst], h[num_dst:].reshape(num_dst, fanout, -1)
        keep = max(fanout // 2, 1)
        mean_sum = nbr[:, :keep].sum(1) * (fanout / keep)
        return self_h @ params["w_self"] + mean_sum @ params["w_nbr"] + params["b"]

    monkeypatch.setattr(models, "sage_layer", half)


def _misses_as_zeros(monkeypatch):
    gather = FeatureStore.gather

    def zeros(self, indices, **kw):
        feats, hit = gather(self, indices, **kw)
        return feats * hit[:, None].to(feats.dtype), hit

    monkeypatch.setattr(FeatureStore, "gather", zeros)


FAULTS = {
    "altered_answer": _altered_answer,
    "stale_answer": _stale_answer,
    "half_the_neighbours": _half_the_neighbours,
    "misses_as_zeros": _misses_as_zeros,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["sage-products.offline4096", "sage-products.poisson"])
def test_a_broken_sampled_path_is_not_correct(monkeypatch, small, served, cell, fault):
    overrides = served if cell.endswith("poisson") else small
    FAULTS[fault](monkeypatch)
    result = _run(cell, overrides, seconds=0.5 if cell.endswith("poisson") else 0.3)
    assert not result["correct"], result["checks"]


def test_a_broken_layerwise_path_is_not_correct(monkeypatch, small):
    forward_layer = layerwise.forward_layer

    def half_edges(params, self_feats, nbr_feats, segment_ids, degrees, **kw):
        return forward_layer(params, self_feats, nbr_feats * 0.5, segment_ids, degrees, **kw)

    monkeypatch.setattr(layerwise, "forward_layer", half_edges)
    assert not _run("sage-products.layerwise", small)["correct"]


def test_an_unbroken_run_is_correct(small):
    assert _run("sage-products.offline4096", small)["correct"]
