"""The per-layer metrics read from the program's own spans (``bench/spans.py``):
present in a traced run of the cells that list them, absent untraced, and
``waits_per_item`` an exact count, on the CPU at a small size."""

import pytest

from bench.harness import run_cell

OFFLINE, LAYERWISE = "sage-products.offline4096", "sage-products.layerwise"
NEW = {
    OFFLINE: {"dispatch_ms", "wait_ms", "waits_per_item", "sample_ms"},
    LAYERWISE: {"dispatch_ms", "wait_ms", "waits_per_item", "pass_prep_s"},
}
SEED = 2**31 + 19


def _run(cell, small, trace, seed=SEED):
    return run_cell(cell, seed, 0.3, trace, device="cpu", overrides=small, log=lambda m: None)


@pytest.mark.parametrize("cell", [OFFLINE, LAYERWISE])
def test_a_traced_run_gives_every_new_metric(cell, small):
    result = _run(cell, small, True)
    assert result["correct"]
    metrics = result["metrics"]
    assert NEW[cell] <= set(metrics)
    assert not ({"sample_ms", "pass_prep_s"} - NEW[cell]) & set(metrics)
    for name in NEW[cell]:
        assert metrics[name]["value"] > 0, name
    # Every item waits at least on its drains: two stages at depth 2
    # layer-wise, three offline.
    assert metrics["waits_per_item"]["value"] >= (3 if cell == OFFLINE else 4)


def test_waits_per_item_is_exact(small):
    """The dedup, depth-2 route waits 8 times a batch: the num_unique read,
    three drains, three reads in ``record`` and the read of the logits."""
    got = [_run(OFFLINE, small, True, seed)["metrics"]["waits_per_item"]["value"]
           for seed in (SEED, SEED + 1)]
    assert got == [8.0, 8.0]


@pytest.mark.parametrize("cell", [OFFLINE, LAYERWISE])
def test_an_untraced_run_gives_none_of_them(cell, small):
    result = _run(cell, small, False)
    assert result["correct"] and not (NEW[cell] & set(result["metrics"]))
