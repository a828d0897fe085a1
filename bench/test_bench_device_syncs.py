"""``device_syncs_per_item`` (``metrics/device_syncs_per_item.py``): the summary's count
of whole-device synchronizes over its items, ``None`` where no item was recorded or the
summary has no such count, and in a traced run on the CPU, where every drain takes the
whole-device path, the offline route's three drains a batch."""

import pytest

from bench import spans
from bench.harness import _reader, run_cell

SEED = 2**31 + 23


def _summary(device_syncs, items):
    return {"device_syncs": device_syncs, "waits": 2 * device_syncs,
            "stages": {"batch": {"count": items}}}


@pytest.mark.parametrize("device_syncs,items,want", [(0, 5, 0.0), (12, 4, 3.0), (3, 2, 1.5)])
def test_it_reads_the_count_over_the_items(monkeypatch, device_syncs, items, want):
    monkeypatch.setattr(spans, "summary", lambda: _summary(device_syncs, items))
    assert _reader("device_syncs_per_item")({}) == want


@pytest.mark.parametrize("summary", [None, {"waits": 8, "stages": {"batch": {"count": 2}}}])
def test_it_reads_nothing_without_items_or_a_count(monkeypatch, summary):
    monkeypatch.setattr(spans, "summary", lambda: summary)
    assert _reader("device_syncs_per_item")({}) is None


@pytest.mark.parametrize("cell,want", [("sage-products.offline4096", 3.0),
                                       ("sage-products.layerwise", None)])
def test_a_traced_cpu_run_counts_the_drains(small, cell, want):
    result = run_cell(cell, SEED, 0.3, True, device="cpu", overrides=small, log=lambda m: None)
    assert result["correct"]
    got = result["metrics"]["device_syncs_per_item"]["value"]
    if want is not None:
        assert got == want
    else:
        # Two drains an item, and a pass's probe and warm synchronizes
        # spread over its items.
        assert got > 2.0
    untraced = run_cell(cell, SEED, 0.3, False, device="cpu", overrides=small, log=lambda m: None)
    assert "device_syncs_per_item" not in untraced["metrics"]
