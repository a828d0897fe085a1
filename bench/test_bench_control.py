"""The precision control on the card, at a size a test run holds: the
reference put in the program's place in float32 with TF32 on (the next
precision below the configuration's) fails the logit comparison that the
program passes.  At each cell's own size the control is read by
``python -m bench.control`` (PERF.md gives its readings)."""

import pytest

from bench.check import LIMITS
from bench.harness import run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["sage-products.offline4096", "gcn-reddit.offline4096",
                                  "sage-products.layerwise"])
def test_tf32_in_the_programs_place_fails(card, cell):
    overrides = {"scale": 0.05, "config": {"cache_mb": 4}, "mix": {"batch_size": 1024}}
    result = run_cell(cell, 2**31 + 41, 1.0, False, device=str(card), overrides=overrides,
                      control=True, log=lambda msg: None)
    assert result["correct"], result["checks"]
    assert result["checks"]["logit_gap"]["value"] < LIMITS["logit_gap"]
    assert result["control"]["logit_gap"]["value"] > LIMITS["logit_gap"]
