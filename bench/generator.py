"""The one generator every traffic mix (``bench/traffic/<mix>.json``) is read by.

A mix is data: its ``kind`` names the entry the window drives and its
other keys are that kind's parameters.

  * ``offline``: the test split in ascending id order, cut into batches of
    ``batch_size`` (the remainder dropped, as the engine's own schedule
    drops it), repeated pass after pass.
  * ``layerwise``: every node, through the layer-wise mode; ``batch_size``
    sizes set-up's presampling.
  * ``poisson``: an open loop of ``streams`` request streams at an
    aggregate ``rate_per_s``.  Each request is ``batch_size`` test seeds,
    uniform over the split (a per-stream permutation sliced into
    requests, as ``runtime.request_queue.uniform_seed_batches`` draws
    them).  A stream's gaps are the quantiles at ``(i + 1/2) / m`` of the
    exponential distribution with the stream's mean gap, in an order drawn
    from the seed: every seed offers the same gaps and so the same load,
    and only their order changes.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np

from bench.data import sub_seed

__all__ = ["load_mix", "offline_batches", "poisson_requests"]

ROOT = pathlib.Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def offline_batches(test_idx: np.ndarray, batch_size: int) -> list[np.ndarray]:
    """One pass over the test split (at least one batch, cycled to fill it
    on a split smaller than a batch)."""
    nb = max(len(test_idx) // batch_size, 1)
    ids = test_idx
    if len(ids) < nb * batch_size:
        ids = np.tile(ids, -(-nb * batch_size // max(len(ids), 1)))
    return list(ids[: nb * batch_size].reshape(nb, batch_size))


def poisson_requests(
    test_idx: np.ndarray,
    *,
    streams: int,
    rate_per_s: float,
    seconds: float,
    batch_size: int,
    seed: int,
) -> list[list[tuple[float, np.ndarray]]]:
    """Per stream, ``(arrival_s, seeds)`` pairs whose arrivals span about
    ``seconds``; ``rate_per_s`` is the aggregate over all streams."""
    mean_gap = streams / float(rate_per_s)
    m = max(int(round(seconds / mean_gap)), 1)
    gaps = -mean_gap * np.log1p(-(np.arange(m) + 0.5) / m)
    out = []
    for sid in range(streams):
        rng = np.random.default_rng(sub_seed(seed, 100 + sid))
        ids = rng.permutation(test_idx)
        need = m * batch_size
        if len(ids) < need:
            ids = np.concatenate(
                [ids] + [rng.permutation(test_idx) for _ in range(math.ceil(need / len(ids)) - 1)]
            )
        arrivals = np.cumsum(rng.permutation(gaps))
        out.append(
            [(float(t), ids[i * batch_size : (i + 1) * batch_size]) for i, t in enumerate(arrivals)]
        )
    return out
