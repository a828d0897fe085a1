"""The comparison that decides ``correct``, after the window has closed.

Every number compared has its limit in ``bench/limits.json``:

  * ``logit_gap``: the widest gap between the program's logits and the
    reference's float64 ones, over the largest reference logit, on a
    sample of the window's answers drawn from the seed (offline: four
    batches and the last; served: sixteen requests and the slowest;
    layer-wise: every node of the last pass);
  * ``count_gap``: the program's adjacency and feature hits and lookups
    against the reference's recount over every batch of the window
    (exact);
  * ``eq1_gap``: the program's capacity split against Eq. 1 worked out
    again from the presampling laps the program measured (exact: a
    timing cannot be drawn again, so the laps are the program's);
  * ``missing``: answers due in the window that never came (exact).

``compare(..., tf32=True)`` puts the reference in the program's place,
computed in float32 with TF32 on: the precision control.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from bench import models
from bench import reference as ref

__all__ = ["LIMITS", "compare"]

LIMITS = json.loads((pathlib.Path(__file__).resolve().parent / "limits.json").read_text())
SAMPLE_BATCHES = 4
SAMPLE_REQUESTS = 16


class Gap:
    """Running widest gap and largest reference magnitude."""

    def __init__(self):
        self.diff = 0.0
        self.scale = 0.0

    def add(self, program: np.ndarray, reference: torch.Tensor) -> None:
        r = reference.double()
        p = torch.as_tensor(np.asarray(program), device=r.device).double()
        if p.shape != r.shape or not bool(torch.isfinite(p).all()):
            self.diff = float("inf")
            return
        self.diff = max(self.diff, float((p - r).abs().max()))
        self.scale = max(self.scale, float(r.abs().max()))

    @property
    def value(self) -> float:
        if not np.isfinite(self.diff):
            return 1e30
        return self.diff / self.scale if self.scale > 0 else self.diff


def _inputs(data, params, device):
    col_ptr = torch.as_tensor(data.col_ptr, device=device)
    rows = torch.as_tensor(data.row_index, device=device)
    features = torch.as_tensor(data.features, device=device)
    params = [{k: v.to(device) for k, v in p.items()} for p in params]
    return col_ptr, rows, features, params


def _caches(config, mix, data, out, col_ptr, rows):
    alloc = out.allocation
    return ref.caches_for(
        col_ptr, rows, data.test_idx,
        batch_size=mix["batch_size"], fanouts=config["fanouts"],
        n_presample=config["n_presample"], seed=out.presample_seed,
        adj_bytes=alloc["adj_bytes"], feat_bytes=alloc["feat_bytes"],
        row_bytes=data.features.shape[1] * data.features.itemsize,
    )


def _eq1_gap(out) -> int:
    alloc, pre = out.allocation, out.presample
    adj, feat = ref.eq1_split(
        pre["sample_times"], pre["feature_times"], alloc["total_bytes"],
        adj_need=pre["adj_need"], feat_need=pre["feat_need"],
    )
    return abs(adj - alloc["adj_bytes"]) + abs(feat - alloc["feat_bytes"])


def _count_gap(out, replays) -> int:
    return sum(
        abs(out.hits[k] - sum(getattr(r, k) for r in replays))
        for k in ("adj_hits", "adj_lookups", "feat_hits", "feat_lookups")
    )


def _forward(config, model, params, features, frontier, batch, tf32):
    with ref.precision(tf32):
        return ref.block_forward(
            params, model, features, frontier, batch, config["fanouts"],
            dtype=torch.float32 if tf32 else torch.float64,
        )


def compare(config, mix, data, params, out, seed, *, device, tf32=False):
    """``(numbers, counts)``: each compared number as ``(value, limit)``, and
    the reference's window counts the per-layer readers take."""
    kind = mix["kind"]
    model = models.load(config["model"])
    col_ptr, rows, features, params = _inputs(data, params, device)
    rng = np.random.default_rng(seed)
    gap = Gap()
    counts = {}
    numbers = {}
    if kind == "layerwise":
        exact = ref.full_forward(params, model, col_ptr, rows, features)
        if tf32:
            with ref.precision(True):
                control = ref.full_forward(params, model, col_ptr, rows, features,
                                           dtype=torch.float32)
            gap.add(control.cpu().numpy(), exact)
        else:
            gap.add(out.full_outputs, exact)
        del exact
        lc = out.layer_counts
        n, e = data.num_nodes, data.num_edges
        numbers["lookup_gap"] = (
            abs(lc["feat_lookups"] - out.passes * (n + e))
            + abs(lc["embed_lookups"] - out.passes * (lc["num_layers"] - 1) * (n + e)),
            LIMITS["lookup_gap"],
        )
        numbers["missing"] = (0 if out.full_outputs is not None else 1, LIMITS["missing"])
    else:
        caches = _caches(config, mix, data, out, col_ptr, rows)
        numbers["eq1_gap"] = (_eq1_gap(out), LIMITS["eq1_gap"])
        batch = mix["batch_size"]
        if kind == "offline":
            jobs = [(out.draw_seed, out.batches, out.outputs)]
            due = len(out.batches)
            done = len(out.outputs)
            picks = set(rng.choice(done, size=min(SAMPLE_BATCHES, done), replace=False).tolist())
            picks.add(done - 1)
            wanted = [picks]
        else:
            jobs, wanted = [], []
            due = done = 0
            latency = []
            for sid, st in enumerate(out.streams):
                jobs.append((st["draw_seed"], [r[1] for r in st["requests"]], st["outputs"]))
                for i, (t, _, retired) in enumerate(st["requests"]):
                    due += 1
                    if retired is not None:
                        done += 1
                        latency.append((retired - t, sid, i))
            flat = [(sid, i) for _, sid, i in latency]
            picks = {flat[j] for j in rng.choice(len(flat), size=min(SAMPLE_REQUESTS, len(flat)),
                                                  replace=False).tolist()}
            picks.add(max(latency)[1:])
            wanted = [{i for s, i in picks if s == sid} for sid in range(len(out.streams))]
        replays = []
        for (draw_seed, seeds_list, outputs), pick in zip(jobs, wanted):
            replay = ref.Replay(col_ptr, caches, config["fanouts"], draw_seed)
            for i, seeds in enumerate(seeds_list):
                if i >= len(outputs):
                    break
                frontier = replay.next(seeds)
                if i in pick:
                    logits = _forward(config, model, params, features, frontier, batch, tf32)
                    if tf32:
                        exact = _forward(config, model, params, features, frontier, batch, False)
                        gap.add(logits.cpu().numpy(), exact)
                    else:
                        gap.add(outputs[i], logits)
            replays.append(replay)
        numbers["count_gap"] = (_count_gap(out, replays), LIMITS["count_gap"])
        numbers["missing"] = (due - done, LIMITS["missing"])
        counts["gather_groups"] = [(
            sum(r.distinct_hit_rows for r in replays),
            sum(r.distinct_miss_rows for r in replays),
            data.features.shape[1] * data.features.itemsize,
        )]
    numbers["logit_gap"] = (gap.value, LIMITS["logit_gap"])
    return numbers, counts
