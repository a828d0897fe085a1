"""The program side of a run: the port's objects for one cell, set up,
warmed and driven through the measured window.

Each ``run_<kind>`` builds the engine on the benchmark's inputs, prepares
DCI's caches (``GNNInferenceEngine.prepare``), warms the cell's own
shapes, runs the window through the entry the mix names and returns an
:class:`Outcome` of plain host data.  The engine and its caches go out of
scope on return, so the reference runs on a card the program has left.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from bench import devtrace, models
from bench.data import GraphData, sub_seed
from bench.generator import offline_batches, poisson_requests
from repro_torch.core.config import EngineConfig, ServeConfig
from repro_torch.graph.csc import CSCGraph
from repro_torch.graph.datasets import DatasetSpec, SyntheticGraphDataset
from repro_torch.runtime.gnn_engine import GNNInferenceEngine
from repro_torch.runtime.request_queue import Request, RequestQueueServer

__all__ = ["Outcome", "RUNS", "make_params"]


@dataclasses.dataclass
class Outcome:
    """What the window produced and the program's own counts."""

    window_s: float
    nodes: int  # seed nodes whose logits the window produced
    attempted: int
    memory_peak_bytes: int
    prep_s: float
    allocation: dict | None  # Eq. 1's split: adj_bytes, feat_bytes, total_bytes
    presample: dict | None  # the laps Eq. 1 read and the needs it clamped to
    hits: dict  # adj_hits, adj_lookups, feat_hits, feat_lookups (the program's)
    presample_seed: int | None = None
    # offline: one entry per batch, in the order the window ran them
    batches: list | None = None
    outputs: list | None = None
    draw_seed: int | None = None
    # poisson: per stream, (arrival_s, seeds, retired_s or None) and logits
    streams: list | None = None
    # layerwise: the last pass's logits of every node, and the passes' counts
    full_outputs: np.ndarray | None = None
    passes: int = 0
    layer_counts: dict | None = None
    pass_seconds: list | None = None


def make_params(config: dict, seed: int, device) -> list[dict]:
    """The model's weights from the seed, on ``device``: drawn by the
    configuration's model file (``bench/models/<model>.py``) from a generator
    seeded for the run."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    return models.load(config["model"]).init(config, gen, device)


def _dataset(config: dict, data: GraphData) -> SyntheticGraphDataset:
    ds = config["dataset"]
    spec = DatasetSpec(
        ds["name"], ds["num_nodes"], ds["avg_degree"], ds["feat_dim"], ds["num_classes"],
        tuple(ds["split"]), ds["pareto_alpha"], ds["popularity_gamma"],
    )
    return SyntheticGraphDataset(
        spec=spec,
        graph=CSCGraph(col_ptr=data.col_ptr, row_index=data.row_index),
        features=data.features,
        labels=data.labels,
        train_idx=data.train_idx,
        val_idx=data.val_idx,
        test_idx=data.test_idx,
    )


def _engine_config(config: dict, **kw) -> EngineConfig:
    return EngineConfig(
        pipeline_depth=config["pipeline_depth"],
        use_kernel=config["use_kernel"],
        dedup=config["dedup"],
        prefetch=config["prefetch"],
        **kw,
    )


def _prepared(config, mix, data, params, seed, device, marks) -> GNNInferenceEngine:
    """The engine with DCI's caches prepared; ``marks`` gets the clock."""
    engine = GNNInferenceEngine(
        _dataset(config, data),
        model=config["model"],
        fanouts=tuple(config["fanouts"]),
        batch_size=mix["batch_size"],
        seed=sub_seed(seed, 3),
        params=params,
        pipeline_depth=config["pipeline_depth"],
        device=device,
    )
    engine.prepare(
        config["policy"],
        config=_engine_config(config),
        total_cache_bytes=int(config["cache_mb"] * 1e6),
        n_presample=config["n_presample"],
    )
    marks["prepared"] = time.perf_counter()
    return engine


def _common(engine: GNNInferenceEngine, device) -> dict:
    pipe = engine.pipeline
    alloc = pipe.caches.allocation
    stats = pipe.presample
    ds = engine.dataset
    return dict(
        memory_peak_bytes=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
        prep_s=pipe.prep_seconds,
        allocation=None if alloc is None else dict(
            adj_bytes=alloc.adj_bytes, feat_bytes=alloc.feat_bytes, total_bytes=alloc.total_bytes
        ),
        presample=None if stats is None else dict(
            sample_times=list(stats.sample_times),
            feature_times=list(stats.feature_times),
            adj_need=ds.graph.num_edges * 4,
            feat_need=ds.features.nbytes,
        ),
        presample_seed=engine.seed,
    )


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WindowBatches:
    """The pass's batches over and over, until the window's deadline: the
    executor pulls the next batch when a slot frees, so every batch that
    starts before the deadline runs to its end.  ``len()`` is the number
    handed out so far."""

    def __init__(self, batches: list[np.ndarray]):
        self.batches = batches
        self.deadline = math.inf
        self.count = 0

    def __iter__(self):
        while time.perf_counter() < self.deadline:
            yield self.batches[self.count % len(self.batches)]
            self.count += 1

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return True

    def __getitem__(self, i: int) -> np.ndarray:
        return self.batches[i % len(self.batches)]


def run_offline(config, mix, data, params, seed, seconds, device, trace, holder, marks) -> Outcome:
    engine = _prepared(config, mix, data, params, seed, device, marks)
    cfg = _engine_config(config)
    batches = offline_batches(data.test_idx, mix["batch_size"])
    engine.warmup(batches[0])
    engine.run(config=cfg, batches=batches[:3], warmup=False)
    _sync(device)
    marks["warm"] = time.perf_counter()

    window = WindowBatches(batches)
    with devtrace.window(trace, holder):
        t0 = time.perf_counter()
        window.deadline = t0 + seconds
        report = engine.run(config=cfg, batches=window, warmup=False, collect_outputs=True)
        t1 = time.perf_counter()
    outputs = engine.last_outputs
    return Outcome(
        window_s=t1 - t0,
        nodes=len(outputs) * mix["batch_size"],
        attempted=window.count,
        hits=dict(
            adj_hits=report.adj_hits, adj_lookups=report.adj_lookups,
            feat_hits=report.feat_hits, feat_lookups=report.feat_lookups,
        ),
        batches=[window[i] for i in range(window.count)],
        outputs=outputs,
        draw_seed=engine.seed + 1,  # the engine's documented stream seed
        **_common(engine, device),
    )


def run_layerwise(config, mix, data, params, seed, seconds, device, trace, holder, marks) -> Outcome:
    engine = _prepared(config, mix, data, params, seed, device, marks)
    cfg = _engine_config(config, mode="layerwise", chunk_size=mix.get("chunk_size"))
    engine.run(config=cfg)  # one whole pass warms every chunk shape and pinned buffer
    _sync(device)
    marks["warm"] = time.perf_counter()

    counts = dict(feat_hits=0, feat_lookups=0, embed_hits=0, embed_lookups=0)
    passes, last, laps = 0, None, []
    with devtrace.window(trace, holder):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            report = engine.run(config=cfg)
            laps.append(time.perf_counter() - t0 - sum(laps))
            passes += 1
            for k in counts:
                counts[k] += getattr(report, k)
            last = report
        t1 = time.perf_counter()
    n = data.num_nodes
    return Outcome(
        window_s=t1 - t0,
        nodes=passes * n,
        attempted=passes,
        hits=dict(adj_hits=0, adj_lookups=0, feat_hits=counts["feat_hits"],
                  feat_lookups=counts["feat_lookups"]),
        full_outputs=np.array(last.outputs),
        passes=passes,
        pass_seconds=laps,
        layer_counts=dict(
            counts, feat_row_bytes=last.feat_row_bytes, embed_row_bytes=last.embed_row_bytes,
            num_layers=last.num_layers,
        ),
        **_common(engine, device),
    )


def _serve(engine, config, mix, traffic, stream_seeds, collect):
    server = RequestQueueServer(
        engine,
        config=ServeConfig(engine=_engine_config(config), admission=mix["admission"]),
    )
    states = [
        server.add_request_stream(
            [Request(request_id=i, stream_id=sid, seeds=s, arrival_s=t)
             for i, (t, s) in enumerate(reqs)],
            seed=stream_seeds[sid],
            collect_outputs=collect,
        )
        for sid, reqs in enumerate(traffic)
    ]
    return states, server.run(warmup=False)


def run_poisson(config, mix, data, params, seed, seconds, device, trace, holder, marks) -> Outcome:
    engine = _prepared(config, mix, data, params, seed, device, marks)
    streams = mix["streams"]
    stream_seeds = [sub_seed(seed, 10 + sid) for sid in range(streams)]
    warm = poisson_requests(
        data.test_idx, streams=streams, rate_per_s=1e6, seconds=2 * streams / 1e6,
        batch_size=mix["batch_size"], seed=sub_seed(seed, 4),
    )
    engine.warmup(warm[0][0][1])
    _serve(engine, config, mix, warm, stream_seeds, collect=False)
    _sync(device)
    marks["warm"] = time.perf_counter()

    traffic = poisson_requests(
        data.test_idx, streams=streams, rate_per_s=mix["rate_per_s"], seconds=seconds,
        batch_size=mix["batch_size"], seed=seed,
    )
    with devtrace.window(trace, holder):
        states, report = _serve(engine, config, mix, traffic, stream_seeds, collect=True)
    hits = dict(adj_hits=0, adj_lookups=0, feat_hits=0, feat_lookups=0)
    out_streams = []
    for st in states:
        rt = st.runtime
        for k in hits:
            hits[k] += getattr(rt, k)
        by_id = {r.request_id: r for r in st.completed}
        reqs = [
            (t, s, by_id[i].retired_s if i in by_id else None)
            for i, (t, s) in enumerate(traffic[st.stream_id])
        ]
        out_streams.append(dict(requests=reqs, outputs=rt.outputs, draw_seed=st.seed + 1))
    done = sum(len(st.completed) for st in states)
    return Outcome(
        window_s=report.wall_seconds,
        nodes=done * mix["batch_size"],
        attempted=sum(len(t) for t in traffic),
        hits=hits,
        streams=out_streams,
        **_common(engine, device),
    )


RUNS = {"offline": run_offline, "layerwise": run_layerwise, "poisson": run_poisson}
