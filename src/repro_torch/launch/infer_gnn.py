"""Command-line entry point: the port's GNN inference and serving.

Single stream (the paper's setup):

    PYTHONPATH=src python -m repro_torch.launch.infer_gnn \
        --dataset ogbn-products --policy dci --fanouts 15,10,5 \
        --batch-size 1024 --cache-mb 2 --use-kernel --prefetch

Multi-stream serving (N request streams sharing one DualCache, batches
interleaved through one pipelined executor — runtime/gnn_serve.py), and
request-level serving on an arrival clock (runtime/request_queue.py):

    PYTHONPATH=src python -m repro_torch.launch.infer_gnn \
        --policy dci --streams 4 --batches-per-stream 8 --pipeline-depth 2
    PYTHONPATH=src python -m repro_torch.launch.infer_gnn \
        --arrival burst --admission slo --slo-ms 400 --batches-per-stream 3

``--refresh-mode interval|events|all`` (with ``--refresh-interval`` and
``--refresh-miss-threshold``) refreshes the caches online
(runtime/cache_refresh.py); ``--mesh K`` shards the feature store into K
node-id ranges (runtime/sharded_serve.py).  ``--faults PLAN.json`` replays
a fault plan (core/faults.py) under ``--fault-policy`` and
``--degraded-mode``.  ``--trace OUT.json`` writes the run's span timeline
(core/trace.py); ``--profile OUT.json`` runs under ``torch.profiler`` and
writes its trace, the program's spans beside the kernels.  ``--policy`` takes dci, sci,
aci, dgl, ducati and rain; ``--mode layerwise`` scores every node layer by
layer in ``--chunk-size`` node ranges instead of sampling mini-batches.
Runs on the CUDA card unless ``--device cpu`` is given; with no card and
no ``--device cpu`` it fails.  Prints the InferenceReport (layer-wise: the
LayerwiseReport; serving: the ServeReport) as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json

from repro_torch.core.config import INFERENCE_MODES, REFRESH_MODES, ServeConfig
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.policies import ADMISSION_POLICIES, POLICIES
from repro_torch.core.trace import MetricsRegistry, Tracer
from repro_torch.graph.datasets import load_dataset
from repro_torch.models.gnn.models import MODELS
from repro_torch.runtime.gnn_engine import GNNInferenceEngine
from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches
from repro_torch.runtime.request_queue import (
    RequestQueueServer,
    burst_trace,
    flash_crowd_trace,
    poisson_trace,
    uniform_seed_batches,
)


@contextlib.contextmanager
def _profiled(path: str | None):
    """Run the body under ``torch.profiler`` and write its Chrome trace to
    ``path``; without a path, run it plainly."""
    if path is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(path)


def _depth(value: str):
    """--pipeline-depth accepts an int or 'auto' (measured compute:prep)."""
    return "auto" if value == "auto" else int(value)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--policy", default="dci", choices=sorted(POLICIES))
    ap.add_argument("--model", default="graphsage", choices=MODELS)
    ap.add_argument("--fanouts", default="15,10,5")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--cache-mb", type=float, default=2.0)
    ap.add_argument("--scale", type=float, default=0.004)
    ap.add_argument("--presample", type=int, default=8)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument(
        "--mode",
        default="sampling",
        choices=INFERENCE_MODES,
        help="'sampling' (default) = mini-batch neighborhood-sampled inference over "
        "the test seeds; 'layerwise' = full-graph layer-wise scoring — every layer over "
        "ALL nodes in node-range chunks, the feature cache serving layer-0 rows and an "
        "embedding cache serving intermediate layer outputs",
    )
    ap.add_argument(
        "--chunk-size",
        type=int,
        default=None,
        help="node-range chunk for --mode layerwise (default 4096, clamped to the graph)",
    )
    ap.add_argument(
        "--pipeline-depth",
        type=_depth,
        default=1,
        help="batches kept in flight: 1 = serial (per-stage sync, the paper's "
        "timing), 2+ = overlap batch i+1's sample/gather with batch i's compute, "
        "'auto' = derive the window from a measured compute:prep probe",
    )
    ap.add_argument(
        "--use-kernel",
        action="store_true",
        help="route feature gathers through the CUDA cached_gather kernels",
    )
    ap.add_argument(
        "--dedup",
        action="store_true",
        help="sort-and-unique each input frontier on the device and gather/model "
        "one row per DISTINCT node; outputs and hit accounting are identical",
    )
    ap.add_argument(
        "--prefetch",
        action="store_true",
        help="stage each batch's MISSED host feature rows onto the device (pinned "
        "pack, side-stream copy) before its gather; outputs and hit accounting are "
        "identical, only where the miss bytes move changes",
    )
    ap.add_argument(
        "--streams",
        type=int,
        default=1,
        help="independent request streams served against ONE shared cache (1 = "
        "the single-stream engine; >1 = runtime/gnn_serve.py, with the presample "
        "budget split across the stream seeds)",
    )
    ap.add_argument(
        "--batches-per-stream",
        type=int,
        default=8,
        help="queue length per stream when serving (--max-batches caps it too)",
    )
    ap.add_argument(
        "--max-inflight",
        type=int,
        default=None,
        help="backpressure cap: window slots one stream may occupy (default: depth)",
    )
    ap.add_argument(
        "--arrival",
        default="none",
        choices=("none", "poisson", "burst", "flash-crowd"),
        help="request-level serving (runtime/request_queue.py): 'poisson' = steady "
        "traffic with exponential gaps, 'burst' = a flash crowd at t=0 colliding "
        "with a steady stream paced at the measured service time (always 2 "
        "streams), 'flash-crowd' = every stream dumps its whole queue at t=0; "
        "'none' (default) serves plain queues",
    )
    ap.add_argument(
        "--slo-ms",
        type=float,
        default=None,
        help="relative deadline attached to every request (arrival modes); reported "
        "as deadline hit rate, and enforced by --admission slo",
    )
    ap.add_argument(
        "--admission",
        default="round-robin",
        choices=sorted(ADMISSION_POLICIES),
        help="admission policy for --arrival modes: 'round-robin', 'edf' (earliest "
        "deadline first), 'slo' (EDF + shed requests whose deadline already passed)",
    )
    ap.add_argument(
        "--mean-interarrival-ms",
        type=float,
        default=50.0,
        help="mean request gap per stream for --arrival poisson",
    )
    ap.add_argument(
        "--faults",
        default=None,
        metavar="PLAN.json",
        help="inject deterministic faults from a FaultPlan JSON file "
        "(core/faults.py): the sites adj_fetch, host_fetch, prefetch and "
        "kernel_gather fail or delay on seeded per-site schedules",
    )
    ap.add_argument(
        "--fault-policy",
        default=None,
        choices=("fail", "retry", "shed"),
        help="what a guarded-site failure does: 'fail' fails fast (default), 'retry' "
        "retries with bounded exponential backoff then fails, 'shed' retries then "
        "sheds just the failing request and keeps serving",
    )
    ap.add_argument(
        "--retry-attempts",
        type=int,
        default=3,
        help="attempts per guarded call including the first (policies retry/shed)",
    )
    ap.add_argument(
        "--retry-backoff-ms",
        type=float,
        default=1.0,
        help="base backoff before attempt 2; doubles per attempt with seeded jitter",
    )
    ap.add_argument(
        "--retry-timeout-ms",
        type=float,
        default=None,
        help="per-attempt budget on the host side of an attempt (dispatch and any "
        "injected delay; a launch does not wait for the card); an attempt over it "
        "raises StageTimeout, which retries like a fault",
    )
    ap.add_argument(
        "--degraded-mode",
        action="store_true",
        help="serve degraded instead of failing when the miss path is down: "
        "cache-only rows (miss rows zero, requests marked degraded) and prefetch "
        "skipping",
    )
    ap.add_argument(
        "--trace",
        default=None,
        metavar="OUT.json",
        help="record a span/event timeline of the run (core/trace.py) and write it "
        "as Chrome trace-event JSON",
    )
    ap.add_argument(
        "--profile",
        default=None,
        metavar="OUT.json",
        help="run under torch.profiler (CPU and, with a card, CUDA activities) and "
        "write its Chrome trace: the program's spans (core/trace.py) beside the "
        "kernels, on one clock",
    )
    ap.add_argument(
        "--metrics",
        default=None,
        metavar="OUT",
        help="write a metrics snapshot (counters/gauges/histograms) to OUT: "
        "Prometheus text when OUT ends in .prom/.txt, JSON otherwise",
    )
    ap.add_argument(
        "--mesh",
        type=int,
        default=0,
        help="shard the feature store by node-id range into this many shards "
        "(runtime/sharded_serve.py), one per card while there are cards, "
        "co-resident on one card beyond that; 0 (default) serves unsharded",
    )
    ap.add_argument(
        "--refresh-mode",
        default="off",
        choices=REFRESH_MODES,
        help="online cache refresh: 'interval' re-allocates (Eq. 1 on the "
        "measured serve-time stage ratio) and delta re-fills every "
        "--refresh-interval retired batches; 'events' refreshes on stream "
        "join/leave; 'all' does both.  Off (default) keeps the caches as "
        "prepared",
    )
    ap.add_argument(
        "--refresh-interval",
        type=int,
        default=8,
        help="retired batches between interval refreshes (interval/all modes)",
    )
    ap.add_argument(
        "--refresh-miss-threshold",
        type=float,
        default=None,
        help="refresh as soon as the live telemetry window's feature miss rate "
        "crosses this value, beside the interval/event triggers (needs "
        "--refresh-mode != off)",
    )
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    if args.arrival == "burst":
        args.streams = 2  # the burst trace is one flash-crowd + one steady stream
    # One typed config carries every knob from here down.
    cfg = ServeConfig.from_args(args)
    tracer = Tracer() if args.trace is not None else None
    metrics = MetricsRegistry() if args.metrics is not None else None

    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    ds = load_dataset(args.dataset, scale=args.scale, max_nodes=200_000)
    eng = GNNInferenceEngine(
        ds,
        model=args.model,
        fanouts=fanouts,
        batch_size=args.batch_size,
        pipeline_depth=args.pipeline_depth,
        device=args.device,
    )
    stream_seeds = [eng.seed + s for s in range(args.streams)] if args.streams > 1 else None
    eng.prepare(
        args.policy,
        config=cfg.engine,
        total_cache_bytes=int(args.cache_mb * 1e6),
        n_presample=args.presample,
        stream_seeds=stream_seeds,
    )
    per_stream = args.batches_per_stream
    if args.max_batches is not None:
        per_stream = min(per_stream, args.max_batches)
    # Under a fault plan a fail-fast abort still prints the partial report
    # (with its 'error' field) instead of a traceback.
    raise_on_error = args.faults is None
    with _profiled(args.profile):
        if args.mode == "layerwise":
            # Full-graph scoring is a whole-dataset pass; the serving front-ends
            # are sampling-mode machinery.
            rep = eng.run(config=cfg.engine, tracer=tracer, metrics=metrics)
        elif args.arrival != "none":
            slo_s = args.slo_ms / 1e3 if args.slo_ms is not None else None
            if args.arrival == "poisson":
                trace = poisson_trace(
                    ds,
                    num_streams=args.streams,
                    requests_per_stream=per_stream,
                    batch_size=args.batch_size,
                    mean_interarrival_s=args.mean_interarrival_ms / 1e3,
                    slo_s=slo_s,
                    seed=eng.seed,
                )
            elif args.arrival == "flash-crowd":
                trace = flash_crowd_trace(
                    ds,
                    num_streams=args.streams,
                    requests_per_stream=per_stream,
                    batch_size=args.batch_size,
                    slo_s=slo_s,
                    seed=eng.seed,
                )
            else:  # burst: pace the steady stream at the measured service time
                probe = uniform_seed_batches(ds, n_batches=1, batch_size=args.batch_size,
                                             seed=eng.seed)[0]
                service_s = float(sum(eng._probe_stage_seconds(probe)))
                trace = burst_trace(
                    ds,
                    burst_requests=per_stream,
                    steady_requests=2 * per_stream,
                    batch_size=args.batch_size,
                    service_estimate_s=service_s,
                    slo_s=slo_s,
                    seed=eng.seed,
                )
            server = RequestQueueServer(eng, config=cfg, tracer=tracer, metrics=metrics)
            for sid, requests in enumerate(trace):
                server.add_request_stream(requests, seed=eng.seed + sid)
            rep = server.run(raise_on_error=raise_on_error)
        elif args.streams > 1 or args.mesh > 0:
            if args.mesh > 0:
                from repro_torch.runtime.sharded_serve import ShardedServer

                server = ShardedServer(eng, config=cfg, tracer=tracer, metrics=metrics)
            else:
                server = MultiStreamServer(eng, config=cfg, tracer=tracer, metrics=metrics)
            queues = make_stream_batches(
                ds,
                num_streams=args.streams,
                batches_per_stream=per_stream,
                batch_size=args.batch_size,
                seed=eng.seed,
            )
            seeds = stream_seeds if stream_seeds is not None else [eng.seed]
            for sid, queue in enumerate(queues):
                server.add_stream(queue, seed=seeds[sid])
            rep = server.run(raise_on_error=raise_on_error)
        else:
            # The servers resolve the injector from cfg.faults; the single-stream
            # engine takes live handles.
            injector = None
            if args.faults is not None:
                injector = FaultInjector(FaultPlan.load(args.faults), tracer=tracer)
            rep = eng.run(
                config=cfg.engine,
                max_batches=args.max_batches,
                tracer=tracer,
                metrics=metrics,
                injector=injector,
                retry_policy=cfg.retry_policy(),
                degraded_mode=cfg.degraded_mode,
            )
    print(json.dumps(rep.summary(), indent=1))
    if tracer is not None:
        tracer.export(args.trace)
    if metrics is not None:
        text = (
            metrics.to_prometheus()
            if args.metrics.endswith((".prom", ".txt"))
            else metrics.to_json()
        )
        with open(args.metrics, "w", encoding="utf-8") as fh:
            fh.write(text)


if __name__ == "__main__":
    main()
