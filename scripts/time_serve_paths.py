#!/usr/bin/env python3
"""Time the kernel routes and degraded serving of the PyTorch port on a card.

    python3 scripts/time_serve_paths.py [--src DIR] [--reps N] [--degraded]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that two trees (a parent unpacked beside the checkout, and the change)
can be timed on one card in one session, in turns.  Set-up is
``chip_smoke.py``'s main path: ogbn-products at Table II size, ``dci``
with 256 MB of cache, GraphSAGE 3x128, fan-outs 15,10,5, batch 1024.

Always timed, ``--reps`` rounds in turns: the eight kernel routes
(kernel and kernel + dedup, with and without prefetch, depth 1 and 2),
8 batches each after the engine's warmup batch, as ``chip_smoke.py``
phase 8 runs them; and one
batch's prefetch staging alone (host clock around a synchronized
``prefetch_misses``) beside the id read it starts with.

``--degraded`` (trees that have serving) also times what degraded serving
is made of, on chip_smoke.py phase 12's 4 x 8 queues as a flash crowd:
the cache-only gather alone (its first call after ``empty_cache`` and the
median of five later ones, host clock around a synchronized call) beside
the kernel route's gather; the retry envelope alone (32 calls of 2
attempts with a 0.1 ms backoff); and three serve runs in a row without a
warmup batch, fault-free and with ``host_fetch`` down, each with its
requests' retire times and the peak of the card's allocated memory over
the run's start.  Like ``chip_smoke.py`` it re-executes itself
with ``PYTHONHASHSEED=0``, so it builds the same graph.  Prints one JSON
line: the card as ``nvidia-smi`` names it with its power limit, then the
readings.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
FANOUTS = (15, 10, 5)
BATCH = 1024
CACHE_BYTES = 256 * 10**6
BATCHES = 8
STREAMS = 4
ROUTES = {
    f"kernel{'_dedup' * dedup}{'_prefetch' * prefetch}_d{depth}":
        dict(dedup=dedup, prefetch=prefetch, pipeline_depth=depth)
    for dedup in (False, True) for prefetch in (False, True) for depth in (1, 2)
}


def host_s(fn, sync) -> float:
    """Seconds of ``fn()`` on the host clock, the card idle before and
    drained after."""
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0


def card_sync(eng):
    import torch

    return torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)


def route_readings(eng, reps: int) -> dict:
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.graph.sampling import sample_blocks

    runs = {label: [] for label in ROUTES}
    for _ in range(reps):
        for label, kw in ROUTES.items():
            cfg = EngineConfig(use_kernel=True, **kw)
            rep = eng.run(config=cfg, max_batches=BATCHES)
            runs[label].append({"total_s": rep.total_seconds,
                                "prefetch_s": rep.prefetch_seconds})
    store = eng.pipeline.caches.store
    gen = torch.Generator(device=eng.device).manual_seed(SEED + 1)
    frontier = sample_blocks(eng.pipeline.caches.dgraph, eng._seeds(eng._batches(1)[0]),
                             eng.fanouts, generator=gen).input_nodes
    sync = card_sync(eng)
    id_read = [host_s(lambda: frontier.cpu().numpy(), sync) for _ in range(5)]
    staging = [host_s(lambda: store.prefetch_misses(frontier), sync) for _ in range(5)]
    return {"routes": runs, "frontier_rows": int(frontier.shape[0]),
            "id_read_s": id_read, "prefetch_misses_s": staging}


def degraded_readings(ds, eng) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig, ServeConfig
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule, InjectedFault
    from repro_torch.core.retry import RetryExhausted, RetryPolicy, call_with_retry
    from repro_torch.graph.sampling import sample_blocks
    from repro_torch.runtime.gnn_serve import make_stream_batches
    from repro_torch.runtime.request_queue import Request, RequestQueueServer

    store = eng.pipeline.caches.store
    queues = make_stream_batches(ds, num_streams=STREAMS, batches_per_stream=BATCHES,
                                 batch_size=eng.batch_size, seed=SEED)
    gen = torch.Generator(device=eng.device).manual_seed(SEED + 1)
    frontier = sample_blocks(eng.pipeline.caches.dgraph, eng._seeds(queues[0][0]),
                             eng.fanouts, generator=gen).input_nodes
    sync = card_sync(eng)
    if eng.device.type == "cuda":
        torch.cuda.empty_cache()
    cache_only_first = host_s(lambda: store.gather_cache_only(frontier), sync)
    cache_only = [host_s(lambda: store.gather_cache_only(frontier), sync) for _ in range(5)]
    kernel = [host_s(lambda: store.gather(frontier, use_kernel=True), sync) for _ in range(5)]

    policy = RetryPolicy(max_attempts=2, backoff_s=1e-4)

    def down():
        raise InjectedFault("host_fetch", 0)

    def envelope():
        for i in range(STREAMS * BATCHES):
            try:
                call_with_retry(down, policy=policy, key=("host_fetch", i),
                                retryable=(InjectedFault,))
            except RetryExhausted:
                pass

    envelope_s = host_s(envelope, sync)

    def serve(degraded: bool) -> dict:
        kw = dict(fault_policy="shed", retry_attempts=2, retry_backoff_ms=0.1,
                  degraded_mode=True) if degraded else {}
        cfg = ServeConfig(engine=EngineConfig(use_kernel=True, pipeline_depth=2), **kw)
        injector = FaultInjector(FaultPlan(rules=(FaultRule("host_fetch"),))) if degraded else None
        rq = RequestQueueServer(eng, config=cfg, admission="round-robin", injector=injector)
        for sid, q in enumerate(queues):
            rq.add_request_stream([Request(i, sid, b) for i, b in enumerate(q)],
                                  seed=SEED + sid)
        on_card = eng.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        rep = rq.run(warmup=False)
        retire = sorted(x for st in rq.streams for x in st.latencies)
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        return {"wall_s": rep.wall_seconds, "degraded": rep.requests_degraded,
                "peak_allocated_over_start_bytes": peak,
                "sample_s": sum(s.sample_seconds for s in rep.streams),
                "feature_s": sum(s.feature_seconds for s in rep.streams),
                "compute_s": sum(s.compute_seconds for s in rep.streams),
                "retire_s": [round(x, 6) for x in retire]}

    serves = {"fault_free": [], "host_fetch_down": []}
    for _ in range(3):
        for label, degraded in (("fault_free", False), ("host_fetch_down", True)):
            serves[label].append(serve(degraded))
    got, hit = store.gather_cache_only(frontier)
    return {"frontier_rows": int(frontier.shape[0]), "hit_rows": int(hit.sum()),
            "gather_cache_only_first_s": cache_only_first,
            "gather_cache_only_s": cache_only, "kernel_gather_s": kernel,
            "cache_only_bytes_allocated": 3 * got.numel() * got.element_size(),
            "retry_envelope_32_s": envelope_s, "serves": serves,
            "median_cache_only_s": statistics.median(cache_only),
            "median_kernel_s": statistics.median(kernel),
            "finite": bool(np.isfinite(got.cpu().numpy()).all())}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=pathlib.Path, default=ROOT / "src")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--degraded", action="store_true")
    args = parser.parse_args()
    if os.environ.get("PYTHONHASHSEED") != "0":
        # graph/datasets.py seeds each graph with hash(name).
        os.execve(sys.executable, [sys.executable, __file__, *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))
    import torch

    if not torch.cuda.is_available():
        print("time_serve_paths: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.core.config import EngineConfig
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ds = load_dataset("ogbn-products", scale=1.0, seed=SEED)
    eng = GNNInferenceEngine(ds, model="graphsage", fanouts=FANOUTS, batch_size=BATCH,
                             seed=SEED, device="cuda")
    eng.prepare("dci", config=EngineConfig(), total_cache_bytes=CACHE_BYTES)
    out = {"card": card, "src": str(args.src), "kernel_routes": route_readings(eng, args.reps)}
    if args.degraded:
        out["degraded"] = degraded_readings(ds, eng)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
