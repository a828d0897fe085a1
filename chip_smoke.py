#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
under ``/usr/local/cuda`` (or on ``PATH``) and PyTorch built for CUDA.
Imports nothing of JAX and nothing of the JAX package.  Phases, none of
whose errors is caught:

1. device: the card's name and power limit;
2. build: compile ``src/repro_torch/csrc/cached_gather.cu`` with ``nvcc``
   and print the ``-Xptxas -v`` summary; measure the pinned host→device
   copy rate;
3. main-path setup: ``load_dataset("ogbn-products", scale=1.0)`` (Table II
   size) and ``prepare("dci", total_cache_bytes=256 MB)`` on the card;
4. kernel parity: the three gather kernels against ``ref.py``
   (``torch.equal``) at the main-path shape — one batch of 1024 seeds at
   fan-outs 15,10,5 gives 1024·16·11·6 = 1,081,344 input rows — for
   ``F = 100`` (the prepared ogbn-products store and a sampled frontier)
   and ``F = 602`` (reddit-sized synthetic tables), with the host table
   pinned on the CPU and on the card, plus all-hit, all-miss, empty and
   out-of-range cases; each kernel timed with CUDA events beside
   ``ref.py``, ``torch.index_select`` on a device-resident table, and the
   bytes bound (PCIe at the card's published Gen5 x16 peak); then the
   device work of one batch's feature stage on the plain and the dedup
   kernel route, with the dedup sort and #2's classification alone;
5. main path: GraphSAGE (3 layers, hidden 128) through
   ``GNNInferenceEngine`` on the kernel route, with and without dedup, at
   depth 1 (stages synchronized) and depth 2, and the table route at
   depth 1 — one prepared pipeline, one seed; the logits must be
   identical, and the launch counters of kernels #1 and #2 (set to 0 just
   before each route and read just after) must be > 0;
6. the CLI, once, as a subprocess.

The script re-executes itself with ``PYTHONHASHSEED=0`` first, so the
dataset (seeded through ``hash(name)``) is the same graph in every run.
The details go to ``chiprun_out/chip_smoke.json``.  The last three lines
are the card (as ``nvidia-smi`` reports it), the kernels' JSON line and
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

SEED = 0
FANOUTS = (15, 10, 5)
BATCH = 1024
MAIN_ROWS = BATCH * 16 * 11 * 6  # 1,081,344 input-frontier rows per batch
CACHE_BYTES = 256 * 10**6
MAIN_BATCHES = 8
REPLACES = {
    "cached_gather": "src/repro/kernels/cached_gather/kernel.py:152",
    "cached_gather_blocks": "src/repro/kernels/cached_gather/kernel.py:347",
    "cached_gather_select": "src/repro/kernels/cached_gather/kernel.py:500",
}


def log(*parts) -> None:
    print(*parts, flush=True)


def phase(name: str) -> None:
    log(f"== {name}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warmup,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_phase() -> dict:
    import torch

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"nvidia-smi: {smi}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda}; device 0: {name}; "
        f"count {torch.cuda.device_count()}")
    return {"nvidia_smi": smi, "kind": name, "count": torch.cuda.device_count()}


def build_phase() -> dict:
    import torch

    from repro_torch.kernels._build import build_library
    from repro_torch.kernels.cached_gather.kernel import load_library
    from repro_torch.runtime.gnn_engine import HBM3_BW, PCIE5_BW

    phase("2. build")
    t0 = time.perf_counter()
    lib, report = build_library("cached_gather")
    load_library()
    build_s = time.perf_counter() - t0
    log(f"built {lib.relative_to(ROOT)} in {build_s:.1f} s; ptxas -v:")
    for line in report.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())
    # Pinned host -> device copy rate: the miss path's link, measured.
    nbytes = 1 << 30
    src = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)
    h2d = nbytes / (ms / 1e3)
    log(f"pinned host->device copy: {h2d / 1e9:.2f} GB/s (1 GiB, 5 copies); the engine's "
        f"published rates: PCIe Gen5 x16 {PCIE5_BW / 1e9:.0f} GB/s one way, "
        f"HBM3 {HBM3_BW / 1e12:.2f} TB/s")
    del src, dst
    return {"build_s": build_s, "h2d_bytes_per_s": h2d}


def setup_phase():
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine

    phase("3. main-path setup")
    t0 = time.perf_counter()
    ds = load_dataset("ogbn-products", scale=1.0, seed=SEED)
    gen_s = time.perf_counter() - t0
    log(f"ogbn-products at scale 1.0: {ds.num_nodes} nodes, {ds.graph.num_edges} edges, "
        f"features {ds.features.nbytes / 1e6:.0f} MB; generated in {gen_s:.1f} s")
    eng = GNNInferenceEngine(ds, model="graphsage", fanouts=FANOUTS, batch_size=BATCH,
                             seed=SEED, device="cuda")
    t0 = time.perf_counter()
    pipe = eng.prepare("dci", config=EngineConfig(), total_cache_bytes=CACHE_BYTES)
    prepare_s = time.perf_counter() - t0
    alloc = pipe.caches.allocation
    log(f"prepare('dci', 256 MB) in {prepare_s:.1f} s (prep_seconds {pipe.prep_seconds:.2f}): "
        f"adj {alloc.adj_bytes} B, feat {alloc.feat_bytes} B, "
        f"{pipe.caches.feat_cached_rows} hot rows, {pipe.caches.adj_cached_elements} adj elements")
    if not (pipe.caches.store.host_table.is_pinned() and pipe.caches.store.hot_table.is_cuda):
        raise AssertionError("the host table must be pinned and the hot table on the card")
    torch.cuda.synchronize()
    return ds, eng, {
        "dataset_s": gen_s, "prepare_s": prepare_s, "prep_seconds": pipe.prep_seconds,
        "num_nodes": ds.num_nodes, "num_edges": ds.graph.num_edges,
        "adj_bytes": alloc.adj_bytes, "feat_bytes": alloc.feat_bytes,
        "hot_rows": pipe.caches.feat_cached_rows,
        "adj_elements": pipe.caches.adj_cached_elements,
    }


def kernel_inputs(eng):
    """Per feature width: (hot, pinned host, device host, full-frontier ids,
    their positions, deduped ids, their positions)."""
    import torch

    from repro_torch.graph.sampling import dedup_frontier, pow2_bucket, sample_blocks

    store = eng.pipeline.caches.store
    seeds = torch.from_numpy(eng._batches(1)[0]).to("cuda")
    block = sample_blocks(
        eng.pipeline.caches.dgraph, seeds, FANOUTS,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 7),
        dedup=True, dedup_pad_id=store.pad_node_id(),
    )
    ids = block.input_nodes
    if ids.shape[0] != MAIN_ROWS:
        raise AssertionError(f"input frontier of {ids.shape[0]} rows, expected {MAIN_ROWS}")
    nu = int(block.dedup.num_unique)
    uids = block.dedup.unique_ids[: pow2_bucket(nu, MAIN_ROWS)]
    pos_of = lambda pm, x: pm[x.to(torch.int64)]  # noqa: E731
    products = dict(
        hot=store.hot_table, host=store.host_table, host_dev=store.host_table.to("cuda"),
        ids=ids, pos=pos_of(store.position_map, ids),
        uids=uids, upos=pos_of(store.position_map, uids),
    )
    # reddit-sized synthetic tables (Table II: 232,965 nodes, F = 602) with
    # a quarter of the nodes cached, at the same frontier length.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    n, f = 232_965, 602
    host_dev = torch.randn((n, f), generator=gen, device="cuda")
    cached = torch.randperm(n, generator=gen, device="cuda")[: n // 4].sort().values
    position_map = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    position_map[cached] = torch.arange(cached.shape[0], dtype=torch.int32, device="cuda")
    rids = torch.randint(0, n, (MAIN_ROWS,), generator=gen, device="cuda", dtype=torch.int32)
    dd = dedup_frontier(rids, int(cached[-1]))
    ruids = dd.unique_ids[: pow2_bucket(int(dd.num_unique), MAIN_ROWS)]
    reddit = dict(
        hot=host_dev[cached].contiguous(), host=host_dev.cpu().pin_memory(), host_dev=host_dev,
        ids=rids, pos=pos_of(position_map, rids),
        uids=ruids, upos=pos_of(position_map, ruids),
    )
    return {100: products, 602: reddit}


def bound_ms(hot, idx, pos, pinned: bool, h2d: float) -> float:
    """Least time for the bytes this gather must move: each DISTINCT hit
    row read once over HBM (published 3.35 TB/s), each distinct miss row
    once over PCIe (pinned host) or HBM (device host), ids and positions
    read once, the output written once; the two links run in parallel.
    The PCIe rate is the card's published Gen5 x16 peak, or the measured
    pinned copy rate where that is higher, so the bound never sits above
    what the card could do."""
    import torch

    from repro_torch.runtime.gnn_engine import HBM3_BW, PCIE5_BW

    s = pos.shape[0]
    row = hot.shape[1] * hot.element_size()
    hit = pos >= 0
    hit_rows = int(torch.unique(pos[hit]).numel())
    miss_rows = int(torch.unique(idx[~hit]).numel())
    hbm = (hit_rows + s) * row + 8 * s + (0 if pinned else miss_rows * row)
    pcie = miss_rows * row if pinned else 0
    return 1e3 * max(hbm / HBM3_BW, pcie / max(PCIE5_BW, h2d))


def feature_stage_phase(eng, case) -> dict:
    """CUDA-event times of the device work each feature route adds, on
    one batch's frontier (the prepared ogbn-products store): the dedup
    sort (run in the sample stage), #2's block classification, and the
    whole feature stage of the plain and the dedup kernel route."""
    import torch

    from repro_torch.graph.sampling import dedup_frontier
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK

    store = eng.pipeline.caches.store
    ids, uids = case["ids"], case["uids"]
    dd = dedup_frontier(ids, store.pad_node_id())
    inverse = dd.inverse.to(torch.int64)

    def dedup_feature():
        feats_u, hit_u = store.gather(uids, use_kernel=True, row_block=ROW_BLOCK)
        return feats_u, hit_u[inverse]

    times = {
        "dedup_sort_ms": cuda_ms(lambda: dedup_frontier(ids, store.pad_node_id()), reps=5),
        "classify_ms": cuda_ms(lambda: tk.classify_blocks(
            uids, case["upos"], store.hot_table.shape[0], store.host_table.shape[0], ROW_BLOCK
        ), reps=5),
        "feature_kernel_ms": cuda_ms(lambda: store.gather(ids, use_kernel=True), reps=5),
        "feature_kernel_dedup_ms": cuda_ms(dedup_feature, reps=5),
    }
    log("  feature-stage device work, one batch (CUDA events, mean of 5): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


def kernel_phase(inputs, h2d) -> tuple[dict, list]:
    import torch

    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.kernels.cached_gather.ref import cached_gather_ref

    phase("4. kernel parity and timing (1,081,344 rows)")
    kernels = {
        "cached_gather": tk.cached_gather,
        "cached_gather_blocks": tk.cached_gather_blocks,
        "cached_gather_select": tk.cached_gather_select,
    }
    # Each kernel's main-path input: #1 and #3 the full frontier, #2 the
    # dedup path's sorted unique bucket.
    main_input = {"cached_gather": ("ids", "pos"), "cached_gather_blocks": ("uids", "upos"),
                  "cached_gather_select": ("ids", "pos")}
    max_err = {k: 0.0 for k in kernels}
    rows = []
    for f, case in inputs.items():
        for placement in ("pinned", "device"):
            host = case["host"] if placement == "pinned" else case["host_dev"]
            for idx_key, pos_key in (("ids", "pos"), ("uids", "upos")):
                idx, pos = case[idx_key], case[pos_key]
                want = cached_gather_ref(case["hot"], host, idx, pos)
                plain = cuda_ms(lambda: cached_gather_ref(case["hot"], host, idx, pos), reps=2)
                lib = cuda_ms(lambda: torch.index_select(case["host_dev"], 0, idx), reps=5)
                if not torch.equal(torch.index_select(case["host_dev"], 0, idx), want):
                    raise AssertionError(f"index_select disagrees with ref.py (F={f})")
                bound = bound_ms(case["hot"], idx, pos, placement == "pinned", h2d)
                for name, fn in kernels.items():
                    got = fn(case["hot"], host, idx, pos)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    max_err[name] = max(max_err[name], err)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} disagrees with ref.py (F={f}, {placement} "
                                             f"host, {idx_key}): max abs err {err}")
                    del got
                    ms = cuda_ms(lambda: fn(case["hot"], host, idx, pos), reps=5)
                    row = dict(kernel=name, F=f, host=placement, input=idx_key,
                               rows=int(idx.shape[0]), hit_rate=float((pos >= 0).float().mean()),
                               ms=ms, plain_ms=plain, bound_ms=bound, library_ms=lib,
                               main=(f == 100 and placement == "pinned"
                                     and main_input[name] == (idx_key, pos_key)))
                    rows.append(row)
                    log(f"  {name:22s} F={f:3d} {placement:6s} {idx_key:4s} rows={row['rows']:8d} "
                        f"hit={row['hit_rate']:.3f} kernel {ms:8.3f} ms  bound {bound:8.3f} ms  "
                        f"ref.py {plain:9.3f} ms  index_select {lib:7.3f} ms  equal")
                del want
    # Edge cases on small inputs, against ref.py, from both host placements.
    case = inputs[602]
    hot = case["hot"]
    n_hot, n_host = hot.shape[0], case["host"].shape[0]
    s = 64
    ar = torch.arange(s, dtype=torch.int32, device="cuda")
    edge = {
        "all-hit": (ar, ar),
        "all-miss": (ar, torch.full((s,), -1, dtype=torch.int32, device="cuda")),
        "out-of-range": (torch.tensor([0, n_host - 1, n_host, 10**9, -5] * 4, dtype=torch.int32,
                                      device="cuda"),
                         torch.tensor([-1, n_hot - 1, n_hot, 10**9, -9] * 4, dtype=torch.int32,
                                      device="cuda")),
        "empty": (ar[:0], ar[:0]),
    }
    for host in (case["host"], case["host_dev"]):
        for label, (idx, pos) in edge.items():
            want = cached_gather_ref(hot, host, idx, pos)
            for name, fn in kernels.items():
                if not torch.equal(fn(hot, host, idx, pos), want):
                    raise AssertionError(f"{name} disagrees with ref.py on the {label} case")
    log(f"  edge cases {sorted(edge)}, pinned and device host: all three kernels equal ref.py")
    return max_err, rows


def main_path_phase(eng) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels.cached_gather import kernel as tk

    phase(f"5. main path: GraphSAGE 3x128, fanouts {FANOUTS}, batch {BATCH}, "
          f"{MAIN_BATCHES} batches per route")
    routes = {
        "kernel_d1": EngineConfig(use_kernel=True, pipeline_depth=1),
        "kernel_d2": EngineConfig(use_kernel=True, pipeline_depth=2),
        "kernel_dedup_d1": EngineConfig(use_kernel=True, dedup=True, pipeline_depth=1),
        "kernel_dedup_d2": EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2),
        "table_d1": EngineConfig(use_kernel=False, pipeline_depth=1),
    }
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    torch.cuda.reset_peak_memory_stats()
    reports, outputs, route_launches = {}, {}, {}
    for label, cfg in routes.items():
        # Counts set to 0 just before each route and read just after it;
        # the run is MAIN_BATCHES batches plus one warmup batch.
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        rep = eng.run(config=cfg, max_batches=MAIN_BATCHES, collect_outputs=True)
        wall = time.perf_counter() - t0
        route_launches[label] = {fn.__name__: fn.launches for fn in counters}
        out = np.stack(eng.last_outputs)
        if out.shape != (MAIN_BATCHES, BATCH, eng.dataset.spec.num_classes) or not np.isfinite(
            out
        ).all():
            raise AssertionError(f"{label}: logits of shape {out.shape}, finite={np.isfinite(out).all()}")
        outputs[label] = out
        reports[label] = dict(rep.summary(), wall_s=wall)
        log(f"  {label:16s} sample {rep.sample_seconds:.4f} s  feature {rep.feature_seconds:.4f} s  "
            f"compute {rep.compute_seconds:.4f} s  total {rep.total_seconds:.4f} s  "
            f"adj hit {rep.adj_hit_rate:.4f}  feat hit {rep.feat_hit_rate:.4f}  "
            f"(run incl. warmup {wall:.2f} s)")
    launches = {fn.__name__: sum(r[fn.__name__] for r in route_launches.values()) for fn in counters}
    per_batch = {name: max(r[name] for r in route_launches.values()) / (MAIN_BATCHES + 1)
                 for name in launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches per route: {route_launches}")
    log(f"  launches on the main path: {launches}; per batch on the route that uses each: "
        f"{per_batch}; max_memory_allocated {peak / 1e9:.2f} GB")
    first = outputs["kernel_d2"]
    for label, out in outputs.items():
        if not np.array_equal(out, first):
            raise AssertionError(f"logits of {label} differ from kernel_d2")
    log(f"  logits identical across {sorted(outputs)}")
    if launches["cached_gather"] == 0 or launches["cached_gather_blocks"] == 0:
        raise AssertionError(f"a main-path kernel was never launched: {launches}")
    return {"reports": reports, "launches": launches, "route_launches": route_launches,
            "launches_per_batch": per_batch, "max_memory_allocated": peak}


def cli_phase() -> dict:
    phase("6. CLI")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.infer_gnn", "--use-kernel", "--max-batches", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"CLI failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    rep = json.loads(proc.stdout)
    if rep["device"] != "cuda:0" or rep["batches"] != 2:
        raise AssertionError(f"unexpected CLI report: {rep}")
    log(f"  infer_gnn --use-kernel --max-batches 2: ok in {time.perf_counter() - t0:.1f} s, "
        f"feat hit {rep['feat_hit_rate']:.4f}, total {rep['total_s']:.4f} s")
    return rep


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        # graph/datasets.py seeds each graph with hash(name), which Python
        # salts per process: with a fixed hash seed every run builds the
        # same graph.  exec replaces this process; it starts no other.
        script = str(pathlib.Path(__file__).resolve())
        os.execve(sys.executable, [sys.executable, script, *sys.argv[1:]],
                  dict(os.environ, PYTHONHASHSEED="0"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "cached_gather.cu").is_file():
        print(f"chip_smoke: no repro_torch sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    device = device_phase()
    build = build_phase()
    ds, eng, setup = setup_phase()
    inputs = kernel_inputs(eng)
    max_err, rows = kernel_phase(inputs, build["h2d_bytes_per_s"])
    feature_stage = feature_stage_phase(eng, inputs[100])
    del inputs
    torch.cuda.empty_cache()
    main_path = main_path_phase(eng)
    cli = cli_phase()

    kernels = []
    for row in rows:
        if row["main"]:
            name = row["kernel"]
            kernels.append({
                "name": name, "route": "cuda", "source": "src/repro_torch/csrc/cached_gather.cu",
                "replaces": REPLACES[name], "launches": main_path["launches"][name],
                "max_abs_err": max_err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": row["library_ms"],
            })
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "device": device, "build": build, "setup": setup, "kernel_rows": rows,
        "feature_stage": feature_stage, "main_path": main_path, "cli": cli, "kernels": kernels,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"done in {time.perf_counter() - t_start:.1f} s; details in chiprun_out/chip_smoke.json")
    log(device["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                           "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
