#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
under ``/usr/local/cuda`` (or on ``PATH``) and PyTorch built for CUDA.
Imports nothing of JAX and nothing of the JAX package.  Phases, none of
whose errors is caught:

1. device: the card's name and power limit;
2. build: compile the three sources of ``src/repro_torch/csrc/``
   (``cached_gather.cu``, ``seg_agg.cu``, ``flash_attention.cu``) with
   ``nvcc``, one process each, all started together, print the build
   time and each kernel's registers, static shared memory and spills
   from ``-Xptxas -v``, and kernel #3's ring (its dynamic shared memory
   per CTA and CTAs per SM at the F = 100 and F = 602 row widths);
   measure the pinned host→device copy rate;
3. main-path setup: ``load_dataset("ogbn-products", scale=1.0)`` (Table II
   size) and ``prepare("dci", total_cache_bytes=256 MB)`` on the card
   (presampling gathers through kernel #1, so this also sets the Eq. 1
   split the card's own feature route implies);
4. kernel parity: the three gather kernels against ``ref.py``
   (``torch.equal``) at the main-path shape — one batch of 1024 seeds at
   fan-outs 15,10,5 gives 1024·16·11·6 = 1,081,344 input rows — for
   ``F = 100`` (the prepared ogbn-products store and a sampled frontier)
   and ``F = 602`` (reddit-sized synthetic tables), with the host table
   pinned on the CPU and on the card, plus all-hit, all-miss, empty and
   out-of-range cases; each kernel timed with CUDA events beside
   ``ref.py``, ``torch.index_select`` on a device-resident table, and the
   bytes bound (PCIe at the card's published Gen5 x16 peak); then #1, #2
   and #3 split into their HBM side (every row forced to hit, beside
   ``index_select`` on the hot table) and their PCIe side (every row
   missing, beside the miss bytes over the measured pinned rate) — #3's
   all-hit time must stay near #1's, which shows that it no longer reads
   the losing host row —, #1 on
   the miss rows alone (every occurrence against each distinct row
   once), and #2's in-kernel block modes against ``classify_blocks``;
   then the device work of one batch's feature stage on the plain and
   the dedup kernel route, with the dedup sort and the former wrapper
   classification alone, and the prefetch staging of one batch's misses
   (host clock, with its device→host id read alone), whose pack #1 and
   #2 must read to the same rows;
5. B4, ``seg_agg``: against ``ref.py`` in float32 and bfloat16 on the
   edge shapes of tests/test_kernels.py and at the main path's
   first-layer shape ``[180224, 5, 100]`` (1,081,344 frontier rows
   reduced to 180,224 destination nodes), timed beside ``ref.py``,
   ``x.sum(1)`` and its bytes bound;
6. B5, ``flash_attention``: against ``ref.py`` on the cases of
   tests/test_kernels.py in float32 and bfloat16, GQA included, and at
   Gemma-2 27B's attention shape (B 1, Hq 32, Hkv 16, D 128, bf16,
   S 4096, causal, window 4096, softcap 50) and its decode shape (Sq 1),
   where the per-design counters must show the prefill on the tensor-core
   kernel (``wgmma``) and the decode on the split-key kernel (``split``).
   Every bfloat16 output is held twice: against ``ref.py`` in bfloat16
   (5e-2) and against ``ref.py`` in float32 on the same inputs (rtol
   2e-2, atol 2e-3); at the Gemma-2 shapes the float32 kernel also runs
   on the upcast inputs against ``ref.py`` in float32 (3e-4) and is
   timed.  Timed beside ``ref.py``, ``flex_attention`` (compiled once,
   before the timing) with the same softcap and mask — the library time
   —, ``scaled_dot_product_attention`` at the same shapes without
   softcap, and the bound (bf16 tensor-core peak, bytes); the kernel
   also in a CUDA graph (device time without the host's per-call cost),
   with TFLOP/s at prefill and GB/s at decode beside the card's peaks;
7. the ops path: ``repro_torch.kernels.aggregate_neighbors`` at the
   main path's shape and ``multi_head_attention`` at both Gemma-2 shapes,
   with the counters of B4 and B5 set to 0 just before and read just
   after (each must be > 0; B5's prefill on ``wgmma``, its decode on
   ``split``);
8. main path: GraphSAGE (3 layers, hidden 128) through
   ``GNNInferenceEngine`` on the kernel route, with and without dedup and
   with and without prefetch, at depth 1 (stages synchronized) and
   depth 2, and the table route at depth 1 — one prepared pipeline, one
   seed; logits and hit counts must be identical, and the launch
   counters of kernels #1 and #2 (set to 0 just before each route and
   read just after) must be > 0;
9. the CLI, as subprocesses: ``--use-kernel --prefetch``, ``--policy
   rain`` and ``--mode layerwise --scale 0.01``;
10. baselines: ``prepare("ducati", 256 MB)`` and ``prepare("rain")`` on
   phase 3's dataset beside phase 3's ``dci``, with each ``prep_seconds``
   and DUCATI's knapsack split; 8 batches of each on the kernel route at
   depth 1 — DUCATI also with dedup, RAIN also on the table route and
   with dedup requested (its report must say dedup off) — identical
   logits and hit counts per policy, #1 (or #2 under dedup) launched;
11. layer-wise: GraphSAGE 3x128 over all 2,449,029 nodes at chunk 4096 on
   the ``dci`` pipeline, the kernel route at depth 2 twice and with
   prefetch at the first run's Eq. 1 split — outputs ``[N, 47]`` and
   feature / embedding hits bit-identical, lookups exactly ``N + E`` per
   layer, #2 launched; #2's in-kernel block modes on every chunk's
   index vector against ``classify_blocks``, and every chunk's gather
   alone through #2 and #1 (pinned host table) and #2 (host table on
   the card), timed with CUDA events; then the table route
   against the kernel route at depth 1 at scale 0.1 (the host gather of
   every miss row is slow at full size).

The script re-executes itself with ``PYTHONHASHSEED=0`` first, so the
dataset (seeded through ``hash(name)``) is the same graph in every run.
Bounds use the published peaks of the card ``nvidia-smi`` names
(``CARD_PEAKS``).  The details go to ``chiprun_out/chip_smoke.json``.
The last three lines are the card (as ``nvidia-smi`` reports it), the
kernels' JSON line and ``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import pathlib
import statistics
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
BASELINE_BATCHES = 8
LAYERWISE_CHUNK = 4096  # the reference CLI's default chunk
LAYERWISE_CUT = 0.1  # the scale of the table-route layer-wise check
SEG_SHAPE = (180_224, 5, 100)  # first GraphSAGE layer: 1024*16*11 dst nodes, fanout 5, F 100
# Gemma-2 27B attention (src/repro/configs/gemma2_27b.py): prefill and decode.
GEMMA = dict(b=1, hq=32, hkv=16, d=128, s=4096, window=4096, softcap=50.0)
SEG_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
ATT_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
# The bfloat16 kernel against ref.py computed in float32 from the same
# bfloat16 inputs (rtol, atol): the kernel rounds only p and its output to
# bfloat16, about 2**-9 relative, so this holds late rows whose |out| is
# near 0.03, where the 5e-2 parity check above could not see a dropped
# key tile.
ATT_TOL_BF16_F32 = (2e-2, 2e-3)
# Kernel #3's all-hit time over #1's on the pinned frontier, at most: both
# read only hot rows there, while reading the losing host row of every row
# too would add the PCIe time of every row (the phase prints it).  The
# ratio is the median of SELECT_RATIO_TRIALS device-only timings of each,
# taken in turns (device_ms).
SELECT_ALL_HIT_RATIO = 1.3
SELECT_RATIO_TRIALS = 5
# Device cycles the card spins (torch.cuda._sleep) before device_ms's first
# event: about 20 ms at the H100's 1.98 GHz, long enough for the host to
# queue every timed call behind it.
QUEUE_AHEAD_CYCLES = 40_000_000
REPLACES = {
    "cached_gather": "src/repro/kernels/cached_gather/kernel.py:152",
    "cached_gather_blocks": "src/repro/kernels/cached_gather/kernel.py:347",
    "cached_gather_select": "src/repro/kernels/cached_gather/kernel.py:500",
    "seg_agg": "src/repro/kernels/seg_agg/kernel.py:32",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:94",
}
SOURCES = {
    "cached_gather": "src/repro_torch/csrc/cached_gather.cu",
    "cached_gather_blocks": "src/repro_torch/csrc/cached_gather.cu",
    "cached_gather_select": "src/repro_torch/csrc/cached_gather.cu",
    "seg_agg": "src/repro_torch/csrc/seg_agg.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s and
# device-memory bytes/s, by a substring of the name nvidia-smi reports.
CARD_PEAKS = {
    "H100 PCIe": (756e12, 2.0e12),
    "H100 NVL": (835e12, 3.9e12),
    "H100": (989e12, 3.35e12),  # SXM (the "H100 80GB HBM3")
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


def device_ms(fn, reps: int) -> float:
    """Like :func:`cuda_ms`, but every call is queued behind a device spin
    before the first event is recorded, so the card runs the calls back to
    back and a pause of the host between two launches (a call of 0.2 ms
    next to a host stall of 0.5 ms) is not counted as the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
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


def card_peaks(name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card, from CARD_PEAKS."""
    return next(v for k, v in CARD_PEAKS.items() if k in name)


def build_phase() -> dict:
    import torch

    from repro_torch.kernels._build import build_library
    from repro_torch.kernels.cached_gather import kernel as cg
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.seg_agg import kernel as sa
    from repro_torch.runtime.gnn_engine import HBM3_BW, PCIE5_BW

    phase("2. build")
    t0 = time.perf_counter()
    names = ("cached_gather", "seg_agg", "flash_attention")
    # One nvcc per source, all started together; each call raises on failure.
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build_library, names)))
    for mod in (cg, sa, fa):
        mod.load_library()
    build_s = time.perf_counter() - t0
    log(f"built {len(names)} libraries in {build_s:.1f} s (in parallel); ptxas -v, per kernel:")
    ptxas = {}
    for name, (lib, report) in built.items():
        log(f"  {lib.relative_to(ROOT)}")
        ptxas[name] = ptxas_summary(report)
        for entry in ptxas[name]:
            log(f"    {entry['kernel']}: {entry['registers']} registers, {entry['smem']} B static "
                f"shared memory, spill stores {entry['spill_stores']} B, loads "
                f"{entry['spill_loads']} B")
    # Kernel #3's ring in dynamic shared memory, at the main path's row and
    # reddit's (f32 and bf16), and the CTAs per SM it leaves room for.
    select_ring = {}
    for label, row_bytes, vec in (("F=100 f32", 400, 16), ("F=602 f32", 2408, 8),
                                  ("F=602 bf16", 1204, 4)):
        rows, unroll, stages = cg._select_ring(row_bytes, vec)
        smem = cg._select_smem(vec, unroll, stages)
        ring = dict(vec=vec, chunk_rows=rows, unroll=unroll, stages=stages, dynamic_smem=smem,
                    ctas_per_sm=cg._ctas_per_sm(cg.KIND_SELECT, vec, smem))
        select_ring[label] = ring
        log(f"  cached_gather_select ring, {label} ({row_bytes} B rows, {vec} B vectors): "
            f"{stages} stages of 32 x {unroll} vectors per warp, chunks of {rows} rows; dynamic "
            f"shared memory {smem} B per CTA, {ring['ctas_per_sm']} CTAs per SM")
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
    return {"build_s": build_s, "h2d_bytes_per_s": h2d, "ptxas": ptxas,
            "select_ring": select_ring}


def ptxas_summary(report: str) -> list[dict]:
    """Registers, static shared memory and spills of each kernel in an
    ``-Xptxas -v`` report, the names demangled by ``c++filt`` where the
    toolchain has it."""
    import re
    import shutil

    entries, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes", line)
            entries.append({"kernel": name, "spill_stores": int(nums[1]),
                            "spill_loads": int(nums[2])})
        elif name and "Used" in line and "registers" in line and entries:
            entries[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entries[-1]["smem"] = int(smem.group(1)) if smem else 0
    filt = shutil.which("c++filt")
    if filt and entries:
        names = subprocess.run([filt], input="\n".join(e["kernel"] for e in entries),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for entry, pretty in zip(entries, names):
            entry["kernel"] = (pretty.replace("(anonymous namespace)::", "").split("(")[0]
                               .removeprefix("void "))
    return entries


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
    sort (run in the sample stage), ``classify_blocks`` (the torch ops
    the former wrapper of #2 ran before each launch; the kernel now
    classifies itself, so this is off the path and timed as the former
    wrapper's cost), and the whole feature stage of the plain and the
    dedup kernel route."""
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
    log("  feature-stage device work, one batch (CUDA events, mean of 5; classify_ms is the former "
        "wrapper cost, off the path): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    # Prefetch staging of the same batch's misses, on the host clock (it
    # reads the ids back, packs on the host and copies on a side stream),
    # and the device->host id read alone.  #1 and #2 must read the pack
    # to the rows they gather from the pinned table.
    nu = int(dd.num_unique)
    for label, gather_ids, live, row_block in (("full", ids, None, None),
                                               ("dedup", uids, nu, ROW_BLOCK)):
        want, _ = store.gather(gather_ids, use_kernel=True, row_block=row_block)
        laps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = store.prefetch_misses(gather_ids, num_live=live)
            staged.ready.synchronize()
            laps.append(time.perf_counter() - t0)
        got, _ = store.gather(gather_ids, use_kernel=True, row_block=row_block, prefetched=staged)
        n = gather_ids.shape[0] if live is None else live
        if not torch.equal(got[:n], want[:n]):
            raise AssertionError(f"the {label} gather from the prefetched pack disagrees")
        times[f"prefetch_{label}_ms"] = 1e3 * min(laps)
        times[f"prefetch_{label}_rows"] = staged.num_miss
        times[f"prefetch_{label}_pack_rows"] = int(staged.rows.shape[0])
    laps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids.cpu()
        laps.append(time.perf_counter() - t0)
    times["id_read_ms"] = 1e3 * min(laps)
    log(f"  prefetch staging, one batch (host clock, best of 3): full frontier "
        f"{times['prefetch_full_ms']:.3f} ms for {times['prefetch_full_rows']} miss rows "
        f"(pack {times['prefetch_full_pack_rows']}), dedup {times['prefetch_dedup_ms']:.3f} ms for "
        f"{times['prefetch_dedup_rows']} (pack {times['prefetch_dedup_pack_rows']}); the "
        f"{ids.numel() * 4 / 1e6:.1f} MB id read alone {times['id_read_ms']:.3f} ms; "
        "#1 and #2 read the packs to equal rows")
    return times


def seg_agg_phase(hbm: float) -> tuple[dict, float]:
    """B4 against ref.py on the edge shapes and the main-path shape, and
    its times there.  Returns (main-shape row, max abs err)."""
    import torch

    from repro_torch.kernels.seg_agg import kernel as sa
    from repro_torch.kernels.seg_agg.ref import seg_agg_ref

    phase(f"5. B4 seg_agg: parity and timing at {SEG_SHAPE}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    max_err = 0.0
    shapes = [(32, 5, 128), (7, 2, 602), (100, 15, 64), (1, 1, 1), SEG_SHAPE]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for mode in ("sum", "mean"):
                got = sa.seg_agg(x, mode=mode)
                want = seg_agg_ref(x, mode=mode)
                torch.cuda.synchronize()
                tol = SEG_TOL[str(dtype).split(".")[1]]
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
                max_err = max(max_err, float((got.float() - want.float()).abs().max()))
    log(f"  {len(shapes)} shapes x f32/bf16 x sum/mean equal ref.py within 1e-6 / 2e-2; "
        f"max abs err {max_err:.3g}")
    x = torch.randn(SEG_SHAPE, generator=gen, device="cuda")
    s, _, f = SEG_SHAPE
    nbytes = (x.numel() + s * f) * x.element_size()
    row = dict(shape=list(SEG_SHAPE), dtype="float32", mode="sum",
               ms=cuda_ms(lambda: sa.seg_agg(x), reps=20),
               plain_ms=cuda_ms(lambda: seg_agg_ref(x), reps=20),
               library_ms=cuda_ms(lambda: x.sum(1), reps=20),
               bound_ms=1e3 * nbytes / hbm, bytes=nbytes)
    log(f"  [{s}, 5, {f}] f32 sum: kernel {row['ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
        f"({nbytes} B)  ref.py {row['plain_ms']:.4f} ms  x.sum(1) {row['library_ms']:.4f} ms")
    return row, max_err


def kept_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    import numpy as np

    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, i + 1) if causal else np.full(sq, sk, np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def gemma_inputs(sq: int):
    import torch

    g = GEMMA
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31 + sq)
    q = torch.randn((g["b"], g["hq"], sq, g["d"]), generator=gen, device="cuda")
    k, v = (torch.randn((g["b"], g["hkv"], g["s"], g["d"]), generator=gen, device="cuda")
            for _ in range(2))
    return q.bfloat16(), k.bfloat16(), v.bfloat16()


def flex_library(sq: int, sk: int, causal: bool, window: int | None, softcap: float):
    """The one PyTorch call that computes B5's function: ``flex_attention``
    with Gemma-2's softcap as its score_mod (applied to the scaled score
    before the mask, as the kernel does) and the causal/window mask as a
    block mask, compiled here, once."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, qi, ki):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, qi, ki):
        keep = qi >= ki if causal else qi >= 0
        return keep & (qi - ki < window) if window is not None else keep

    block_mask = create_block_mask(mask_mod, None, None, sq, sk, device="cuda")
    compiled = torch.compile(flex_attention, dynamic=False)
    return lambda q, k, v: compiled(q, k, v, score_mod=score_mod, block_mask=block_mask,
                                    enable_gqa=True)


def check_attention(got, q, k, v, kw) -> float:
    """Hold one kernel output against ref.py on the same inputs in their
    dtype, and a bfloat16 output also against ref.py in float32; returns
    the max abs error against the same-dtype ref.py."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

    hq = q.shape[1]
    want = attention_ref(q, expand_kv(k, hq), expand_kv(v, hq), **kw)
    tol = ATT_TOL[str(q.dtype).split(".")[1]]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = float((got.float() - want.float()).abs().max())
    if q.dtype == torch.bfloat16:
        del want
        want = attention_ref(q.float(), expand_kv(k.float(), hq), expand_kv(v.float(), hq), **kw)
        rtol, atol = ATT_TOL_BF16_F32
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    return err


def attention_phase(peaks: tuple[float, float]) -> tuple[dict, float]:
    """B5 against ref.py on the kernel tests' cases and at Gemma-2 27B's
    shapes, and its times there.  Returns (rows by shape, max abs err
    against ref.py in the inputs' dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

    phase("6. B5 flash_attention: parity and timing at Gemma-2 27B's shapes")
    torch.backends.cuda.matmul.allow_tf32 = False  # ref.py's float32 products in full fp32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    cases = [  # tests/test_kernels.py:205-214, the decode case :249-256, a GQA case
        (1, 1, 1, 128, 128, 64, True, None, None), (1, 1, 1, 256, 256, 128, True, None, 50.0),
        (1, 1, 1, 200, 200, 64, True, 64, None), (1, 1, 1, 128, 128, 64, False, None, None),
        (1, 1, 1, 96, 160, 64, False, None, None), (1, 1, 1, 64, 64, 128, True, 16, 30.0),
        (1, 1, 1, 1, 1024, 64, False, None, None), (2, 8, 2, 64, 64, 32, True, None, None),
        (1, 1, 1, 200, 64, 32, False, 64, None),
    ]
    max_err = 0.0
    for b, hq, hkv, sq, sk, d, causal, window, cap in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=cap)
            got = fa.flash_attention(q, k, v, **kw)
            max_err = max(max_err, check_attention(got, q, k, v, kw))
    log(f"  {len(cases)} cases x f32/bf16 equal ref.py within 3e-4 / 5e-2, and bf16 ref.py "
        f"in f32 within rtol 2e-2 atol 2e-3; max abs err {max_err:.3g}")
    g = GEMMA
    bf16_peak, hbm = peaks
    rows = {}
    for label, sq, causal, design, design32 in (("prefill", g["s"], True, "wgmma", "fma"),
                                                ("decode", 1, False, "split", "split")):
        q, k, v = gemma_inputs(sq)
        kw = dict(causal=causal, window=g["window"], softcap=g["softcap"])
        err = check_attention(designed_call(fa, design, q, k, v, kw), q, k, v, kw)
        max_err = max(max_err, err)
        # The float32 kernel on the same inputs, upcast: the tight check of
        # this shape's GQA indexing and of every key tile.
        q32, k32, v32 = q.float(), k.float(), v.float()
        err32 = check_attention(designed_call(fa, design32, q32, k32, v32, kw), q32, k32, v32, kw)
        f32_ms = cuda_ms(lambda: fa.flash_attention(q32, k32, v32, **kw), reps=2 if sq > 1 else 5)
        del q32, k32, v32
        library = flex_library(sq, g["s"], causal, g["window"], g["softcap"])
        lib_out = library(q, k, v)
        lib_err = check_attention(lib_out, q, k, v, kw)
        del lib_out
        torch.cuda.empty_cache()
        pairs = g["b"] * g["hq"] * kept_pairs(sq, g["s"], causal, g["window"])
        flops = 4 * g["d"] * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read, out written
        bound = 1e3 * max(flops / bf16_peak, nbytes / hbm)
        nocap = dict(causal=causal, window=g["window"] if causal else None)
        row = dict(
            shape=[g["b"], g["hq"], g["hkv"], sq, g["s"], g["d"]], causal=causal,
            window=g["window"], softcap=g["softcap"], flops=flops, bytes=nbytes, max_abs_err=err,
            f32_max_abs_err=err32, library_max_abs_err=lib_err,
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=5),
            plain_ms=cuda_ms(lambda: attention_ref(
                q, expand_kv(k, g["hq"]), expand_kv(v, g["hq"]), **kw), reps=2),
            library_ms=cuda_ms(lambda: library(q, k, v), reps=5),
            bound_ms=bound, bound_by="operations" if flops / bf16_peak > nbytes / hbm else "bytes",
            nocap_ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **nocap), reps=5),
            sdpa_nocap_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=5),
            graph_ms=graph_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=20),
            f32_ms=f32_ms, design=design, f32_design=design32,
        )
        row.update(tflops=flops / row["ms"] / 1e9, flops_share=flops / row["ms"] / 1e-3 / bf16_peak,
                   gbs=nbytes / row["graph_ms"] / 1e6, hbm_share=nbytes / row["graph_ms"] / 1e-3 / hbm)
        rows[label] = row
        log(f"  {label} {row['shape']} bf16 causal={causal} window {g['window']} softcap "
            f"{g['softcap']} ({design}): kernel {row['ms']:.4f} ms (in a CUDA graph "
            f"{row['graph_ms']:.4f})  bound {bound:.4f} ms ({row['bound_by']}, "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  ref.py {row['plain_ms']:.3f} ms  "
            f"flex_attention {row['library_ms']:.4f} ms; f32 ({design32}) {f32_ms:.4f} ms; without "
            f"softcap: kernel {row['nocap_ms']:.4f} ms  scaled_dot_product_attention "
            f"{row['sdpa_nocap_ms']:.4f} ms")
        if label == "prefill":
            log(f"    {row['tflops']:.1f} TFLOP/s, {100 * row['flops_share']:.1f}% of the bf16 "
                f"peak {bf16_peak / 1e12:.0f} TFLOP/s")
        else:
            log(f"    {row['gbs']:.1f} GB/s in the graph, {100 * row['hbm_share']:.1f}% of HBM's "
                f"{hbm / 1e12:.2f} TB/s ({nbytes / row['ms'] / 1e6:.1f} GB/s per eager call)")
        log(f"    max abs err vs ref.py: bf16 kernel {err:.3g} (also within rtol 2e-2 atol 2e-3 "
            f"of ref.py in f32), f32 kernel {err32:.3g} (within 3e-4), flex_attention {lib_err:.3g}")
    return rows, max_err


def designed_call(fa, design: str, q, k, v, kw):
    """One ``flash_attention`` call that must go through ``design``: the
    per-design counters, set to 0 just before, read just after."""
    fa.flash_attention.design_launches = dict.fromkeys(fa.DESIGNS, 0)
    out = fa.flash_attention(q, k, v, **kw)
    counts = dict(fa.flash_attention.design_launches)
    if counts != {**dict.fromkeys(fa.DESIGNS, 0), design: 1}:
        raise AssertionError(f"{tuple(q.shape)} {q.dtype} should take {design}: {counts}")
    return out


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``reps`` calls captured in one CUDA
    graph and replayed: the device's time without the host's per-call
    cost (which a short call's eager timing measures instead)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5) / reps


def ops_path_phase() -> dict:
    """The slice's ops path: the public ops of repro_torch.kernels at the
    shapes above, with B4's and B5's counters set to 0 just before and
    read just after."""
    import torch

    from repro_torch.kernels import aggregate_neighbors, multi_head_attention
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.seg_agg import kernel as sa

    phase("7. ops path: aggregate_neighbors and multi_head_attention (repro_torch.kernels)")
    x = torch.randn(SEG_SHAPE, generator=torch.Generator(device="cuda").manual_seed(SEED + 51),
                    device="cuda")
    inputs = {label: gemma_inputs(sq) for label, sq in (("prefill", GEMMA["s"]), ("decode", 1))}
    g = GEMMA
    counters = (sa.seg_agg, fa.flash_attention)
    for fn in counters:
        fn.launches = 0
    fa.flash_attention.design_launches = dict.fromkeys(fa.DESIGNS, 0)
    agg = aggregate_neighbors(x, mode="mean", use_kernel=True)
    outs = {label: multi_head_attention(q, k, v, causal=label == "prefill", window=g["window"],
                                        softcap=g["softcap"], use_kernel=True)
            for label, (q, k, v) in inputs.items()}
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    designs = dict(fa.flash_attention.design_launches)
    if agg.shape != (SEG_SHAPE[0], SEG_SHAPE[2]) or not bool(torch.isfinite(agg).all()):
        raise AssertionError(f"aggregate_neighbors gave {tuple(agg.shape)}, finite="
                             f"{bool(torch.isfinite(agg).all())}")
    for label, out in outs.items():
        if out.shape != inputs[label][0].shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"multi_head_attention ({label}) gave {tuple(out.shape)}")
    if min(launches.values()) == 0:
        raise AssertionError(f"an ops-path kernel was never launched: {launches}")
    if designs != {"fma": 0, "wgmma": 1, "split": 1}:  # prefill, decode
        raise AssertionError(f"B5 designs on the ops path: {designs}")
    log(f"  launches on the ops path: {launches}, B5 by design {designs}; outputs finite, shapes "
        f"{tuple(agg.shape)}, {[tuple(o.shape) for o in outs.values()]}")
    return launches


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


def split_phase(case, h2d) -> dict:
    """Phase 4, continued: what holds the gathers back at the main shape
    (the prepared ogbn-products store, F = 100, pinned host).  Each kernel
    on its main input (#1 and #3 the frontier, #2 the dedup bucket) as the
    path gives it, with every row forced to hit (slot = id mod H: the HBM
    side; the kernel then computes exactly ``torch.index_select(hot, 0,
    slot)``, timed as its same-function library time) and with every row
    missing (slot -1: the PCIe side, beside its bytes over the measured
    pinned copy rate).  #3's all-hit time must be within
    ``SELECT_ALL_HIT_RATIO`` of #1's, each the median of device-only
    timings taken in turns: a kernel that read the losing host row too
    would pay the PCIe read of every row there.  Then #1 on the
    frontier's miss rows alone, every occurrence
    against each distinct row once: per-row times that agree would mean
    the L2 keeps sysmem lines.  Then #2's in-kernel classification against
    ``classify_blocks``.  Every output equals ref.py."""
    import torch

    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK
    from repro_torch.kernels.cached_gather.ref import cached_gather_ref

    hot, host = case["hot"], case["host"]
    n_hot, row = hot.shape[0], hot.shape[1] * hot.element_size()

    def checked_ms(fn, h, idx, pos, reps=5):
        if not torch.equal(fn(hot, h, idx, pos), cached_gather_ref(hot, h, idx, pos)):
            raise AssertionError(f"{fn.__name__} disagrees with ref.py in the split phase")
        return cuda_ms(lambda: fn(hot, h, idx, pos), reps=reps)

    rows = []
    for name, fn, (ik, pk) in (("cached_gather", tk.cached_gather, ("ids", "pos")),
                               ("cached_gather_blocks", tk.cached_gather_blocks, ("uids", "upos")),
                               ("cached_gather_select", tk.cached_gather_select, ("ids", "pos"))):
        idx = case[ik]
        for variant, pos in (("main", case[pk]),
                             ("all-hit", (idx % n_hot).to(torch.int32)),
                             ("all-miss", torch.full_like(idx, -1))):
            hit = pos >= 0
            miss_rows = int((~hit).sum())
            r = dict(kernel=name, variant=variant, rows=int(idx.shape[0]), miss_rows=miss_rows,
                     ms=checked_ms(fn, host, idx, pos, reps=3 if variant == "all-miss" else 5),
                     bound_ms=bound_ms(hot, idx, pos, True, h2d),
                     miss_bytes_over_h2d_ms=1e3 * miss_rows * row / h2d)
            if variant == "all-hit":
                r["library_ms"] = cuda_ms(lambda: torch.index_select(hot, 0, pos), reps=5)
            rows.append(r)
            log(f"  {name:22s} {variant:8s} rows={r['rows']:8d} miss={miss_rows:8d} kernel "
                f"{r['ms']:8.3f} ms  bound {r['bound_ms']:7.3f} ms  miss bytes / pinned rate "
                f"{r['miss_bytes_over_h2d_ms']:8.3f} ms"
                + (f"  index_select(hot) {r['library_ms']:.3f} ms" if "library_ms" in r else ""))
    # The gate: device-only times of #1 and #3 on the all-hit input, in
    # turns, and the median of each.
    idx, pos = case["ids"], (case["ids"] % n_hot).to(torch.int32)
    trials = {"cached_gather": [], "cached_gather_select": []}
    for _ in range(SELECT_RATIO_TRIALS):
        for name, fn in (("cached_gather", tk.cached_gather),
                         ("cached_gather_select", tk.cached_gather_select)):
            trials[name].append(device_ms(lambda: fn(hot, host, idx, pos), reps=5))
    all_hit = {k: statistics.median(v) for k, v in trials.items()}
    ratio = all_hit["cached_gather_select"] / all_hit["cached_gather"]
    log(f"  #3 all-hit / #1 all-hit: {ratio:.3f} (at most {SELECT_ALL_HIT_RATIO}; medians of "
        f"{SELECT_RATIO_TRIALS} device-only timings, #1 {all_hit['cached_gather']:.3f} ms, #3 "
        f"{all_hit['cached_gather_select']:.3f} ms; reading every losing host row would take "
        f"{1e3 * case['ids'].shape[0] * row / h2d:.3f} ms at the pinned rate)")
    if ratio > SELECT_ALL_HIT_RATIO:
        raise AssertionError(f"#3's all-hit gather takes {ratio:.3f}x #1's")
    occ = case["ids"][case["pos"] < 0]
    dist = torch.unique(occ).to(torch.int32)
    miss = {}
    for label, idx in (("occurrences", occ), ("distinct", dist)):
        ms = checked_ms(tk.cached_gather, host, idx, torch.full_like(idx, -1))
        miss[label] = dict(rows=int(idx.shape[0]), ms=ms, bytes_per_s=idx.shape[0] * row / (ms / 1e3),
                           us_per_krow=1e3 * ms / (idx.shape[0] / 1e3))
    log(f"  #1 on the miss rows alone: every occurrence {miss['occurrences']['rows']} rows "
        f"{miss['occurrences']['ms']:.3f} ms ({miss['occurrences']['bytes_per_s'] / 1e9:.2f} GB/s), "
        f"each distinct row once {miss['distinct']['rows']} rows {miss['distinct']['ms']:.3f} ms "
        f"({miss['distinct']['bytes_per_s'] / 1e9:.2f} GB/s); pinned copy {h2d / 1e9:.2f} GB/s")
    # #2's classification, done in the kernel, against the plain rule.
    uids, upos = case["uids"], case["upos"]
    want_mode, _ = tk.classify_blocks(uids, upos, n_hot, host.shape[0], ROW_BLOCK)
    modes = torch.full_like(want_mode, -1)
    tk._launch_blocks(hot, host, uids, upos, ROW_BLOCK, modes=modes)
    torch.cuda.synchronize()
    if not torch.equal(modes, want_mode):
        raise AssertionError("kernel #2's in-kernel block modes differ from classify_blocks")
    counts = [int((want_mode == m).sum()) for m in range(3)]
    log(f"  #2 in-kernel modes equal classify_blocks: {counts[0]} per-row blocks, {counts[1]} hot "
        f"spans, {counts[2]} host spans of {len(want_mode)}")
    return {"rows": rows, "select_all_hit_ratio": ratio, "select_all_hit_trials_ms": trials,
            "miss_only": miss, "block_modes": counts}


def main_path_phase(eng) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels.cached_gather import kernel as tk

    phase(f"8. main path: GraphSAGE 3x128, fanouts {FANOUTS}, batch {BATCH}, "
          f"{MAIN_BATCHES} batches per route")
    routes = {
        "kernel_d1": EngineConfig(use_kernel=True, pipeline_depth=1),
        "kernel_d2": EngineConfig(use_kernel=True, pipeline_depth=2),
        "kernel_dedup_d1": EngineConfig(use_kernel=True, dedup=True, pipeline_depth=1),
        "kernel_dedup_d2": EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2),
        "kernel_prefetch_d1": EngineConfig(use_kernel=True, prefetch=True, pipeline_depth=1),
        "kernel_prefetch_d2": EngineConfig(use_kernel=True, prefetch=True, pipeline_depth=2),
        "kernel_dedup_prefetch_d1": EngineConfig(use_kernel=True, dedup=True, prefetch=True,
                                                 pipeline_depth=1),
        "kernel_dedup_prefetch_d2": EngineConfig(use_kernel=True, dedup=True, prefetch=True,
                                                 pipeline_depth=2),
        "table_d1": EngineConfig(use_kernel=False, pipeline_depth=1),
    }
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    torch.cuda.reset_peak_memory_stats()
    reports, outputs, route_launches, hits = {}, {}, {}, {}
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
        hits[label] = (rep.adj_hits, rep.adj_lookups, rep.feat_hits, rep.feat_lookups)
        reports[label] = dict(rep.summary(), wall_s=wall)
        log(f"  {label:24s} sample {rep.sample_seconds:.4f} s  prefetch {rep.prefetch_seconds:.4f} s  "
            f"feature {rep.feature_seconds:.4f} s  compute {rep.compute_seconds:.4f} s  "
            f"total {rep.total_seconds:.4f} s  adj hit {rep.adj_hit_rate:.4f}  "
            f"feat hit {rep.feat_hit_rate:.4f}  prefetched_rows {rep.prefetched_rows}  "
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
        if hits[label] != hits["kernel_d2"]:
            raise AssertionError(f"hit counts of {label} {hits[label]} differ from kernel_d2's "
                                 f"{hits['kernel_d2']}")
    for label in routes:
        if ("prefetch" in label) != (reports[label]["prefetch"] and
                                     reports[label].get("prefetched_rows", 0) > 0):
            raise AssertionError(f"{label}: prefetch {reports[label]['prefetch']}, "
                                 f"prefetched_rows {reports[label].get('prefetched_rows')}")
    log(f"  logits and hit counts identical across {sorted(outputs)}")
    if launches["cached_gather"] == 0 or launches["cached_gather_blocks"] == 0:
        raise AssertionError(f"a main-path kernel was never launched: {launches}")
    return {"reports": reports, "launches": launches, "route_launches": route_launches,
            "launches_per_batch": per_batch, "max_memory_allocated": peak}


def counted_run(run, counters) -> tuple[object, dict]:
    """``run()`` with every launch counter set to 0 just before it and read
    just after it: ``(result, {kernel: launches})``."""
    for fn in counters:
        fn.launches = 0
    result = run()
    return result, {fn.__name__: fn.launches for fn in counters}


def baselines_phase(ds, eng) -> dict:
    """DUCATI and RAIN beside phase 3's DCI on the same dataset: their
    preparation times and splits, then BASELINE_BATCHES batches of each on
    the kernel route at depth 1 (DUCATI also with dedup, RAIN also on the
    table route and with dedup requested, which RAIN turns off)."""
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.core.policies import prepare
    from repro_torch.kernels.cached_gather import kernel as tk

    phase(f"10. baselines: DUCATI and RAIN beside DCI, {BASELINE_BATCHES} batches per route")
    dci = eng.pipeline
    kw = dict(total_cache_bytes=CACHE_BYTES, fanouts=FANOUTS, batch_size=BATCH, seed=SEED,
              device="cuda")
    pipes, prep_wall = {"dci": dci}, {}
    for name in ("ducati", "rain"):
        t0 = time.perf_counter()
        pipes[name] = prepare(name, ds, **kw)
        prep_wall[name] = time.perf_counter() - t0
    d_alloc, c_alloc = pipes["ducati"].caches.allocation, dci.caches.allocation
    prep = {name: p.prep_seconds for name, p in pipes.items()}
    log(f"  prep_seconds: dci {prep['dci']:.4f}, ducati {prep['ducati']:.4f} (32 presampling "
        f"batches), rain {prep['rain']:.4f}; DCI / DUCATI {prep['dci'] / prep['ducati']:.4f}; "
        f"prepare() wall: ducati {prep_wall['ducati']:.1f} s, rain {prep_wall['rain']:.1f} s")
    log(f"  DUCATI's knapsack: adj {d_alloc.adj_bytes} B, feat {d_alloc.feat_bytes} B "
        f"({pipes['ducati'].caches.feat_cached_rows} hot rows, "
        f"{pipes['ducati'].caches.adj_cached_elements} adj elements); DCI's Eq. 1: adj "
        f"{c_alloc.adj_bytes} B, feat {c_alloc.feat_bytes} B; RAIN caches nothing, "
        f"{len(pipes['rain'].batch_order)} batches in LSH order")
    routes = {
        "ducati": {"kernel_d1": EngineConfig(use_kernel=True, pipeline_depth=1),
                   "kernel_dedup_d1": EngineConfig(use_kernel=True, dedup=True,
                                                   pipeline_depth=1)},
        "rain": {"kernel_d1": EngineConfig(use_kernel=True, pipeline_depth=1),
                 "kernel_dedup_requested_d1": EngineConfig(use_kernel=True, dedup=True,
                                                           pipeline_depth=1),
                 "table_d1": EngineConfig(use_kernel=False, pipeline_depth=1)},
    }
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    reports, launches = {}, {}
    try:
        for name, by_label in routes.items():
            eng.pipeline = pipes[name]
            outs, hits = {}, {}
            for label, cfg in by_label.items():
                rep, counts = counted_run(
                    lambda: eng.run(config=cfg, max_batches=BASELINE_BATCHES,
                                    collect_outputs=True), counters)
                key = f"{name}_{label}"
                launches[key] = counts
                out = np.stack(eng.last_outputs)
                if out.shape != (BASELINE_BATCHES, BATCH, ds.spec.num_classes) or not (
                        np.isfinite(out).all()):
                    raise AssertionError(f"{key}: logits of shape {out.shape}")
                outs[label] = out
                hits[label] = (rep.adj_hits, rep.adj_lookups, rep.feat_hits, rep.feat_lookups)
                reports[key] = rep.summary()
                log(f"  {key:32s} sample {rep.sample_seconds:.4f} s  feature "
                    f"{rep.feature_seconds:.4f} s  compute {rep.compute_seconds:.4f} s  total "
                    f"{rep.total_seconds:.4f} s  adj hit {rep.adj_hit_rate:.4f}  feat hit "
                    f"{rep.feat_hit_rate:.4f}  ({'reuse hits' if name == 'rain' else 'hits'} "
                    f"{rep.feat_hits} of {rep.feat_lookups})  dedup {rep.dedup}  launches {counts}")
                kernel = "cached_gather_blocks" if rep.dedup else "cached_gather"
                if cfg.use_kernel and counts[kernel] == 0:
                    raise AssertionError(f"{key}: {kernel} was never launched: {counts}")
                if name == "rain" and rep.dedup:
                    raise AssertionError(f"{key}: RAIN's report has dedup on")
            first = next(iter(outs))
            for label in outs:
                if not np.array_equal(outs[label], outs[first]) or hits[label] != hits[first]:
                    raise AssertionError(f"{name}: {label} differs from {first}")
            log(f"  {name}: logits and hit counts identical across {sorted(outs)}")
    finally:
        eng.pipeline = dci
    del pipes
    torch.cuda.empty_cache()
    return {"prep_seconds": prep, "prepare_wall_s": prep_wall,
            "dci_over_ducati": prep["dci"] / prep["ducati"],
            "ducati_split": {"adj_bytes": d_alloc.adj_bytes, "feat_bytes": d_alloc.feat_bytes},
            "dci_split": {"adj_bytes": c_alloc.adj_bytes, "feat_bytes": c_alloc.feat_bytes},
            "reports": reports, "launches": launches}


def layerwise_gathers(ds, pipe, alloc, params) -> dict:
    """Every layer-wise chunk's gather alone, per layer input: layer 0
    against the re-filled feature cache, layers 1-2 against an embedding
    cache of the same position map over a zero spill table (the rows'
    values do not change what moves).  #2's in-kernel block modes on each
    chunk against ``classify_blocks``; then, with CUDA events, all chunks
    back to back through #2 and #1 from the pinned host table, and
    through #2 with the host table on the card (its PCIe side removed);
    layer 0's ``forward_layer`` per chunk (:func:`forward_sums`)."""
    import numpy as np
    import torch

    from repro_torch.graph.features import (build_embedding_cache, refresh_feature_cache)
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK
    from repro_torch.runtime.layerwise import layerwise_access_counts, plan_chunks

    n = ds.num_nodes
    counts = layerwise_access_counts(ds.graph)
    plan = plan_chunks(ds.graph, LAYERWISE_CHUNK, device="cuda")
    out = {}
    inputs = (
        ("layer 0 (feature cache)",
         lambda: refresh_feature_cache(pipe.caches.store, counts, alloc.feat_bytes)[0]),
        ("layers 1-2 (embedding cache)",
         lambda: build_embedding_cache(torch.zeros((n, 128), pin_memory=True), counts,
                                       alloc.embed_bytes, device="cuda")),
    )
    for label, make_store in inputs:
        store = make_store()
        hot, host = store.hot_table, store.host_table
        pad_id = max(store.pad_node_id(), 0)
        ids = [torch.where(spec.live, spec.device_ids, pad_id) for spec in plan.chunks]
        pos = [store.position_map[i.to(torch.int64)] for i in ids]
        total = torch.zeros(3, dtype=torch.int64, device="cuda")
        for i, p in zip(ids, pos):
            want, _ = tk.classify_blocks(i, p, hot.shape[0], n, ROW_BLOCK)
            modes = torch.full_like(want, -1)
            tk._launch_blocks(hot, host, i, p, ROW_BLOCK, modes=modes)
            if not torch.equal(modes, want):
                raise AssertionError(f"#2's in-kernel modes differ from classify_blocks ({label})")
            total += torch.bincount(modes.to(torch.int64), minlength=3)
        modes3 = total.tolist()
        host_dev = host.to("cuda")
        rows = sum(int(i.shape[0]) for i in ids)
        misses = sum(int((p < 0).sum()) for p in pos)

        def every_chunk(kernel, table):
            return lambda: [kernel(hot, table, i, p) for i, p in zip(ids, pos)]

        times = {
            "blocks_pinned_ms": cuda_ms(every_chunk(tk.cached_gather_blocks, host), reps=1),
            "rows_pinned_ms": cuda_ms(every_chunk(tk.cached_gather, host), reps=1),
            "blocks_on_card_ms": cuda_ms(every_chunk(tk.cached_gather_blocks, host_dev), reps=1),
        }
        row = host.shape[1] * host.element_size()
        out[label] = dict(zip(("per_row", "hot_span", "host_span"), modes3), rows=rows,
                          miss_rows=misses, row_bytes=row, **times)
        log(f"  {label}, {plan.num_chunks} chunks, {rows} index slots, {misses} miss rows of "
            f"{row} B: #2's block modes {modes3[0]} mixed (row by row), {modes3[1]} all-hit "
            f"spans, {modes3[2]} all-miss spans of {sum(modes3)}; every chunk's gather alone "
            f"(CUDA events): #2 {times['blocks_pinned_ms']:.1f} ms, #1 "
            f"{times['rows_pinned_ms']:.1f} ms, #2 with the host table on the card "
            f"{times['blocks_on_card_ms']:.1f} ms; miss bytes over the time of #2 "
            f"{misses * row / (times['blocks_pinned_ms'] / 1e3) / 1e9:.2f} GB/s")
        if label.startswith("layer 0"):
            out[label]["forward"] = forward_sums(ds, plan, params, hot, host_dev, ids, pos)
        del store, hot, host, host_dev, ids, pos
        torch.cuda.empty_cache()
    return out


def forward_sums(ds, plan, params, hot, host_dev, ids, pos) -> dict:
    """Layer 0's ``forward_layer`` on every chunk, CUDA events around each
    call: with the plan's two-level neighbor sum (pieces of at most
    ceil(sqrt(max degree)) rows, live edges only), and with one
    ``segment_reduce`` over the padded bucket, whose per-thread loop is a
    whole segment long (a hub's in-degree, or the pad segment).  Each is
    held to the same layer in float64: the two-level sum must stay within
    1e-4 of each chunk's largest output (the one-level sum's distance is
    printed beside it: both orders round differently)."""
    import numpy as np
    import torch

    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.models.gnn.models import forward_layer

    deg = np.diff(ds.graph.col_ptr)
    size = plan.chunk_size
    p64 = {k: v.double() for k, v in params[0].items()}
    ms = {"two_level_ms": 0.0, "one_level_ms": 0.0}
    err = {"two_level_ms": 0.0, "one_level_ms": 0.0}
    kw = dict(model="graphsage", num_dst=size, relu=True)
    for spec, i, p in zip(plan.chunks, ids, pos):
        feats = tk.cached_gather_blocks(hot, host_dev, i, p)
        one = np.zeros(size + 1, np.int64)
        one[: spec.cnt] = deg[spec.lo : spec.lo + spec.cnt]
        one[size] = feats.shape[0] - size - spec.n_edges
        one = (torch.from_numpy(one).to("cuda"),)
        with torch.inference_mode():
            f64 = feats.double()
            want = forward_layer(p64, f64[:size], f64[size:], spec.seg_ids, spec.degrees.double(),
                                 levels=one, **kw)
            scale = max(want.abs().max().item(), 1.0)
            del f64
            for label, nbr, levels in (
                    ("two_level_ms", feats[size : size + spec.n_edges], spec.levels),
                    ("one_level_ms", feats[size:], one)):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                got = forward_layer(params[0], feats[:size], nbr, spec.seg_ids, spec.degrees,
                                    levels=levels, **kw)
                stop.record()
                stop.synchronize()
                ms[label] += start.elapsed_time(stop)
                err[label] = max(err[label], (got.double() - want).abs().max().item() / scale)
    if err["two_level_ms"] > 1e-4:
        raise AssertionError(f"the two-level neighbor sum is {err['two_level_ms']:.2e} of a "
                             "chunk's largest output from float64")
    log(f"  layer 0's forward_layer over {plan.num_chunks} chunks (CUDA events): two-level sum "
        f"{ms['two_level_ms']:.1f} ms, one segment_reduce over the padded bucket "
        f"{ms['one_level_ms']:.1f} ms; largest distance from float64 over a chunk's largest "
        f"output: {err['two_level_ms']:.2e} and {err['one_level_ms']:.2e}")
    return {**ms, "two_level_err": err["two_level_ms"], "one_level_err": err["one_level_ms"]}


def layerwise_phase(ds, eng) -> dict:
    """Layer-wise GraphSAGE 3x128 over every node at chunk 4096 on phase
    3's DCI pipeline: the kernel route at depth 2 twice and with prefetch,
    at one allocation (the first run's Eq. 1 split), bit-identical; then
    the table route against the kernel route at depth 1 at scale 0.1."""
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.graph.datasets import load_dataset
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine
    from repro_torch.runtime.layerwise import run_layerwise

    phase(f"11. layer-wise: GraphSAGE 3x128 over all {ds.num_nodes} nodes, chunk "
          f"{LAYERWISE_CHUNK}")
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    n, e = ds.num_nodes, ds.graph.num_edges

    def runs(engine, routes):
        """Each route's report and launches; the first through the engine
        (its Eq. 1 split), the others through run_layerwise at that split."""
        pipe, params = engine.pipeline, list(engine.model.layers)
        reports, launches, first = {}, {}, None
        for label, cfg in routes.items():
            if first is None:
                call = lambda: engine.run(config=cfg)  # noqa: E731
            else:
                call = lambda: run_layerwise(  # noqa: E731
                    engine.dataset, pipe, params, model=engine.model_name,
                    config=cfg.resolved(pipe, pipeline_depth=cfg.pipeline_depth),
                    allocation=first.allocation)
            t0 = time.perf_counter()
            rep, counts = counted_run(call, counters)
            wall = time.perf_counter() - t0
            first = first or rep
            reports[label], launches[label] = rep, counts
            log(f"  {label:28s} gather {rep.gather_seconds:.4f} s  prefetch "
                f"{rep.prefetch_seconds:.4f} s  compute {rep.compute_seconds:.4f} s  spill "
                f"{rep.spill_seconds:.4f} s  fill {rep.fill_seconds:.4f} s  prep "
                f"{rep.prep_seconds:.4f} s  total {rep.total_seconds:.4f} s  feat hit "
                f"{rep.feat_hit_rate:.4f}  embed hit {rep.embed_hit_rate:.4f}  launches {counts}  "
                f"(call {wall:.1f} s)")
            if cfg.use_kernel and counts["cached_gather_blocks"] == 0:
                raise AssertionError(f"{label}: #2 was never launched: {counts}")
        base = next(iter(reports.values()))
        if base.outputs.shape != (engine.dataset.num_nodes, 47) or not np.isfinite(
                base.outputs).all():
            raise AssertionError(f"layer-wise outputs of shape {base.outputs.shape}")
        for label, rep in reports.items():
            if not np.array_equal(rep.outputs, base.outputs):
                raise AssertionError(f"layer-wise outputs of {label} differ")
            got = (rep.feat_hits, rep.feat_lookups, rep.embed_hits, rep.embed_lookups)
            if got != (base.feat_hits, base.feat_lookups, base.embed_hits, base.embed_lookups):
                raise AssertionError(f"layer-wise hits of {label} differ: {got}")
        log(f"  outputs {base.outputs.shape} and feature / embedding hits and lookups identical "
            f"across {sorted(reports)}")
        return reports, launches

    torch.cuda.reset_peak_memory_stats()
    lw = dict(mode="layerwise", chunk_size=LAYERWISE_CHUNK)
    reports, launches = runs(eng, {
        "kernel_d2": EngineConfig(use_kernel=True, pipeline_depth=2, **lw),
        "kernel_d2_again": EngineConfig(use_kernel=True, pipeline_depth=2, **lw),
        "kernel_prefetch_d2": EngineConfig(use_kernel=True, prefetch=True, pipeline_depth=2,
                                           **lw),
    })
    peak = torch.cuda.max_memory_allocated()
    base = reports["kernel_d2"]
    if base.feat_lookups != n + e or base.embed_lookups != 2 * (n + e):
        raise AssertionError(f"lookups {base.feat_lookups} / {base.embed_lookups}, expected "
                             f"{n + e} per layer")
    alloc = base.allocation
    log(f"  lookups: {base.feat_lookups} on layer 0 (N + E = {n + e}) and {base.embed_lookups} "
        f"on layers 1-2; Eq. 1 layer-wise split: feat {alloc.feat_bytes} B, embed "
        f"{alloc.embed_bytes} B (feat share {alloc.feat_fraction:.4f}); max_memory_allocated "
        f"{peak / 1e9:.2f} GB")
    gathers = layerwise_gathers(ds, eng.pipeline, alloc, list(eng.model.layers))
    # The table route gathers every miss row on the host: held to the
    # kernel route at the cut size, with the budget cut alike.
    small = load_dataset("ogbn-products", scale=LAYERWISE_CUT, seed=SEED)
    eng_small = GNNInferenceEngine(small, model="graphsage", fanouts=FANOUTS, batch_size=BATCH,
                                   seed=SEED, device="cuda")
    eng_small.prepare("dci", total_cache_bytes=int(CACHE_BYTES * LAYERWISE_CUT))
    log(f"  scale {LAYERWISE_CUT}: {small.num_nodes} nodes, {small.graph.num_edges} edges, "
        f"{int(CACHE_BYTES * LAYERWISE_CUT)} B of cache")
    cut_reports, cut_launches = runs(eng_small, {
        "cut_kernel_d1": EngineConfig(use_kernel=True, pipeline_depth=1, **lw),
        "cut_table_d1": EngineConfig(use_kernel=False, pipeline_depth=1, **lw),
    })
    del eng_small, small
    torch.cuda.empty_cache()
    launches.update(cut_launches)
    return {"reports": {k: r.summary() for k, r in {**reports, **cut_reports}.items()},
            "launches": launches, "max_memory_allocated": peak,
            "allocation": {"feat_bytes": alloc.feat_bytes, "embed_bytes": alloc.embed_bytes,
                           "feat_fraction": alloc.feat_fraction},
            "lookups_per_layer": n + e, "chunk_gathers": gathers}


def cli_phase() -> dict:
    phase("9. CLI")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = {}
    for args in (["--use-kernel", "--prefetch", "--max-batches", "2"],
                 ["--policy", "rain", "--max-batches", "2"],
                 ["--mode", "layerwise", "--scale", "0.01"]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.infer_gnn", *args],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"CLI {args} failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        rep = json.loads(proc.stdout)
        label = " ".join(args)
        runs[label] = rep
        if rep["device"] != "cuda:0":
            raise AssertionError(f"unexpected CLI report: {rep}")
        if "--mode" in args:
            if rep["mode"] != "layerwise" or rep["nodes"] != 24_490:
                raise AssertionError(f"unexpected layer-wise CLI report: {rep}")
            detail = (f"embed hit {rep['embed_hit_rate']:.4f}, {rep['chunks']} chunks")
        else:
            want_prefetch = "--prefetch" in args
            if rep["batches"] != 2 or rep["prefetch"] != want_prefetch:
                raise AssertionError(f"unexpected CLI report: {rep}")
            detail = f"prefetched_rows {rep.get('prefetched_rows', 0)}"
        log(f"  infer_gnn {label}: ok in {time.perf_counter() - t0:.1f} s, policy "
            f"{rep['policy']}, feat hit {rep['feat_hit_rate']:.4f}, {detail}, total "
            f"{rep['total_s']:.4f} s")
    return runs


def main() -> int:
    # torch.compile (flex_attention's library time) keeps its caches under
    # the checkout's build/ and compiles in this process, starting no pool.
    for var, value in (("TORCHINDUCTOR_CACHE_DIR", ROOT / "build" / "torchinductor"),
                       ("TRITON_CACHE_DIR", ROOT / "build" / "triton"),
                       ("TORCHINDUCTOR_COMPILE_THREADS", 1)):
        os.environ.setdefault(var, str(value))
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
    if not all((SRC / "repro_torch" / "csrc" / f"{n}.cu").is_file()
               for n in ("cached_gather", "seg_agg", "flash_attention")):
        print(f"chip_smoke: no repro_torch sources under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    device = device_phase()
    build = build_phase()
    ds, eng, setup = setup_phase()
    inputs = kernel_inputs(eng)
    max_err, rows = kernel_phase(inputs, build["h2d_bytes_per_s"])
    split = split_phase(inputs[100], build["h2d_bytes_per_s"])
    feature_stage = feature_stage_phase(eng, inputs[100])
    del inputs
    torch.cuda.empty_cache()
    peaks = card_peaks(device["nvidia_smi"])
    seg_row, seg_err = seg_agg_phase(peaks[1])
    att_rows, att_err = attention_phase(peaks)
    torch.cuda.empty_cache()
    ops_launches = ops_path_phase()
    torch.cuda.empty_cache()
    main_path = main_path_phase(eng)
    cli = cli_phase()
    baselines = baselines_phase(ds, eng)
    layerwise = layerwise_phase(ds, eng)
    # Launches on the paths: the nine routes, the baselines' and the
    # layer-wise runs, each counted from 0 just before it.
    path_launches = {
        name: main_path["launches"][name]
        + sum(c[name] for c in baselines["launches"].values())
        + sum(c[name] for c in layerwise["launches"].values())
        for name in main_path["launches"]
    }
    log(f"launches on the paths (phases 8, 10, 11): {path_launches}")

    kernels = []
    for row in rows:
        if row["main"]:
            name = row["kernel"]
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": path_launches[name],
                "max_abs_err": max_err[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": "bytes", "library_ms": row["library_ms"],
            })
    prefill = att_rows["prefill"]
    kernels += [
        {"name": "seg_agg", "route": "cuda", "source": SOURCES["seg_agg"],
         "replaces": REPLACES["seg_agg"], "launches": ops_launches["seg_agg"],
         "max_abs_err": seg_err, "ms": seg_row["ms"], "plain_ms": seg_row["plain_ms"],
         "bound_ms": seg_row["bound_ms"], "bound_by": "bytes",
         "library_ms": seg_row["library_ms"]},
        # library_ms: flex_attention with the same softcap and mask
        # (scaled_dot_product_attention without softcap is in chip_smoke.json).
        {"name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"],
         "replaces": REPLACES["flash_attention"], "launches": ops_launches["flash_attention"],
         "max_abs_err": att_err, "ms": prefill["ms"], "plain_ms": prefill["plain_ms"],
         "bound_ms": prefill["bound_ms"], "bound_by": prefill["bound_by"],
         "library_ms": prefill["library_ms"]},
    ]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "device": device, "build": build, "setup": setup, "kernel_rows": rows,
        "split": split, "feature_stage": feature_stage, "seg_agg": seg_row, "attention": att_rows,
        "ops_launches": ops_launches, "main_path": main_path, "baselines": baselines,
        "layerwise": layerwise, "cli": cli, "path_launches": path_launches, "kernels": kernels,
        "seconds": time.perf_counter() - t_start,
    }, indent=1))
    decode = att_rows["decode"]
    log(json.dumps({"flash_attention_decode": {
        k: decode[k] for k in ("shape", "design", "ms", "graph_ms", "plain_ms", "library_ms",
                               "bound_ms", "bound_by", "f32_ms", "max_abs_err")}}))
    log(f"done in {time.perf_counter() - t_start:.1f} s; details in chiprun_out/chip_smoke.json")
    log(device["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                           "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
