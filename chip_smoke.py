#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, ``nvcc``
under ``/usr/local/cuda`` (or on ``PATH``) and PyTorch built for CUDA.
Imports nothing of JAX and nothing of the JAX package.  Phases, none of
whose errors is caught:

1. device: the card's name and power limit;
2. build: compile the five sources of ``src/repro_torch/csrc/``
   (``cached_gather.cu``, ``seg_agg.cu``, ``flash_attention.cu``,
   ``gat_attend.cu``, ``sample_layer.cu``) with ``nvcc``, one process each, all started together, print the build
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
   then #2 at Reddit's shape (F = 602, pinned host) on the dedup bucket
   and with every row missing: equal to ``ref.py``, read by aligned
   lines, its miss bytes' rate beside the pinned copy's, and the lines it
   reads a miss row; then the device work of one batch's feature stage on the plain and
   the dedup kernel route, with the dedup sort and the former wrapper
   classification alone, and the prefetch staging of one batch's misses
   (host clock, with its device→host id read alone), whose pack #1 and
   #2 must read to the same rows;
5. B4, ``seg_agg``: against ``ref.py`` in float32 and bfloat16 on the
   edge shapes of tests/test_kernels.py and at the main path's
   first-layer shape ``[180224, 5, 100]`` (1,081,344 frontier rows
   reduced to 180,224 destination nodes), timed beside ``ref.py``,
   ``x.sum(1)`` and its bytes bound; then its indexed form
   (``seg_agg_indexed``, layer 0 reading the frontier's distinct rows
   through the inverse map) at the benchmark's offline layer 0: 4096
   seeds at fan-outs 15,10,5 give 270,336 destinations of 16 rows, read
   from a table of ogbn-products' 2,449,029 rows of F = 100 (GraphSAGE)
   and of Reddit's 232,965 rows of F = 602 (GCN) by uniform ids.  Self
   rows must equal ``ref.py``'s; the sums must lie within float32
   summation's bound of the float64 sum, (fanout + 2) x 2^-24 x the sum
   of magnitudes (the largest gap to ``ref.py`` is printed).  Timed
   beside ``ref.py``, the expansion ``x[idx]`` with the fanout sum it
   replaces (the library time) and its bytes bound (each distinct row
   read once, the index, the outputs).  Then its dense form (no index,
   the routes without dedup) on the expanded rows: the same bits as the
   indexed form, timed beside the split and ``.sum(1)`` (and GCN's self
   add and divide) that layer 0 ran before it;
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
   read just after) must be > 0; every route's layer 0 must launch
   ``seg_agg_indexed`` once per batch and the report count each batch
   (``fused_batches``), and every route's sampling must launch
   ``sample_layer`` once a layer a batch (``sample_layer.launches``, set
   to 0 just before each route: 3 layers x (8 batches + a warm-up));
   8b. the sampler's kernel at the offline cells' last layer (4096 seeds
   at fan-outs 15,10,5: 270,336 seeds x 15 draws) on phase 3's prepared
   ogbn-products graph and on Reddit's stand-in
   (``bench/configs/gcn-reddit.json``, no adjacency cache), bit for bit
   against ``ref.py`` on the same uniforms, timed (device and host time
   a call) beside the plain path with the concatenation it replaced and
   beside its bytes bound at HBM3's rate; then a whole batch's
   ``sample_blocks`` with dedup through the kernel and through ``ref.py``;
9. the CLI, as subprocesses: ``--use-kernel --prefetch``, ``--policy
   rain``, ``--mode layerwise --scale 0.01``, and serving at the default
   ``--scale 0.004``: ``--streams 4 --batches-per-stream 2``, ``--arrival
   burst --admission slo --slo-ms 400`` and ``--faults`` (a plan written
   under ``chiprun_out/``) ``--fault-policy retry``;
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
   every miss row is slow at full size);
12. serving, on phase 3's ``dci`` pipeline: ``MultiStreamServer`` with 4
   streams x 8 batches (``make_stream_batches``, seed 0) at depth 2 on the
   kernel route and on kernel + dedup — every stream's logits and hit
   counts equal (``torch.equal``) to the engine running it alone with its
   seed, #1 (or #2) launched, no ``kernel_fallbacks``, the in-flight cap
   kept; then ``RequestQueueServer``: (a)'s queues as a flash crowd under
   round-robin (the same admission log and logits), a Poisson trace at
   offered load 0.7 of the kernel route's per-batch time ((a)'s wall over
   its batches; the SLO stays 10x the probe's table-route service time)
   under round-robin, EDF and SLO, and a burst trace under round-robin and EDF (p50/p99,
   deadline hit rate and shed count are readings, not gates); then seeded
   fault plans: ``host_fetch`` p 0.05 under retry (logits equal, retries
   counted), ``kernel_gather`` twice under fail-fast (two gathers on the
   table route, #1 launched for every other batch, logits equal) and
   ``host_fetch`` always down under degraded shedding (every request
   answered cache-only: each batch's logits are the forward of the
   fault-free gather with its miss rows zeroed; completed and shed
   requests partition each stream);
13. online refresh, on phase 3's ``dci`` pipeline: the engine runs 16
   batches on the kernel route at depth 2 with an interval refresh every
   4 batches — logits ``torch.equal`` to the same batches with refresh
   off, per-epoch counters partitioning the lifetime ones, at least 3
   events —; a 4-stream ``MultiStreamServer`` with refresh mode "all"
   (3 streams, then a 4th added after serving began, then one removed):
   every stream's logits equal its solo run; a ``refresh_fill`` plan that
   rolls one refresh back (availability 1.0, the failure recorded, the
   same tensors kept); each event's pause and its split (telemetry pull,
   Eq. 1, adjacency and feature re-fills), the allocator's peak over a
   growing refresh, and the per-batch cost of the telemetry's read-back
   and scatters.  The caches are put back to phase 12's epoch at the end
   (a refresh writes only new tensors, so the old ones are intact);
14. sharded serving: ``ShardedServer`` with 4 shards co-resident on the
   card, 4 streams x 8 batches at depth 2 on the kernel route and on
   kernel + dedup — logits and hit counts equal to phase 12's
   ``MultiStreamServer``, per-shard hits tiling the global counters, #1
   (or #2) launched once per non-empty shard per batch —; an interval
   refresh with a repartition per epoch (each repartition's rows tiling
   that epoch's hot set); a ``shard_exchange`` plan that fails shard 1
   over to its host table (read by #1, one launch per segment as when
   healthy) for 4 retired batches and rejoins, logits equal; the host
   partition's per-batch time and the serve walls beside phase 12's;
15. LM serving: Gemma 2B at full size (18 layers, d 2048, MQA, head dim
   256, vocab 256000, bf16, random weights from a seeded card generator)
   through the serve CLI's ``main``: the Eq. 1 serving caches at 4 MB, a
   batched prefill of 8 x 2048 synthetic tokens and 32 greedy decode
   steps, every layer's attention on B5 (``wgmma`` prefill, ``split``
   decode: the per-design counters, set to 0 just before, must read 18
   and 576); prefill and decode times, tokens/s and
   ``max_memory_allocated``.  Then an fp32 ``BatchedServer`` on Gemma 2B
   (4 slots, 6 prompts of 100-500 tokens, 16 new tokens) whose tokens
   must equal a sequential prefill + decode of each request (or part at
   a near-tie, ``LM_TIE_TOL``), and prefill + decode against a longer
   prefill; Gemma-2 27B at full width and 4 layers (2 x 6144 tokens past
   the 4096 window, then 4 decode steps: local and global layers on B5);
   a smoke config in fp32 against the CPU route at 1e-4.  The inputs of
   the first layer of each kind (and the last decode step) are captured
   and B5 is held to ``ref.py`` at each of those shapes, and timed at the
   Gemma 2B prefill and decode and the Gemma-2 27B local prefill beside
   ``_attend`` (its transposes included), ``ref.py``, the bound and the
   library call (``scaled_dot_product_attention`` for Gemma 2B,
   ``flex_attention`` for Gemma-2 27B).  The kernels' line counts these
   runs' B5 launches in ``flash_attention``'s;
16. LM serving, MoE and state-space archs, at full width through the
   serve CLI's ``main`` (bf16, random weights): Jamba v0.1 cut to one
   pattern period of 8 layers (7 Mamba, 1 attention, 4 MoE; 13.0 B
   parameters), 4 x 1024 tokens and 8 decode steps, its attention on B5
   (the counters must read 1 ``wgmma`` and 8 ``split``) and Eq. 1's
   expert share holding at least one expert; RWKV6-3B at full size, 4 x
   512 on the scan and on the chunked route, the chunked prefill held to
   the scan in fp32 at full size (``RWKV_CHUNK_TOL``); DeepSeek-V2 cut to
   2 layers, 2 x 512, its MoE dispatch run twice on one input for the
   same bits; each with prefill s, decode ms per step, decode's device
   busy share (``torch.profiler``) and ``max_memory_allocated``; fp32
   ``BatchedServer``s for RWKV6-3B (full size) and Jamba (one period at
   the smoke config's width) whose tokens must equal sequential
   decoding; and B5 held to ``ref.py`` and timed beside SDPA at Jamba's
   prefill and decode shapes.  Its B5 launches join the kernels' line;
17. the encoder-decoder: SeamlessM4T-medium at full size (12 + 12 layers,
   d 1024, 16 heads x 64, d_ff 4096, vocab 256206; bf16, random weights
   from a seeded card generator) through ``launch/steps.py``: a prefill
   of 4 x 1024 source frames and 4 x 256 target tokens, then 16 greedy
   decode steps, cold and warm; every attention on B5 (the counters must
   read 36 ``wgmma`` per prefill — encoder self, decoder self and cross —
   and 24 ``split`` per decode step); prefill s, decode ms per step and
   ``max_memory_allocated``; an fp32 smoke config against the CPU route
   at 1e-4; B5 held to ``ref.py`` at each new shape (head dim 64, non-
   causal, Sq != Sk) and timed beside SDPA;
18. training: Gemma 2B at full size through the train CLI's ``main``
   (bf16, fp32 AdamW moments, 4 x 2048 tokens, 4 steps): each step's
   synchronized time and tokens/s, split between forward + backward and
   the AdamW update, the losses (finite, the first near ln 256000) and
   ``max_memory_allocated``; no B5 launch in the steps (attention under
   autograd takes the plain route), then an eval prefill of the trained
   parameters on B5 (18 ``wgmma``); the fp32 smoke config's loss and
   gradients on the card against the CPU route at 1e-4, and one step's
   parameters and AdamW state through a checkpoint, bit for bit;
19. the dry-run against the card: Gemma 2B at full size on a 1 x 1 mesh,
   three steps (phase 15's prefill of 8 x 2048 and its decode of 8 slots
   at a 2080-token cache, phase 18's training step of 4 x 2048), each
   counted on meta tensors by ``launch.dryrun.dryrun_one`` and then
   materialized on the card from a seeded card generator: the card
   tensors' bytes must equal the record's parameter and argument bytes;
   each step timed (CUDA events, warm, mean of 5, training of 3) beside
   its bound at the published H100 peaks (FLOPs over the bf16 peak, dot
   bytes over HBM3's rate; the attention counted on the plain route,
   which scores the masked half of a causal matrix that B5 skips), with
   B5's launches (18 ``wgmma`` per prefill, 18 ``split`` per decode step,
   none in training); ``remat_dots`` training against whole remat from
   the same parameters and batch (three chained steps each, losses and
   a gradient norm within 1e-5 relative, step times and peaks; at 2 x
   2048 if 4 x 2048 runs out of memory); the expert-parallel MoE on a 1
   x 1 mesh against the dense MoE at Jamba's full width (fp32, 4 x 1024
   tokens, 1e-5); and an NCCL world of one process through
   ``launch/distributed.py`` (an ``all_reduce`` leaves its tensor as it
   was; the production topology check names one device).

20. GAT (run after phase 8), at ``gat-products.offline4096``'s shapes
   (``bench/configs/gat-products.json``, batch 4096 at fan-outs 15,10,5):
   ``gat_attend`` at its three layers — layer 0 through the inverse map,
   270,336 destinations x 16 positions of F = 100 from a table of
   ogbn-products' 2,449,029 rows by uniform ids (about 2.03 M of them
   distinct), 4 heads; layers 1 and 2 in place, 24,576 x 11 and 4,096 x
   6 positions of F = 1,024, 4 and 6 heads — held to ``ref.py`` in
   float64 on the same inputs (the widest gap within ``GAT_TOL`` of the
   largest output), layer 0's dense form the same bits as its indexed
   form; each timed beside ``ref.py``, the paper's order in torch ops
   (project every position's row, score, softmax, sum: the library time)
   and the bound of ``bench/models/gat.py``'s ``attend_bytes`` at HBM3's
   rate.  Then GAT through ``GNNInferenceEngine`` on the cell's route
   (kernel, dedup, depth 2) and without dedup, ``prepare("dci", 256 MB)``
   at batch 4096: ``gat_attend.launches`` set to 0 just before each run
   and read just after must be 3 a batch (warm-up included), each batch
   counted in ``fused_batches``, the logits of both routes identical.

21. The Graph Transformer (run after phase 20), at ``gt-products.offline4096``'s
   shapes (``bench/configs/gt-products.json``, batch 4096 at fan-outs
   15,10,5): ``dot_attend`` at its three layers — layer 0 through the
   inverse map, 270,336 destinations x 15 neighbour positions of F = 100 from
   a table of ogbn-products' 2,449,029 rows by uniform ids; layers 1 and 2 in
   place, 24,576 x 10 and 4,096 x 5 of F = 512, 4 heads each — the queries
   folded from random maps as the model folds them, held to ``ref.py`` in
   float64 on the same inputs (the widest gap within ``GAT_TOL`` of the
   largest output), layer 0's dense form the same bits as its indexed form;
   each timed beside ``ref.py``, the paper's order in torch ops (project every
   neighbour's row to a key and a value, score, softmax, sum: the library
   time) and the bound of ``bench/models/graph_transformer.py``'s
   ``attend_bytes`` at HBM3's rate.  Then the Graph Transformer through
   ``GNNInferenceEngine`` on the cell's route (kernel, dedup, depth 2) and
   without dedup, as phase 20 runs GAT: 3 ``dot_attend`` launches a batch,
   each batch a fused one, the logits of both routes identical.

22. GraphSAGE-LSTM (run after phase 21), at ``sage-lstm-reddit.offline4096``'s
   shapes (``bench/configs/sage-lstm-reddit.json``, batch 4096 at fan-outs
   25,10): ``lstm_agg`` at its two layers — layer 0 through an index,
   45,056 destinations x 25 slots over ``LSTM_TABLE_ROWS`` gate rows by
   uniform ids; layer 1 in place, 4,096 x 10 — held to ``ref.py`` in
   float64 on the same inputs (the widest gap within ``GAT_TOL`` of the
   largest state), layer 0's dense form the same bits as its indexed form;
   each timed beside ``ref.py``, the input map's SGEMM (over the gate
   table's rows at layer 0, every slot's row at layer 1), ``torch.nn.LSTM``
   (cuDNN, float32, TF32 off) over the gathered padded sequence of input
   rows (its input map over every slot included: the library time, and its
   last state held to the kernel's) and the bound of
   ``bench/models/graphsage_lstm.py``'s ``recur_flops`` at float32's 67
   TFLOP/s and ``recur_bytes`` at HBM3's rate.  Then GraphSAGE-LSTM through
   ``GNNInferenceEngine`` on the cell's route (kernel, dedup) on Reddit's
   stand-in with 128 MB of cache, at depth 2 and depth 1: 2 ``lstm_agg``
   launches a batch, each batch a fused one, the same bits at both depths;
   the distinct frontier rows a batch (``unique_rows``) are printed.

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
SERVE_STREAMS = 4  # phase 12: streams x batches at depth 2
SERVE_BATCHES = 8
SERVE_DEPTH = 2
REFRESH_BATCHES = 16  # phase 13: the engine's refresh run
REFRESH_INTERVAL = 4  # phase 13, the engine: retired batches between interval refreshes
# Serving refreshes (phases 13 and 14) come every SERVE_BATCHES or twice as
# many retired batches: each full-size refresh pauses 2-4 s on the host.
SHARDS = 4  # phase 14: co-resident shards on the one card
POISSON_LOAD = 0.7  # offered load of the Poisson trace at the kernel route's per-batch time
BURST_REQUESTS = 8  # the burst trace: 8 at t = 0 beside 16 steady ones
LAYERWISE_CHUNK = 4096  # the reference CLI's default chunk
LAYERWISE_CUT = 0.1  # the scale of the table-route layer-wise check
SEG_SHAPE = (180_224, 5, 100)  # first GraphSAGE layer: 1024*16*11 dst nodes, fanout 5, F 100
# seg_agg_indexed at the benchmark's offline layer 0 (4096*6*11 destinations,
# fanout 15): (label, F, table rows, mode) for ogbn-products and Reddit.
INDEXED_DST, INDEXED_FANOUT = 270_336, 15
INDEXED_CASES = (("products", 100, 2_449_029, "sage"), ("reddit", 602, 232_965, "gcn"))
# Phase 20, GAT at gat-products.offline4096 (batch 4096 at FANOUTS, the
# widths of bench/configs/gat-products.json): gat_attend against ref.py in
# float64 within GAT_TOL of the largest output (float32 scores of up to
# 1,024 terms and the online softmax's rescaling; the card tests hold it
# to the same limit), and the engine's batches on the cell's route.
GAT_CONFIG = ROOT / "bench" / "configs" / "gat-products.json"
GAT_BATCH = 4096
GAT_TABLE_ROWS = 2_449_029  # layer 0 reads ogbn-products' rows through the inverse map
GAT_TOL = 1e-5
# Phase 21, the Graph Transformer at gt-products.offline4096 (batch 4096 at
# FANOUTS): dot_attend held to ref.py as gat_attend is, within GAT_TOL (float32
# scores of up to 512 terms and the online softmax's rescaling), and the
# engine's batches on the cell's route.
GT_CONFIG = ROOT / "bench" / "configs" / "gt-products.json"
# Phase 22, GraphSAGE-LSTM at sage-lstm-reddit.offline4096 (batch 4096 at
# fan-outs 25,10): lstm_agg held to ref.py within GAT_TOL (float32 sums of
# 128 terms over 25 dependent steps), layer 0 through an index over
# LSTM_TABLE_ROWS gate rows (about the distinct frontier rows of the cell's
# batches), and the engine's batches on the cell's route.
LSTM_CONFIG = ROOT / "bench" / "configs" / "sage-lstm-reddit.json"
LSTM_TABLE_ROWS = 104_000
# The sampler's kernel at the offline cells' last layer (batch 4096 at
# FANOUTS: 270,336 seeds x 15 draws): on phase 3's prepared ogbn-products
# graph (its adjacency cache active) and on Reddit's stand-in
# (bench/configs/gcn-reddit.json, no adjacency cache), timed over
# SAMPLER_REPS calls.
SAMPLER_BATCH = 4096
SAMPLER_REPS = 20
REDDIT_CONFIG = ROOT / "bench" / "configs" / "gcn-reddit.json"
# Bytes the sampler's kernel must move: per seed its id, node range, cached
# length and cache offset; per draw u, one neighbour id read, and the
# neighbour, hit flag and slot written.
SAMPLER_SEED_BYTES = 4 + 8 + 4 + 4
SAMPLER_DRAW_BYTES = 8 + 4 + 4 + 1 + 4
KERNEL_SOURCES = ("cached_gather", "seg_agg", "flash_attention", "gat_attend", "sample_layer",
                  "dot_attend", "lstm_agg")
# Gemma-2 27B attention (src/repro/configs/gemma2_27b.py): prefill and decode.
GEMMA = dict(b=1, hq=32, hkv=16, d=128, s=4096, window=4096, softcap=50.0)
# Phase 15, LM serving (src/repro/configs/gemma_2b.py at full size, bf16):
# the serve CLI's requests x prompt tokens, decode steps and cache budget.
LM_PREFILL = (8, 2048)
LM_DECODE_STEPS = 32
LM_CACHE_MB = 4
# The fp32 BatchedServer on Gemma 2B: prompt lengths, slots, new tokens.
LM_SERVER_PROMPTS = (100, 180, 260, 340, 420, 500)
LM_SERVER_SLOTS = 4
LM_SERVER_NEW = 16
# Batched and sequential greedy tokens may part only at a near-tie: the
# batched token's fp32 logit within this of the top one in the sequential
# run (logits of scale ~1; the two decode routes differ by about 1e-5).
LM_TIE_TOL = 1e-3
# Gemma-2 27B at full width (src/repro/configs/gemma2_27b.py), depth cut to
# two local/global repeats: batch x prompt (past the 4096 window) and decode.
GEMMA2_LAYERS = 4
GEMMA2_PREFILL = (2, 6144)
GEMMA2_DECODE_STEPS = 4
# Phase 16, LM serving for the MoE and state-space archs at full width
# (src/repro/configs/jamba_v01_52b.py, rwkv6_3b.py, deepseek_v2_236b.py),
# depth cut to one card: Jamba to one pattern period, DeepSeek-V2 to 2 layers.
JAMBA_LAYERS = 8
JAMBA_PREFILL = (4, 1024)
# Jamba's budget: Eq. 1's expert share (about half) must hold at least one
# expert at the reference's accounting (88 MB each at 8 layers), and its
# embedding share less than the 1.07 GB fp32 table.
JAMBA_CACHE_MB = 1000
RWKV_PREFILL = (4, 512)
DEEPSEEK_LAYERS = 2
DEEPSEEK_PREFILL = (2, 512)
DEEPSEEK_DECODE_STEPS = 4
SSM_DECODE_STEPS = 8
SSM_CACHE_MB = 64
# The fp32 BatchedServers: prompt lengths, slots, new tokens; Jamba's
# width cut (d_model, heads, head dim, FFN widths of the smoke config).
SSM_SERVER_PROMPTS = (50, 100, 150, 200, 250, 300)
SSM_SERVER_SLOTS = 4
SSM_SERVER_NEW = 8
JAMBA_SMALL_WIDTH = dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
# RWKV-6's chunked prefill against its scan, fp32 at full size: logits and
# every layer's state and shift.  The two routes sum the same terms in
# another order (float32, about 1e-6 relative per layer), 32 layers deep.
RWKV_CHUNK_TOL = dict(rtol=1e-3, atol=1e-3)
# Phase 17, the encoder-decoder (src/repro/configs/seamless_m4t_medium.py at
# full size, bf16): batch x source frames, target prompt tokens, decode steps.
ENCDEC_SRC = (4, 1024)
ENCDEC_PROMPT = 256
ENCDEC_DECODE_STEPS = 16
# Phase 18, training Gemma 2B at full size through the train CLI: batch x
# sequence, steps, and the eval prefill of the trained parameters after it.
TRAIN_SHAPE = (4, 2048)
TRAIN_STEPS = 4
TRAIN_EVAL_PREFILL = (1, 512)
# Phase 19: chained training steps under each remat policy.
REMAT_STEPS = 3
SEG_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
ATT_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
# The bfloat16 kernel against ref.py computed in float32 from the same
# bfloat16 inputs (rtol, atol): the kernel rounds only p and its output to
# bfloat16, about 2**-9 relative, so this holds late rows whose |out| is
# near 0.03, where the 5e-2 parity check above could not see a dropped
# key tile.
ATT_TOL_BF16_F32 = (2e-2, 2e-3)
# Phase 15 holds B5 at the model's own activations to ATT_TOL only: there
# attention is peaked, so a row's output rests on a few keys and rounding
# p to bfloat16 alone moves it by about 2**-9 |v| (on an H100 the bf16
# kernel read 2.19e-3 from ref.py in float32 at one of 33.3 M Gemma 2B
# prefill outputs).  Its tight check is the float32 kernel on the
# same inputs, upcast, against ref.py in float32 (3e-4), as in phase 6.
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
    "seg_agg_indexed": "none: fuses src/repro/models/gnn/models.py:79 with seg_agg",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:94",
    "gat_attend": "none: JAX has no GAT",
    "dot_attend": "none: JAX has no Graph Transformer",
    "lstm_agg": "none: JAX has no LSTM aggregator",
    "sample_layer": "none: src/repro/graph/sampling.py samples in jnp ops, fused by XLA",
}
SOURCES = {
    "cached_gather": "src/repro_torch/csrc/cached_gather.cu",
    "cached_gather_blocks": "src/repro_torch/csrc/cached_gather.cu",
    "cached_gather_select": "src/repro_torch/csrc/cached_gather.cu",
    "seg_agg": "src/repro_torch/csrc/seg_agg.cu",
    "seg_agg_indexed": "src/repro_torch/csrc/seg_agg.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "gat_attend": "src/repro_torch/csrc/gat_attend.cu",
    "dot_attend": "src/repro_torch/csrc/dot_attend.cu",
    "lstm_agg": "src/repro_torch/csrc/lstm_agg.cu",
    "sample_layer": "src/repro_torch/csrc/sample_layer.cu",
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
    from repro_torch.kernels.dot_attend import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gat_attend import kernel as ga
    from repro_torch.kernels.lstm_agg import kernel as la
    from repro_torch.kernels.sample_layer import kernel as sl
    from repro_torch.kernels.seg_agg import kernel as sa
    from repro_torch.runtime.gnn_engine import HBM3_BW, PCIE5_BW

    phase("2. build")
    t0 = time.perf_counter()
    names = KERNEL_SOURCES
    # One nvcc per source, all started together; each call raises on failure.
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build_library, names)))
    for mod in (cg, sa, fa, ga, sl, da, la):
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
    row["indexed"] = [indexed_row(gen, hbm, *case) for case in INDEXED_CASES]
    return row, max_err


def indexed_row(gen, hbm: float, label: str, f: int, rows: int, mode: str) -> dict:
    """seg_agg_indexed at one offline cell's layer 0: parity with ref.py and
    its times beside ref.py, the expansion with the fanout sum it replaces,
    and its bytes bound; then its dense form (no index, the routes without
    dedup) beside the split and sum that layer 0 ran before it."""
    import torch

    from repro_torch.kernels.seg_agg import kernel as sa
    from repro_torch.kernels.seg_agg.ref import seg_agg_indexed_ref

    n, fo = INDEXED_DST, INDEXED_FANOUT
    table = torch.randn((rows, f), generator=gen, device="cuda")
    idx = torch.randint(0, rows, (n * (1 + fo),), generator=gen, device="cuda",
                        dtype=torch.int32)
    kw = dict(num_dst=n, fanout=fo, mode=mode)

    def parts(out):  # sage gives (self rows, sums), gcn the mean
        return out if mode == "sage" else (out,)

    # Self rows are copies: equal to ref.py's.  The sum against the float64
    # one within float32 summation's bound in any order, (fanout + 2) *
    # 2**-24 over the sum of magnitudes; the largest gap to ref.py
    # (float32, torch's own order) is printed.
    got = parts(sa.seg_agg_indexed(table, idx, **kw))
    want = parts(seg_agg_indexed_ref(table, idx, **kw))
    if mode == "sage" and not torch.equal(got[0], want[0]):
        raise AssertionError(f"seg_agg_indexed ({label}): self rows differ from ref.py")
    exact = parts(seg_agg_indexed_ref(table.double(), idx, **kw))[-1]
    mags = parts(seg_agg_indexed_ref(table.abs().double(), idx, **kw))[-1]
    if not bool(((got[-1].double() - exact).abs() <= (fo + 2) * 2.0**-24 * mags).all()):
        raise AssertionError(f"seg_agg_indexed ({label}) beyond float32 summation's bound")
    err = float((got[-1] - want[-1]).abs().max())
    del want, exact, mags
    idx64 = idx.long()

    def expand_then_sum():
        h = table[idx64]
        return h[n:].view(n, fo, f).sum(1)

    distinct = int(torch.unique(idx).numel())
    outs = 2 if mode == "sage" else 1
    nbytes = (distinct * f + n * outs * f) * 4 + idx.numel() * 4
    positions_bytes = (idx.numel() * f + n * outs * f) * 4 + idx.numel() * 4
    out = dict(label=label, shape=[n, fo, f], table_rows=rows, mode=mode, max_abs_err=err,
               ms=cuda_ms(lambda: sa.seg_agg_indexed(table, idx, **kw), reps=10),
               plain_ms=cuda_ms(lambda: seg_agg_indexed_ref(table, idx, **kw), reps=3),
               library_ms=cuda_ms(expand_then_sum, reps=3),
               distinct_rows=distinct, bytes=nbytes, bound_ms=1e3 * nbytes / hbm,
               every_position_bytes=positions_bytes,
               every_position_ms=1e3 * positions_bytes / hbm)
    log(f"  indexed {label} [{n} x {1 + fo}, F {f}] {mode}: kernel {out['ms']:.4f} ms  bound "
        f"{out['bound_ms']:.4f} ms ({distinct} distinct rows, {nbytes} B; every position read "
        f"{out['every_position_ms']:.4f} ms)  ref.py {out['plain_ms']:.4f} ms  x[idx] + sum "
        f"{out['library_ms']:.4f} ms; max abs err {err:.3g}")

    # The dense form reads the expanded rows in place: the same bits as the
    # indexed form.  Before it, layer 0 summed them with split_frontier and
    # .sum(1) (GCN then added the self rows and divided; GraphSAGE's FC
    # took the self rows as a view).
    dense = table[idx64]
    del table, idx, idx64
    got_dense = parts(sa.seg_agg_indexed(dense, None, **kw))
    if not all(torch.equal(a, b) for a, b in zip(got, got_dense)):
        raise AssertionError(f"seg_agg_indexed ({label}): dense form differs from indexed form")
    del got, got_dense

    def split_then_sum():
        agg = dense[n:].view(n, fo, f).sum(1)
        return agg if mode == "sage" else (dense[:n] + agg) / (fo + 1)

    # GraphSAGE's self rows are read in place (a view): neither read nor
    # written here.
    dense_bytes = n * (fo + (mode == "gcn") + 1) * f * 4
    out.update(dense_ms=cuda_ms(lambda: sa.seg_agg_indexed(dense, None, **kw), reps=10),
               dense_before_ms=cuda_ms(split_then_sum, reps=10), dense_bytes=dense_bytes,
               dense_bound_ms=1e3 * dense_bytes / hbm)
    log(f"  dense {label} [{n} x {1 + fo}, F {f}] {mode}: kernel {out['dense_ms']:.4f} ms  "
        f"bound {out['dense_bound_ms']:.4f} ms ({dense_bytes} B)  split + sum(1)"
        f"{' + self, / n' if mode == 'gcn' else ''} {out['dense_before_ms']:.4f} ms")
    del dense
    return out


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


def check_attention(got, q, k, v, kw, against_f32: bool = True) -> float:
    """Hold one kernel output against ref.py on the same inputs in their
    dtype, and a bfloat16 output also against ref.py in float32 (unless
    ``against_f32`` is False); returns the max abs error against the
    same-dtype ref.py."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

    hq = q.shape[1]
    want = attention_ref(q, expand_kv(k, hq), expand_kv(v, hq), **kw)
    tol = ATT_TOL[str(q.dtype).split(".")[1]]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = float((got.float() - want.float()).abs().max())
    if q.dtype == torch.bfloat16 and against_f32:
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


def line_phase(case, h2d) -> dict:
    """Phase 4, continued at Reddit's shape (F = 602, pinned host table):
    #2 on the dedup bucket as the path gives it and with every row
    missing, each output equal to ref.py, and each launch reading its host
    side by aligned lines (``line_launches``); its miss bytes over its
    time beside the pinned copy rate; and the lines it reads a miss row
    (``line_plan``'s count over the bucket's all-miss spans and the miss
    rows of its other blocks) beside the lines a row's bytes fill."""
    import torch

    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.kernels.cached_gather.kernel import ROW_BLOCK
    from repro_torch.kernels.cached_gather.ref import cached_gather_ref

    hot, host, uids = case["hot"], case["host"], case["uids"]
    n_hot, n_host, row = hot.shape[0], host.shape[0], hot.shape[1] * hot.element_size()
    base = tk._host_pointer(host)
    out = {}
    for variant, pos in (("main", case["upos"]), ("all-miss", torch.full_like(uids, -1))):
        before = tk.cached_gather_blocks.line_launches
        got = tk.cached_gather_blocks(hot, host, uids, pos)
        if not torch.equal(got, cached_gather_ref(hot, host, uids, pos)):
            raise AssertionError(f"#2 disagrees with ref.py at F = 602 ({variant})")
        if tk.cached_gather_blocks.line_launches != before + 1:
            raise AssertionError("#2 did not read Reddit's pinned miss rows by aligned lines")
        del got
        ms = cuda_ms(lambda: tk.cached_gather_blocks(hot, host, uids, pos), reps=5)
        # The ranges copy_lines reads: each all-miss span of ROW_BLOCK rows,
        # and each miss row of every other block.
        mode, start = tk.classify_blocks(uids, pos, n_hot, n_host, ROW_BLOCK)
        span = mode == 2
        in_span = span.repeat_interleave(ROW_BLOCK)[: uids.shape[0]]
        rows_alone = uids[(pos < 0) & ~in_span].to(torch.int64).clamp(0, n_host - 1)
        ranges = [(base + start[span].to(torch.int64) * row, ROW_BLOCK * row),
                  (base + rows_alone * row, row)]
        n_lines = sum(int(((a % tk.LINE_BYTES + nbytes + tk.LINE_BYTES - 1)
                           // tk.LINE_BYTES).sum()) for a, nbytes in ranges)
        for a, nbytes in ranges:  # the count is line_plan's
            for x in a[:16].tolist():
                plan = tk.line_plan(x, nbytes, base, base + n_host * row)
                if plan["n_lines"] != (x % tk.LINE_BYTES + nbytes + tk.LINE_BYTES - 1) // tk.LINE_BYTES:
                    raise AssertionError("line_plan's count differs from the kernel's arithmetic")
        miss_rows = int((pos < 0).sum())
        rate = miss_rows * row / (ms / 1e3)
        out[variant] = dict(rows=int(uids.shape[0]), miss_rows=miss_rows, ms=ms,
                            bound_ms=bound_ms(hot, uids, pos, True, h2d), miss_bytes_per_s=rate,
                            spans=int(span.sum()), lines_per_miss_row=n_lines / max(miss_rows, 1),
                            lines_filled_per_row=row / tk.LINE_BYTES)
        log(f"  cached_gather_blocks   F=602 pinned {variant:8s} rows={uids.shape[0]:8d} miss="
            f"{miss_rows:8d} kernel {ms:8.3f} ms  bound {out[variant]['bound_ms']:7.3f} ms  miss "
            f"bytes {rate / 1e9:.2f} GB/s (pinned copy {h2d / 1e9:.2f} GB/s); lines read a miss "
            f"row {out[variant]['lines_per_miss_row']:.2f} ({row / tk.LINE_BYTES:.2f} filled by "
            f"its bytes; {out[variant]['spans']} all-miss spans), by aligned lines, equal")
    return out


def main_path_phase(eng) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.kernels.sample_layer import kernel as sl
    from repro_torch.kernels.seg_agg import kernel as sa

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
    indexed_total = sampled_total = 0
    for label, cfg in routes.items():
        # Counts set to 0 just before each route and read just after it;
        # the run is MAIN_BATCHES batches plus one warmup batch.
        for fn in counters:
            fn.launches = 0
        sa.seg_agg_indexed.launches = 0
        sl.sample_layer.launches = 0
        t0 = time.perf_counter()
        rep = eng.run(config=cfg, max_batches=MAIN_BATCHES, collect_outputs=True)
        wall = time.perf_counter() - t0
        route_launches[label] = {fn.__name__: fn.launches for fn in counters}
        indexed = sa.seg_agg_indexed.launches
        if indexed != MAIN_BATCHES + 1 or rep.fused_batches != MAIN_BATCHES:
            raise AssertionError(f"{label}: seg_agg_indexed launched {indexed} times, "
                                 f"fused_batches {rep.fused_batches}, for {MAIN_BATCHES} "
                                 f"batches and a warmup")
        indexed_total += indexed
        sampled = sl.sample_layer.launches
        if sampled != len(FANOUTS) * (MAIN_BATCHES + 1):
            raise AssertionError(f"{label}: sample_layer launched {sampled} times for "
                                 f"{len(FANOUTS)} layers x ({MAIN_BATCHES} batches + a warmup)")
        sampled_total += sampled
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
    log(f"  logits and hit counts identical across {sorted(outputs)}; seg_agg_indexed once "
        f"per batch on every route; sample_layer.launches {len(FANOUTS) * (MAIN_BATCHES + 1)} "
        f"a route ({len(FANOUTS)} layers x ({MAIN_BATCHES} batches + a warmup)), "
        f"{sampled_total} in all")
    if launches["cached_gather"] == 0 or launches["cached_gather_blocks"] == 0:
        raise AssertionError(f"a main-path kernel was never launched: {launches}")
    return {"reports": reports, "launches": launches, "route_launches": route_launches,
            "launches_per_batch": per_batch, "max_memory_allocated": peak,
            "seg_agg_indexed_launches": indexed_total, "sample_layer_launches": sampled_total}


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of the host's time to issue one call, over
    ``reps`` calls after one warmup (the card drains them afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / reps * 1e3


def sampler_phase(eng, hbm: float) -> dict:
    """Phase 8b: the sampler's kernel at the offline cells' last layer
    against ref.py (bit for bit) and timed beside the plain path and the
    concatenation it replaced and beside its bytes bound; then a whole
    batch's sample_blocks both ways."""
    import numpy as np
    import torch

    from bench.data import make_graph
    from repro_torch.graph import sampling
    from repro_torch.graph.csc import CSCGraph
    from repro_torch.kernels.sample_layer import kernel as sl
    from repro_torch.kernels.sample_layer.ref import sample_layer_ref

    phase(f"8b. sample_layer at the last layer of batch {SAMPLER_BATCH}, fanouts {FANOUTS}: "
          f"ogbn-products (phase 3's graph) and Reddit's stand-in")
    cuda = torch.device("cuda")
    reddit = make_graph(json.loads(REDDIT_CONFIG.read_text())["dataset"], SEED, device=cuda)
    graphs = {
        "products": (eng.pipeline.caches.dgraph, eng.dataset.test_idx),
        "reddit": (sampling.device_graph(CSCGraph(col_ptr=reddit.col_ptr,
                                                  row_index=reddit.row_index), device=cuda),
                   reddit.test_idx),
    }
    rows = []
    for label, (g, test_idx) in graphs.items():
        gen = torch.Generator(device=cuda).manual_seed(SEED)
        batch = torch.from_numpy(np.asarray(test_idx[:SAMPLER_BATCH], np.int32)).to(cuda)
        seeds = sampling.sample_blocks(g, batch, FANOUTS[1:], generator=gen).input_nodes
        fanout = FANOUTS[0]
        u = torch.rand((seeds.shape[0], fanout), generator=gen, dtype=torch.float64, device=cuda)
        buf = torch.empty(seeds.shape[0] * (1 + fanout), dtype=torch.int32, device=cuda)
        buf[: seeds.shape[0]] = seeds
        head, tail = buf[: seeds.shape[0]], buf[seeds.shape[0]:]
        count = torch.zeros((), dtype=torch.int64, device=cuda)
        plain_nbr = torch.empty_like(tail)
        plain_count = torch.zeros_like(count)
        hit, slots = sl.sample_layer(g, head, u, tail, count)
        plain_hit, plain_slots = sample_layer_ref(g, seeds, u, plain_nbr, plain_count)
        torch.cuda.synchronize()
        if not (torch.equal(tail, plain_nbr) and torch.equal(hit, plain_hit)
                and torch.equal(slots, plain_slots) and int(count) == int(plain_count)):
            raise AssertionError(f"{label}: sample_layer differs from ref.py on the same u")

        def kernel():
            sl.sample_layer(g, head, u, tail, count)

        def plain():  # the plain path and the concatenation the kernel replaced
            sample_layer_ref(g, seeds, u, plain_nbr, plain_count)
            torch.cat([seeds, plain_nbr])

        draws = seeds.shape[0] * fanout
        nbytes = seeds.shape[0] * SAMPLER_SEED_BYTES + draws * SAMPLER_DRAW_BYTES
        row = {
            "label": label, "seeds": int(seeds.shape[0]), "draws": draws,
            "hit_share": int(plain_count) / draws,
            "ms": device_ms(kernel, SAMPLER_REPS), "plain_ms": device_ms(plain, SAMPLER_REPS),
            "host_ms": host_ms(kernel, SAMPLER_REPS),
            "plain_host_ms": host_ms(plain, SAMPLER_REPS),
            "bytes": nbytes, "bound_ms": nbytes / hbm * 1e3, "max_abs_err": 0,
        }

        def block(layer_fn):
            def run():
                sampling.sample_layer = layer_fn
                try:
                    sampling.sample_blocks(g, batch, FANOUTS, generator=gen, dedup=True)
                finally:
                    sampling.sample_layer = sl.sample_layer
            return run

        for key, fn in (("batch", block(sl.sample_layer)), ("plain_batch", block(sample_layer_ref))):
            row[f"{key}_ms"] = device_ms(fn, SAMPLER_REPS)
            row[f"{key}_host_ms"] = host_ms(fn, SAMPLER_REPS)
        rows.append(row)
        log(f"  {label}: {row['seeds']} seeds x {fanout}, hit share {row['hit_share']:.4f}; "
            f"kernel {row['ms']:.4f} ms (host {row['host_ms']:.4f}), plain + cat "
            f"{row['plain_ms']:.4f} ms (host {row['plain_host_ms']:.4f}), bound "
            f"{row['bound_ms']:.4f} ms ({nbytes} B); a batch's sample_blocks with dedup: "
            f"kernel {row['batch_ms']:.4f} ms (host {row['batch_host_ms']:.4f}), plain "
            f"{row['plain_batch_ms']:.4f} ms (host {row['plain_batch_host_ms']:.4f})")
        del buf, head, tail, u, seeds, hit, slots, plain_hit, plain_slots, plain_nbr
    del graphs, reddit
    torch.cuda.empty_cache()
    return {"layers": rows}


def gat_phase(ds, hbm: float) -> dict:
    """Phase 20: gat_attend at the GAT cell's three layers against ref.py
    and timed, then GAT through the engine with its launches counted."""
    import numpy as np
    import torch

    from bench import models as bench_models
    from repro_torch.kernels.gat_attend import kernel as ga
    from repro_torch.kernels.gat_attend.ref import gat_attend_ref

    config = json.loads(GAT_CONFIG.read_text())
    bench_gat = bench_models.load("gat")
    widths = bench_gat.dims(config)
    phase(f"20. GAT: gat_attend at gat-products.offline4096's layers, then the engine "
          f"(batch {GAT_BATCH}, fanouts {FANOUTS})")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 29)
    layers = []
    for layer, fo in enumerate(FANOUTS):  # layer 0 reads the deepest frontier
        heads, f = config["heads"][layer], widths[layer]
        width = widths[-1] if layer == len(FANOUTS) - 1 else config["head_dim"]
        n = GAT_BATCH * int(np.prod([1 + k for k in FANOUTS[layer + 1:]]))
        positions = n * (1 + fo)
        indexed = layer == 0
        if indexed:
            x = torch.randn((GAT_TABLE_ROWS, f), generator=gen, device="cuda")
            idx = torch.randint(0, GAT_TABLE_ROWS, (positions,), generator=gen, device="cuda",
                                dtype=torch.int32)
            distinct = int(torch.unique(idx).numel())
        else:
            x, idx, distinct = torch.randn((positions, f), generator=gen, device="cuda"), None, positions
        w = torch.randn((f, heads * width), generator=gen, device="cuda") / f ** 0.5
        a_src, a_dst = torch.randn((2, heads, width), generator=gen, device="cuda") / width ** 0.5
        u = torch.einsum("fhd,shd->shf", w.view(f, heads, width), torch.stack((a_src, a_dst)))
        kw = dict(num_dst=n, fanout=fo, negative_slope=config["negative_slope"])
        label = f"layer {layer}"

        got = ga.gat_attend(x, idx, u, **kw)
        exact = gat_attend_ref(x.double(), idx, u.double(), **kw)
        err = float((got.double() - exact).abs().max())
        gap = err / float(exact.abs().max())
        del exact
        if not gap <= GAT_TOL:
            raise AssertionError(f"gat_attend ({label}): {gap:.3g} of the largest output from "
                                 f"ref.py in float64, over {GAT_TOL}")
        idx64 = None if idx is None else idx.long()

        def paper_order():
            """Project every position's row, score, softmax, sum (Eqs. 2-4)."""
            z = ((x if idx64 is None else x[idx64]) @ w).view(-1, heads, width)
            z_self, nbr = z[:n], z[n:].view(n, fo, heads, width)
            e = torch.cat([(z_self * a_src).sum(-1)[:, None], (nbr * a_src).sum(-1)], 1)
            e = torch.nn.functional.leaky_relu(e + (z_self * a_dst).sum(-1)[:, None],
                                               config["negative_slope"])
            alpha = torch.softmax(e, 1)
            return alpha[:, 0, :, None] * z_self + (alpha[:, 1:, :, None] * nbr).sum(1)

        mine = torch.einsum("nhf,fhd->nhd", got, w.view(f, heads, width))
        lib = paper_order()
        library_gap = float((lib - mine).abs().max() / lib.abs().max())
        del lib, mine
        nbytes = bench_gat.attend_bytes(f, widths[layer + 1], config=config, layer=layer, dst=n,
                                        positions=positions, distinct_rows=distinct,
                                        indexed=indexed)
        row = dict(label=label, shape=[n, 1 + fo, f], heads=heads, indexed=indexed,
                   distinct_rows=distinct, max_abs_err=err, max_rel_gap=gap,
                   library_rel_gap=library_gap,
                   ms=cuda_ms(lambda: ga.gat_attend(x, idx, u, **kw), reps=10),
                   plain_ms=cuda_ms(lambda: gat_attend_ref(x, idx, u, **kw), reps=3),
                   library_ms=cuda_ms(paper_order, reps=3),
                   bytes=nbytes, bound_ms=1e3 * nbytes / hbm)
        form = "through the index" if indexed else "in place"
        log(f"  {label} [{n} x {1 + fo}, F {f}, {heads} heads] {form}: kernel {row['ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({distinct} distinct rows, {nbytes} B)  ref.py "
            f"{row['plain_ms']:.4f} ms  paper order {row['library_ms']:.4f} ms; gap to ref.py in "
            f"float64 {gap:.3g} of the largest output, paper order to the kernel's heads "
            f"{library_gap:.3g}")
        if indexed:  # the dense form of the same positions: the same bits
            dense = x[idx64]
            del x, idx, idx64
            if not torch.equal(ga.gat_attend(dense, None, u, **kw), got):
                raise AssertionError(f"gat_attend ({label}): dense form differs from indexed form")
            row["dense_ms"] = cuda_ms(lambda: ga.gat_attend(dense, None, u, **kw), reps=10)
            log(f"  {label} dense form (no index): kernel {row['dense_ms']:.4f} ms, the same bits")
            del dense
        else:
            del x
        del got, w, u
        torch.cuda.empty_cache()
        layers.append(row)

    return {"layers": layers, **attention_engine_runs(ds, "gat", ga.gat_attend, config, widths[-1])}


def gt_phase(ds, hbm: float) -> dict:
    """Phase 21: dot_attend at the Graph Transformer cell's three layers against
    ref.py and timed, then the Graph Transformer through the engine with its
    launches counted."""
    import numpy as np
    import torch

    from bench import models as bench_models
    from repro_torch.kernels.dot_attend import kernel as da
    from repro_torch.kernels.dot_attend.ref import dot_attend_ref
    from repro_torch.models.gnn import models as gm

    config = json.loads(GT_CONFIG.read_text())
    bench_gt = bench_models.load("graph_transformer")
    widths = bench_gt.dims(config)
    phase(f"21. Graph Transformer: dot_attend at gt-products.offline4096's layers, then the "
          f"engine (batch {GAT_BATCH}, fanouts {FANOUTS})")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    layers = []
    for layer, fo in enumerate(FANOUTS):  # layer 0 reads the deepest frontier
        heads, f = config["heads"][layer], widths[layer]
        width = widths[-1] if layer == len(FANOUTS) - 1 else config["head_dim"]
        n = GAT_BATCH * int(np.prod([1 + k for k in FANOUTS[layer + 1:]]))
        positions = n * (1 + fo)
        indexed = layer == 0
        if indexed:
            x = torch.randn((GAT_TABLE_ROWS, f), generator=gen, device="cuda")
            idx = torch.randint(0, GAT_TABLE_ROWS, (positions,), generator=gen, device="cuda",
                                dtype=torch.int32)
            distinct = int(torch.unique(idx).numel())
            self_h = x[idx[:n].long()]
        else:
            x, idx, distinct = torch.randn((positions, f), generator=gen, device="cuda"), None, positions
            self_h = x[:n]
        p = {}
        for name in "qkv":
            p[f"w_{name}"] = torch.randn((f, heads * width), generator=gen, device="cuda") / f ** 0.5
            p[f"b_{name}"] = torch.randn((heads, width), generator=gen, device="cuda") / f ** 0.5
        u = gm._gt_query(p, self_h)
        kw = dict(num_dst=n, fanout=fo)
        label = f"layer {layer}"

        got = da.dot_attend(x, idx, u, **kw)
        exact = dot_attend_ref(x.double(), idx, u.double(), **kw)
        err = float((got.double() - exact).abs().max())
        gap = err / float(exact.abs().max())
        del exact
        if not gap <= GAT_TOL:
            raise AssertionError(f"dot_attend ({label}): {gap:.3g} of the largest output from "
                                 f"ref.py in float64, over {GAT_TOL}")
        idx64 = None if idx is None else idx.long()

        def paper_order():
            """Project every neighbour's row to a key and a value, score, softmax, sum."""
            nbr = x[n:] if idx64 is None else x[idx64[n:]]
            q = (self_h @ p["w_q"]).view(n, 1, heads, width) + p["b_q"]
            k = (nbr @ p["w_k"]).view(n, fo, heads, width) + p["b_k"]
            alpha = torch.softmax((q * k).sum(-1) / width ** 0.5, 1)
            del k
            v = (nbr @ p["w_v"]).view(n, fo, heads, width) + p["b_v"]
            return (alpha[..., None] * v).sum(1)

        mine = torch.einsum("nhf,fhd->nhd", got, p["w_v"].view(f, heads, width)) + p["b_v"]
        lib = paper_order()
        library_gap = float((lib - mine).abs().max() / lib.abs().max())
        del lib, mine
        nbytes = bench_gt.attend_bytes(f, widths[layer + 1], config=config, layer=layer, dst=n,
                                       positions=positions, distinct_rows=distinct,
                                       indexed=indexed)
        row = dict(label=label, shape=[n, fo, f], heads=heads, indexed=indexed,
                   distinct_rows=distinct, max_abs_err=err, max_rel_gap=gap,
                   library_rel_gap=library_gap,
                   ms=cuda_ms(lambda: da.dot_attend(x, idx, u, **kw), reps=10),
                   plain_ms=cuda_ms(lambda: dot_attend_ref(x, idx, u, **kw), reps=3),
                   library_ms=cuda_ms(paper_order, reps=3),
                   bytes=nbytes, bound_ms=1e3 * nbytes / hbm)
        form = "through the index" if indexed else "in place"
        log(f"  {label} [{n} x {fo}, F {f}, {heads} heads] {form}: kernel {row['ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({distinct} distinct rows, {nbytes} B)  ref.py "
            f"{row['plain_ms']:.4f} ms  paper order {row['library_ms']:.4f} ms; gap to ref.py in "
            f"float64 {gap:.3g} of the largest output, paper order to the kernel's heads "
            f"{library_gap:.3g}")
        if indexed:  # the dense form of the same positions: the same bits
            dense = x[idx64]
            del x, idx, idx64
            if not torch.equal(da.dot_attend(dense, None, u, **kw), got):
                raise AssertionError(f"dot_attend ({label}): dense form differs from indexed form")
            row["dense_ms"] = cuda_ms(lambda: da.dot_attend(dense, None, u, **kw), reps=10)
            log(f"  {label} dense form (no index): kernel {row['dense_ms']:.4f} ms, the same bits")
            del dense
        else:
            del x
        del got, u, p, self_h
        torch.cuda.empty_cache()
        layers.append(row)

    return {"layers": layers,
            **attention_engine_runs(ds, "graph_transformer", da.dot_attend, config, widths[-1])}


def lstm_phase(hbm: float) -> dict:
    """Phase 22: lstm_agg at the GraphSAGE-LSTM cell's two layers against
    ref.py and timed beside the input map, cuDNN's LSTM and the bound, then
    GraphSAGE-LSTM through the engine on Reddit's stand-in with its launches
    counted."""
    import numpy as np
    import torch

    from bench import models as bench_models
    from bench.data import make_graph
    from bench.drive import _dataset
    from bench.flops import FP32_PEAK
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels.lstm_agg import kernel as la
    from repro_torch.kernels.lstm_agg.ref import lstm_agg_ref
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine

    config = json.loads(LSTM_CONFIG.read_text())
    model = bench_models.load("graphsage_lstm")
    widths = model.dims(config)
    fanouts = tuple(config["fanouts"])
    hidden = config["lstm_hidden"]
    phase(f"22. GraphSAGE-LSTM: lstm_agg at sage-lstm-reddit.offline4096's layers, then the "
          f"engine (batch {GAT_BATCH}, fanouts {fanouts})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 35)
    layers = []
    for layer, fo in enumerate(fanouts):  # layer 0 reads the deepest frontier
        f = widths[layer]
        n = GAT_BATCH * int(np.prod([1 + k for k in fanouts[layer + 1:]]))
        indexed = layer == 0
        table_rows = LSTM_TABLE_ROWS if indexed else n * fo
        x = torch.randn((table_rows, f), generator=gen, device="cuda")
        idx = (torch.randint(0, table_rows, (n * (1 + fo),), generator=gen, device="cuda",
                             dtype=torch.int32) if indexed else None)
        distinct = int(torch.unique(idx[n:]).numel()) if indexed else table_rows
        w_ih = torch.randn((f, 4 * hidden), generator=gen, device="cuda") / f ** 0.5
        w_hh = torch.randn((hidden, 4 * hidden), generator=gen, device="cuda") / hidden ** 0.5
        b = torch.randn((4 * hidden,), generator=gen, device="cuda") / f ** 0.5
        g = torch.addmm(b, x, w_ih)
        kw = dict(num_dst=n, fanout=fo)
        label = f"layer {layer}"

        got = la.lstm_agg(g, idx, w_hh, **kw)
        exact = lstm_agg_ref(g.double(), idx, w_hh.double(), **kw)
        err = float((got.double() - exact).abs().max())
        gap = err / float(exact.abs().max())
        del exact
        if not gap <= GAT_TOL:
            raise AssertionError(f"lstm_agg ({label}): {gap:.3g} of the largest state from "
                                 f"ref.py in float64, over {GAT_TOL}")
        if not torch.equal(la.lstm_agg(g, idx, w_hh, **kw), got):
            raise AssertionError(f"lstm_agg ({label}): a second run gave other bits")

        # cuDNN's LSTM over the gathered sequence of input rows: torch's gate
        # order is (i, f, g, o) and it adds no forget bias, so the maps are
        # permuted and the 1 rides in bias_hh.
        perm = torch.cat([torch.arange(k * hidden, (k + 1) * hidden, device="cuda")
                          for k in (0, 2, 1, 3)])
        lstm = torch.nn.LSTM(f, hidden, batch_first=True, device="cuda")
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(w_ih[:, perm].T)
            lstm.weight_hh_l0.copy_(w_hh[:, perm].T)
            lstm.bias_ih_l0.copy_(b[perm])
            lstm.bias_hh_l0.zero_()
            lstm.bias_hh_l0[hidden:2 * hidden] = 1.0
        seq = (x if idx is None else x[idx[n:].long()]).view(n, fo, f)

        def library():
            with torch.no_grad():
                return lstm(seq)[1][0][0]

        library_gap = float((library() - got).abs().max() / got.abs().max())
        flops = model.recur_flops(n, n * fo, config=config)
        nbytes = model.recur_bytes(n, n * fo, config=config, distinct_rows=distinct,
                                   indexed=indexed)
        bound_s = max(flops / FP32_PEAK, nbytes / hbm)
        row = dict(label=label, shape=[n, fo, f], indexed=indexed, distinct_rows=distinct,
                   max_abs_err=err, max_rel_gap=gap, library_rel_gap=library_gap,
                   ms=cuda_ms(lambda: la.lstm_agg(g, idx, w_hh, **kw), reps=10),
                   plain_ms=cuda_ms(lambda: lstm_agg_ref(g, idx, w_hh, **kw), reps=3),
                   input_map_ms=cuda_ms(lambda: torch.addmm(b, x, w_ih), reps=10),
                   library_ms=cuda_ms(library, reps=3),
                   flops=flops, bytes=nbytes, bound_ms=1e3 * bound_s,
                   bound_by="operations" if flops / FP32_PEAK >= nbytes / hbm else "bytes")
        form = "through the index" if indexed else "in place"
        log(f"  {label} [{n} x {fo}, F {f}, H {hidden}] {form}: kernel {row['ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({flops} FLOP, {nbytes} B, "
            f"{distinct} distinct rows)  ref.py {row['plain_ms']:.4f} ms  input map "
            f"{row['input_map_ms']:.4f} ms ({table_rows} rows)  cuDNN LSTM over the gathered "
            f"sequence {row['library_ms']:.4f} ms; gap to ref.py in float64 {gap:.3g} of the "
            f"largest state, cuDNN to the kernel {library_gap:.3g}")
        if indexed:  # the dense form of the same slots: the same bits
            dense = g[idx[n:].long()]
            if not torch.equal(la.lstm_agg(dense, None, w_hh, **kw), got):
                raise AssertionError(f"lstm_agg ({label}): dense form differs from indexed form")
            row["dense_ms"] = cuda_ms(lambda: la.lstm_agg(dense, None, w_hh, **kw), reps=10)
            log(f"  {label} dense form (no index): kernel {row['dense_ms']:.4f} ms, the same bits")
            del dense
        del x, g, got, seq, lstm, idx
        torch.cuda.empty_cache()
        layers.append(row)

    data = make_graph(config["dataset"], SEED, device="cuda")
    params = model.init(config, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    eng = GNNInferenceEngine(_dataset(config, data), model="graphsage_lstm", fanouts=fanouts,
                             batch_size=GAT_BATCH, seed=SEED, params=params, device="cuda")
    t0 = time.perf_counter()
    eng.prepare(config["policy"], config=EngineConfig(),
                total_cache_bytes=int(config["cache_mb"] * 1e6),
                n_presample=config["n_presample"])
    prepare_s = time.perf_counter() - t0
    batches = min(MAIN_BATCHES, len(data.test_idx) // GAT_BATCH)
    runs, outputs, launches = {}, {}, 0
    for label, depth in (("kernel_dedup_d2", 2), ("kernel_dedup_d1", 1)):
        cfg = EngineConfig(use_kernel=True, dedup=True, pipeline_depth=depth)
        la.lstm_agg.launches = 0
        rep = eng.run(config=cfg, max_batches=batches, collect_outputs=True)
        count = la.lstm_agg.launches
        if count != len(fanouts) * (batches + 1) or rep.fused_batches != batches:
            raise AssertionError(f"graphsage_lstm {label}: lstm_agg launched {count} times, "
                                 f"fused_batches {rep.fused_batches}, for {batches} batches "
                                 f"and a warm-up")
        out = np.stack(eng.last_outputs)
        if out.shape != (batches, GAT_BATCH, widths[-1]) or not np.isfinite(out).all():
            raise AssertionError(f"graphsage_lstm {label}: logits of shape {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        launches += count
        outputs[label] = out
        runs[label] = dict(rep.summary(), lstm_agg_launches=count)
        log(f"  engine {label}: {batches} batches, lstm_agg {count} launches, fused_batches "
            f"{rep.fused_batches}, distinct rows a batch {rep.unique_rows / batches:.0f}, "
            f"compute {rep.compute_seconds:.4f} s, total {rep.total_seconds:.4f} s")
    if not np.array_equal(outputs["kernel_dedup_d2"], outputs["kernel_dedup_d1"]):
        raise AssertionError("graphsage_lstm: logits at depth 2 differ from those at depth 1")
    log(f"  logits identical at depth 1 and 2; prepare {prepare_s:.1f} s")
    del eng, data
    return {"layers": layers, "runs": runs, "launches": launches, "prepare_s": prepare_s}


def attention_engine_runs(ds, model: str, kernel, config: dict, classes: int) -> dict:
    """Phases 20-21's engine part: ``model`` through ``GNNInferenceEngine`` on
    the cell's route (kernel, dedup, depth 2) and without dedup, MAIN_BATCHES
    batches of GAT_BATCH each; ``kernel`` (its ``launches`` set to 0 just
    before each run and read just after) must launch once a layer a batch,
    warm-up included, every batch must count as fused, and both routes must
    give the same logits."""
    import numpy as np

    from repro_torch.core.config import EngineConfig
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine

    name = kernel.__name__
    eng = GNNInferenceEngine(ds, model=model, fanouts=FANOUTS, batch_size=GAT_BATCH, seed=SEED,
                             device="cuda")
    t0 = time.perf_counter()
    eng.prepare(config["policy"], config=EngineConfig(), total_cache_bytes=CACHE_BYTES)
    prepare_s = time.perf_counter() - t0
    runs, outputs, launches = {}, {}, 0
    for label, dedup in (("kernel_dedup_d2", True), ("kernel_d2", False)):
        cfg = EngineConfig(use_kernel=True, dedup=dedup, pipeline_depth=2)
        kernel.launches = 0
        rep = eng.run(config=cfg, max_batches=MAIN_BATCHES, collect_outputs=True)
        count = kernel.launches
        if count != len(FANOUTS) * (MAIN_BATCHES + 1) or rep.fused_batches != MAIN_BATCHES:
            raise AssertionError(f"{model} {label}: {name} launched {count} times, fused_batches "
                                 f"{rep.fused_batches}, for {MAIN_BATCHES} batches and a warm-up")
        out = np.stack(eng.last_outputs)
        if out.shape != (MAIN_BATCHES, GAT_BATCH, classes) or not np.isfinite(out).all():
            raise AssertionError(f"{model} {label}: logits of shape {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        launches += count
        outputs[label] = out
        runs[label] = dict(rep.summary(), **{f"{name}_launches": count})
        log(f"  engine {label}: {MAIN_BATCHES} batches, {name} {count} launches "
            f"({count / (MAIN_BATCHES + 1):.0f} a batch), fused_batches {rep.fused_batches}, "
            f"compute {rep.compute_seconds:.4f} s, total {rep.total_seconds:.4f} s")
    if not np.array_equal(outputs["kernel_dedup_d2"], outputs["kernel_d2"]):
        raise AssertionError(f"{model}: logits with dedup differ from those without")
    log(f"  logits identical with and without dedup; prepare {prepare_s:.1f} s")
    del eng
    return {"runs": runs, "launches": launches, "prepare_s": prepare_s}


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


def serve_run(server, counters, **run_kw):
    """``server.run()`` counted from 0 (the launches of a serving path)."""
    return counted_run(lambda: server.run(**run_kw), counters)


def log_serve(label: str, rep, counts=None) -> dict:
    summary = rep.summary()
    log(f"  {label:34s} wall {rep.wall_seconds:.4f} s  {rep.throughput_seeds_per_s:.1f} seeds/s  "
        f"p50 {rep.p50_latency_s * 1e3:.3f} ms  p95 {rep.p95_latency_s * 1e3:.3f} ms  "
        f"p99 {rep.p99_latency_s * 1e3:.3f} ms  batches {rep.total_batches}"
        + (f"  deadline hit {rep.deadline_hit_rate:.4f} ({rep.deadline_hits}/"
           f"{rep.deadline_total})  shed {rep.requests_shed}" if rep.admission else "")
        + (f"  retries {rep.stage_retries}  retried {rep.requests_retried}  degraded "
           f"{rep.requests_degraded}  kernel_fallbacks {rep.kernel_fallbacks}  "
           f"faults {rep.faults}" if rep.faults is not None else "")
        + (f"  launches {counts}" if counts is not None else ""))
    return summary


def serving_phase(ds, eng) -> dict:
    """Multi-stream and request-level serving on phase 3's ``dci``
    pipeline: SERVE_STREAMS streams of SERVE_BATCHES batches at depth
    SERVE_DEPTH on the kernel routes, each stream held to its solo run;
    Poisson, burst and flash-crowd traces under the admission policies;
    seeded fault plans under retry, fail-fast (kernel_gather reroute) and
    degraded shedding."""
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig, ServeConfig
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine
    from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches
    from repro_torch.graph.sampling import sample_blocks
    from repro_torch.runtime.request_queue import (Request, RequestQueueServer, burst_trace,
                                                   poisson_trace, uniform_seed_batches)

    phase(f"12. serving: {SERVE_STREAMS} streams x {SERVE_BATCHES} batches on the dci pipeline, "
          f"depth {SERVE_DEPTH}")
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    n_batches = SERVE_STREAMS * SERVE_BATCHES
    queues = make_stream_batches(ds, num_streams=SERVE_STREAMS, batches_per_stream=SERVE_BATCHES,
                                 batch_size=BATCH, seed=SEED)
    seeds = [SEED + sid for sid in range(SERVE_STREAMS)]
    params = [dict(layer) for layer in eng.model.layers]
    reports, launches, outputs, base_reps = {}, {}, {}, {}

    def cfg(**kw):
        return ServeConfig(engine=EngineConfig(use_kernel=True, pipeline_depth=SERVE_DEPTH),
                           **kw)

    def add_streams(server):
        for sid, q in enumerate(queues):
            server.add_stream(q, seed=seeds[sid], collect_outputs=True)
        return server

    def stream_outputs(server):
        return [np.stack(st.runtime.outputs) for st in server.streams]

    # (a) Multi-stream: every stream against the engine running it alone.
    for label, dedup in (("kernel", False), ("kernel_dedup", True)):
        server = add_streams(MultiStreamServer(
            eng, config=cfg().replace(engine=cfg().engine.replace(dedup=dedup))))
        rep, counts = serve_run(server, counters)
        kernel = "cached_gather_blocks" if dedup else "cached_gather"
        if counts[kernel] == 0 or rep.kernel_fallbacks != 0 or rep.total_batches != n_batches:
            raise AssertionError(f"serve {label}: launches {counts}, kernel_fallbacks "
                                 f"{rep.kernel_fallbacks}, batches {rep.total_batches}")
        seen = [st.max_inflight_seen for st in server.streams]
        if max(seen) > server.max_inflight:
            raise AssertionError(f"serve {label}: in flight {seen} over the cap "
                                 f"{server.max_inflight}")
        solo_s = []
        for sid, q in enumerate(queues):
            solo = GNNInferenceEngine(ds, model="graphsage", fanouts=FANOUTS, batch_size=BATCH,
                                      seed=seeds[sid], params=params, device="cuda")
            solo.pipeline = eng.pipeline
            srep = solo.run(config=EngineConfig(use_kernel=True, dedup=dedup, pipeline_depth=1),
                            batches=list(q), collect_outputs=True)
            solo_s.append(srep.total_seconds)
            st, rt = rep.streams[sid], server.streams[sid].runtime
            if (st.adj_hits, st.adj_lookups, st.feat_hits, st.feat_lookups) != (
                    srep.adj_hits, srep.adj_lookups, srep.feat_hits, srep.feat_lookups):
                raise AssertionError(f"serve {label}: stream {sid}'s hit counts differ from "
                                     "its solo run")
            for a, b in zip(solo.last_outputs, rt.outputs):
                if not torch.equal(torch.from_numpy(a), torch.from_numpy(b)):
                    raise AssertionError(f"serve {label}: stream {sid}'s logits differ from its "
                                         "solo run")
        out = stream_outputs(server)
        if any(o.shape != (SERVE_BATCHES, BATCH, ds.spec.num_classes) or not np.isfinite(o).all()
               for o in out):
            raise AssertionError(f"serve {label}: logits of shapes {[o.shape for o in out]}")
        outputs[label] = out
        base_reps[label] = rep
        launches[label] = counts
        reports[label] = log_serve(label, rep, counts)
        reports[label].update(solo_total_s=solo_s, max_inflight_seen=seen,
                              admission_log=server.admission_log)
        for st in rep.streams:
            log(f"    stream {st.stream_id}: sample {st.sample_seconds:.4f} s  feature "
                f"{st.feature_seconds:.4f} s  compute {st.compute_seconds:.4f} s  p99 "
                f"{st.p99_latency_s * 1e3:.3f} ms  adj hit {st.adj_hit_rate:.4f}  feat hit "
                f"{st.feat_hit_rate:.4f}")
        log(f"    every stream equal to its solo run (logits and hit counts); solo kernel d1 "
            f"totals {[round(t, 4) for t in solo_s]} s; in flight at most {seen}")
    base_out, base_log = outputs["kernel"], reports["kernel"]["admission_log"]
    base_rep = base_reps["kernel"]

    # (b) Request queue.  service_s: the synchronized per-stage probe of one
    # batch after a warmup, as the reference's CLI paces its burst trace;
    # it gathers on the table route.  The Poisson trace is paced at the
    # kernel route's measured per-batch time instead, (a)'s wall over its
    # batches, so that its offered load is POISSON_LOAD of what the server
    # serves; the SLO stays 10 x the table-route time.
    probe = uniform_seed_batches(ds, n_batches=1, batch_size=BATCH, seed=SEED)[0]
    service_s = float(sum(eng._probe_stage_seconds(probe)))
    kernel_service_s = base_rep.wall_seconds / base_rep.total_batches
    slo_s = 10 * service_s
    log(f"  service_s {service_s * 1e3:.3f} ms (the probe's sample + table gather + forward); "
        f"kernel route {kernel_service_s * 1e3:.3f} ms per batch ((a)'s wall over its "
        f"{base_rep.total_batches} batches, the Poisson pace); SLO {slo_s * 1e3:.3f} ms")
    # (a)'s queues as a flash crowd (every request at t = 0) under
    # round-robin: the admission log and logits of (a) exactly.
    rq = RequestQueueServer(eng, config=cfg(), admission="round-robin")
    for sid, q in enumerate(queues):
        rq.add_request_stream([Request(i, sid, b) for i, b in enumerate(q)], seed=seeds[sid],
                              collect_outputs=True)
    rep, counts = serve_run(rq, counters)
    launches["flash_round_robin"] = counts
    reports["flash_round_robin"] = log_serve("flash crowd of (a)'s queues, round-robin", rep,
                                             counts)
    if rq.admission_log != base_log or any(
            not np.array_equal(a, b) for a, b in zip(stream_outputs(rq), base_out)):
        raise AssertionError("round-robin over a flash crowd differs from the queue server")
    log("    round-robin at t = 0 reproduces (a)'s admission log and logits")
    mean_gap = SERVE_STREAMS * kernel_service_s / POISSON_LOAD
    traces = {
        f"poisson_{name}": (name, poisson_trace(
            ds, num_streams=SERVE_STREAMS, requests_per_stream=SERVE_BATCHES, batch_size=BATCH,
            mean_interarrival_s=mean_gap, slo_s=slo_s, seed=SEED))
        for name in ("round-robin", "edf", "slo")
    }
    traces.update({
        f"burst_{name}": (name, burst_trace(
            ds, burst_requests=BURST_REQUESTS, steady_requests=2 * BURST_REQUESTS,
            batch_size=BATCH, service_estimate_s=service_s, slo_s=slo_s, seed=SEED))
        for name in ("round-robin", "edf")
    })
    for label, (admission, trace) in traces.items():
        rq = RequestQueueServer(eng, config=cfg(), admission=admission)
        for sid, reqs in enumerate(trace):
            rq.add_request_stream(reqs, seed=SEED + sid)
        rep, counts = serve_run(rq, counters)
        offered = sum(len(t) for t in trace)
        if rep.total_batches + rep.requests_shed != offered or counts["cached_gather"] == 0:
            raise AssertionError(f"{label}: {rep.total_batches} done + {rep.requests_shed} shed "
                                 f"of {offered}; launches {counts}")
        launches[label] = counts
        reports[label] = log_serve(f"{label} (mean gap {mean_gap * 1e3:.1f} ms)"
                                   if label.startswith("poisson") else label, rep, counts)

    # (c) Faults, each plan seeded here.
    def fault_serve(label, plan, server_cls=MultiStreamServer, **kw):
        server = add_streams(server_cls(eng, config=cfg(**kw), injector=FaultInjector(plan)))
        rep, counts = serve_run(server, counters, warmup=False)
        launches[label] = counts
        reports[label] = log_serve(label, rep, counts)
        return server, rep, counts

    def same_as_base(label, server):
        if any(not np.array_equal(a, b) for a, b in zip(stream_outputs(server), base_out)):
            raise AssertionError(f"{label}: logits differ from the fault-free serve")

    server, rep, _ = fault_serve(
        "faults_host_fetch_retry",
        FaultPlan(seed=2, rules=(FaultRule("host_fetch", probability=0.05),)),
        fault_policy="retry", retry_backoff_ms=0.1)
    same_as_base("host_fetch retry", server)
    if rep.stage_retries == 0 or rep.availability != 1.0:
        raise AssertionError(f"host_fetch retry: {rep.stage_retries} retries, availability "
                             f"{rep.availability}")
    server, rep, counts = fault_serve(
        "faults_kernel_gather", FaultPlan(rules=(FaultRule("kernel_gather", max_faults=2),)))
    same_as_base("kernel_gather reroute", server)
    if rep.kernel_fallbacks != 2 or counts["cached_gather"] != n_batches - 2:
        raise AssertionError(f"kernel_gather: kernel_fallbacks {rep.kernel_fallbacks}, #1 "
                             f"launched {counts['cached_gather']} of {n_batches} batches")
    log(f"    kernel_gather: 2 gathers rerouted to the table route, #1 launched "
        f"{counts['cached_gather']} times for {n_batches} batches, logits equal")
    plan = FaultPlan(rules=(FaultRule("host_fetch"),))
    rq = RequestQueueServer(eng, config=cfg(fault_policy="shed", retry_attempts=2,
                                            retry_backoff_ms=0.1, degraded_mode=True),
                            injector=FaultInjector(plan))
    for sid, q in enumerate(queues):
        rq.add_request_stream([Request(i, sid, b) for i, b in enumerate(q)], seed=seeds[sid],
                              collect_outputs=True)
    reserved = torch.cuda.memory_reserved()
    rep, counts = serve_run(rq, counters, warmup=False)
    launches["faults_host_fetch_degraded"] = counts
    reports["faults_host_fetch_degraded"] = log_serve("faults_host_fetch_degraded", rep, counts)
    for st in rq.streams:
        done = {r.request_id for r in st.completed}
        shed = {r.request_id for r in st.shed_requests}
        if done & shed or done | shed != set(range(SERVE_BATCHES)):
            raise AssertionError(f"stream {st.stream_id}: completed {done} and shed {shed} do "
                                 "not partition its requests")
    if rep.requests_degraded != n_batches or rep.requests_shed != 0:
        raise AssertionError(f"degraded: {rep.requests_degraded} degraded, "
                             f"{rep.requests_shed} shed of {n_batches}")
    # The degraded run's own logits, batch by batch, against the forward
    # of the fault-free gather with its miss rows zeroed.  Each stream's
    # draws are replayed from its own generator (seeded seed + 1, as the
    # server seeds it); the replay is first held to (a)'s fault-free logits.
    store = eng.pipeline.caches.store
    hits = zero_rows = 0
    for sid, q in enumerate(queues):
        gen = torch.Generator(device="cuda").manual_seed(seeds[sid] + 1)
        if rep.streams[sid].feat_hits != base_rep.streams[sid].feat_hits:
            raise AssertionError(f"degraded stream {sid}: feature hits "
                                 f"{rep.streams[sid].feat_hits}, fault-free "
                                 f"{base_rep.streams[sid].feat_hits}")
        for b, seeds_b in enumerate(q):
            frontier = sample_blocks(eng.pipeline.caches.dgraph, eng._seeds(seeds_b), FANOUTS,
                                     generator=gen).input_nodes
            feats, hit = store.gather(frontier, use_kernel=True)
            with torch.inference_mode():
                want = eng.model(feats).cpu().numpy()
                zeroed = eng.model(torch.where(hit[:, None], feats, 0.0)).cpu().numpy()
            if not np.array_equal(want, base_out[sid][b]):
                raise AssertionError(f"the replay of stream {sid} batch {b} is not (a)'s")
            if not np.array_equal(zeroed, rq.streams[sid].runtime.outputs[b]):
                raise AssertionError(f"degraded stream {sid} batch {b}: logits are not those of "
                                     "hit rows real and miss rows zero")
            hits += int(hit.sum())
            zero_rows += int((~hit).sum())
    log(f"    degraded: {rep.requests_degraded} of {n_batches} requests answered cache-only; "
        f"every batch's logits equal the forward of the fault-free gather with its {zero_rows} "
        f"miss rows zeroed ({hits} hit rows kept); hit counts equal (a)'s; completed and shed "
        f"partition every stream; {reserved / 1e9:.2f} GB reserved before the run, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB after")
    torch.cuda.empty_cache()
    return {"reports": reports, "launches": launches, "service_s": service_s,
            "kernel_service_s": kernel_service_s, "slo_s": slo_s, "poisson_mean_gap_s": mean_gap,
            "outputs": outputs, "hits": {
                label: [(st.adj_hits, st.adj_lookups, st.feat_hits, st.feat_lookups)
                        for st in r.streams] for label, r in base_reps.items()},
            "walls": {label: r.wall_seconds for label, r in base_reps.items()}}


def refresh_phase(ds, eng) -> dict:
    """Online refresh on phase 3's ``dci`` pipeline: the engine's interval
    refresh against refresh off, a serving join/leave under mode "all",
    a ``refresh_fill`` rollback, the pause split, the allocator's peak
    over a growing refresh and the telemetry's per-batch cost.  Leaves
    the caches as phase 12 left them."""
    import dataclasses

    import numpy as np
    import torch

    import repro_torch.runtime.cache_refresh as crm
    from repro_torch.core.allocation import reallocate_capacity
    from repro_torch.core.config import EngineConfig, ServeConfig
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule
    from repro_torch.core.telemetry import WorkloadTelemetry
    from repro_torch.graph.sampling import sample_blocks
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.runtime.cache_refresh import RefreshConfig
    from repro_torch.runtime.gnn_engine import GNNInferenceEngine
    from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches

    phase(f"13. online refresh: {REFRESH_BATCHES} batches, interval {REFRESH_INTERVAL}, "
          f"depth {SERVE_DEPTH}, on the dci pipeline")
    caches = eng.pipeline.caches
    snapshot = (caches.dgraph, caches.store, caches.allocation, caches._adj_cache, caches.epoch)
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    params = [dict(layer) for layer in eng.model.layers]
    out, launches, events_log = {}, {}, {}

    def log_events(label, events):
        rows = []
        for e in events:
            split = {k: round(v * 1e3, 3) for k, v in e.pause_split.items()}
            rows.append(dict(e.summary(), pause_split_ms=split))
            log(f"    {label} epoch {e.epoch} ({e.reason}): pause {e.pause_seconds * 1e3:.3f} ms "
                f"= {split} ms; window {e.window_batches} batches, miss rate "
                f"{e.window_miss_rate:.4f}; feat +{e.delta.feat.rows_inserted} "
                f"-{e.delta.feat.rows_evicted} ={e.delta.feat.rows_kept}, adj nodes changed "
                f"{e.delta.adj.nodes_changed}, regathered {e.delta.adj.elements_regathered}")
        events_log[label] = rows

    # (a) The engine: refresh on against refresh off, the same batches,
    # each call's wall on the host clock (the stage total leaves out the
    # retire path: the refresh pauses and the telemetry).
    batches = eng._batches(REFRESH_BATCHES)
    cfg = EngineConfig(use_kernel=True, pipeline_depth=SERVE_DEPTH)
    t0 = time.perf_counter()
    off = eng.run(config=cfg, batches=batches, collect_outputs=True)
    torch.cuda.synchronize()
    off_wall = time.perf_counter() - t0
    off_out = np.stack(eng.last_outputs)
    eq1_calls = []  # Eq. 1's inputs (the decayed lap history) and its split, per refresh

    def recorded_eq1(alloc, sample_s, feature_s, **kw):
        got = reallocate_capacity(alloc, sample_s, feature_s, **kw)
        eq1_calls.append((sum(sample_s), sum(feature_s), got.adj_bytes))
        return got

    crm.reallocate_capacity = recorded_eq1
    try:
        t0 = time.perf_counter()
        on, counts = counted_run(lambda: eng.run(
            config=cfg, batches=batches, collect_outputs=True,
            refresh=RefreshConfig(mode="interval", interval_batches=REFRESH_INTERVAL)), counters)
        torch.cuda.synchronize()
        on_wall = time.perf_counter() - t0
    finally:
        crm.reallocate_capacity = reallocate_capacity
    on_out = np.stack(eng.last_outputs)
    launches["engine"] = counts
    if not np.array_equal(on_out, off_out):
        raise AssertionError("refresh changed the engine's logits")
    if len(on.refresh_events) < 3 or counts["cached_gather"] == 0:
        raise AssertionError(f"engine refresh: {len(on.refresh_events)} events, launches {counts}")
    per_epoch = sum(v["batches"] for v in on.epoch_hits.values())
    if per_epoch != on.num_batches or caches.epoch != snapshot[4] + len(on.refresh_events):
        raise AssertionError(f"epochs {on.epoch_hits} do not partition {on.num_batches} batches")
    log(f"  engine: {len(on.refresh_events)} refreshes over {on.num_batches} batches, logits "
        f"equal to refresh off; run() wall {on_wall:.4f} s (off {off_wall:.4f} s), stage total "
        f"{on.total_seconds:.4f} s (off {off.total_seconds:.4f} s); feat hit "
        f"{on.feat_hit_rate:.4f} (off {off.feat_hit_rate:.4f}), adj hit {on.adj_hit_rate:.4f} "
        f"(off {off.adj_hit_rate:.4f}); launches {counts}")
    # What Eq. 1 reads: the preparation profile's synchronized laps seed
    # the history, and each window's depth-2 laps (dispatch times) are
    # folded in at the refresh; the step bound then clamps its split.
    pre = eng.pipeline.presample
    log(f"    preparation laps: sample {sum(pre.sample_times):.4f} s : feature "
        f"{sum(pre.feature_times):.4f} s, the build's adj share "
        f"{snapshot[2].adj_bytes / snapshot[2].total_bytes:.4f}")
    for i, (smp, feat, want) in enumerate(eq1_calls):
        log(f"    refresh {i + 1}: Eq. 1 on the decayed laps sample {smp:.4f} s : feature "
            f"{feat:.4f} s asks adj {want} B; applied adj "
            f"{on.refresh_events[i].delta.allocation.adj_bytes} B")
    alloc_walk = [snapshot[2]] + [e.delta.allocation for e in on.refresh_events]
    for ep, row in sorted(on.epoch_hits.items()):
        a = alloc_walk[ep - snapshot[4]]
        log(f"    epoch {ep}: adj {a.adj_bytes} B, feat {a.feat_bytes} B; {row['batches']} "
            f"batches, adj hit {row['adj_hit_rate']:.4f}, feat hit {row['feat_hit_rate']:.4f}")
    log_events("engine", on.refresh_events)
    out["engine"] = {"on": on.summary(), "off": off.summary(), "on_wall_s": on_wall,
                     "off_wall_s": off_wall, "eq1": eq1_calls}

    # (b) Serving under mode "all": 3 streams, a join after serving began,
    # then a leave.  Every stream's logits equal its solo run.
    queues = make_stream_batches(ds, num_streams=SERVE_STREAMS, batches_per_stream=SERVE_BATCHES,
                                 batch_size=BATCH, seed=SEED + 100)
    seeds = [SEED + 100 + sid for sid in range(SERVE_STREAMS)]
    server = MultiStreamServer(eng, config=ServeConfig(engine=cfg.replace(
        refresh_mode="all", refresh_interval=2 * SERVE_BATCHES)))
    for sid in range(SERVE_STREAMS - 1):
        server.add_stream(queues[sid], seed=seeds[sid], collect_outputs=True)
    t0 = time.perf_counter()
    rep1, c1 = serve_run(server, counters)
    t_join = time.perf_counter()
    server.add_stream(queues[-1], seed=seeds[-1], collect_outputs=True)
    join_s = time.perf_counter() - t_join
    rep2, c2 = serve_run(server, counters)
    server.remove_stream(SERVE_STREAMS - 1)
    serve_s = time.perf_counter() - t0
    launches["serve_all"] = {k: c1[k] + c2[k] for k in c1}
    reasons = [e.reason for e in server.refresh_manager.events]
    if "stream-join" not in reasons or reasons[-1] != "stream-leave" or "interval" not in reasons:
        raise AssertionError(f"serving refreshes {reasons}")
    for sid, q in enumerate(queues):
        solo = GNNInferenceEngine(ds, model="graphsage", fanouts=FANOUTS, batch_size=BATCH,
                                  seed=seeds[sid], params=params, device="cuda")
        solo.pipeline = eng.pipeline
        solo.run(config=EngineConfig(use_kernel=True, pipeline_depth=1), batches=list(q),
                 collect_outputs=True)
        got = server.streams[sid].runtime.outputs
        if len(got) != len(q) or not all(np.array_equal(a, b)
                                         for a, b in zip(solo.last_outputs, got)):
            raise AssertionError(f"refresh serve: stream {sid}'s logits differ from its solo run")
    log(f"  serve, mode all: {len(reasons)} refreshes {reasons}; every stream equal to its solo "
        f"run; the join (presampling {seeds[-1]} at full size, then a refresh) took "
        f"{join_s:.3f} s; walls {rep1.wall_seconds:.4f} + {rep2.wall_seconds:.4f} s "
        f"(serving, the join and the leave {serve_s:.2f} s); per epoch {rep2.epochs}")
    log_events("serve", server.refresh_manager.events)
    out["serve_all"] = {"reasons": reasons, "join_s": join_s, "walls": [
        rep1.wall_seconds, rep2.wall_seconds], "epochs": rep2.epochs}

    # (c) A refresh_fill fault: the one refresh (2 streams x 4 batches, an
    # interval of 8) rolls back, and serving goes on at the old epoch.
    epoch0 = caches.epoch
    plan = FaultPlan(rules=(FaultRule("refresh_fill", max_faults=1),))
    server = MultiStreamServer(eng, config=ServeConfig(engine=cfg.replace(
        refresh_mode="interval", refresh_interval=SERVE_BATCHES), fault_policy="retry",
        retry_backoff_ms=0.1), injector=FaultInjector(plan))
    for sid in range(2):
        server.add_stream(queues[sid][:SERVE_BATCHES // 2], seed=seeds[sid],
                          collect_outputs=True)
    rep, counts = serve_run(server, counters)
    launches["refresh_fill"] = counts
    failures = server.refresh_manager.failures
    if (len(failures) != 1 or failures[0].epoch != epoch0 or rep.availability != 1.0
            or rep.faults["refresh_fill"]["faults"] != 1):
        raise AssertionError(f"refresh_fill: failures {failures}, availability "
                             f"{rep.availability}, faults {rep.faults}")
    log(f"  refresh_fill: 1 refresh rolled back at epoch {epoch0} "
        f"({failures[0].error}, {failures[0].pause_seconds * 1e3:.3f} ms), "
        f"{len(rep.refresh_events)} committed after it, availability {rep.availability}")
    out["refresh_fill"] = {"failure": failures[0].summary(), "committed": len(rep.refresh_events)}

    # (d) Back to phase 12's caches, then a growing refresh alone: the
    # rollback's same-tensors property on the card, and the allocator's peak.
    (caches.dgraph, caches.store, caches.allocation, caches._adj_cache, caches.epoch) = snapshot
    stats = eng.pipeline.presample
    tensors = [caches.store.hot_table, caches.store.position_map, caches.dgraph.cache_row_index]
    clones = [t.clone() for t in tensors]
    alloc = caches.allocation
    grow = dataclasses.replace(alloc, total_bytes=alloc.total_bytes + alloc.feat_bytes,
                               feat_bytes=2 * alloc.feat_bytes)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    delta = caches.refresh(allocation=grow, node_counts=stats.node_counts,
                           edge_counts=stats.edge_counts)
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    if not all(torch.equal(t, c) for t, c in zip(tensors, clones)):
        raise AssertionError("a refresh wrote into the previous epoch's tensors")
    log(f"  growing refresh (feature budget x2): {grow_s * 1e3:.3f} ms (adj "
        f"{delta.adj_seconds * 1e3:.3f}, feat {delta.feat_seconds * 1e3:.3f}); hot table "
        f"{tuple(tensors[0].shape)} -> {tuple(caches.store.hot_table.shape)}, "
        f"+{delta.feat.rows_inserted} rows; allocator peak {peak / 1e9:.3f} GB over "
        f"{base_mem / 1e9:.3f} GB; the previous epoch's tensors unchanged")
    (caches.dgraph, caches.store, caches.allocation, caches._adj_cache, caches.epoch) = snapshot
    del clones, delta

    # (e) The telemetry's per-batch cost at full size: the read-back of the
    # frontier, hit mask and edge slots, and the numpy scatters.
    store = caches.store
    block = sample_blocks(caches.dgraph, eng._seeds(batches[0]), FANOUTS,
                          generator=torch.Generator(device="cuda").manual_seed(SEED))
    _, hit = store.gather(block.input_nodes, use_kernel=True)
    torch.cuda.synchronize()
    tel = WorkloadTelemetry(ds.num_nodes, ds.graph.num_edges)
    reads, scatters = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        host = (block.input_nodes.cpu().numpy(), hit.cpu().numpy(),
                [sl.cpu().numpy() for sl in block.edge_slots])
        t1 = time.perf_counter()
        tel.observe_batch(*host)
        t2 = time.perf_counter()
        reads.append(t1 - t0)
        scatters.append(t2 - t1)
    log(f"  telemetry per batch ({block.input_nodes.shape[0]} frontier rows, "
        f"{sum(sl.numel() for sl in block.edge_slots)} edge slots): read-back "
        f"{min(reads) * 1e3:.3f} ms, observe_batch {min(scatters) * 1e3:.3f} ms (min of 3)")
    out["telemetry_ms"] = {"read": min(reads) * 1e3, "observe": min(scatters) * 1e3}
    out.update(events=events_log, launches=launches, grow={
        "seconds": grow_s, "peak_bytes": peak, "base_bytes": base_mem,
        "rows_before": int(tensors[0].shape[0])})
    torch.cuda.empty_cache()
    return out


def sharded_phase(ds, eng, serving) -> dict:
    """Sharded serving with SHARDS co-resident shards on the card, held to
    phase 12's MultiStreamServer; an interval refresh with repartitions;
    a ``shard_exchange`` failover and rejoin."""
    import numpy as np
    import torch

    from repro_torch.core.config import EngineConfig, ServeConfig
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule
    from repro_torch.graph.sampling import sample_blocks
    from repro_torch.kernels.cached_gather import kernel as tk
    from repro_torch.runtime.gnn_serve import make_stream_batches
    from repro_torch.runtime.sharded_serve import ShardedServer

    phase(f"14. sharded serving: {SHARDS} shards co-resident on the card, {SERVE_STREAMS} "
          f"streams x {SERVE_BATCHES} batches, depth {SERVE_DEPTH}")
    caches = eng.pipeline.caches
    snapshot = (caches.dgraph, caches.store, caches.allocation, caches._adj_cache, caches.epoch)
    counters = (tk.cached_gather, tk.cached_gather_blocks, tk.cached_gather_select)
    queues = make_stream_batches(ds, num_streams=SERVE_STREAMS, batches_per_stream=SERVE_BATCHES,
                                 batch_size=BATCH, seed=SEED)
    seeds = [SEED + sid for sid in range(SERVE_STREAMS)]
    out, launches = {}, {}

    class CheckedServer(ShardedServer):
        """Holds every repartition's rows to its epoch's hot set."""

        def _apply_refresh_event(self, event):
            super()._apply_refresh_event(event)
            rows = sum(self.repartition_log[-1]["rows_after"])
            if rows != self.engine.pipeline.caches.store.num_cached:
                raise AssertionError(f"epoch {event.epoch}: the shards hold {rows} rows, the "
                                     f"base {self.engine.pipeline.caches.store.num_cached}")

    def serve(label, cfg, *, n_streams=SERVE_STREAMS, n_batches=SERVE_BATCHES, injector=None):
        t0 = time.perf_counter()
        server = CheckedServer(eng, config=cfg, injector=injector)
        build_s = time.perf_counter() - t0
        for sid in range(n_streams):
            server.add_stream(queues[sid][:n_batches], seed=seeds[sid], collect_outputs=True)
        server._warmup_sharded(server._warmup_seeds())
        rep, counts = serve_run(server, counters, warmup=False)
        launches[label] = counts
        outs = [np.stack(st.runtime.outputs) for st in server.streams]
        log_serve(label, rep, counts)
        return server, rep, counts, outs, build_s

    def cfg(**kw):
        return ServeConfig(engine=EngineConfig(use_kernel=True, pipeline_depth=SERVE_DEPTH, **kw),
                           mesh=SHARDS)

    for label, dedup in (("kernel", False), ("kernel_dedup", True)):
        server, rep, counts, outs, build_s = serve(f"sharded_{label}", cfg(dedup=dedup))
        kernel = "cached_gather_blocks" if dedup else "cached_gather"
        gathers = sum(p["gathers"] for p in rep.shards)
        nonempty = [p["gathers"] for p in rep.shards]
        if counts[kernel] != gathers or gathers == 0 or rep.kernel_fallbacks:
            raise AssertionError(f"sharded {label}: {counts} launches, {gathers} non-empty "
                                 f"shard segments")
        want = serving["hits"][label]
        got = [(st.adj_hits, st.adj_lookups, st.feat_hits, st.feat_lookups) for st in rep.streams]
        if got != [tuple(h) for h in want]:
            raise AssertionError(f"sharded {label}: hit counts {got}, phase 12 {want}")
        if any(not np.array_equal(a, b) for a, b in zip(outs, serving["outputs"][label])):
            raise AssertionError(f"sharded {label}: logits differ from phase 12's")
        for key in ("feat_hits", "feat_lookups", "adj_hits", "adj_lookups"):
            if sum(p[key] for p in rep.shards) != getattr(rep, key):
                raise AssertionError(f"sharded {label}: per-shard {key} do not tile the total")
        if not all(fs.host_table.is_pinned() for fs in server.sharded.store.shards):
            raise AssertionError("a shard's host table is not pinned")
        log(f"    equal to phase 12 (logits, hit counts); per-shard hits "
            f"{[p['feat_hits'] for p in rep.shards]} tile {rep.feat_hits}; #{1 + dedup} "
            f"launched {counts[kernel]} times = the non-empty shard segments {nonempty} over "
            f"{rep.total_batches} batches; wall {rep.wall_seconds:.4f} s against phase 12's "
            f"{serving['walls'][label]:.4f} s; shards built in {build_s:.3f} s; rows cached "
            f"{[p['rows_cached'] for p in rep.shards]}")
        out[label] = dict(rep.summary(), build_s=build_s, phase12_wall_s=serving["walls"][label])
        if not dedup:
            base_outs = outs

    # The host side of the exchange, per batch at full size: the frontier's
    # id read, the partition, and the retire's per-shard accounting.
    frontier = sample_blocks(caches.dgraph, eng._seeds(queues[0][0]), FANOUTS,
                             generator=torch.Generator(device="cuda").manual_seed(SEED)).input_nodes
    torch.cuda.synchronize()
    part_t, read_t = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        ids = frontier.cpu().numpy()
        t1 = time.perf_counter()
        part = server.sharded.store.partition(ids)
        t2 = time.perf_counter()
        read_t.append(t1 - t0)
        part_t.append(t2 - t1)
    log(f"  host partition per batch ({ids.size} ids, {SHARDS} shards): id read "
        f"{min(read_t) * 1e3:.3f} ms, partition {min(part_t) * 1e3:.3f} ms (min of 3); "
        f"segments {part.seg_len}")
    out["partition_ms"] = {"read": min(read_t) * 1e3, "partition": min(part_t) * 1e3}

    # Interval refresh with a repartition per epoch (2 streams x 8 batches).
    server, rep, counts, outs, _ = serve(
        "sharded_refresh", cfg(refresh_mode="interval", refresh_interval=SERVE_BATCHES),
        n_streams=2)
    if not rep.refresh_events or len(server.repartition_log) != len(rep.refresh_events):
        raise AssertionError(f"sharded refresh: {len(rep.refresh_events)} events, "
                             f"{len(server.repartition_log)} repartitions")
    if any(not np.array_equal(a, b) for a, b in zip(outs, base_outs)):
        raise AssertionError("sharded refresh: logits differ from the refresh-free serve")
    log(f"    {len(rep.refresh_events)} refreshes, each repartitioned: "
        f"{[(e['epoch'], e['rows_after']) for e in server.repartition_log]}; logits equal; "
        f"shard allocations {[a.total_bytes for a in server.shard_allocations]} B")
    out["refresh"] = {"repartition_log": server.repartition_log, "wall_s": rep.wall_seconds}
    (caches.dgraph, caches.store, caches.allocation, caches._adj_cache, caches.epoch) = snapshot

    # A shard lost mid-exchange: served from its host table, then rejoined.
    plan = FaultPlan(rules=(FaultRule("shard_exchange", start_after=2, max_faults=1, shard=1,
                                      down_for=4),))
    server, rep, counts, outs, _ = serve("sharded_failover", cfg(), injector=FaultInjector(plan))
    if (rep.failovers != [{"shard": 1, "down_for": 4, "call": 2}] or server.sharded.down
            or rep.availability != 1.0):
        raise AssertionError(f"failover: {rep.failovers}, down {server.sharded.down}, "
                             f"availability {rep.availability}")
    if any(not np.array_equal(a, b) for a, b in zip(outs, base_outs)):
        raise AssertionError("failover: logits differ from the healthy sharded serve")
    # The down shard's segments are read from its host view by #1 too, so
    # every non-empty segment launches once; the faulted attempt adds the
    # launches of the shards exchanged before the victim (at most SHARDS - 1).
    gathers = sum(p["gathers"] for p in rep.shards)
    redone = counts["cached_gather"] - gathers
    if gathers != launches["sharded_kernel"]["cached_gather"] or not 0 <= redone < SHARDS:
        raise AssertionError(f"failover: #1 launched {counts['cached_gather']} times for "
                             f"{gathers} non-empty shard segments")
    log(f"    shard 1 failed over at exchange call 2 for 4 retired batches and rejoined; logits "
        f"equal; #1 launched {counts['cached_gather']} times = {gathers} non-empty segments "
        f"(the down shard's included) + {redone} redone by the faulted attempt")
    out["failover"] = dict(rep.summary())
    out["launches"] = launches
    torch.cuda.empty_cache()
    return out


class AttendRecorder:
    """Keeps the inputs of the LM's ``_attend`` calls while installed: the
    first prefill call of each window (the first layer of each kind) and
    the last decode call at each key count (decode attends over the kept
    ring slots with no window); with ``by_shape``, the first call at each
    (Sq, Sk, causal) instead.  Calls go on to the routed ``_attend``
    unchanged."""

    def __init__(self, by_shape: bool = False):
        from repro_torch.models.lm import attention

        self.module, self.original, self.calls = attention, attention._attend, {}
        self.by_shape = by_shape

    def __enter__(self):
        def record(q, k, v, *, causal, window, softcap):
            kw = dict(causal=causal, window=window, softcap=softcap)
            if self.by_shape:
                self.calls.setdefault((q.shape[1], k.shape[1], causal), (q, k, v, kw))
            elif q.shape[1] > 1:
                self.calls.setdefault(("prefill", window), (q, k, v, kw))
            else:
                self.calls[("decode", k.shape[1])] = (q, k, v, kw)
            return self.original(q, k, v, **kw)

        self.module._attend = record
        return self

    def __exit__(self, *exc):
        self.module._attend = self.original


def b5_counted(fn):
    """``fn()`` with B5's counters set to 0 just before and read just
    after (synchronized): (result, launches by design)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa

    fa.flash_attention.launches = 0
    fa.flash_attention.design_launches = dict.fromkeys(fa.DESIGNS, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fa.flash_attention.design_launches)


def lm_shape_row(label, call, peaks, library, time_it=True) -> dict:
    """One captured ``_attend`` call at its real shape: B5 (on ``[B, H, S,
    D]`` copies) held to ref.py in the inputs' dtype (ATT_TOL), and B5's
    float32 design on the upcast inputs to ref.py in float32 (3e-4); if
    ``time_it``, B5, ``_attend`` itself (the transposes included), ref.py
    and ``library`` timed, with the bound (operations for prefill, bytes
    for decode)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

    q_bshd, k_bshd, v_bshd, kw = call
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q_bshd, k_bshd, v_bshd))
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    design = fa.plan(q.dtype, b, hq, k.shape[1], sq, sk, d, torch.cuda.get_device_properties(
        0).multi_processor_count).design
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    got = designed_call(fa, design, q, k, v, kw)
    err = check_attention(got, q, k, v, kw, against_f32=False)
    q32, k32, v32 = q.float(), k.float(), v.float()
    design32 = fa.plan(q32.dtype, b, hq, k.shape[1], sq, sk, d, sm_count).design
    err32 = check_attention(designed_call(fa, design32, q32, k32, v32, kw), q32, k32, v32, kw)
    want32 = attention_ref(q32, expand_kv(k32, hq), expand_kv(v32, hq), **kw)
    err_vs_f32 = float((got.float() - want32).abs().max())
    del q32, k32, v32, want32, got
    row = dict(shape=[b, hq, k.shape[1], sq, sk, d], dtype=str(q.dtype).split(".")[1],
               design=design, f32_design=design32, **kw, max_abs_err=err, f32_max_abs_err=err32,
               max_abs_err_vs_f32_ref=err_vs_f32)
    if time_it:
        bf16_peak, hbm = peaks
        pairs = b * hq * kept_pairs(sq, sk, kw["causal"], kw["window"])
        flops = 4 * d * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        reps = 5 if sq > 1 else 20
        from repro_torch.models.lm.attention import _attend

        row.update(
            flops=flops, bytes=nbytes, bound_ms=1e3 * max(flops / bf16_peak, nbytes / hbm),
            bound_by="operations" if flops / bf16_peak > nbytes / hbm else "bytes",
            ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=reps),
            attend_ms=cuda_ms(lambda: _attend(q_bshd, k_bshd, v_bshd, **kw), reps=reps),
            graph_ms=graph_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=20),
            plain_ms=cuda_ms(lambda: attention_ref(q, expand_kv(k, hq), expand_kv(v, hq), **kw),
                             reps=2),
        )
        lib_fn = library(q, k, v, kw)
        row["library_max_abs_err"] = check_attention(lib_fn(), q, k, v, kw, against_f32=False)
        row["library_ms"] = cuda_ms(lib_fn, reps=reps)
        log(f"  {label} {row['shape']} {row['dtype']} causal={kw['causal']} window "
            f"{kw['window']} softcap {kw['softcap']} ({design}): kernel {row['ms']:.4f} ms (in a "
            f"CUDA graph {row['graph_ms']:.4f}), _attend with its transposes "
            f"{row['attend_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), ref.py {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.4f} ms; max abs err {err:.3g} (library "
            f"{row['library_max_abs_err']:.3g}); f32 ({design32}) {err32:.3g}; bf16 kernel "
            f"against ref.py in f32 {err_vs_f32:.3g}")
    else:
        log(f"  {label} {row['shape']} {row['dtype']} causal={kw['causal']} window "
            f"{kw['window']} softcap {kw['softcap']} ({design}): within {ATT_TOL['bfloat16']} of "
            f"ref.py, max abs err {err:.3g}; f32 ({design32}) within {ATT_TOL['float32']}, "
            f"{err32:.3g}; bf16 kernel against ref.py in f32 {err_vs_f32:.3g}")
    return row


def sdpa_library(q, k, v, kw):
    """``scaled_dot_product_attention`` for Gemma 2B (no softcap, no window)."""
    import torch.nn.functional as F

    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=kw["causal"],
                                                  enable_gqa=True)


def flex_library_for(q, k, v, kw):
    fn = flex_library(q.shape[2], k.shape[2], kw["causal"], kw["window"], kw["softcap"])
    return lambda: fn(q, k, v)


def greedy_check(label, got: list, want: list, want_logits: list) -> dict:
    """Tokens of one request, batched against sequential.  At the first
    differing step the sequential run's logits must hold a near-tie: the
    batched token's logit within LM_TIE_TOL of the top one; later steps
    have other contexts and are not compared."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            gap = float(want_logits[i].max() - want_logits[i][g])
            if gap > LM_TIE_TOL:
                raise AssertionError(f"{label}: step {i} gave token {g} against {w}, logit gap "
                                     f"{gap:.3g} > {LM_TIE_TOL}")
            return {"first_difference": i, "logit_gap": gap}
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} tokens against {len(want)}")
    return {"first_difference": None}


def device_kernels(fn) -> dict[str, float]:
    """``fn()`` under ``torch.profiler``, synchronized: device seconds by
    kernel name (lower case); empty when the profiler records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        us = evt.cuda_time_total if us is None else us
        out[evt.key.lower()] = out.get(evt.key.lower(), 0.0) + us / 1e6
    return out


def is_matmul(name: str) -> bool:
    return any(k in name for k in ("gemm", "xmma", "nvjet", "cutlass"))


def lm_family(name: str) -> str:
    if any(k in name for k in ("wgmma_kernel", "split_kernel", "combine_kernel", "fma_kernel")):
        return "b5"
    return "matmul" if is_matmul(name) else "other"


def train_family(name: str) -> str:
    """A training kernel's family by its name: fp32 products (``sgemm`` or
    ``f32f32`` in cuBLAS's names: the attention under autograd, TF32 off),
    the other products (bf16), softmax (attention and the loss chunks,
    forward and backward), and the rest (elementwise, norms, AdamW)."""
    if is_matmul(name):
        return "matmul_fp32" if ("sgemm" in name or "f32f32" in name) else "matmul_bf16"
    return "softmax" if "softmax" in name else "other"


def lm_breakdown(cfg, n_req: int, prompt_len: int) -> dict:
    """Where Gemma 2B's serving time goes, warm: the model built again as
    the serve CLI builds it, one prefill and LM_DECODE_STEPS decode steps
    after a warmup of each (host clock, synchronized), then one prefill and
    4 decode steps under ``torch.profiler``: device time by kernel family
    (B5, matrix products, the rest) and the device's busy share of the
    warm wall time.  Device numbers are None when the profiler records no
    device time."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.lm import model as lm

    params = lm.init_params(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(TokenStream(vocab=cfg.vocab, seed=1).sample(
        np.random.default_rng(2), n_req, prompt_len), device="cuda")
    cache_size = prompt_len + LM_DECODE_STEPS

    def run(steps: int) -> tuple[float, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv = lm.prefill(params, {"tokens": tokens}, cfg, cache_size=cache_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(steps):
            logits, kv = lm.decode_step(params, torch.argmax(logits, -1)[:, None], kv,
                                        prompt_len + i, cfg)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    run(2)  # warmup
    prefill_s, decode_s = run(LM_DECODE_STEPS)
    out = dict(prefill_s=prefill_s, decode_s=decode_s,
               decode_ms_per_step=1e3 * decode_s / LM_DECODE_STEPS,
               prefill_tok_s=n_req * prompt_len / prefill_s,
               decode_tok_s=n_req * LM_DECODE_STEPS / decode_s)
    logits, kv = lm.prefill(params, {"tokens": tokens}, cfg, cache_size=cache_size)
    nxt = torch.argmax(logits, -1)[:, None]
    torch.cuda.synchronize()
    work = {"prefill": (lambda: lm.prefill(params, {"tokens": tokens}, cfg, cache_size=cache_size),
                        prefill_s),
            "decode": (lambda: [lm.decode_step(params, nxt, kv, prompt_len + i, cfg)
                                for i in range(4)], 4 * decode_s / LM_DECODE_STEPS)}
    notes = []
    for label, (fn, wall) in work.items():
        families = {"b5": 0.0, "matmul": 0.0, "other": 0.0}
        for name, sec in device_kernels(fn).items():
            families[lm_family(name)] += sec
        device_s = sum(families.values())
        # Busy share: the profiled work's device time over the warm wall of
        # the same work (host clock, synchronized, profiler off).
        out[label + "_device_s"] = families if device_s > 0 else None
        out[label + "_busy_share"] = device_s / wall if device_s > 0 else None
        notes.append(f"{label}{' (4 steps)' if label == 'decode' else ''} " + (
            ", ".join(f"{k} {v:.4f}" for k, v in families.items())
            + f" s on the device, busy {100 * device_s / wall:.1f}% of its warm wall"
            if device_s > 0 else "no device time recorded"))
    del params, tokens, logits, kv
    torch.cuda.empty_cache()
    log(f"  warm, built again: prefill {prefill_s:.4f} s ({out['prefill_tok_s']:.0f} tok/s), "
        f"decode {out['decode_ms_per_step']:.3f} ms per step ({out['decode_tok_s']:.1f} tok/s); "
        f"profiled: {'; '.join(notes)}")
    return out


def lm_phase(peaks) -> dict:
    """LM serving on the card: Gemma 2B at full size through the serve
    CLI's ``main``, an fp32 BatchedServer held to sequential decoding,
    Gemma-2 27B at full width and 4 layers, and B5 held to ref.py at every
    new shape the path gave it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import serve
    from repro_torch.models.lm import model as lm
    from repro_torch.runtime.serve_engine import BatchedServer
    from repro_torch.utils.tree import tree_map

    n_req, prompt_len = LM_PREFILL
    phase(f"15. LM serving: Gemma 2B full size, bf16, {n_req} x {prompt_len} prefill and "
          f"{LM_DECODE_STEPS} decode steps; fp32 BatchedServer; Gemma-2 27B full width, "
          f"{GEMMA2_LAYERS} layers")
    t_phase = time.perf_counter()
    out: dict = {"launches": {}}

    # (a) The serve CLI's main at full size: init, Eq. 1 caches, prefill, decode.
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    args = ["--arch", "gemma-2b", "--requests", str(n_req), "--prompt-len", str(prompt_len),
            "--gen-len", str(LM_DECODE_STEPS + 1), "--cache-mb", str(LM_CACHE_MB)]
    t0 = time.perf_counter()
    with AttendRecorder() as rec:
        rep, counts = b5_counted(lambda: serve.main(args))
    wall = time.perf_counter() - t0
    cfg = get_config("gemma-2b")
    want = {**dict.fromkeys(counts, 0), "wgmma": cfg.n_layers,
            "split": cfg.n_layers * LM_DECODE_STEPS}
    if counts != want:
        raise AssertionError(f"Gemma 2B serve: B5 launches by design {counts}, want {want}")
    toks = rep["tokens"]
    if toks.shape != (n_req, LM_DECODE_STEPS + 1) or not (0 <= toks).all() or not (
            toks < cfg.vocab).all():
        raise AssertionError(f"Gemma 2B serve gave tokens {toks.shape}, range "
                             f"{toks.min()}..{toks.max()}")
    peak = torch.cuda.max_memory_allocated()
    out["gemma_2b"] = dict(
        {k: v for k, v in rep.items() if k != "tokens"}, wall_s=wall, launches=counts,
        prefill_tok_s=n_req * prompt_len / rep["prefill_s"],
        decode_ms_per_step=1e3 * rep["decode_s"] / LM_DECODE_STEPS,
        max_memory_allocated=peak, memory_above_base=peak - base)
    out["launches"]["gemma_2b"] = counts
    g = out["gemma_2b"]
    log(f"  Gemma 2B ({wall:.1f} s with init and caches): prefill {rep['prefill_s']:.4f} s "
        f"({g['prefill_tok_s']:.0f} tok/s), decode {g['decode_ms_per_step']:.3f} ms per step "
        f"({rep['decode_tok_s']:.1f} tok/s), embed cache {rep['embed_rows']} rows, hit "
        f"{rep['prompt_hit_rate']:.4f} / gen {rep['gen_hit_rate']:.4f}; max_memory_allocated "
        f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} above the phase's start); B5 {counts}")
    captured = dict(rec.calls)
    out["gemma_2b"]["warm"] = lm_breakdown(cfg, n_req, prompt_len)
    marks = {"gemma_2b": time.perf_counter() - t_phase}

    # (b) fp32 BatchedServer on Gemma 2B at full size against sequential decoding.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = lm.init_params(cfg32, generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    stream = TokenStream(vocab=cfg32.vocab, seed=3)
    rng = np.random.default_rng(4)
    prompts = [stream.sample(rng, 1, n)[0] for n in LM_SERVER_PROMPTS]
    max_len = max(LM_SERVER_PROMPTS) + LM_SERVER_NEW + 4
    t0 = time.perf_counter()

    def serve_batched():
        server = BatchedServer(cfg32, params, slots=LM_SERVER_SLOTS, max_len=max_len)
        for i, p in enumerate(prompts):
            server.submit(p, LM_SERVER_NEW, req_id=i)
        return server.run()

    results, counts = b5_counted(serve_batched)
    batched_s = time.perf_counter() - t0
    if counts != {**dict.fromkeys(counts, 0), "fma": cfg.n_layers * len(prompts)}:
        raise AssertionError(f"fp32 server: B5 launches {counts} (one fma prefill per layer per "
                             "admission; the per-slot decode is plain torch)")
    out["launches"]["fp32_server"] = counts

    def sequential():
        runs = []
        for p in prompts:
            logits, caches = lm.prefill(params, {"tokens": torch.as_tensor(p[None], device="cuda")},
                                        cfg32, cache_size=max_len)
            steps = [logits[0, : cfg.vocab]]
            for i in range(LM_SERVER_NEW - 1):
                nxt = torch.argmax(steps[-1]).view(1, 1)
                logits, caches = lm.decode_step(params, nxt, caches, len(p) + i, cfg32)
                steps.append(logits[0, : cfg.vocab])
            runs.append(steps)
        return runs

    t0 = time.perf_counter()
    runs, counts = b5_counted(sequential)
    sequential_s = time.perf_counter() - t0
    want = {**dict.fromkeys(counts, 0), "fma": cfg.n_layers * len(prompts),
            "split": cfg.n_layers * (LM_SERVER_NEW - 1) * len(prompts)}
    if counts != want:
        raise AssertionError(f"fp32 sequential: B5 launches {counts}, want {want}")
    out["launches"]["fp32_sequential"] = counts
    checks = []
    for req, steps in zip(results, runs):
        want_toks = [int(torch.argmax(s)) for s in steps]
        checks.append(greedy_check(f"request {req.req_id}", req.generated, want_toks, steps))
    # The reference's invariant at full size: prefill then decode equals a
    # longer prefill (fp32; fma prefill against split decode).
    p = torch.as_tensor(prompts[2][None], device="cuda")
    longer, _ = lm.prefill(params, {"tokens": p}, cfg32, cache_size=max_len)
    _, caches = lm.prefill(params, {"tokens": p[:, :-1]}, cfg32, cache_size=max_len)
    stepped, _ = lm.decode_step(params, p[:, -1:], caches, p.shape[1] - 1, cfg32)
    invariant_err = float((stepped - longer).abs().max())
    torch.testing.assert_close(stepped, longer, atol=2e-4, rtol=2e-4)
    del params, caches, longer, stepped, runs
    out["fp32_server"] = dict(prompts=list(LM_SERVER_PROMPTS), slots=LM_SERVER_SLOTS,
                              new=LM_SERVER_NEW, batched_s=batched_s, sequential_s=sequential_s,
                              checks=checks, invariant_max_abs_err=invariant_err)
    marks["fp32_server"] = time.perf_counter() - t_phase
    differing = [c for c in checks if c["first_difference"] is not None]
    log(f"  fp32 BatchedServer, {LM_SERVER_SLOTS} slots, prompts {list(LM_SERVER_PROMPTS)}, "
        f"{LM_SERVER_NEW} new tokens: {batched_s:.2f} s; sequential prefill + decode of each "
        f"{sequential_s:.2f} s; {len(checks) - len(differing)} of {len(checks)} requests equal"
        + (f", near-ties at {differing}" if differing else "")
        + f"; prefill + decode against a longer prefill: max abs err {invariant_err:.3g}")

    # (c) Gemma-2 27B at full width, GEMMA2_LAYERS layers: local and global.
    cfg27 = dataclasses.replace(get_config("gemma2-27b"), n_layers=GEMMA2_LAYERS)
    params = lm.init_params(cfg27, generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
    b27, s27 = GEMMA2_PREFILL
    tokens = torch.as_tensor(TokenStream(vocab=cfg27.vocab, seed=5).sample(
        np.random.default_rng(6), b27, s27), device="cuda")

    def run27():
        logits, caches = lm.prefill(params, {"tokens": tokens}, cfg27,
                                    cache_size=s27 + GEMMA2_DECODE_STEPS)
        firsts = [logits]
        for i in range(GEMMA2_DECODE_STEPS):
            logits, caches = lm.decode_step(params, torch.argmax(logits, -1)[:, None], caches,
                                            s27 + i, cfg27)
            firsts.append(logits)
        return torch.stack(firsts)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with AttendRecorder() as rec27:
        logits27, counts = b5_counted(run27)
    wall27 = time.perf_counter() - t0
    want = {**dict.fromkeys(counts, 0), "wgmma": GEMMA2_LAYERS,
            "split": GEMMA2_LAYERS * GEMMA2_DECODE_STEPS}
    if counts != want:
        raise AssertionError(f"Gemma-2 27B: B5 launches {counts}, want {want}")
    if logits27.shape != (GEMMA2_DECODE_STEPS + 1, b27, cfg27.vocab_padded) or not bool(
            torch.isfinite(logits27).all()) or float(logits27.abs().max()) > cfg27.final_softcap:
        raise AssertionError(f"Gemma-2 27B logits {tuple(logits27.shape)}, finite "
                             f"{bool(torch.isfinite(logits27).all())}")
    out["launches"]["gemma2_27b"] = counts
    out["gemma2_27b"] = dict(layers=GEMMA2_LAYERS, batch=b27, prompt=s27,
                             decode_steps=GEMMA2_DECODE_STEPS, wall_s=wall27, launches=counts)
    log(f"  Gemma-2 27B, {GEMMA2_LAYERS} layers: prefill {b27} x {s27} + {GEMMA2_DECODE_STEPS} "
        f"decode steps in {wall27:.3f} s; logits finite, within the final softcap; B5 {counts}")
    del params, logits27
    marks["gemma2_27b"] = time.perf_counter() - t_phase

    # (d) A small input against the CPU route: fp32 smoke config, both rings wrapped.
    small = dataclasses.replace(get_smoke("gemma2-27b"), dtype="float32")
    cpu_params = lm.init_params(small, generator=torch.Generator().manual_seed(SEED), device="cpu")
    card_params = tree_map(lambda a: a.cuda(), cpu_params)
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, small.vocab, (2, 20)))
    small_err = 0.0
    want_l, want_c = lm.prefill(cpu_params, {"tokens": toks}, small, cache_size=32)
    got_l, got_c = lm.prefill(card_params, {"tokens": toks.cuda()}, small, cache_size=32)
    for step in range(8):
        small_err = max(small_err, float((got_l.cpu() - want_l).abs().max()))
        torch.testing.assert_close(got_l.cpu(), want_l, atol=1e-4, rtol=1e-4)
        nxt = torch.argmax(want_l[:, : small.vocab], -1)[:, None]
        if not torch.equal(torch.argmax(got_l[:, : small.vocab], -1)[:, None].cpu(), nxt):
            raise AssertionError(f"smoke fp32: greedy tokens differ from the CPU route at {step}")
        want_l, want_c = lm.decode_step(cpu_params, nxt, want_c, 20 + step, small)
        got_l, got_c = lm.decode_step(card_params, nxt.cuda(), got_c, 20 + step, small)
    out["small_max_abs_err"] = small_err
    marks["small"] = time.perf_counter() - t_phase
    log(f"  gemma2-27b smoke, fp32, prompt 20 past its window-16 ring + 8 decode steps: card "
        f"within 1e-4 of the CPU route (max abs err {small_err:.3g}), tokens equal")

    # (e) B5 at every new shape of the path, against ref.py; timed at the
    # Gemma 2B prefill and decode and the Gemma-2 27B local prefill.
    torch.cuda.empty_cache()
    shapes = {}
    plan = [("gemma_2b_prefill", captured[("prefill", None)], sdpa_library, True),
            ("gemma_2b_decode_first", captured[("decode", prompt_len + 1)], None, False),
            ("gemma_2b_decode", captured[("decode", prompt_len + LM_DECODE_STEPS)],
             sdpa_library, True),
            ("gemma2_27b_local_prefill", rec27.calls[("prefill", cfg27.window)],
             flex_library_for, True),
            ("gemma2_27b_global_prefill", rec27.calls[("prefill", None)], None, False),
            # The local ring holds the window's keys; the global cache s27 + steps.
            ("gemma2_27b_local_decode", rec27.calls[("decode", cfg27.window)], None, False),
            ("gemma2_27b_global_decode", rec27.calls[("decode", s27 + GEMMA2_DECODE_STEPS)],
             None, False)]
    del captured, rec, rec27
    for label, call, library, time_it in plan:
        shapes[label] = lm_shape_row(label, call, peaks, library, time_it)
        torch.cuda.empty_cache()
    del plan
    out["shapes"] = shapes
    out["launches_total"] = sum(sum(c.values()) for c in out["launches"].values())
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_at"] = marks
    log(f"  phase 15: {out['seconds']:.1f} s (at the end of each step: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())}); B5 launched "
        f"{out['launches_total']} times on the LM paths ({out['launches']})")
    return out


class DecodeRecorder:
    """Keeps the arguments of the serve CLI's last ``decode_step`` call
    while installed (parameters, tokens, caches, position, config), so a
    phase can run more decode steps of the CLI's own model after ``main``
    returns.  Calls go on unchanged."""

    def __init__(self):
        from repro_torch.launch import serve

        self.module, self.original, self.last = serve, serve.decode_step, None

    def __enter__(self):
        def record(params, tokens, caches, cache_len, cfg, **kw):
            self.last = (params, tokens, caches, cache_len, cfg)
            return self.original(params, tokens, caches, cache_len, cfg, **kw)

        self.module.decode_step = record
        return self

    def __exit__(self, *exc):
        self.module.decode_step = self.original


def decode_busy(call, steps: int = 4) -> dict:
    """The recorded decode step repeated ``steps`` times on its own inputs:
    warm ms per step (host clock, synchronized) and, under
    ``torch.profiler``, the device's seconds and busy share of that wall
    (None when the profiler records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.lm import model as lm

    params, tokens, caches, cache_len, cfg = call

    def run():
        for _ in range(steps):
            lm.decode_step(params, tokens, caches, cache_len, cfg)
        torch.cuda.synchronize()

    run()  # warmup
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    device_s = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(evt, "device_time_total", None)
            device_s += (evt.cuda_time_total if us is None else us) / 1e6
    return dict(warm_ms_per_step=1e3 * wall / steps,
                device_s=device_s if device_s > 0 else None,
                busy_share=device_s / wall if device_s > 0 else None)


def ssm_cli_part(label: str, args: list, want_counts: dict | None, base: int, capture=False):
    """One serve CLI run at full width with B5's counters set to 0 just
    before and read just after (``want_counts``: the launches by design it
    must give, every other design 0); its report, launches, peak memory
    above ``base``, the recorded last decode call and, with ``capture``,
    the ``_attend`` calls."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with AttendRecorder() as rec, DecodeRecorder() as dec:
        rep, counts = b5_counted(lambda: serve.main(args))
    wall = time.perf_counter() - t0
    want = {**dict.fromkeys(counts, 0), **(want_counts or {})}
    if counts != want:
        raise AssertionError(f"{label}: B5 launches by design {counts}, want {want}")
    toks = rep["tokens"]
    n_req, gen = int(args[args.index("--requests") + 1]), int(args[args.index("--gen-len") + 1])
    vocab = get_config(rep["arch"]).vocab
    if toks.shape != (n_req, gen) or not (0 <= toks).all() or not (toks < vocab).all():
        raise AssertionError(f"{label}: tokens {toks.shape}, range {toks.min()}..{toks.max()}")
    peak = torch.cuda.max_memory_allocated()
    steps = gen - 1
    row = dict({k: v for k, v in rep.items() if k not in ("tokens", "hot_experts")},
               hot_experts=None if rep["hot_experts"] is None else rep["hot_experts"].tolist(),
               wall_s=wall, launches=counts, decode_steps=steps,
               decode_ms_per_step=1e3 * rep["decode_s"] / steps,
               prefill_tok_s=n_req * int(args[args.index("--prompt-len") + 1]) / rep["prefill_s"],
               max_memory_allocated=peak, memory_above_base=peak - base)
    experts = ("" if rep["hot_experts"] is None else
               f"; Eq. 1 split embed {rep['feat_bytes'] / 1e6:.1f} MB ({rep['embed_rows']} rows) / "
               f"expert {rep['adj_bytes'] / 1e6:.1f} MB: {len(rep['hot_experts'])} hot experts "
               f"of {rep['expert_bytes_each'] / 1e6:.2f} MB each {row['hot_experts']}, expert hit "
               f"{rep['prompt_expert_hit_rate']:.4f} on the prompts' router top-k")
    log(f"  {label} ({wall:.1f} s with init and caches): prefill {rep['prefill_s']:.4f} s "
        f"({row['prefill_tok_s']:.0f} tok/s), decode {row['decode_ms_per_step']:.3f} ms per step; "
        f"embed hit {rep['prompt_hit_rate']:.4f}{experts}; max_memory_allocated {peak / 1e9:.2f} "
        f"GB ({(peak - base) / 1e9:.2f} above the phase's start); B5 {counts}")
    return row, toks, dec.last, (dict(rec.calls) if capture else None)


def ssm_server_part(label: str, cfg, params, prompts, want_prefill: str | None,
                    base: int) -> dict:
    """A float32 BatchedServer (SSM_SERVER_SLOTS slots) against a sequential
    prefill + decode of each request: every request's greedy tokens equal,
    or parting at a near-tie (LM_TIE_TOL).  ``want_prefill``: the B5 design
    of the model's GQA layers' prefill (None: no GQA layer); the per-slot
    decode launches nothing.  Peak memory above ``base`` is logged."""
    import torch

    from repro_torch.models.lm import model as lm
    from repro_torch.runtime.serve_engine import BatchedServer

    gqa = sum(k in ("attn", "local") for k in cfg.layer_kinds()) if cfg.attn_kind == "gqa" else 0
    max_len = max(len(p) for p in prompts) + SSM_SERVER_NEW + 4

    def serve_batched():
        server = BatchedServer(cfg, params, slots=SSM_SERVER_SLOTS, max_len=max_len)
        for i, p in enumerate(prompts):
            server.submit(p, SSM_SERVER_NEW, req_id=i)
        return server.run()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, counts = b5_counted(serve_batched)
    batched_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(counts, 0), **({want_prefill: gqa * len(prompts)} if gqa else {})}
    if counts != want:
        raise AssertionError(f"{label} server: B5 launches {counts}, want {want}")

    def sequential():
        runs = []
        for p in prompts:
            logits, caches = lm.prefill(params, {"tokens": torch.as_tensor(p[None], device="cuda")},
                                        cfg, cache_size=max_len)
            steps = [logits[0, : cfg.vocab]]
            for i in range(SSM_SERVER_NEW - 1):
                nxt = torch.argmax(steps[-1]).view(1, 1)
                logits, caches = lm.decode_step(params, nxt, caches, len(p) + i, cfg)
                steps.append(logits[0, : cfg.vocab])
            runs.append(steps)
        return runs

    t0 = time.perf_counter()
    runs, seq_counts = b5_counted(sequential)
    sequential_s = time.perf_counter() - t0
    want = {**dict.fromkeys(seq_counts, 0), **({want_prefill: gqa * len(prompts),
                                                "split": gqa * len(prompts) * (SSM_SERVER_NEW - 1)}
                                               if gqa else {})}
    if seq_counts != want:
        raise AssertionError(f"{label} sequential: B5 launches {seq_counts}, want {want}")
    checks = [greedy_check(f"{label} request {req.req_id}", req.generated,
                           [int(torch.argmax(s)) for s in steps], steps)
              for req, steps in zip(results, runs)]
    differing = [c for c in checks if c["first_difference"] is not None]
    log(f"  {label} fp32 BatchedServer, {SSM_SERVER_SLOTS} slots, prompts "
        f"{[len(p) for p in prompts]}, {SSM_SERVER_NEW} new tokens: {batched_s:.2f} s; "
        f"sequential {sequential_s:.2f} s; {len(checks) - len(differing)} of {len(checks)} "
        f"requests equal" + (f", near-ties at {differing}" if differing else "")
        + f"; B5 {counts} / sequential {seq_counts}; max_memory_allocated {peak / 1e9:.2f} GB "
        f"({(peak - base) / 1e9:.2f} above the phase's start)")
    return dict(batched_s=batched_s, sequential_s=sequential_s, checks=checks, launches=counts,
                sequential_launches=seq_counts, max_memory_allocated=peak,
                memory_above_base=peak - base)


def ssm_phase(peaks) -> dict:
    """LM serving for the MoE and state-space archs at full width (depth
    cut to one card): Jamba v0.1, RWKV6-3B and DeepSeek-V2 through the serve
    CLI's ``main``, RWKV-6's chunked prefill held to its scan, DeepSeek-V2's
    dispatch run twice, fp32 BatchedServers held to sequential decoding,
    and B5 at Jamba's shapes."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm import tp as lm_tp
    from repro_torch.models.lm.moe import moe_ffn
    from repro_torch.models.lm.config import MoEConfig
    from repro_torch.models.lm.norms import rms_norm
    from repro_torch.utils.tree import tree_map

    phase(f"16. LM serving, MoE and state-space archs: Jamba v0.1 ({JAMBA_LAYERS} layers), "
          f"RWKV6-3B, DeepSeek-V2 ({DEEPSEEK_LAYERS} layers), full width, bf16; fp32 "
          "BatchedServers")
    t_phase = time.perf_counter()
    out: dict = {"launches": {}}
    marks = {}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()

    # (a) Jamba v0.1, one pattern period: 7 Mamba layers, 1 attention, 4 MoE.
    n_req, prompt_len = JAMBA_PREFILL
    args = ["--arch", "jamba-v0.1-52b", "--layers", str(JAMBA_LAYERS), "--requests", str(n_req),
            "--prompt-len", str(prompt_len), "--gen-len", str(SSM_DECODE_STEPS + 1),
            "--cache-mb", str(JAMBA_CACHE_MB)]
    row, _, call, captured = ssm_cli_part(
        "Jamba", args, {"wgmma": 1, "split": SSM_DECODE_STEPS}, base, capture=True)
    if not row["hot_experts"]:
        raise AssertionError(f"Jamba: Eq. 1's expert share {row['adj_bytes']} B holds no expert "
                             f"of {row['expert_bytes_each']} B")
    row["decode"] = decode_busy(call)
    out["jamba"] = row
    out["launches"]["jamba"] = row["launches"]
    log(f"    decode, warm: {row['decode']['warm_ms_per_step']:.3f} ms per step, device busy "
        f"{row['decode']['busy_share']}")
    del call
    torch.cuda.empty_cache()
    marks["jamba"] = time.perf_counter() - t_phase

    # (b) RWKV6-3B at full size: the scan route, then the chunked route.
    n_req, prompt_len = RWKV_PREFILL
    args = ["--arch", "rwkv6-3b", "--requests", str(n_req), "--prompt-len", str(prompt_len),
            "--gen-len", str(SSM_DECODE_STEPS + 1), "--cache-mb", str(SSM_CACHE_MB)]
    row, scan_toks, call, _ = ssm_cli_part("RWKV6-3B, scan prefill", args, None, base)
    row["decode"] = decode_busy(call)
    log(f"    decode, warm: {row['decode']['warm_ms_per_step']:.3f} ms per step, device busy "
        f"{row['decode']['busy_share']}")
    del call
    lm_tp.set_rwkv_chunked(True)
    try:
        chunked, chunked_toks, call, _ = ssm_cli_part("RWKV6-3B, chunked prefill", args, None, base)
    finally:
        lm_tp.set_rwkv_chunked(False)
    del call
    row["chunked"] = chunked
    row["chunked_tokens_equal"] = bool(np.array_equal(scan_toks, chunked_toks))
    out["launches"]["rwkv6"] = row["launches"]
    out["launches"]["rwkv6_chunked"] = chunked["launches"]
    # The chunked prefill held to the scan at full size in fp32, on the
    # CLI's own prompts and weights (its generator and seed).
    cfg32 = dataclasses.replace(get_config("rwkv6-3b"), dtype="float32")
    params32 = lm.init_params(cfg32, generator=torch.Generator(device="cuda").manual_seed(0))
    stream = TokenStream(vocab=cfg32.vocab, seed=1)
    toks = torch.as_tensor(stream.sample(np.random.default_rng(2), n_req, prompt_len),
                           device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_l, scan_c = lm.prefill(params32, {"tokens": toks}, cfg32)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    lm_tp.set_rwkv_chunked(True)
    try:
        t0 = time.perf_counter()
        chunk_l, chunk_c = lm.prefill(params32, {"tokens": toks}, cfg32)
        torch.cuda.synchronize()
        chunk_s = time.perf_counter() - t0
    finally:
        lm_tp.set_rwkv_chunked(False)
    errs = {"logits": float((chunk_l - scan_l).abs().max())}
    torch.testing.assert_close(chunk_l, scan_l, **RWKV_CHUNK_TOL)
    for key in ("state", "shift"):
        got, want = chunk_c[0]["tm"][key], scan_c[0]["tm"][key]
        errs[key] = float((got - want).abs().max())
        errs[key + "_max_abs"] = float(want.abs().max())
        torch.testing.assert_close(got, want, **RWKV_CHUNK_TOL)
    del scan_c, chunk_c, scan_l, chunk_l
    row["fp32_chunked_vs_scan"] = dict(errs, scan_prefill_s=scan_s, chunked_prefill_s=chunk_s,
                                       tol=RWKV_CHUNK_TOL)
    out["rwkv6"] = row
    log(f"    chunked prefill (bf16, CLI) {chunked['prefill_s']:.4f} s against the scan's "
        f"{row['prefill_s']:.4f} s; greedy tokens equal: {row['chunked_tokens_equal']}; fp32 at "
        f"full size, {n_req} x {prompt_len}: scan {scan_s:.4f} s, chunked {chunk_s:.4f} s, "
        f"chunked within {RWKV_CHUNK_TOL} of the scan (logits max abs err {errs['logits']:.3g}, "
        f"every layer's state {errs['state']:.3g} of |state| up to {errs['state_max_abs']:.3g}, "
        f"shift {errs['shift']:.3g})")
    marks["rwkv6"] = time.perf_counter() - t_phase

    # (d, RWKV-6) the fp32 BatchedServer on the same full-size fp32 model.
    stream = TokenStream(vocab=cfg32.vocab, seed=3)
    rng = np.random.default_rng(4)
    prompts = [stream.sample(rng, 1, n)[0] for n in SSM_SERVER_PROMPTS]
    out["rwkv6_server"] = ssm_server_part("RWKV6-3B", cfg32, params32, prompts, None, base)
    out["launches"]["rwkv6_server"] = out["rwkv6_server"]["launches"]
    del params32
    torch.cuda.empty_cache()
    marks["rwkv6_server"] = time.perf_counter() - t_phase

    # (c) DeepSeek-V2, 2 layers: MLA (plain torch) and 160 experts top-6 + 2 shared.
    n_req, prompt_len = DEEPSEEK_PREFILL
    args = ["--arch", "deepseek-v2-236b", "--layers", str(DEEPSEEK_LAYERS), "--requests",
            str(n_req), "--prompt-len", str(prompt_len), "--gen-len",
            str(DEEPSEEK_DECODE_STEPS + 1), "--cache-mb", str(SSM_CACHE_MB)]
    row, _, call, _ = ssm_cli_part("DeepSeek-V2", args, None, base)
    row["decode"] = decode_busy(call)
    params, _, _, _, cfg = call
    # The dispatch twice on one input: the first MoE layer on the normed
    # embedding rows of the CLI's prompts.
    prompts = TokenStream(vocab=cfg.vocab, seed=1).sample(np.random.default_rng(2), n_req,
                                                          prompt_len)
    block = tree_map(lambda a: a[0], {k: params["blocks"][0][k] for k in ("ln2", "moe")})
    x = rms_norm(block["ln2"], params["embed"][torch.as_tensor(prompts, device="cuda").long()])
    first, first_aux = moe_ffn(block["moe"], x, cfg)
    again, again_aux = moe_ffn(block["moe"], x, cfg)
    if not (torch.equal(first.view(torch.int16), again.view(torch.int16))
            and torch.equal(first_aux, again_aux)):
        raise AssertionError("DeepSeek-V2: the MoE dispatch gave other bits on a second run")
    row["dispatch_ms"] = cuda_ms(lambda: moe_ffn(block["moe"], x, cfg), reps=3)
    out["deepseek"] = row
    out["launches"]["deepseek"] = row["launches"]
    log(f"    decode, warm: {row['decode']['warm_ms_per_step']:.3f} ms per step, device busy "
        f"{row['decode']['busy_share']}; the first MoE layer's dispatch on {tuple(x.shape)} "
        f"twice: the same bits (output and aux), {row['dispatch_ms']:.3f} ms per call")
    del call, params, block, x, first, again
    torch.cuda.empty_cache()
    marks["deepseek"] = time.perf_counter() - t_phase

    # (d, Jamba) fp32 at the smallest width that keeps the period-8 pattern,
    # MoE every other layer and 16 experts top-2 (one period at full width
    # is 52 GB in fp32).
    small = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_LAYERS,
                                dtype="float32", **JAMBA_SMALL_WIDTH,
                                moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=256, every=2))
    params = lm.init_params(small, generator=torch.Generator(device="cuda").manual_seed(SEED + 3))
    stream = TokenStream(vocab=small.vocab, seed=5)
    rng = np.random.default_rng(6)
    prompts = [stream.sample(rng, 1, n)[0] for n in SSM_SERVER_PROMPTS]
    out["jamba_server"] = ssm_server_part("Jamba (small width)", small, params, prompts, "fma",
                                          base)
    out["launches"]["jamba_server"] = out["jamba_server"]["launches"]
    del params
    marks["jamba_server"] = time.perf_counter() - t_phase

    # (e) B5 at Jamba's shapes: its prefill and its last decode step.
    torch.cuda.empty_cache()
    sk = JAMBA_PREFILL[1] + SSM_DECODE_STEPS
    out["shapes"] = {
        "jamba_prefill": lm_shape_row("jamba_prefill", captured[("prefill", None)], peaks,
                                      sdpa_library),
        "jamba_decode": lm_shape_row("jamba_decode", captured[("decode", sk)], peaks,
                                     sdpa_library),
    }
    del captured
    torch.cuda.empty_cache()
    out["launches_total"] = sum(sum(c.values()) for c in out["launches"].values())
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_at"] = marks
    log(f"  phase 16: {out['seconds']:.1f} s (at the end of each step: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())}); B5 launched "
        f"{out['launches_total']} times on these paths ({out['launches']})")
    return out


def encdec_phase(peaks) -> dict:
    """The encoder-decoder at full size: SeamlessM4T-medium's prefill (the
    encoder over the source frames, the decoder with cross-attention) and
    greedy decode through ``launch/steps.py``, every attention on B5; B5
    held to ref.py at each new shape; an fp32 smoke config against the CPU
    route."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.lm import model as lm
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("seamless-m4t-medium")
    b, se = ENCDEC_SRC
    st, steps = ENCDEC_PROMPT, ENCDEC_DECODE_STEPS
    phase(f"17. encoder-decoder: SeamlessM4T-medium full size ({cfg.encoder_layers} + "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} x {cfg.head_dim} heads, vocab "
          f"{cfg.vocab}), bf16: {b} x {se} source frames, {b} x {st} target tokens, {steps} "
          "decode steps")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params = lm.init_params(cfg, generator=gen)
    n_params = sum(t.numel() for t in tree_leaves(params))
    src = torch.randn((b, se, cfg.d_model), generator=gen, device="cuda")
    tokens = torch.as_tensor(TokenStream(vocab=cfg.vocab, seed=8).sample(
        np.random.default_rng(9), b, st), device="cuda")
    prefill_step = make_prefill_step(cfg, cache_size=st + steps)
    serve_step = make_serve_step(cfg)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill_step(params, {"tokens": tokens, "src_embeds": src})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [logits]
        for i in range(steps):
            logits, caches = serve_step(params, torch.argmax(logits, -1)[:, None], caches, st + i)
            out.append(logits)
        torch.cuda.synchronize()
        return torch.stack(out), t1 - t0, time.perf_counter() - t1

    (_, cold_prefill, cold_decode), _ = b5_counted(run)
    with AttendRecorder(by_shape=True) as rec:
        (logits, prefill_s, decode_s), counts = b5_counted(run)
    want = {**dict.fromkeys(counts, 0), "wgmma": cfg.encoder_layers + 2 * cfg.n_layers,
            "split": 2 * cfg.n_layers * steps}
    if counts != want:
        raise AssertionError(f"SeamlessM4T: B5 launches by design {counts}, want {want}")
    if logits.shape != (steps + 1, b, cfg.vocab_padded) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"SeamlessM4T logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    peak = torch.cuda.max_memory_allocated()
    out: dict = {"launches": {"seamless": counts}}
    out["seamless"] = dict(
        parameters=n_params, batch=b, source=se, prompt=st, decode_steps=steps,
        prefill_s=prefill_s, decode_s=decode_s, decode_ms_per_step=1e3 * decode_s / steps,
        cold_prefill_s=cold_prefill, cold_decode_s=cold_decode, launches=counts,
        max_memory_allocated=peak, memory_above_base=peak - base)
    log(f"  SeamlessM4T-medium ({n_params / 1e9:.3f} B parameters): prefill {prefill_s:.4f} s "
        f"(cold {cold_prefill:.4f}), decode {1e3 * decode_s / steps:.3f} ms per step (cold "
        f"{1e3 * cold_decode / steps:.3f}); logits finite; max_memory_allocated "
        f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} above the phase's start); B5 {counts}")
    # The device's busy share: a prefill and 4 decode steps profiled, over
    # the warm walls of the same work.
    batch = {"tokens": tokens, "src_embeds": src}
    first, caches = prefill_step(params, batch)
    nxt = torch.argmax(first, -1)[:, None]
    notes = []
    for label, fn, wall in (
            ("prefill", lambda: prefill_step(params, batch), prefill_s),
            ("decode", lambda: [serve_step(params, nxt, caches, st + i) for i in range(4)],
             4 * decode_s / steps)):
        families = {"b5": 0.0, "matmul": 0.0, "other": 0.0}
        for name, sec in device_kernels(fn).items():
            families[lm_family(name)] += sec
        device_s = sum(families.values())
        out["seamless"][label + "_device_s"] = families if device_s > 0 else None
        out["seamless"][label + "_busy_share"] = device_s / wall if device_s > 0 else None
        notes.append(f"{label}{' (4 steps)' if label == 'decode' else ''} " + (
            ", ".join(f"{k} {v:.4f}" for k, v in families.items())
            + f" s on the device, busy {100 * device_s / wall:.1f}% of its warm wall"
            if device_s > 0 else "no device time recorded"))
    log(f"  profiled: {'; '.join(notes)}")
    del params, logits, src, tokens, batch, first, caches
    marks = {"seamless": time.perf_counter() - t_phase}

    # An fp32 smoke config on the card against the CPU route: prefill and
    # greedy decode, logits at 1e-4 and tokens equal.
    small = dataclasses.replace(get_smoke("seamless-m4t-medium"), dtype="float32")
    cpu_params = lm.init_params(small, generator=torch.Generator().manual_seed(SEED),
                                device="cpu")
    card_params = tree_map(lambda a: a.cuda(), cpu_params)
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, small.vocab, (2, 20)))
    src_s = torch.from_numpy(rng.standard_normal((2, 36, small.d_model)).astype(np.float32))
    want_l, want_c = lm.prefill(cpu_params, {"tokens": toks, "src_embeds": src_s}, small,
                                cache_size=32)
    got_l, got_c = lm.prefill(card_params, {"tokens": toks.cuda(), "src_embeds": src_s.cuda()},
                              small, cache_size=32)
    small_err = 0.0
    for step in range(8):
        small_err = max(small_err, float((got_l.cpu() - want_l).abs().max()))
        torch.testing.assert_close(got_l.cpu(), want_l, atol=1e-4, rtol=1e-4)
        nxt = torch.argmax(want_l[:, : small.vocab], -1)[:, None]
        if not torch.equal(torch.argmax(got_l[:, : small.vocab], -1)[:, None].cpu(), nxt):
            raise AssertionError(f"seamless smoke fp32: greedy tokens differ at step {step}")
        want_l, want_c = lm.decode_step(cpu_params, nxt, want_c, 20 + step, small)
        got_l, got_c = lm.decode_step(card_params, nxt.cuda(), got_c, 20 + step, small)
    out["small_max_abs_err"] = small_err
    marks["small"] = time.perf_counter() - t_phase
    log(f"  seamless smoke, fp32, 36 source frames, prompt 20 + 8 decode steps: card within "
        f"1e-4 of the CPU route (max abs err {small_err:.3g}), tokens equal")

    # B5 at the path's new shapes (head dim 64, no GQA), against ref.py.
    torch.cuda.empty_cache()
    calls = rec.calls
    plan = [("seamless_encoder", calls[(se, se, False)], sdpa_library, True),
            ("seamless_self_prefill", calls[(st, st, True)], sdpa_library, False),
            ("seamless_cross_prefill", calls[(st, se, False)], sdpa_library, True),
            ("seamless_cross_decode", calls[(1, se, False)], sdpa_library, True),
            ("seamless_self_decode", calls[(1, st + steps, False)], sdpa_library, True)]
    del calls, rec
    out["shapes"] = {}
    for label, call, library, time_it in plan:
        out["shapes"][label] = lm_shape_row(label, call, peaks, library, time_it)
        torch.cuda.empty_cache()
    del plan
    out["launches_total"] = sum(sum(c.values()) for c in out["launches"].values())
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_at"] = marks
    log(f"  phase 17: {out['seconds']:.1f} s (at the end of each step: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())}); B5 launched "
        f"{out['launches_total']} times on this path")
    return out


class TrainRecorder:
    """While installed, times each step of the train CLI's ``main`` (host
    clock, synchronized before and after) and the AdamW update inside it
    (synchronized before and after), and keeps the last step's parameters."""

    def __init__(self):
        from repro_torch.launch import steps, train

        self.steps_mod, self.train_mod = steps, train
        self.make, self.update = train.make_train_step, steps.adamw_update
        self.walls, self.updates, self.params = [], [], None

    def __enter__(self):
        import torch

        def update(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.update(*args, **kw)
            torch.cuda.synchronize()
            self.updates.append(time.perf_counter() - t0)
            return out

        def make(cfg, **kw):
            step_fn = self.make(cfg, **kw)

            def step(params, opt_state, batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step_fn(params, opt_state, batch)
                torch.cuda.synchronize()
                self.walls.append(time.perf_counter() - t0)
                self.params = out[0]
                return out

            return step

        self.train_mod.make_train_step, self.steps_mod.adamw_update = make, update
        return self

    def __exit__(self, *exc):
        self.train_mod.make_train_step, self.steps_mod.adamw_update = self.make, self.update


def train_phase() -> dict:
    """Training on the card: Gemma 2B at full size through the train CLI's
    ``main`` (attention on the plain torch route under autograd: no B5
    launch), then an eval prefill of the trained parameters on B5; the fp32
    smoke config's loss and gradients against the CPU route, and a
    checkpoint round trip from card tensors."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.tokens import TokenStream, batches
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import model as lm
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("gemma-2b")
    b, s = TRAIN_SHAPE
    args = ["--arch", "gemma-2b", "--batch", str(b), "--seq", str(s), "--steps",
            str(TRAIN_STEPS), "--log-every", "1"]
    phase(f"18. training: Gemma 2B full size ({cfg.n_layers} layers, d {cfg.d_model}, vocab "
          f"{cfg.vocab}), bf16 with fp32 AdamW moments, through the train CLI: {b} x {s} tokens, "
          f"{TRAIN_STEPS} steps")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainRecorder() as rec:
        losses, counts = b5_counted(lambda: train.main(args))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()):
        raise AssertionError(f"training launched B5 {counts}: it has no backward pass")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"Gemma 2B training losses {losses}")
    n_params = sum(t.numel() for t in tree_leaves(rec.params))
    fwd_bwd = [w - u for w, u in zip(rec.walls, rec.updates)]
    out: dict = {"gemma_2b": dict(
        parameters=n_params, batch=b, seq=s, losses=losses, step_s=rec.walls,
        forward_backward_s=fwd_bwd, adamw_s=rec.updates,
        tokens_per_s=[b * s / w for w in rec.walls], wall_s=wall, launches=counts,
        max_memory_allocated=peak, memory_above_base=peak - base)}
    log(f"  Gemma 2B ({n_params / 1e9:.3f} B parameters, {wall:.1f} s with init): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)} (ln {cfg.vocab} = {math.log(cfg.vocab):.4f}); "
        f"max_memory_allocated {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} above the "
        f"phase's start); B5 {counts}")
    for i, (w, fb, u) in enumerate(zip(rec.walls, fwd_bwd, rec.updates)):
        log(f"  step {i + 1}{' (cold)' if i == 0 else ''}: {w:.4f} s ({b * s / w:.0f} tokens/s): "
            f"forward + backward {fb:.4f} s, AdamW {u:.4f} s")

    # Where a warm step's device time goes: one more step of the trained
    # parameters (a fresh AdamW state, the CLI's first batch) profiled.
    batch = next(batches(TokenStream(vocab=cfg.vocab, seed=0), batch=b, seq=s, steps=1))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    step = make_train_step(cfg)
    opt = init_adamw(rec.params)
    kernels = device_kernels(lambda: step(rec.params, opt, batch))
    del opt, batch
    torch.cuda.empty_cache()
    families = {"matmul_bf16": 0.0, "matmul_fp32": 0.0, "softmax": 0.0, "other": 0.0}
    for name, sec in kernels.items():
        families[train_family(name)] += sec
    device_s = sum(families.values())
    warm = statistics.median(rec.walls[1:])
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out["gemma_2b"].update(device_s=families if device_s > 0 else None,
                           busy_share=device_s / warm if device_s > 0 else None,
                           top_kernels=top)
    log("  profiled warm step: " + (
        ", ".join(f"{k} {v:.4f}" for k, v in families.items())
        + f" s on the device, busy {100 * device_s / warm:.1f}% of the warm step's "
        f"{warm:.4f} s; top kernels: "
        + "; ".join(f"{name[:60]} {sec:.4f}" for name, sec in top[:5])
        if device_s > 0 else "no device time recorded"))

    # The trained parameters served: an eval prefill on B5.
    gen = np.random.default_rng(11)
    eb, es = TRAIN_EVAL_PREFILL
    toks = torch.as_tensor(gen.integers(0, cfg.vocab, (eb, es)), device="cuda")
    (logits, _), counts = b5_counted(lambda: lm.prefill(rec.params, {"tokens": toks}, cfg))
    if counts != {**dict.fromkeys(counts, 0), "wgmma": cfg.n_layers}:
        raise AssertionError(f"eval prefill of the trained Gemma 2B: B5 {counts}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("eval prefill of the trained Gemma 2B: logits not finite")
    out["launches"] = {"eval_prefill": counts}
    log(f"  eval prefill of the trained parameters, {eb} x {es}: logits finite, B5 {counts}")
    del rec, logits, toks
    torch.cuda.empty_cache()
    marks = {"gemma_2b": time.perf_counter() - t_phase}

    # The fp32 smoke config: loss and gradients on the card against the CPU
    # route (no B5 launch), then one step and a checkpoint round trip.
    small = dataclasses.replace(get_smoke("gemma-2b"), dtype="float32")
    cpu_params = lm.init_params(small, generator=torch.Generator().manual_seed(SEED),
                                device="cpu")
    card_params = tree_map(lambda a: a.cuda(), cpu_params)
    toks = np.random.default_rng(12).integers(0, small.vocab, (2, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}

    def loss_and_grads(params, device):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = lm.train_loss(tracked, {k: v.to(device) for k, v in batch.items()}, small)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(tracked))

    want, want_g = loss_and_grads(cpu_params, "cpu")
    (got, got_g), counts = b5_counted(lambda: loss_and_grads(card_params, "cuda"))
    if any(counts.values()):
        raise AssertionError(f"smoke train_loss launched B5 {counts}")
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    grad_err = 0.0
    for g, w in zip(got_g, want_g, strict=True):
        scale = float(w.abs().max())
        grad_err = max(grad_err, float((g.cpu() - w).abs().max()) / max(scale, 1e-30))
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * scale)
    params, opt, _ = make_train_step(small, base_lr=1e-2)(card_params, init_adamw(card_params),
                                                          {k: v.cuda() for k, v in batch.items()})
    path = ROOT / "build" / "chip_smoke_checkpoint.npz"
    path.parent.mkdir(exist_ok=True)
    tree = {"params": params, "opt": opt}
    save_checkpoint(str(path), tree)
    back = load_checkpoint(str(path), tree_unflatten(tree, [torch.empty_like(t) for t in
                                                            tree_leaves(tree)]))
    path.unlink()
    for a, c in zip(tree_leaves(tree), tree_leaves(back), strict=True):
        if not (c.is_cuda and a.dtype == c.dtype and torch.equal(a, c)):
            raise AssertionError("checkpoint round trip from card tensors changed a leaf")
    out["small"] = dict(loss=float(got), loss_cpu=float(want),
                        loss_abs_err=float((got.cpu() - want).abs()),
                        grad_max_err_over_leaf_max=grad_err)
    marks["small"] = time.perf_counter() - t_phase
    log(f"  gemma-2b smoke, fp32, 2 x 64 tokens: loss {float(got):.6f} on the card against "
        f"{float(want):.6f} on the CPU, gradients within {grad_err:.3g} of each leaf's largest "
        f"|g|, no B5 launch; one step's {len(tree_leaves(tree))} leaves through a checkpoint, "
        "bit for bit")
    out["launches_total"] = sum(sum(c.values()) for c in out["launches"].values())
    out["seconds"] = time.perf_counter() - t_phase
    out["seconds_at"] = marks
    log(f"  phase 18: {out['seconds']:.1f} s (at the end of each step: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in marks.items())})")
    return out


def tree_nbytes(tree) -> int:
    from repro_torch.utils.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def remat_compare(cfg, b: int, s: int) -> dict:
    """Gemma 2B training under whole-repeat remat and under ``"dots"``, each
    from the same parameters (drawn again from one seed, so no second copy
    lives beside the run), fresh moments and the same batch: REMAT_STEPS
    chained steps (their losses and times, ``max_memory_allocated``
    reset before them: the AdamW update's old and new trees set it), then
    one more loss and gradient pass alone (its peak, which the policy
    moves, and the gradient norm)."""
    import torch

    from repro_torch.configs import InputShape
    from repro_torch.launch.specs import abstract_train_inputs, concrete_from_abstract
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import model as lm
    from repro_torch.models.lm import tp
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.utils.tree import tree_leaves, tree_map

    abstract, _, batch = abstract_train_inputs(cfg, InputShape(f"train_{b}x{s}", s, b, "train"))
    batch = concrete_from_abstract(batch, seed=SEED + 1, device="cuda")
    step = make_train_step(cfg)
    out = {"batch": b, "seq": s}
    for policy in (None, "dots"):
        tp.set_remat_policy(policy)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            p = concrete_from_abstract(abstract, seed=SEED, device="cuda")
            o = init_adamw(p)
            losses, walls = [], []
            for _ in range(REMAT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, loss = step(p, o, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                losses.append(float(loss))
            step_peak = torch.cuda.max_memory_allocated()
            del p, o
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            params = concrete_from_abstract(abstract, seed=SEED, device="cuda")
            tracked = tree_map(lambda t: t.detach().requires_grad_(), params)
            grads = torch.autograd.grad(lm.train_loss(tracked, batch, cfg), tree_leaves(tracked))
            norm = float(torch.sqrt(sum(g.float().pow(2).sum() for g in grads)))
            grad_peak = torch.cuda.max_memory_allocated()
            del params, tracked, grads
        finally:
            tp.set_remat_policy(None)
        out[policy or "whole"] = dict(losses=losses, step_s=walls, grad_norm=norm,
                                      max_memory_allocated=step_peak,
                                      grad_pass_max_memory_allocated=grad_peak)
    whole, dots = out["whole"], out["dots"]
    for a, c in zip(whole["losses"] + [whole["grad_norm"]], dots["losses"] + [dots["grad_norm"]],
                    strict=True):
        if not abs(a - c) <= 1e-5 * abs(a):
            raise AssertionError(f"remat_dots {dots} against whole remat {whole}: not within 1e-5")
    return out


def dryrun_phase() -> dict:
    """Gemma 2B at full size on a 1 x 1 mesh: the dry-run's record of three
    steps (counted on meta tensors) against the card.  For each step the
    same inputs materialized on the card from a seeded card generator
    must hold the record's parameter and argument bytes exactly; the step
    is timed and set against its counted bound at the published H100
    peaks (``launch.mesh.HW``), and its B5 launches are counted.  Then
    ``remat_dots`` training against whole remat, the expert-parallel MoE
    on a 1 x 1 mesh against the dense MoE at Jamba's full width, and an
    NCCL world of one process through ``launch/distributed.py``."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import distributed, dryrun
    from repro_torch.launch.mesh import HW, AbstractMesh
    from repro_torch.launch.specs import concrete_from_abstract
    from repro_torch.models.lm import moe
    from repro_torch.optim.adamw import init_adamw

    cfg = get_config("gemma-2b")
    mesh = AbstractMesh(("data", "model"), (1, 1))
    phase(f"19. the dry-run against the card: Gemma 2B full size ({cfg.n_layers} layers, bf16) "
          f"on a {mesh.label()} mesh; bounds at the published peaks {HW['peak_flops_bf16']:.4g} "
          f"FLOP/s and {HW['hbm_bw']:.4g} B/s")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    b, s = LM_PREFILL
    shapes = [InputShape(f"prefill_{b}x{s}", s, b, "prefill"),
              InputShape(f"decode_{b}x{s + LM_DECODE_STEPS}", s + LM_DECODE_STEPS, b, "decode"),
              InputShape(f"train_{TRAIN_SHAPE[0]}x{TRAIN_SHAPE[1]}", TRAIN_SHAPE[1],
                         TRAIN_SHAPE[0], "train")]
    out: dict = {"steps": {}, "launches": {}}
    for shape in shapes:
        rec = dryrun.dryrun_one("gemma-2b", shape, mesh=mesh, verbose=False)
        fn, args, _ = dryrun.build_lowerable("gemma-2b", shape, mesh)
        dryrun.reset_switches()
        if shape.kind == "train":  # AdamW's moments start at zero (random ones go negative)
            params = concrete_from_abstract(args[0], seed=SEED, device="cuda")
            args = (params, init_adamw(params),
                    concrete_from_abstract(args[2], seed=SEED + 1, device="cuda"))
        else:
            args = concrete_from_abstract(args, seed=SEED, device="cuda")
        h, ma = rec["hlo"], rec["memory_analysis"]
        got = {"parameter_bytes": tree_nbytes(args[0]), "argument_bytes": tree_nbytes(list(args))}
        if (got["parameter_bytes"], got["argument_bytes"]) != (
                h["parameter_bytes_per_device"], ma["argument_size_in_bytes"]):
            raise AssertionError(f"{shape.name}: card bytes {got} against the record's "
                                 f"{h['parameter_bytes_per_device']} and "
                                 f"{ma['argument_size_in_bytes']}")
        if shape.kind == "decode":  # every slot at the last position: B5's split route
            call = lambda: fn(args[0], args[1], args[2], shape.seq_len - 1)  # noqa: E731
        else:
            call = lambda: fn(*args)  # noqa: E731
        result, counts = b5_counted(call)
        want = {"prefill": "wgmma", "decode": "split"}.get(shape.kind)
        expect = {**dict.fromkeys(counts, 0), **({want: cfg.n_layers} if want else {})}
        if counts != expect:
            raise AssertionError(f"{shape.name}: B5 {counts}, expected {expect}")
        first = result[-1] if shape.kind == "train" else result[0]
        if not bool(torch.isfinite(first).all()):
            raise AssertionError(f"{shape.name}: output not finite")
        del result, first
        torch.cuda.reset_peak_memory_stats()
        seconds = cuda_ms(call, 3 if shape.kind == "train" else 5) / 1e3
        compute_s = h["flops_per_device"] / HW["peak_flops_bf16"]
        memory_s = h["dot_bytes_per_device"] / HW["hbm_bw"]
        bound = max(compute_s, memory_s)
        row = dict(flops=h["flops_per_device"], dot_bytes=h["dot_bytes_per_device"],
                   parameter_bytes=got["parameter_bytes"], argument_bytes=got["argument_bytes"],
                   output_bytes=ma["output_size_in_bytes"], count_s=rec["compile_s"],
                   measured_s=seconds, compute_s=compute_s, memory_s=memory_s, bound_s=bound,
                   bound_by="operations" if compute_s >= memory_s else "bytes",
                   measured_over_bound=seconds / bound,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        if shape.kind == "decode":  # host-bound? the device's busy share of a warm step
            row["busy"] = decode_busy((args[0], args[1], args[2], shape.seq_len - 1, cfg))
        out["steps"][shape.name] = row
        out["launches"][shape.name] = counts
        log(f"  {shape.name}: {row['flops']:.4e} FLOPs, {row['dot_bytes']:.4e} dot bytes "
            f"(counted on meta in {rec['compile_s']:.2f} s; attention on the plain route's "
            "count, which includes the masked half of a causal score matrix that B5 skips); "
            f"card bytes = record: parameters {got['parameter_bytes']}, arguments "
            f"{got['argument_bytes']}; measured {seconds:.5f} s, compute_s {compute_s:.5f}, "
            f"memory_s {memory_s:.5f}, bound {bound:.5f} s ({row['bound_by']}), measured / "
            f"bound {row['measured_over_bound']:.3f}; B5 {counts}"
            + (f"; warm {row['busy']['warm_ms_per_step']:.3f} ms a step on the host clock, "
               f"device busy {row['busy']['busy_share']}" if "busy" in row else ""))
        del args, call, fn
        torch.cuda.empty_cache()

    # remat_dots against whole remat, at phase 18's shape (2 x 2048 if the
    # saved products do not fit: the batch is cut, never the width).
    try:
        remat, oom = remat_compare(cfg, *TRAIN_SHAPE), None
    except torch.cuda.OutOfMemoryError as e:
        remat, oom = None, str(e).splitlines()[0]  # the traceback's tensors go with e
    if remat is None:
        log(f"  remat_dots at {TRAIN_SHAPE}: out of memory ({oom}); both variants again at "
            f"2 x {TRAIN_SHAPE[1]}")
        torch.cuda.empty_cache()
        remat = remat_compare(cfg, 2, TRAIN_SHAPE[1])
        remat["out_of_memory_at"] = list(TRAIN_SHAPE)
    out["remat"] = remat
    for name in ("whole", "dots"):
        r = remat[name]
        log(f"  remat {name}, {remat['batch']} x {remat['seq']}: steps "
            f"{', '.join(f'{w:.4f}' for w in r['step_s'])} s, losses "
            f"{', '.join(f'{x:.6f}' for x in r['losses'])}, grad norm {r['grad_norm']:.6f}, "
            f"max_memory_allocated {r['max_memory_allocated'] / 1e9:.2f} GB over the steps, "
            f"{r['grad_pass_max_memory_allocated'] / 1e9:.2f} GB over a loss and gradient "
            "pass alone")
    torch.cuda.empty_cache()

    # The expert-parallel MoE on a 1 x 1 mesh: one Jamba MoE layer at full
    # width in fp32 against the dense dispatch.
    jcfg = dataclasses.replace(get_config("jamba-v0.1-52b"), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mp = moe.init_moe_params(gen, jcfg, torch.float32, device="cuda")
    x = torch.randn((4, 1024, jcfg.d_model), generator=gen, device="cuda")
    want, want_aux = moe.moe_ffn(mp, x, jcfg)
    moe.set_shard_map_context(mesh, ("data",), "model")
    try:
        got, got_aux = moe.moe_ffn(mp, x, jcfg)
    finally:
        moe.set_shard_map_context(None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_aux, want_aux, rtol=1e-5, atol=1e-5)
    out["moe_unit_mesh"] = dict(max_abs_err=float((got - want).abs().max()),
                                aux=float(got_aux), aux_dense=float(want_aux))
    log(f"  expert-parallel MoE on {mesh.label()}: Jamba's layer (d {jcfg.d_model}, "
        f"{jcfg.moe.n_experts} experts, top-{jcfg.moe.top_k}, d_ff {jcfg.moe.d_ff_expert}), "
        f"fp32, 4 x 1024 tokens: max abs err {out['moe_unit_mesh']['max_abs_err']:.3g} against "
        f"the dense moe_ffn, aux {float(got_aux):.8f} against {float(want_aux):.8f}")
    del mp, x, want, got
    torch.cuda.empty_cache()

    # An NCCL world of one process.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed.initialize_from_env()
        t = torch.arange(8, dtype=torch.float32, device="cuda")
        dist.all_reduce(t)
        if not torch.equal(t, torch.arange(8, dtype=torch.float32, device="cuda")):
            raise AssertionError("all_reduce over a world of one changed its tensor")
        try:
            distributed.assert_production_topology(multi_pod=False)
        except RuntimeError as e:
            message = str(e)
        else:
            raise AssertionError("assert_production_topology passed on one card")
        if "found 1 " not in message:
            raise AssertionError(f"unexpected topology message {message!r}")
        backend = dist.get_backend()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["process_group"] = dict(backend=backend, topology_error=message)
    log(f"  process group: {backend} world of 1, all_reduce unchanged; topology check: "
        f"{message}")
    out["launches_total"] = sum(sum(c.values()) for c in out["launches"].values())
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['seconds']:.1f} s")
    return out


def cli_phase() -> dict:
    from repro_torch.core.faults import FaultPlan, FaultRule

    phase("9. CLI")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    OUT.mkdir(exist_ok=True)
    plan = OUT / "cli_fault_plan.json"
    FaultPlan(seed=2, rules=(FaultRule("host_fetch", start_after=1, max_faults=2),)).save(
        str(plan))
    runs = {}
    for args in (["--use-kernel", "--prefetch", "--max-batches", "2"],
                 ["--policy", "rain", "--max-batches", "2"],
                 ["--mode", "layerwise", "--scale", "0.01"],
                 ["--use-kernel", "--streams", "4", "--batches-per-stream", "2",
                  "--pipeline-depth", "2"],
                 ["--use-kernel", "--arrival", "burst", "--admission", "slo", "--slo-ms", "400",
                  "--batches-per-stream", "2"],
                 ["--use-kernel", "--streams", "2", "--batches-per-stream", "2", "--faults",
                  str(plan), "--fault-policy", "retry"]):
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
            detail = (f"embed hit {rep['embed_hit_rate']:.4f}, {rep['chunks']} chunks, total "
                      f"{rep['total_s']:.4f} s")
        elif "--batches-per-stream" in args:
            streams = 2 if "burst" in args else int(args[args.index("--streams") + 1])
            want = 6 if "burst" in args else 2 * streams
            if rep["streams"] != streams or rep["batches"] + rep.get("requests_shed", 0) != want:
                raise AssertionError(f"unexpected serving CLI report: {rep}")
            if "--faults" in args and (rep["faults"]["host_fetch"]["faults"] != 2
                                       or rep["availability"] != 1.0):
                raise AssertionError(f"unexpected fault CLI report: {rep}")
            detail = (f"{rep['streams']} streams, {rep['batches']} batches, "
                      f"{rep['throughput_seeds_per_s']:.1f} seeds/s, p50 "
                      f"{rep['p50_latency_s'] * 1e3:.3f} ms, p99 {rep['p99_latency_s'] * 1e3:.3f} ms"
                      + (f", deadline hit {rep.get('deadline_hit_rate', 1.0)}, shed "
                         f"{rep['requests_shed']}" if "admission" in rep else "")
                      + (f", faults {rep['faults']}, retries {rep['stage_retries']}"
                         if "faults" in rep else ""))
        else:
            want_prefetch = "--prefetch" in args
            if rep["batches"] != 2 or rep["prefetch"] != want_prefetch:
                raise AssertionError(f"unexpected CLI report: {rep}")
            detail = (f"prefetched_rows {rep.get('prefetched_rows', 0)}, total "
                      f"{rep['total_s']:.4f} s")
        log(f"  infer_gnn {label}: ok in {time.perf_counter() - t0:.1f} s, policy "
            f"{rep['policy']}, feat hit {rep['feat_hit_rate']:.4f}, {detail}")
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
    if not all((SRC / "repro_torch" / "csrc" / f"{n}.cu").is_file() for n in KERNEL_SOURCES):
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
    lines = line_phase(inputs[602], build["h2d_bytes_per_s"])
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
    sampler = sampler_phase(eng, peaks[1])
    gat = gat_phase(ds, peaks[1])
    torch.cuda.empty_cache()
    gt = gt_phase(ds, peaks[1])
    torch.cuda.empty_cache()
    lstm = lstm_phase(peaks[1])
    torch.cuda.empty_cache()
    cli = cli_phase()
    baselines = baselines_phase(ds, eng)
    layerwise = layerwise_phase(ds, eng)
    serving = serving_phase(ds, eng)
    refresh = refresh_phase(ds, eng)
    sharded = sharded_phase(ds, eng, serving)
    del serving["outputs"]
    lm = lm_phase(peaks)
    ssm = ssm_phase(peaks)
    encdec = encdec_phase(peaks)
    training = train_phase()
    dry = dryrun_phase()
    # Launches on the paths: the nine routes, the baselines', the
    # layer-wise, the serving, refresh and sharded runs, each counted from
    # 0 just before it.
    phases = {"12": serving["launches"], "13": refresh["launches"], "14": sharded["launches"]}
    path_launches = {
        name: main_path["launches"][name]
        + sum(c[name] for c in baselines["launches"].values())
        + sum(c[name] for c in layerwise["launches"].values())
        + sum(c[name] for runs in phases.values() for c in runs.values())
        for name in main_path["launches"]
    }
    serve_launches = {p: {name: sum(c[name] for c in runs.values())
                          for name in main_path["launches"]} for p, runs in phases.items()}
    log(f"launches on the paths (phases 8, 10-14): {path_launches}; phases 12, 13 and 14 "
        f"alone: {serve_launches}")

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
        # One row per offline cell's layer 0; launches: phase 8's routes.
        *({"name": "seg_agg_indexed", "route": "cuda", "source": SOURCES["seg_agg_indexed"],
           "replaces": REPLACES["seg_agg_indexed"], "case": r["label"],
           "launches": main_path["seg_agg_indexed_launches"], "max_abs_err": r["max_abs_err"],
           "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": "bytes", "library_ms": r["library_ms"]} for r in seg_row["indexed"]),
        # One row per layer of the GAT cell; launches: phase 20's engine runs.
        *({"name": "gat_attend", "route": "cuda", "source": SOURCES["gat_attend"],
           "replaces": REPLACES["gat_attend"], "case": r["label"], "launches": gat["launches"],
           "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"]}
          for r in gat["layers"]),
        # One row per layer of the Graph Transformer cell; launches: phase 21's engine runs.
        *({"name": "dot_attend", "route": "cuda", "source": SOURCES["dot_attend"],
           "replaces": REPLACES["dot_attend"], "case": r["label"], "launches": gt["launches"],
           "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"]}
          for r in gt["layers"]),
        # One row per layer of the GraphSAGE-LSTM cell; launches: phase 22's
        # engine runs.  library_ms: cuDNN's LSTM with its input map over
        # every slot (the kernel's input map is a separate SGEMM).
        *({"name": "lstm_agg", "route": "cuda", "source": SOURCES["lstm_agg"],
           "replaces": REPLACES["lstm_agg"], "case": r["label"], "launches": lstm["launches"],
           "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
          for r in lstm["layers"]),
        # One row per offline cell's last sampled layer; launches: phase 8's
        # routes.  No library call computes the same function.
        *({"name": "sample_layer", "route": "cuda", "source": SOURCES["sample_layer"],
           "replaces": REPLACES["sample_layer"], "case": r["label"],
           "launches": main_path["sample_layer_launches"], "max_abs_err": r["max_abs_err"],
           "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
           "bound_by": "bytes", "library_ms": None} for r in sampler["layers"]),
        # library_ms: flex_attention with the same softcap and mask
        # (scaled_dot_product_attention without softcap is in chip_smoke.json).
        # launches: the ops path's, phases 15-17's LM serving runs, phase
        # 18's eval prefill (its training steps launch none) and phase 19's
        # prefill and decode step.
        {"name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"],
         "replaces": REPLACES["flash_attention"],
         "launches": ops_launches["flash_attention"] + lm["launches_total"]
         + ssm["launches_total"] + encdec["launches_total"] + training["launches_total"]
         + dry["launches_total"],
         "max_abs_err": att_err, "ms": prefill["ms"], "plain_ms": prefill["plain_ms"],
         "bound_ms": prefill["bound_ms"], "bound_by": prefill["bound_by"],
         "library_ms": prefill["library_ms"]},
    ]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "device": device, "build": build, "setup": setup, "kernel_rows": rows,
        "split": split, "lines": lines, "feature_stage": feature_stage, "seg_agg": seg_row, "attention": att_rows,
        "ops_launches": ops_launches, "main_path": main_path, "sampler": sampler, "gat": gat,
        "gt": gt, "lstm": lstm,
        "baselines": baselines,
        "layerwise": layerwise, "serving": serving, "refresh": refresh, "sharded": sharded,
        "lm": lm, "ssm": ssm, "encdec": encdec, "training": training, "dryrun": dry,
        "cli": cli, "path_launches": path_launches,
        "serve_launches": serve_launches, "kernels": kernels,
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
