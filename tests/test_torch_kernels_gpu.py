"""The CUDA kernels against their ``ref.py`` on the card (marked ``gpu``).

Every test takes the ``cuda`` fixture, which skips when no card is present
— decided inside the fixture, never at import time, so every worker
collects the same tests.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Gathers are copies, so their comparisons are ``torch.equal``; the
aggregation and attention kernels are held at the tolerances their CPU
parity tests state (float32 1e-6 and 3e-4, bfloat16 2e-2 and 5e-2), with
TF32 off for the plain version's float32 products.  Each attention call
is checked against the design ``plan`` gives it (its per-design counter),
and a tensor-core output also against ``ref.py`` in float32 on the same
inputs (rtol 2e-2, atol 2e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.config import EngineConfig
from repro_torch.graph.datasets import load_dataset
from repro_torch.kernels.cached_gather import kernel as tk
from repro_torch.kernels.cached_gather.ops import cached_feature_gather
from repro_torch.kernels.cached_gather.ref import cached_gather_ref
from repro_torch.kernels.dot_attend import kernel as da
from repro_torch.kernels.dot_attend.ref import dot_attend_ref
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import (attention_ref, attention_split_ref,
                                                      expand_kv)
from repro_torch.kernels.gat_attend import kernel as ga
from repro_torch.kernels.gat_attend.ref import gat_attend_ref
from repro_torch.kernels.seg_agg import kernel as sa
from repro_torch.kernels.seg_agg.ref import seg_agg_indexed_ref, seg_agg_ref
from repro_torch.models.lm import attention as lm_attn
from repro_torch.models.lm import model as lm_model
from repro_torch.models.lm import moe as lm_moe
from repro_torch.runtime import serve_engine as lm_serve_engine
from repro_torch.runtime.gnn_engine import GNNInferenceEngine
from repro_torch.utils.tree import tree_map

pytestmark = pytest.mark.gpu

KERNELS = {
    "db": tk.cached_gather,
    "blocks": tk.cached_gather_blocks,
    "select": tk.cached_gather_select,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tables(cuda, h, n, f, dtype, host_on):
    gen = torch.Generator().manual_seed(h * 1000 + n + f)
    hot = torch.randn((h, f), generator=gen).to(dtype).to(cuda)
    host = torch.randn((n, f), generator=gen).to(dtype)
    host = host.to(cuda) if host_on == "device" else host.pin_memory()
    return hot, host


def _ids(cuda, s, h, n, seed, sorted_runs=False):
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n, (s,), generator=gen, dtype=torch.int32)
    pos = torch.randint(-1, h, (s,), generator=gen, dtype=torch.int32)
    if sorted_runs:
        idx = torch.sort(idx).values
        pos = torch.where(pos >= 0, torch.arange(s, dtype=torch.int32) % h, pos)
    return idx.to(cuda), pos.to(cuda)


@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("host_on", ["pinned", "device"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n,f,s", [(16, 100, 64, 32), (8, 50, 602, 7), (64, 4096, 100, 5000),
                                     (1, 10, 3, 1), (300, 2000, 602, 4099)])
def test_kernel_matches_ref(cuda, kind, host_on, dtype, h, n, f, s):
    hot, host = _tables(cuda, h, n, f, dtype, host_on)
    idx, pos = _ids(cuda, s, h, n, seed=s, sorted_runs=kind == "blocks")
    before = KERNELS[kind].launches
    out = KERNELS[kind](hot, host, idx, pos)
    torch.cuda.synchronize()
    assert KERNELS[kind].launches == before + 1
    assert out.is_cuda and out.dtype == dtype
    assert torch.equal(out, cached_gather_ref(hot, host, idx, pos))


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_edge_cases(cuda, kind):
    hot, host = _tables(cuda, 12, 40, 602, torch.float32, "pinned")
    s = 24
    ids = torch.arange(s, dtype=torch.int32, device=cuda)
    for pos in (torch.arange(s, dtype=torch.int32, device=cuda) % 12,  # all hits
                torch.full((s,), -1, dtype=torch.int32, device=cuda)):  # all misses
        assert torch.equal(KERNELS[kind](hot, host, ids, pos), cached_gather_ref(hot, host, ids, pos))
    idx = torch.tensor([0, 39, 40, 1000, -3, 5, 7, 2], dtype=torch.int32, device=cuda)
    pos = torch.tensor([-1, 11, 12, -1, 100, -7, 3, 0], dtype=torch.int32, device=cuda)
    assert torch.equal(KERNELS[kind](hot, host, idx, pos), cached_gather_ref(hot, host, idx, pos))
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = KERNELS[kind].launches
    out = KERNELS[kind](hot, host, empty, empty)
    assert out.shape == (0, 602) and KERNELS[kind].launches == before


def test_blocks_runs_and_row_blocks(cuda):
    hot, host = _tables(cuda, 64, 256, 100, torch.float32, "pinned")
    ids = torch.arange(10, 74, dtype=torch.int32, device=cuda)
    hit_run = torch.arange(0, 64, dtype=torch.int32, device=cuda)
    miss_run = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    for pos in (hit_run, miss_run):
        mode, _ = tk.classify_blocks(ids, pos, 64, 256, tk.ROW_BLOCK)
        assert bool((mode > 0).all())
        for rb in (1, 2, 8, 16, 100):
            out = tk.cached_gather_blocks(hot, host, ids[:61], pos[:61], row_block=rb)
            assert torch.equal(out, cached_gather_ref(hot, host, ids[:61], pos[:61]))


def _run_inputs(cuda, s, h, n, seed, max_run=80):
    """Ids and slots in runs of 1 to ``max_run`` rows: consecutive hits,
    consecutive misses (some ending at their table's last row, some
    reaching past it and clamping there), runs broken by one row, and
    random rows."""
    gen = np.random.default_rng(seed)
    idx = gen.integers(0, n, s).astype(np.int32)
    pos = gen.integers(-1, h, s).astype(np.int32)

    def start(size, length):
        u = gen.random()
        return size - length if u < 0.15 else size - length // 2 if u < 0.3 else gen.integers(0, size)

    i = 0
    while i < s:
        length = min(int(gen.integers(1, max_run + 1)), s - i)
        kind = int(gen.integers(0, 4))
        run = np.arange(length, dtype=np.int32)
        if kind == 0:  # a hit run
            pos[i : i + length] = start(h, length) + run
        elif kind == 1:  # a miss run
            idx[i : i + length] = start(n, length) + run
            pos[i : i + length] = -1 - run % 3
        elif kind == 2:  # a run broken by one row
            pos[i : i + length] = gen.integers(0, h) + run
            pos[i + length // 2] = -1
        i += length
    return torch.from_numpy(idx).to(cuda), torch.from_numpy(pos).to(cuda)


def _vec(row_bytes, hot, host):
    return tk._vec_bytes(row_bytes, hot.data_ptr(), host.data_ptr(), 256)


@pytest.mark.parametrize("host_on", ["pinned", "device"])
@pytest.mark.parametrize("f", [100, 602])
@pytest.mark.parametrize("kind", ["db", "blocks", "select"])
def test_ragged_tails_of_the_persistent_grid(cuda, kind, f, host_on):
    """S below, at and just above one warp's rows and one full persistent
    grid (for #1 with short rows from a pinned table, of its hit warps and
    of its miss warps; otherwise every warp takes both kinds; for #3, of
    its chunks of rows, one ring stage each for short rows), and S = 1:
    every tail of the stride loops."""
    h, n, row_block = 300, 5000, tk.ROW_BLOCK
    hot, host = _tables(cuda, h, n, f, torch.float32, host_on)
    row_bytes = f * 4
    vec = _vec(row_bytes, hot, host)
    miss_warps = tk._miss_warps(row_bytes, vec, host.is_cuda) if kind == "db" else 0
    if kind == "db":  # hit warps' chunks, and miss warps' chunks of 32 rows
        per_warp = tk._rows_per_warp(row_bytes, vec)
        ctas = tk._ctas_per_sm(tk.KIND_ROWS, vec)
    elif kind == "select":
        per_warp, unroll, stages = tk._select_ring(row_bytes, vec)
        ctas = tk._ctas_per_sm(tk.KIND_SELECT, vec, tk._select_smem(vec, unroll, stages))
    else:
        per_warp = row_block
        ctas = tk._ctas_per_sm(tk.KIND_BLOCKS, vec)
    n_ctas = tk._sm_count(cuda.index or 0) * ctas
    sizes = {1, per_warp - 1, per_warp, per_warp + 1, 31, 32, 33}
    grids = [n_ctas * (tk.WARPS_PER_CTA - miss_warps) * per_warp]
    if miss_warps:
        grids.append(n_ctas * miss_warps * 32)
    for grid_rows in grids:
        sizes |= {grid_rows - 1, grid_rows, grid_rows + 1}
    for s in sorted(sizes - {0}):
        idx, pos = _run_inputs(cuda, s, h, n, seed=s)
        out = KERNELS[kind](hot, host, idx, pos)
        torch.cuda.synchronize()
        assert torch.equal(out, cached_gather_ref(hot, host, idx, pos)), s


@pytest.mark.parametrize("host_on", ["pinned", "device"])
@pytest.mark.parametrize("dtype,f,stages_per_row", [(torch.float32, 602, 1), (torch.float32, 2500, 2),
                                                    (torch.bfloat16, 4500, 2),
                                                    (torch.bfloat16, 10002, 3)])
def test_select_long_rows_in_ring_stages(cuda, dtype, f, stages_per_row, host_on):
    """#3 on rows longer than 32 vectors, each a chunk alone: reddit's
    2,408-byte rows (one stage of 8-byte vectors) and rows that take two
    or three stages of the ring (f32 at 16-byte vectors, bf16 at 8 and 4),
    for S = 1, a few rows and a grid's worth with a ragged tail."""
    h, n = 300, 2000
    hot, host = _tables(cuda, h, n, f, dtype, host_on)
    row_bytes = f * hot.element_size()
    vec = _vec(row_bytes, hot, host)
    rows, unroll, stages = tk._select_ring(row_bytes, vec)
    assert rows == 1 and stages >= 2
    assert -(-(row_bytes // vec) // (32 * unroll)) == stages_per_row
    for s in (1, 7, 3001):
        idx, pos = _run_inputs(cuda, s, h, n, seed=s + f)
        out = tk.cached_gather_select(hot, host, idx, pos)
        torch.cuda.synchronize()
        assert torch.equal(out, cached_gather_ref(hot, host, idx, pos)), s


@pytest.mark.parametrize("host_on", ["pinned", "device"])
@pytest.mark.parametrize("f", [1, 3])
def test_select_two_byte_vectors(cuda, f, host_on):
    """bf16 rows of odd width copy 2-byte vectors, which cp.async cannot:
    #3's register instance, in the same kernel, equals ref.py."""
    h, n = 64, 700
    hot, host = _tables(cuda, h, n, f, torch.bfloat16, host_on)
    assert _vec(2 * f, hot, host) == 2 and tk._select_ring(2 * f, 2)[2] == 0
    for s in (1, 31, 33, 4099):
        idx, pos = _run_inputs(cuda, s, h, n, seed=s * 3 + f)
        before = tk.cached_gather_select.launches
        out = tk.cached_gather_select(hot, host, idx, pos)
        torch.cuda.synchronize()
        assert tk.cached_gather_select.launches == before + 1
        assert torch.equal(out, cached_gather_ref(hot, host, idx, pos)), s


def test_select_counts_one_launch_per_call(cuda):
    """cached_gather_select.launches rises by exactly one for each call
    that launches (S > 0) and not at all for an empty frontier."""
    hot, host = _tables(cuda, 12, 40, 100, torch.float32, "pinned")
    idx, pos = _ids(cuda, 50, 12, 40, seed=3)
    empty = idx[:0]
    before = tk.cached_gather_select.launches
    for i, p in [(idx, pos), (empty, empty), (idx[:1], pos[:1]), (idx, pos)]:
        tk.cached_gather_select(hot, host, i, p)
    torch.cuda.synchronize()
    assert tk.cached_gather_select.launches == before + 3


@pytest.mark.parametrize("host_on", ["pinned", "device"])
@pytest.mark.parametrize("dtype,f", [(torch.float32, 100), (torch.float32, 602),
                                     (torch.bfloat16, 1), (torch.bfloat16, 3),
                                     (torch.bfloat16, 602)])
@pytest.mark.parametrize("row_block", [2, 3, 8, 32, 33, 100])
def test_blocks_classify_in_kernel(cuda, row_block, dtype, f, host_on):
    """#2 on runs, broken runs and mixed blocks at every vector width:
    its output equals ref.py's, and the modes it computes equal
    classify_blocks'."""
    h, n, s = 1000, 4000, 3001
    hot, host = _tables(cuda, h, n, f, dtype, host_on)
    idx, pos = _run_inputs(cuda, s, h, n, seed=row_block * 7 + f, max_run=3 * row_block)
    # Blocks 0 and 1: spans that end at the hot table's and the host
    # table's last row.
    run = torch.arange(row_block, dtype=torch.int32, device=cuda)
    pos[:row_block] = h - row_block + run
    idx[row_block : 2 * row_block] = n - row_block + run
    pos[row_block : 2 * row_block] = -1
    want = cached_gather_ref(hot, host, idx, pos)
    before = tk.cached_gather_blocks.launches
    assert torch.equal(tk.cached_gather_blocks(hot, host, idx, pos, row_block=row_block), want)
    assert tk.cached_gather_blocks.launches == before + 1
    want_mode, _ = tk.classify_blocks(idx, pos, h, n, row_block)
    assert want_mode[0] == 1 and want_mode[1] == 2
    modes = torch.full_like(want_mode, -1)
    out = tk._launch_blocks(hot, host, idx, pos, row_block, modes=modes)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(modes, want_mode)
    assert tk.cached_gather_blocks.launches == before + 1


def test_blocks_pad_a_short_hot_table_on_the_card(cuda):
    """H = 4 < row_block: slots in [4, 8) read zero pad rows and larger
    slots clamp to pad row 7, as the reference's row-block kernel pads."""
    hot, host = _tables(cuda, 4, 50, 100, torch.float32, "pinned")
    pos = torch.tensor([0, 1, 2, 3, 5, 100, -1, 2, 0, 1, 2, 3, 4, 5, 6, 7, 3], dtype=torch.int32,
                       device=cuda)
    idx = torch.arange(pos.shape[0], dtype=torch.int32, device=cuda)
    padded = torch.cat([hot, hot.new_zeros((4, 100))])
    out = tk.cached_gather_blocks(hot, host, idx, pos)
    assert torch.equal(out, cached_gather_ref(padded, host, idx, pos))
    assert not out[[4, 5, 12, 13, 14, 15]].any() and out[[0, 1, 2, 3]].any(dim=1).all()


def test_wrappers_refuse_what_they_cannot_read(cuda):
    hot, host = _tables(cuda, 4, 20, 16, torch.float32, "device")
    idx, pos = _ids(cuda, 9, 4, 20, seed=1)
    with pytest.raises(ValueError, match="pinned"):
        tk.cached_gather(hot, host.cpu(), idx, pos)  # pageable host memory
    with pytest.raises(ValueError):
        tk.cached_gather(hot, host, idx.cpu(), pos.cpu())  # indices off the card
    with pytest.raises(ValueError):
        tk.cached_gather_blocks(hot, host, idx, pos, row_block=0)
    with pytest.raises(ValueError, match="use_kernel"):
        cached_feature_gather(hot, host, idx, pos)  # the plain version stays on the CPU
    assert torch.equal(cached_feature_gather(hot, host, idx, pos, use_kernel=True),
                       cached_gather_ref(hot, host, idx, pos))


def test_engine_routes_agree_on_the_card(cuda):
    """Kernel, kernel+dedup and table routes, each with prefetch off and
    on, give identical logits and hit counts, and the main path launches
    kernels #1 and #2."""
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    outs, hits = [], set()
    n_db, n_blk = tk.cached_gather.launches, tk.cached_gather_blocks.launches
    for prefetch in (False, True):
        for cfg in (EngineConfig(use_kernel=True, pipeline_depth=2),
                    EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2),
                    EngineConfig(use_kernel=True, dedup=True, pipeline_depth=1),
                    EngineConfig(use_kernel=False, pipeline_depth=1)):
            rep = eng.run(config=cfg.replace(prefetch=prefetch), max_batches=3,
                          collect_outputs=True)
            outs.append(np.stack(eng.last_outputs))
            hits.add((rep.feat_hits, rep.adj_hits))
            assert 0 < rep.feat_hit_rate < 1 and 0 < rep.adj_hit_rate < 1
            assert (rep.prefetched_rows > 0) == prefetch
    assert tk.cached_gather.launches > n_db and tk.cached_gather_blocks.launches > n_blk
    assert len(hits) == 1
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


@pytest.mark.parametrize("cached_rows", [0, 40, 2000])
def test_gathers_read_a_prefetched_pack(cuda, cached_rows):
    """#1 and #2 reading the device miss pack through ``pack_pos`` (or the
    all-miss row set) give ref.py's rows from the full pinned host table."""
    from repro_torch.graph.features import build_feature_cache, plain_feature_store

    gen = np.random.default_rng(cached_rows)
    feats = gen.standard_normal((3000, 100)).astype(np.float32)
    counts = gen.poisson(1.0, 3000).astype(np.int32)
    store = (build_feature_cache(feats, counts, cached_rows * 400, device=cuda) if cached_rows
             else plain_feature_store(feats, device=cuda))
    ids = torch.from_numpy(np.sort(gen.integers(0, 3000, 5000)).astype(np.int32)).to(cuda)
    uids = torch.unique(ids).to(torch.int32)
    for gather_ids, row_block in ((ids, None), (uids, tk.ROW_BLOCK)):
        staged = store.prefetch_misses(gather_ids)
        assert staged.rows.is_cuda and staged.ready is not None
        assert (staged.idx is None) == (cached_rows == 0)
        for use_kernel in (True, False):
            got, hit = store.gather(gather_ids, use_kernel=use_kernel, prefetched=staged,
                                    row_block=row_block)
            want, want_hit = store.gather(gather_ids, use_kernel=True, row_block=row_block)
            assert torch.equal(got, want) and torch.equal(hit, want_hit)
            pos = store.position_map[gather_ids.to(torch.int64)]
            assert torch.equal(got, cached_gather_ref(store.hot_table, store.host_table,
                                                      gather_ids, pos))


@pytest.mark.parametrize("use_kernel,row_block", [(False, None), (True, None), (True, 8)])
def test_gather_clamps_ids_past_the_last_node_on_the_card(cuda, use_kernel, row_block):
    """Ids >= N read node N - 1's hit flag and row on CUDA tensors too."""
    from repro_torch.graph.features import build_feature_cache

    n = 50
    feats = np.random.default_rng(7).standard_normal((n, 8)).astype(np.float32)
    store = build_feature_cache(feats, np.arange(n), 320, device=cuda)
    ids = torch.tensor([50, 55, 3], dtype=torch.int32, device=cuda)
    got, hit = store.gather(ids, use_kernel=use_kernel, row_block=row_block)
    assert hit.tolist() == [True, True, False]
    np.testing.assert_array_equal(got.cpu().numpy(), feats[[49, 49, 3]])
    cached, chit = store.gather_cache_only(ids)
    assert chit.tolist() == [True, True, False]
    np.testing.assert_array_equal(cached.cpu().numpy(), np.stack([feats[49], feats[49],
                                                                  np.zeros(8, np.float32)]))


def test_layerwise_routes_are_bit_identical_on_the_card(cuda):
    """Layer-wise on the kernel route (#2), twice, with prefetch, and on the
    table route at depth 1, at one allocation: the same outputs and hits,
    and #2 launched."""
    from repro_torch.runtime.layerwise import run_layerwise

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    pipe = eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    before = tk.cached_gather_blocks.launches
    first = eng.run(config=EngineConfig(mode="layerwise", chunk_size=1024, use_kernel=True,
                                        pipeline_depth=2))
    assert tk.cached_gather_blocks.launches > before and first.device == "cuda:0"
    assert 0 < first.feat_hits < first.feat_lookups and 0 < first.embed_hits
    for knobs in (dict(use_kernel=True, pipeline_depth=2),
                  dict(use_kernel=True, pipeline_depth=2, prefetch=True),
                  dict(use_kernel=False, pipeline_depth=1)):
        cfg = EngineConfig(mode="layerwise", chunk_size=1024, **knobs)
        rep = run_layerwise(ds, pipe, list(eng.model.layers), model="graphsage",
                            config=cfg.resolved(pipe, pipeline_depth=cfg.pipeline_depth),
                            allocation=first.allocation)
        np.testing.assert_array_equal(rep.outputs, first.outputs)
        assert (rep.feat_hits, rep.feat_lookups, rep.embed_hits, rep.embed_lookups) == (
            first.feat_hits, first.feat_lookups, first.embed_hits, first.embed_lookups)
    assert first.outputs.shape == (ds.num_nodes, ds.spec.num_classes)
    assert np.isfinite(first.outputs).all()


def _cpu_draws(ds, batches, fanouts):
    """Slot draws for ``batches`` made on the CPU, recovered from a
    CPU-sampled block as ``edge_slots - col_ptr[frontier]``."""
    from repro_torch.graph.sampling import device_graph, sample_blocks

    g = device_graph(ds.graph, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    draws = []
    for seeds in batches:
        block = sample_blocks(g, torch.from_numpy(seeds), fanouts, generator=gen)
        draws.append([slots - g.col_ptr[f.to(torch.int64)][:, None].to(slots.dtype)
                      for f, slots in zip(block.frontiers, block.edge_slots)])
    return draws


def test_rain_on_the_card_matches_its_cpu_run(cuda):
    """RAIN's reuse on the card (kernel and table routes) against the same
    draws on the CPU: reuse hits equal, logits within 1e-4."""
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    fanouts = (3, 2)
    runs = {}
    for device in ("cpu", cuda):
        eng = GNNInferenceEngine(ds, fanouts=fanouts, batch_size=64, device=device)
        eng.prepare("rain")
        draws = _cpu_draws(ds, eng._batches(4), fanouts)
        for use_kernel in (True, False):
            rep = eng.run(config=EngineConfig(use_kernel=use_kernel, dedup=True), max_batches=4,
                          collect_outputs=True, draws=draws)
            assert not rep.dedup
            runs[(str(device), use_kernel)] = (rep.feat_hits, rep.feat_lookups,
                                               np.stack(eng.last_outputs))
    cpu_hits, cpu_lookups, cpu_out = runs[("cpu", True)]
    assert 0 < cpu_hits < cpu_lookups
    for hits, lookups, out in runs.values():
        assert (hits, lookups) == (cpu_hits, cpu_lookups)
        np.testing.assert_allclose(out, cpu_out, rtol=1e-4, atol=1e-4)


def _card_server(cuda, cfg, injector=None):
    """A 3-stream server on the card over one prepared dci pipeline."""
    from repro_torch.runtime.gnn_serve import MultiStreamServer, make_stream_batches

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2, stream_seeds=[0, 1, 2])
    queues = make_stream_batches(ds, num_streams=3, batches_per_stream=3, batch_size=128,
                                 seed=0)
    server = MultiStreamServer(eng, config=cfg, injector=injector)
    for sid, q in enumerate(queues):
        server.add_stream(q, seed=sid, collect_outputs=True)
    return eng, queues, server


@pytest.mark.parametrize("dedup", [False, True])
def test_three_stream_server_is_serial_equivalent_on_the_card(cuda, dedup):
    """Each of three interleaved streams (each with its own CUDA generator)
    gives the logits and hit counts of its batches alone through the
    engine with the same seed, on the kernel routes (#1, or #2 under
    dedup, launched)."""
    from repro_torch.core.config import ServeConfig

    cfg = ServeConfig(engine=EngineConfig(use_kernel=True, dedup=dedup, pipeline_depth=2))
    eng, queues, server = _card_server(cuda, cfg)
    kernel = tk.cached_gather_blocks if dedup else tk.cached_gather
    before = kernel.launches
    rep = server.run()
    assert kernel.launches - before == 9 + 1  # every batch, and the warmup
    assert rep.device == "cuda:0" and rep.kernel_fallbacks == 0
    assert all(s.max_inflight_seen <= 2 for s in server.streams)
    for sid, q in enumerate(queues):
        solo = GNNInferenceEngine(eng.dataset, fanouts=(4, 3), batch_size=128, seed=sid,
                                  device=cuda, params=[dict(l) for l in eng.model.layers])
        solo.pipeline = eng.pipeline
        srep = solo.run(config=EngineConfig(use_kernel=True, dedup=dedup),
                        batches=list(q), collect_outputs=True)
        st = rep.streams[sid]
        assert (st.adj_hits, st.feat_hits) == (srep.adj_hits, srep.feat_hits)
        for a, b in zip(solo.last_outputs, server.streams[sid].runtime.outputs):
            np.testing.assert_array_equal(a, b)


def test_kernel_gather_faults_reroute_off_kernel_one_on_the_card(cuda):
    """Two injected kernel_gather faults under fail-fast: those two gathers
    run on the table route (kernel #1 launches 9 - 2 times over 9 batches),
    and the logits equal the fault-free serve's."""
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule

    cfg = ServeConfig(engine=EngineConfig(use_kernel=True, pipeline_depth=2))
    _, _, base = _card_server(cuda, cfg)
    base.run()
    plan = FaultPlan(rules=(FaultRule("kernel_gather", start_after=1, max_faults=2),))
    _, _, server = _card_server(cuda, cfg, FaultInjector(plan))
    before = tk.cached_gather.launches
    rep = server.run(warmup=False)
    assert tk.cached_gather.launches - before == 9 - 2
    assert rep.kernel_fallbacks == 2 and rep.requests_degraded == 0
    for a, b in zip(base.streams, server.streams):
        for x, y in zip(a.runtime.outputs, b.runtime.outputs):
            np.testing.assert_array_equal(x, y)


def test_a_refresh_on_the_card_leaves_the_previous_epoch_unchanged(cuda):
    """A committed refresh that grows the hot table and inserts rows, and
    one rolled back by a ``refresh_fill`` fault, write nothing into the
    tensors the previous epoch's batches read; the rolled-back one leaves
    the cache holding the same objects."""
    import dataclasses

    from repro_torch.core.faults import FaultInjector, FaultPlan, FaultRule, InjectedFault

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    caches, stats = eng.pipeline.caches, eng.pipeline.presample
    alloc = caches.allocation
    grow = dataclasses.replace(alloc, total_bytes=4 * alloc.total_bytes,
                               feat_bytes=4 * alloc.feat_bytes)
    counts = np.random.default_rng(0).integers(0, 9, ds.num_nodes)

    def tensors():
        return [caches.store.hot_table, caches.store.position_map, caches.dgraph.cache_ptr,
                caches.dgraph.cache_row_index, caches.dgraph.cached_len, caches.dgraph.row_index]

    old, objs = tensors(), (caches.dgraph, caches.store, caches.allocation, caches.epoch)
    clones = [t.clone() for t in old]
    inj = FaultInjector(FaultPlan(rules=(FaultRule("refresh_fill", max_faults=1),)))
    with pytest.raises(InjectedFault):
        caches.refresh(allocation=grow, node_counts=counts, edge_counts=stats.edge_counts,
                       injector=inj)
    assert (caches.dgraph, caches.store, caches.allocation, caches.epoch) == objs
    assert all(a is b for a, b in zip(tensors(), old))
    delta = caches.refresh(allocation=grow, node_counts=counts, edge_counts=stats.edge_counts,
                           injector=inj)
    torch.cuda.synchronize()
    assert delta.feat.rows_inserted > 0 and caches.store.hot_table.shape[0] > old[0].shape[0]
    assert caches.store.hot_table.is_cuda and caches.store.host_table.is_pinned()
    for t, c in zip(old, clones):
        assert torch.equal(t, c)


@pytest.mark.parametrize("row_block", [None, tk.ROW_BLOCK])
def test_co_resident_shards_gather_like_the_store_on_the_card(cuda, row_block):
    """Four co-resident shards through #1 (or #2) give the unsharded
    gather's bits; each shard's host table is a pinned view sharing the
    global table's storage, read over UVA at its own offset."""
    from repro_torch.graph.sampling import sample_blocks
    from repro_torch.graph.shard import ShardedFeatureStore, make_shard_plan

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    store = eng.pipeline.caches.store
    ss = ShardedFeatureStore.partition_store(store, make_shard_plan(store.num_nodes, 4))
    base = store.host_table.untyped_storage().data_ptr()
    for s, fs in enumerate(ss.shards):
        lo, _ = ss.plan.bounds(s)
        assert fs.host_table.is_pinned() and fs.host_table.untyped_storage().data_ptr() == base
        assert fs.host_table.data_ptr() == base + lo * store.feat_dim * 4
        assert fs.hot_table.is_cuda and fs.hot_table.data_ptr() != store.hot_table.data_ptr()
    block = sample_blocks(eng.pipeline.caches.dgraph, eng._seeds(ds.test_idx[:128]), (4, 3),
                          generator=torch.Generator(device=cuda).manual_seed(1))
    ids = block.input_nodes
    if row_block:
        ids = torch.unique(ids)
    kernel = tk.cached_gather_blocks if row_block else tk.cached_gather
    want_f, want_h = store.gather(ids, use_kernel=True, row_block=row_block)
    part = ss.partition(ids.cpu().numpy())
    before = kernel.launches
    feats, hit = ss.gather(part, use_kernel=True, row_block=row_block)
    torch.cuda.synchronize()
    assert kernel.launches - before == sum(b is not None for b in part.seg_ids) == 4
    assert torch.equal(feats, want_f) and torch.equal(hit, want_h)
    table_f, _ = ss.gather(part)  # the table route through the views agrees
    assert torch.equal(table_f, want_f)


@pytest.mark.parametrize("row_block", [None, tk.ROW_BLOCK])
def test_a_failed_over_shard_is_gathered_by_the_kernel_on_the_card(cuda, row_block):
    """A down shard's segment is read from its pinned host view by #1 (or
    #2) on the card: one launch per non-empty segment, down shard
    included, and the unsharded gather's bits and hit mask."""
    from repro_torch.graph.sampling import sample_blocks
    from repro_torch.graph.shard import ShardedFeatureStore, make_shard_plan

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    store = eng.pipeline.caches.store
    ss = ShardedFeatureStore.partition_store(store, make_shard_plan(store.num_nodes, 4))
    block = sample_blocks(eng.pipeline.caches.dgraph, eng._seeds(ds.test_idx[:128]), (4, 3),
                          generator=torch.Generator(device=cuda).manual_seed(1))
    ids = block.input_nodes
    if row_block:
        ids = torch.unique(ids)
    kernel = tk.cached_gather_blocks if row_block else tk.cached_gather
    want_f, want_h = store.gather(ids, use_kernel=True, row_block=row_block)
    part = ss.partition(ids.cpu().numpy())
    assert part.seg_ids[1] is not None
    before = kernel.launches
    feats, hit = ss.gather(part, use_kernel=True, row_block=row_block, down={1, 2})
    torch.cuda.synchronize()
    assert kernel.launches - before == sum(b is not None for b in part.seg_ids) == 4
    assert feats.is_cuda and torch.equal(feats, want_f) and torch.equal(hit, want_h)


def test_ducati_routes_agree_on_the_card(cuda):
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    pipe = eng.prepare("ducati", total_cache_bytes=300_000, n_presample=1)
    assert pipe.presample.n_batches == 4 and pipe.caches.feat_cached_rows > 0
    n_db, n_blk = tk.cached_gather.launches, tk.cached_gather_blocks.launches
    outs, hits = [], set()
    for dedup in (False, True):
        rep = eng.run(config=EngineConfig(use_kernel=True, dedup=dedup), max_batches=3,
                      collect_outputs=True)
        outs.append(np.stack(eng.last_outputs))
        hits.add((rep.feat_hits, rep.adj_hits))
    assert tk.cached_gather.launches > n_db and tk.cached_gather_blocks.launches > n_blk
    assert len(hits) == 1
    np.testing.assert_array_equal(outs[0], outs[1])


SEG_TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
ATT_TOL = {torch.float32: 3e-4, torch.bfloat16: 5e-2}
# A bfloat16 output against ref.py in float32 on the same inputs (rtol,
# atol): the kernel rounds only p and its output to bfloat16, which moves a
# row that keeps n keys by about 2**-9 |v| / sqrt(n).  Held on the rows that
# keep at least F32_MIN_KEYS keys: on a row of two keys and an output near
# 0 the reference's own rounding of p exceeds atol (ref.py in bfloat16
# fails the same check there).
ATT_TOL_BF16_F32 = (2e-2, 2e-3)
F32_MIN_KEYS = 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("s,fo,f", [(32, 5, 128), (7, 2, 602), (100, 15, 64), (1, 1, 1),
                                    (4099, 10, 100), (33, 3, 7)])
def test_seg_agg_matches_ref(cuda, dtype, mode, s, fo, f):
    x = torch.randn((s, fo, f), generator=torch.Generator().manual_seed(s + f)).to(dtype).to(cuda)
    before = sa.seg_agg.launches
    got = sa.seg_agg(x, mode=mode)
    torch.cuda.synchronize()
    assert sa.seg_agg.launches == before + 1 and got.dtype == dtype and got.shape == (s, f)
    torch.testing.assert_close(got, seg_agg_ref(x, mode=mode), rtol=SEG_TOL[dtype],
                               atol=SEG_TOL[dtype])


def test_seg_agg_odd_pitch_empty_and_refusals(cuda):
    x = torch.randn((9, 4, 101), device=cuda)[:, :, 1:]  # a non-contiguous view
    torch.testing.assert_close(sa.seg_agg(x), x.sum(1), rtol=1e-6, atol=1e-6)
    assert sa.seg_agg(torch.empty((0, 3, 8), device=cuda)).shape == (0, 8)
    with pytest.raises(ValueError):
        sa.seg_agg(x.half())
    with pytest.raises(ValueError, match="use_kernel"):
        from repro_torch.kernels import aggregate_neighbors

        aggregate_neighbors(x)


# The indexed form at the offline cells' layer 0 (4096 seeds at fan-outs
# 15,10,5: 270,336 destinations of 16 rows each, F = 100 and 602, ids over
# the graphs' node counts), and shapes that take every vector width (16,
# 8, 4 B), rows narrower than a warp and more than one chunk of slots.
# Self rows are copies and must be equal.  Sums are held to the float64
# sum within the bound of float32 summation in any order, (fanout + 2) ulps
# of 2**-24 over the same sum of magnitudes: the plain version sums in
# torch's reduction order, not in slot order, and at the cells' shapes
# differs from the kernel by up to 1.9e-6 (rtol and atol 1e-6 fail on
# about 1 element in 10**5, where terms cancel).
INDEXED_SHAPES = [(270_336, 15, 100, 2_449_029), (270_336, 15, 602, 232_965),
                  (4096, 10, 101, 5000), (1000, 15, 3, 300), (1000, 17, 36, 900),
                  (999, 33, 100, 700), (513, 5, 602, 400), (77, 1, 24, 50), (50, 40, 16, 64)]


@pytest.mark.parametrize("mode", ["sage", "gcn"])
@pytest.mark.parametrize("num_dst,fanout,f,rows", INDEXED_SHAPES)
def test_seg_agg_indexed_matches_ref(cuda, mode, num_dst, fanout, f, rows):
    gen = torch.Generator(device=cuda).manual_seed(num_dst + f)
    table = torch.full((rows + 3, f), float("nan"), device=cuda)  # the last 3 rows are pad
    table[:rows] = torch.randn((rows, f), generator=gen, device=cuda)
    idx = torch.randint(0, rows, (num_dst * (1 + fanout),), generator=gen, device=cuda,
                        dtype=torch.int32)
    kw = dict(num_dst=num_dst, fanout=fanout, mode=mode)
    for index, x in ((idx, table), (None, table[idx.long()])):
        before = sa.seg_agg_indexed.launches
        got = sa.seg_agg_indexed(x, index, **kw)
        torch.cuda.synchronize()
        assert sa.seg_agg_indexed.launches == before + 1
        exact = seg_agg_indexed_ref(x.double(), index, **kw)
        mags = seg_agg_indexed_ref(x.abs().double(), index, **kw)
        got, exact, mags = (got, exact, mags) if mode == "sage" else ((got,), (exact,), (mags,))
        if mode == "sage":
            assert torch.equal(got[0], exact[0].float())
        g, w, m = got[-1], exact[-1], mags[-1]
        assert g.shape == (num_dst, f) and not torch.isnan(g).any()
        assert bool(((g.double() - w).abs() <= (fanout + 2) * 2.0**-24 * m).all())
        if index is not None:
            indexed = got
        else:  # the dense form of the same positions: the same bits
            assert all(torch.equal(a, b) for a, b in zip(indexed, got))
        del x, exact, mags


def test_seg_agg_indexed_odd_base_empty_and_refusals(cuda):
    table = torch.randn(41 * 64 + 1, device=cuda)[1:].view(41, 64)  # a base 4 bytes past 16
    idx = torch.randint(0, 41, (7 * 4,), device=cuda, dtype=torch.int32)
    self_h, agg = sa.seg_agg_indexed(table, idx, num_dst=7, fanout=3, mode="sage")
    want = seg_agg_indexed_ref(table, idx, num_dst=7, fanout=3, mode="sage")
    assert torch.equal(self_h, want[0])
    torch.testing.assert_close(agg, want[1], rtol=1e-6, atol=1e-6)
    dense = table[idx.long()]  # the dense form's self rows: a view of its input
    self_d, agg_d = sa.seg_agg_indexed(dense, None, num_dst=7, fanout=3, mode="sage")
    assert self_d.data_ptr() == dense.data_ptr() and torch.equal(agg_d, agg)
    empty = sa.seg_agg_indexed(table, idx[:0], num_dst=0, fanout=3, mode="gcn")
    assert empty.shape == (0, 64)
    with pytest.raises(ValueError, match="float32"):
        sa.seg_agg_indexed(table.double(), idx, num_dst=7, fanout=3, mode="gcn")
    with pytest.raises(ValueError, match="int32"):
        sa.seg_agg_indexed(table, idx.long(), num_dst=7, fanout=3, mode="gcn")
    with pytest.raises(ValueError, match="idx on"):
        sa.seg_agg_indexed(table, idx.cpu(), num_dst=7, fanout=3, mode="gcn")


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_forward_inverse_index_equals_the_dense_form_on_the_card(cuda, model):
    """Layer 0 through seg_agg_indexed, with the inverse map and in the
    dense form: the same bits on the card, and close to the CPU's
    expansion-then-sum (the widest gap within 2e-5 of the largest logit,
    the benchmark's ``logit_gap`` limit: the card's matmuls and sums run
    in other orders than the CPU's)."""
    from repro_torch.models.gnn import models as gm

    fanouts = (15, 10, 5)
    gen = torch.Generator().manual_seed(7)
    params = gm.init_params(gen, model, 100, 47, device=cuda)
    positions = 64 * 16 * 11 * 6
    uniq = torch.randn((positions // 3 + 11, 100), generator=gen)
    uniq[-11:] = float("nan")  # pad rows, never read
    inverse = torch.randint(0, positions // 3, (positions,), generator=gen, dtype=torch.int32)
    before = sa.seg_agg_indexed.launches
    got = gm.forward(params, uniq.to(cuda), model=model, fanouts=fanouts,
                     inverse_index=inverse.to(cuda))
    dense = gm.forward(params, uniq[inverse.long()].to(cuda), model=model, fanouts=fanouts)
    torch.cuda.synchronize()
    assert sa.seg_agg_indexed.launches == before + 2
    assert got.shape == (64, 47) and torch.equal(got, dense)
    cpu = gm.forward([{k: v.cpu() for k, v in p.items()} for p in params], uniq,
                     model=model, fanouts=fanouts, inverse_index=inverse)
    assert float((got.cpu() - cpu).abs().max() / cpu.abs().max()) <= 2e-5


def test_engine_counts_every_batch_through_the_indexed_layer(cuda):
    """On the kernel + dedup route (and the dense one), every batch's
    layer 0 launches seg_agg_indexed and the report counts it."""
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    outs = []
    for dedup in (True, False):
        before = sa.seg_agg_indexed.launches
        rep = eng.run(config=EngineConfig(use_kernel=True, dedup=dedup, pipeline_depth=2),
                      max_batches=4, collect_outputs=True, warmup=False)
        assert rep.fused_batches == rep.num_batches == 4
        assert sa.seg_agg_indexed.launches - before == 4
        assert rep.summary()["fused_batches"] == 4
        outs.append(np.stack(eng.last_outputs))
    np.testing.assert_array_equal(outs[0], outs[1])


# GAT's attention at the cell's shapes (gat-products.offline4096: layer 0
# reads 270,336 x 16 positions of F = 100 through the inverse map over the
# graph's 2,449,029 ids; layers 1 and 2 read 24,576 x 11 and 4,096 x 6
# positions of F = 1,024 in place, 4 and 6 heads), and shapes that take
# 1, 2, 4 and 8 warps a destination, a row narrower than a warp, one and
# eight heads, one slot and a fanout past a chunk.  Held to ref.py in
# float64 on the same float32 inputs: the widest gap within 1e-5 of the
# largest output (float32 scores of up to 1,024 terms and the online
# softmax's rescaling, against torch's softmax of float64 scores).  The
# indexed and the dense form give the same bits.
GAT_SHAPES = [(270_336, 15, 100, 4, 2_449_029), (24_576, 10, 1024, 4, 0), (4096, 5, 1024, 6, 0),
              (1000, 15, 600, 4, 900), (999, 17, 256, 3, 700), (513, 1, 4, 1, 300),
              (300, 6, 512, 8, 400), (77, 4, 132, 2, 50), (64, 9, 36, 5, 64)]


def _u(gen, cuda, heads, f, scale):
    return torch.randn((2, heads, f), generator=gen, device=cuda) * scale


@pytest.mark.parametrize("num_dst,fanout,f,heads,rows", GAT_SHAPES)
def test_gat_attend_matches_ref(cuda, num_dst, fanout, f, heads, rows):
    gen = torch.Generator(device=cuda).manual_seed(num_dst + f)
    positions = num_dst * (1 + fanout)
    u = _u(gen, cuda, heads, f, 1.0 / f ** 0.5)
    forms = []
    if rows:
        table = torch.full((rows + 3, f), float("nan"), device=cuda)  # the last 3 rows are pad
        table[:rows] = torch.randn((rows, f), generator=gen, device=cuda)
        idx = torch.randint(0, rows, (positions,), generator=gen, device=cuda, dtype=torch.int32)
        forms.append((table, idx))
        forms.append((table[idx.long()], None))
    else:
        forms.append((torch.randn((positions, f), generator=gen, device=cuda), None))
    kw = dict(num_dst=num_dst, fanout=fanout, negative_slope=0.2)
    first = None
    for x, index in forms:
        before = ga.gat_attend.launches
        got = ga.gat_attend(x, index, u, **kw)
        torch.cuda.synchronize()
        assert ga.gat_attend.launches == before + 1
        assert got.shape == (num_dst, heads, f) and not torch.isnan(got).any()
        exact = gat_attend_ref(x.double(), index, u.double(), **kw)
        gap = float((got.double() - exact).abs().max() / exact.abs().max())
        assert gap <= 1e-5, gap
        if first is None:
            first = got
        else:  # the dense form of the same positions: the same bits
            assert torch.equal(first, got)
        del x, exact


def test_gat_attend_odd_base_empty_and_refusals(cuda):
    table = torch.randn(41 * 64 + 1, device=cuda)[1:].view(41, 64)  # a base 4 bytes past 16
    idx = torch.randint(0, 41, (7 * 4,), device=cuda, dtype=torch.int32)
    u = torch.randn((2, 3, 64), device=cuda) / 8
    kw = dict(num_dst=7, fanout=3, negative_slope=0.2)
    got = ga.gat_attend(table, idx, u, **kw)  # the wrapper copies the table to an aligned base
    torch.testing.assert_close(got, gat_attend_ref(table, idx, u, **kw), rtol=1e-5, atol=1e-6)
    assert torch.equal(ga.gat_attend(table.clone(), idx, u, **kw), got)
    dense = torch.empty(28 * 64 + 1, device=cuda)[1:].view(28, 64)
    dense.copy_(table[idx.long()])
    assert torch.equal(ga.gat_attend(dense, None, u, **kw), got)
    empty = ga.gat_attend(table, idx[:0], u, num_dst=0, fanout=3, negative_slope=0.2)
    assert empty.shape == (0, 3, 64)
    with pytest.raises(ValueError, match="float32"):
        ga.gat_attend(table.double(), idx, u, **kw)
    with pytest.raises(ValueError, match="int32"):
        ga.gat_attend(table, idx.long(), u, **kw)
    with pytest.raises(ValueError, match="idx on"):
        ga.gat_attend(table, idx.cpu(), u, **kw)
    with pytest.raises(ValueError, match="heads"):
        ga.gat_attend(table, idx, torch.zeros((2, 9, 64), device=cuda), **kw)
    for f in (602, 1028):  # a row the kernel does not read in 16-byte vectors, a row too wide
        with pytest.raises(ValueError, match="multiple of 4 floats, at most 1024"):
            ga.gat_attend(torch.zeros((28, f), device=cuda), None,
                          torch.zeros((2, 1, f), device=cuda), **kw)


def test_gat_forward_inverse_index_equals_the_dense_form_on_the_card(cuda):
    """GAT at the cell's widths (4 heads of 256 twice, 6 heads averaged):
    layer 0 through gat_attend with the inverse map and in the dense form
    gives the same bits, three launches a forward, and the logits sit
    within 2e-5 of the largest of the CPU's (the benchmark's
    ``logit_gap`` limit: the card's products and sums run in other orders)."""
    from repro_torch.models.gnn import models as gm

    fanouts = (15, 10, 5)
    gen = torch.Generator().manual_seed(7)
    params = gm.init_params(gen, "gat", 100, 47, device=cuda)
    positions = 64 * 16 * 11 * 6
    uniq = torch.randn((positions // 3 + 11, 100), generator=gen)
    uniq[-11:] = float("nan")  # pad rows, never read
    inverse = torch.randint(0, positions // 3, (positions,), generator=gen, dtype=torch.int32)
    before = ga.gat_attend.launches
    got = gm.forward(params, uniq.to(cuda), model="gat", fanouts=fanouts,
                     inverse_index=inverse.to(cuda))
    dense = gm.forward(params, uniq[inverse.long()].to(cuda), model="gat", fanouts=fanouts)
    torch.cuda.synchronize()
    assert ga.gat_attend.launches == before + 6
    assert got.shape == (64, 47) and torch.equal(got, dense)
    cpu = gm.forward([{k: v.cpu() for k, v in p.items()} for p in params], uniq,
                     model="gat", fanouts=fanouts, inverse_index=inverse)
    assert float((got.cpu() - cpu).abs().max() / cpu.abs().max()) <= 2e-5


def test_gat_engine_routes_agree_and_count_the_fused_batches_on_the_card(cuda):
    """GAT through the engine on the card: every batch's layer 0 runs in
    gat_attend (two launches a batch of a two-layer GAT, one fused batch),
    and the dedup, table and prefetch routes give the same bits."""
    from repro_torch.models.gnn import models as gm

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    params = gm.init_params(torch.Generator().manual_seed(3), "gat", 100, 47, n_layers=2)
    eng = GNNInferenceEngine(ds, model="gat", fanouts=(4, 3), batch_size=128, params=params,
                             device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    outs = []
    for cfg in (EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2),
                EngineConfig(use_kernel=True, dedup=False, pipeline_depth=2),
                EngineConfig(use_kernel=True, dedup=True, prefetch=True, pipeline_depth=1),
                EngineConfig(use_kernel=False, pipeline_depth=1)):
        before = ga.gat_attend.launches
        rep = eng.run(config=cfg, max_batches=4, collect_outputs=True, warmup=False)
        assert rep.fused_batches == rep.num_batches == 4
        assert ga.gat_attend.launches - before == 8
        outs.append(np.stack(eng.last_outputs))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


# The Graph Transformer's attention at the cell's shapes
# (gt-products.offline4096: layer 0 through the inverse map over
# ogbn-products' rows, layers 1 and 2 in place on 512-float rows, 4 heads),
# then one to eight heads, one slot and a fanout past a chunk.  The queries
# are drawn at the scale the fold gives them (scores of unit spread).  Held
# to ref.py in float64 on the same float32 inputs: the widest gap within
# 1e-5 of the largest output (float32 scores of up to 512 terms and the
# online softmax's rescaling, against torch's softmax of float64 scores,
# as gat_attend is held).  The indexed and the dense form give the same
# bits.
DOT_SHAPES = [(270_336, 15, 100, 4, 2_449_029), (24_576, 10, 512, 4, 0), (4096, 5, 512, 4, 0),
              (1000, 15, 600, 4, 900), (999, 17, 256, 3, 700), (513, 1, 4, 1, 300),
              (300, 6, 512, 8, 400), (77, 4, 132, 2, 50), (64, 9, 1024, 5, 64)]


@pytest.mark.parametrize("num_dst,fanout,f,heads,rows", DOT_SHAPES)
def test_dot_attend_matches_ref(cuda, num_dst, fanout, f, heads, rows):
    gen = torch.Generator(device=cuda).manual_seed(num_dst + f + 33)
    positions = num_dst * (1 + fanout)
    u = torch.randn((num_dst, heads, f), generator=gen, device=cuda) / f ** 0.5
    forms = []
    if rows:
        table = torch.full((rows + 3, f), float("nan"), device=cuda)  # the last 3 rows are pad
        table[:rows] = torch.randn((rows, f), generator=gen, device=cuda)
        idx = torch.randint(0, rows, (positions,), generator=gen, device=cuda, dtype=torch.int32)
        forms.append((table, idx))
        forms.append((table[idx.long()], None))
    else:
        forms.append((torch.randn((positions, f), generator=gen, device=cuda), None))
    kw = dict(num_dst=num_dst, fanout=fanout)
    first = None
    for x, index in forms:
        before = da.dot_attend.launches
        got = da.dot_attend(x, index, u, **kw)
        torch.cuda.synchronize()
        assert da.dot_attend.launches == before + 1
        assert got.shape == (num_dst, heads, f) and not torch.isnan(got).any()
        exact = dot_attend_ref(x.double(), index, u.double(), **kw)
        gap = float((got.double() - exact).abs().max() / exact.abs().max())
        assert gap <= 1e-5, gap
        if first is None:
            first = got
        else:  # the dense form of the same positions: the same bits
            assert torch.equal(first, got)
        del x, exact


def test_dot_attend_odd_base_empty_and_refusals(cuda):
    table = torch.randn(41 * 64 + 1, device=cuda)[1:].view(41, 64)  # a base 4 bytes past 16
    idx = torch.randint(0, 41, (7 * 4,), device=cuda, dtype=torch.int32)
    u = torch.randn((7, 3, 64), device=cuda) / 8
    kw = dict(num_dst=7, fanout=3)
    got = da.dot_attend(table, idx, u, **kw)  # the wrapper copies the table to an aligned base
    torch.testing.assert_close(got, dot_attend_ref(table, idx, u, **kw), rtol=1e-5, atol=1e-6)
    assert torch.equal(da.dot_attend(table.clone(), idx, u, **kw), got)
    dense = torch.empty(28 * 64 + 1, device=cuda)[1:].view(28, 64)
    dense.copy_(table[idx.long()])
    assert torch.equal(da.dot_attend(dense, None, u, **kw), got)
    odd_u = torch.empty(u.numel() + 1, device=cuda)[1:].view(u.shape)
    odd_u.copy_(u)
    assert torch.equal(da.dot_attend(table, idx, odd_u, **kw), got)
    empty = da.dot_attend(table, idx[:0], u[:0], num_dst=0, fanout=3)
    assert empty.shape == (0, 3, 64)
    with pytest.raises(ValueError, match="float32"):
        da.dot_attend(table.double(), idx, u, **kw)
    with pytest.raises(ValueError, match="int32"):
        da.dot_attend(table, idx.long(), u, **kw)
    with pytest.raises(ValueError, match="idx on"):
        da.dot_attend(table, idx.cpu(), u, **kw)
    with pytest.raises(ValueError, match="heads"):
        da.dot_attend(table, idx, torch.zeros((7, 9, 64), device=cuda), **kw)
    for f in (602, 1028):  # a row the kernel does not read in 16-byte vectors, a row too wide
        with pytest.raises(ValueError, match="multiple of 4 floats, at most 1024"):
            da.dot_attend(torch.zeros((28, f), device=cuda), None,
                          torch.zeros((7, 1, f), device=cuda), **kw)


def test_gt_forward_inverse_index_equals_the_dense_form_on_the_card(cuda):
    """The Graph Transformer at the cell's widths (4 heads of 128 twice, 4
    heads averaged): layer 0 through dot_attend with the inverse map and in
    the dense form gives the same bits, three launches a forward, and the
    logits sit within 2e-5 of the largest of the CPU's (the benchmark's
    ``logit_gap`` limit: the card's products and sums run in other orders)."""
    from repro_torch.models.gnn import models as gm

    fanouts = (15, 10, 5)
    gen = torch.Generator().manual_seed(8)
    params = gm.init_params(gen, "graph_transformer", 100, 47, device=cuda)
    positions = 64 * 16 * 11 * 6
    uniq = torch.randn((positions // 3 + 11, 100), generator=gen)
    uniq[-11:] = float("nan")  # pad rows, never read
    inverse = torch.randint(0, positions // 3, (positions,), generator=gen, dtype=torch.int32)
    kw = dict(model="graph_transformer", fanouts=fanouts)
    before = da.dot_attend.launches
    got = gm.forward(params, uniq.to(cuda), inverse_index=inverse.to(cuda), **kw)
    dense = gm.forward(params, uniq[inverse.long()].to(cuda), **kw)
    torch.cuda.synchronize()
    assert da.dot_attend.launches == before + 6
    assert got.shape == (64, 47) and torch.equal(got, dense)
    cpu = gm.forward([{k: v.cpu() for k, v in p.items()} for p in params], uniq,
                     inverse_index=inverse, **kw)
    assert float((got.cpu() - cpu).abs().max() / cpu.abs().max()) <= 2e-5


def test_gt_engine_routes_agree_and_count_the_fused_batches_on_the_card(cuda):
    """The Graph Transformer through the engine on the card: every batch's
    layers run in dot_attend (two launches a batch of a two-layer model, one
    fused batch), and the dedup, table and prefetch routes give the same
    bits."""
    from repro_torch.models.gnn import models as gm

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    params = gm.init_params(torch.Generator().manual_seed(3), "graph_transformer", 100, 47,
                            n_layers=2)
    eng = GNNInferenceEngine(ds, model="graph_transformer", fanouts=(4, 3), batch_size=128,
                             params=params, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    outs = []
    for cfg in (EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2),
                EngineConfig(use_kernel=True, dedup=False, pipeline_depth=2),
                EngineConfig(use_kernel=True, dedup=True, prefetch=True, pipeline_depth=1),
                EngineConfig(use_kernel=False, pipeline_depth=1)):
        before = da.dot_attend.launches
        rep = eng.run(config=cfg, max_batches=4, collect_outputs=True, warmup=False)
        assert rep.fused_batches == rep.num_batches == 4
        assert da.dot_attend.launches - before == 8
        outs.append(np.stack(eng.last_outputs))
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


# The sampler's per-layer kernel (sample_layer) at the offline cells' last
# layer (batch 4096 at fan-outs 15,10,5: 270,336 seeds x 15 draws) over
# graphs of ogbn-products' and Reddit's node count and average degree,
# held to ref.py on the same u bit for bit: neighbours, hit flags, edge
# slots and the hit total.  Each graph has isolated nodes (a trailing one
# whose slot is E) and nodes with no cached prefix and with the whole list
# cached; the seeds take some of each.
SAMPLE_GRAPHS = {"products": (2_449_029, 25), "reddit": (232_965, 50)}


def _sample_graph(cuda, n, avg_deg, seed=0):
    from repro_torch.graph.sampling import DeviceGraph

    gen = torch.Generator(device=cuda).manual_seed(seed)
    deg = torch.randint(0, 2 * avg_deg, (n,), generator=gen, device=cuda, dtype=torch.int32)
    isolated = torch.randint(0, n, (64,), generator=gen, device=cuda)
    deg[isolated] = 0
    deg[-1] = 0  # the trailing isolated node: its slot is E
    col_ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    col_ptr[1:] = torch.cumsum(deg, 0)
    num_edges = int(col_ptr[-1])
    row = torch.randint(0, n, (num_edges,), generator=gen, device=cuda, dtype=torch.int32)
    pick = torch.rand(n, generator=gen, device=cuda)
    part = (torch.rand(n, generator=gen, device=cuda) * (deg + 1).float()).to(torch.int32)
    clen = torch.where(pick < 0.3, 0, torch.where(pick < 0.6, deg, part.clamp_max(deg)))
    cache_ptr = torch.zeros(n + 1, dtype=torch.int32, device=cuda)
    cache_ptr[1:] = torch.cumsum(clen, 0)
    cached = max(int(cache_ptr[-1]), 1)
    cache_row = torch.randint(0, n, (cached,), generator=gen, device=cuda, dtype=torch.int32)
    return DeviceGraph(col_ptr=col_ptr, row_index=row, cache_ptr=cache_ptr,
                       cache_row_index=cache_row, cached_len=clen.to(torch.int32))


def _sample_seeds(cuda, g, s, seed=1):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = g.cached_len.shape[0]
    seeds = torch.randint(0, n, (s,), generator=gen, device=cuda, dtype=torch.int32)
    deg = g.col_ptr[1:] - g.col_ptr[:-1]
    kinds = (torch.nonzero(deg == 0).flatten()[:50],
             torch.nonzero((deg > 0) & (g.cached_len == 0)).flatten()[:50],
             torch.nonzero((deg > 0) & (g.cached_len == deg)).flatten()[:50])
    special = torch.cat([*kinds, torch.tensor([n - 1], device=cuda)]).to(torch.int32)
    seeds[: special.shape[0]] = special
    return seeds


def _both_layers(g, seeds, draws):
    """The kernel and ref.py on the same inputs: (nbr, hit, slots, count) each."""
    from repro_torch.kernels.sample_layer import kernel as sk
    from repro_torch.kernels.sample_layer.ref import sample_layer_ref

    out = []
    for fn in (sk.sample_layer, sample_layer_ref):
        nbr = torch.full((draws.numel(),), -7, dtype=torch.int32, device=seeds.device)
        count = torch.full((), 5, dtype=torch.int64, device=seeds.device)  # added to
        hit, slots = fn(g, seeds, draws, nbr, count)
        out.append((nbr, hit, slots, count))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("mode", ["uniforms", "slots"])
@pytest.mark.parametrize("graph", sorted(SAMPLE_GRAPHS))
def test_sample_layer_matches_ref_bit_for_bit(cuda, graph, mode):
    from repro_torch.kernels.sample_layer import kernel as sk
    from repro_torch.kernels.sample_layer.ref import slots_from_uniforms

    g = _sample_graph(cuda, *SAMPLE_GRAPHS[graph])
    seeds = _sample_seeds(cuda, g, 270_336)
    u = torch.rand((seeds.shape[0], 15), generator=torch.Generator(device=cuda).manual_seed(2),
                   dtype=torch.float64, device=cuda)
    s64 = seeds.long()
    deg = g.col_ptr[s64 + 1] - g.col_ptr[s64]
    draws = u if mode == "uniforms" else slots_from_uniforms(deg, u)
    before = sk.sample_layer.launches
    (nbr, hit, slots, count), (rn, rh, rs, rc) = _both_layers(g, seeds, draws)
    assert sk.sample_layer.launches == before + 1
    assert torch.equal(nbr, rn) and torch.equal(hit, rh) and torch.equal(slots, rs)
    assert int(count) == int(rc) == 5 + int(hit.sum())
    isolated = deg == 0
    assert isolated.any() and hit[isolated].all()
    assert torch.equal(nbr.view(-1, 15)[isolated], seeds[isolated, None].expand(-1, 15))
    assert (slots[seeds == g.cached_len.shape[0] - 1] == g.row_index.shape[0]).all()
    clen = g.cached_len[s64]
    assert not hit[(clen == 0) & ~isolated].any()
    assert hit[(clen == deg) & ~isolated].all()


def test_sample_layer_small_cases_and_refusals_on_the_card(cuda):
    from repro_torch.graph.sampling import DeviceGraph
    from repro_torch.kernels.sample_layer import kernel as sk

    # Nodes 1 and 4 isolated (4 trailing: slot E); 0 wholly cached, 2 not at all.
    g = DeviceGraph(*(torch.tensor(a, dtype=torch.int32, device=cuda) for a in (
        [0, 2, 2, 5, 6, 6], [1, 3, 0, 2, 4, 0], [0, 2, 2, 2, 3, 3], [1, 3, 4], [2, 0, 0, 1, 0])))
    seeds = torch.tensor([0, 1, 2, 3, 4, 4, 1, 2], dtype=torch.int32, device=cuda)
    for fanout in (1, 3, 16):
        u = torch.rand((8, fanout), dtype=torch.float64, device=cuda)
        for draws in (u, torch.arange(fanout, dtype=torch.int32, device=cuda).expand(8, -1)
                      % torch.tensor([2, 1, 3, 1, 1, 1, 1, 3], device=cuda)[:, None].int()):
            (nbr, hit, slots, count), (rn, rh, rs, rc) = _both_layers(g, seeds, draws)
            assert torch.equal(nbr, rn) and torch.equal(hit, rh) and torch.equal(slots, rs)
            assert int(count) == int(rc)
            assert (slots[4:6] == 6).all() and hit[[1, 4, 5, 6]].all() and not hit[[2, 7]].any()
    before = sk.sample_layer.launches
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    count = torch.zeros((), dtype=torch.int64, device=cuda)
    hit, slots = sk.sample_layer(g, empty, torch.empty((0, 3), dtype=torch.float64, device=cuda),
                                 empty, count)
    assert hit.shape == slots.shape == (0, 3) and sk.sample_layer.launches == before
    nbr = torch.empty(8 * 3, dtype=torch.int32, device=cuda)
    u = torch.rand((8, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="draws on cpu"):
        sk.sample_layer(g, seeds, u.cpu(), nbr, count)
    with pytest.raises(ValueError, match="graph.col_ptr on cpu"):
        sk.sample_layer(dataclasses.replace(g, col_ptr=g.col_ptr.cpu()), seeds, u, nbr, count)
    with pytest.raises(ValueError, match="float64 uniforms or int32 slots"):
        sk.sample_layer(g, seeds, u.float(), nbr, count)
    with pytest.raises(ValueError, match="hit_count must be an int64 scalar"):
        sk.sample_layer(g, seeds, u, nbr, count.int())


@pytest.mark.parametrize("mode", ["generator", "draws", "full_neighborhood"])
def test_sample_blocks_on_the_card_equal_the_plain_path(cuda, monkeypatch, mode):
    """sample_blocks through the kernel and through ref.py (the sampler of
    before, as the CPU runs it) on the card, three layers at fan-outs
    15,10,5 from 4096 seeds: the same frontiers, hits, slots, hit total
    and dedup, and the generator left in the same state."""
    from repro_torch.graph import sampling
    from repro_torch.kernels.sample_layer import kernel as sk
    from repro_torch.kernels.sample_layer.ref import sample_layer_ref

    g = _sample_graph(cuda, *SAMPLE_GRAPHS["reddit"], seed=3)
    seeds = _sample_seeds(cuda, g, 4096, seed=4)
    fanouts = (15, 10, 5)
    blocks, states = [], []
    draws = None
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(sampling, "sample_layer", sample_layer_ref)
        gen = torch.Generator(device=cuda).manual_seed(21)
        kw = dict(generator=gen)
        if mode == "full_neighborhood":
            kw = dict(full_neighborhood=True)
        elif mode == "draws":
            if draws is None:  # another generator's slots, recovered, replayed
                drawn = sampling.sample_blocks(
                    g, seeds, fanouts, generator=torch.Generator(device=cuda).manual_seed(22))
                draws = [s - g.col_ptr[f.long()][:, None]
                         for f, s in zip(drawn.frontiers, drawn.edge_slots)]
            kw = dict(draws=draws)
        before = sk.sample_layer.launches
        blocks.append(sampling.sample_blocks(g, seeds, fanouts, dedup=True, dedup_pad_id=0, **kw))
        torch.cuda.synchronize()
        assert sk.sample_layer.launches - before == (0 if plain else 3)
        states.append(gen.get_state())
    got, want = blocks
    assert len(got.frontiers) == 4 and got.input_nodes.shape == (4096 * 16 * 11 * 6,)
    for name in ("frontiers", "neighbor_hits", "edge_slots"):
        for a, b in zip(getattr(got, name), getattr(want, name), strict=True):
            assert torch.equal(a, b), name
    assert all(f.data_ptr() == got.input_nodes.data_ptr() for f in got.frontiers)
    assert int(got.hit_count) == int(want.hit_count) == sum(int(h.sum())
                                                            for h in got.neighbor_hits)
    assert torch.equal(got.dedup.unique_ids, want.dedup.unique_ids)
    assert torch.equal(got.dedup.inverse, want.dedup.inverse)
    assert torch.equal(states[0], states[1])


def test_engine_batches_equal_with_the_kernel_and_the_plain_sampler_on_the_card(
        cuda, monkeypatch):
    """Four engine batches on the cell's route (kernel, dedup, depth 2) with
    the sampler's kernel and with ref.py in its place: the same logits and
    counts; the kernel launches once a layer a batch and every ``sample``
    span says so in ``kernel_layers``."""
    from repro_torch.core.trace import Tracer
    from repro_torch.graph import sampling
    from repro_torch.kernels.sample_layer import kernel as sk
    from repro_torch.kernels.sample_layer.ref import sample_layer_ref

    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    cfg = EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(sampling, "sample_layer", sample_layer_ref)
        tracer = Tracer()
        before = sk.sample_layer.launches
        rep = eng.run(config=cfg, max_batches=4, collect_outputs=True, tracer=tracer,
                      warmup=False)
        layers = [e["args"]["kernel_layers"] for e in tracer.events
                  if e["ph"] == "X" and e["name"] == "sample"]
        assert layers == [0 if plain else 2] * 4
        assert sk.sample_layer.launches - before == (0 if plain else 2 * 4)
        runs.append(((rep.adj_hits, rep.adj_lookups, rep.feat_hits, rep.feat_lookups,
                      rep.unique_rows, rep.gathered_rows), np.stack(eng.last_outputs)))
    (counts, out), (plain_counts, plain_out) = runs
    assert counts == plain_counts and 0 < counts[0] < counts[1]
    np.testing.assert_array_equal(out, plain_out)


def _qkv(cuda, b, hq, hkv, sq, sk, d, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=gen).to(dtype).to(cuda)
    k = torch.randn((b, hkv, sk, d), generator=gen).to(dtype).to(cuda)
    v = torch.randn((b, hkv, sk, d), generator=gen).to(dtype).to(cuda)
    return q, k, v


def _design(q, k):
    return fa.plan(q.dtype, q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                   q.shape[3], torch.cuda.get_device_properties(q.device).multi_processor_count)


def _check_attention(q, k, v, design=None, **kw):
    """One call through the wrapper: one launch, counted under the design
    ``plan`` names (and ``design`` where the test names one), held to
    ref.py in q's dtype and, for a tensor-core output, in float32."""
    route = _design(q, k)
    assert design is None or route.design == design
    before = fa.flash_attention.launches
    designs = dict(fa.flash_attention.design_launches)
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.dtype == q.dtype
    designs[route.design] += 1
    assert fa.flash_attention.design_launches == designs
    hq = q.shape[1]
    want = attention_ref(q, expand_kv(k, hq), expand_kv(v, hq), **kw)
    tol = ATT_TOL[q.dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    if route.design == "wgmma":
        want32 = attention_ref(q.float(), expand_kv(k.float(), hq), expand_kv(v.float(), hq), **kw)
        rows = _kept_keys(q.shape[2], k.shape[2], q.device, **kw) >= F32_MIN_KEYS
        rtol, atol = ATT_TOL_BF16_F32
        torch.testing.assert_close(got.float()[:, :, rows], want32[:, :, rows], rtol=rtol, atol=atol)
    return got


def _kept_keys(sq, sk, device, *, causal=True, window=None, softcap=None):
    """Keys each query row keeps under the masks."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= qi >= ki
    if window is not None:
        keep &= qi - ki < window
    return keep.sum(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "sq,sk,d,causal,window,cap",
    [
        (128, 128, 64, True, None, None),
        (256, 256, 128, True, None, 50.0),
        (200, 200, 64, True, 64, None),
        (128, 128, 64, False, None, None),
        (96, 160, 64, False, None, None),
        (64, 64, 128, True, 16, 30.0),
        (1, 1024, 64, False, None, None),
        (1, 1024, 128, True, None, None),
        (200, 64, 32, False, 64, None),
    ],
)
def test_flash_attention_matches_ref(cuda, dtype, sq, sk, d, causal, window, cap):
    q, k, v = _qkv(cuda, 1, 1, 1, sq, sk, d, dtype, seed=sq + sk)
    got = _check_attention(q, k, v, causal=causal, window=window, softcap=cap)
    if sq == 200 and sk == 64:  # rows from 127 on keep no key
        assert not got[0, 0, 127:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 48, 64, 128, 192, 256, 80])
def test_flash_attention_head_dims_and_gqa(cuda, dtype, d):
    q, k, v = _qkv(cuda, 2, 8, 2, 77, 130, d, dtype, seed=d)
    _check_attention(q, k, v, causal=True, window=50, softcap=30.0)
    _check_attention(q, k, v, causal=False)


def test_flash_attention_edges_and_refusals(cuda):
    q, k, v = _qkv(cuda, 1, 2, 1, 5, 0, 64, torch.float32)
    assert not fa.flash_attention(q, k, v, causal=False).any()  # no key at all
    q, k, v = _qkv(cuda, 1, 2, 2, 0, 8, 64, torch.float32)
    assert fa.flash_attention(q, k, v).shape == (1, 2, 0, 64)
    q, k, v = _qkv(cuda, 1, 2, 2, 8, 8, 300, torch.float32)
    with pytest.raises(ValueError, match="D=300"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="use_kernel"):
        from repro_torch.kernels import multi_head_attention

        multi_head_attention(q, k, v)
    q, k, v = _qkv(cuda, 1, 4, 2, 70, 70, 64, torch.float32)
    two_d = fa.flash_attention_2d(q[0, 1], k[0, 0], v[0, 0], causal=True, softcap=20.0)
    torch.testing.assert_close(two_d, fa.flash_attention(q, k, v, causal=True, softcap=20.0)[0, 1],
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
@pytest.mark.parametrize(
    "sq,sk,d,causal,window,cap",
    [
        (127, 127, 128, True, None, 50.0),
        (129, 129, 64, True, None, None),
        (1000, 1000, 128, True, 300, 50.0),  # the window cuts key tiles
        (129, 4097, 128, False, None, None),
        (127, 4097, 64, False, 1000, None),
        (1000, 129, 256, True, None, 30.0),
        (300, 100, 128, False, 50, None),  # rows from 149 on keep no key
    ],
)
def test_flash_attention_prefill_ragged_tiles(cuda, dtype, design, sq, sk, d, causal, window,
                                              cap):
    """Query and key counts around the 128-row tile, GQA 4:2."""
    q, k, v = _qkv(cuda, 1, 4, 2, sq, sk, d, dtype, seed=sq * 3 + sk + d)
    got = _check_attention(q, k, v, design=design, causal=causal, window=window, softcap=cap)
    if sq == 300:
        assert not got[:, :, 149:].any() and got[:, :, :149].abs().sum(-1).gt(0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,group", [(4, 1), (2, 2), (1, 8)])
@pytest.mark.parametrize("sk", [1, 2, 63, 64, 65, 1000, 4096, 5000])
def test_flash_attention_split(cuda, dtype, hkv, group, sk):
    """The split-key decode at Sq 1 (and Sq 2): against ref.py and against
    its plain statement with the same chunks."""
    for sq, kw in ((1, dict(causal=False, softcap=50.0)), (2, dict(causal=False, window=40))):
        q, k, v = _qkv(cuda, 2, hkv * group, hkv, sq, sk, 64, dtype, seed=sk + group)
        got = _check_attention(q, k, v, design="split", **kw)
        hq = hkv * group
        chunk = _design(q, k).chunk
        want = attention_split_ref(q, expand_kv(k, hq), expand_kv(v, hq), chunk=chunk, **kw)
        torch.testing.assert_close(got, want, rtol=ATT_TOL[dtype], atol=ATT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_split_masked_chunks(cuda, dtype):
    """Chunks that keep no key: causal Sq 1 keeps key 0 only (the output is
    v[0]); 16 causal rows under a window of 3 keep keys 0-15 of 3000."""
    q, k, v = _qkv(cuda, 1, 8, 1, 1, 3000, 128, dtype, seed=5)
    got = _check_attention(q, k, v, design="split", causal=True)
    torch.testing.assert_close(got[0, :, 0], v[0, 0, 0].expand(8, 128), rtol=0, atol=0)
    q, k, v = _qkv(cuda, 2, 16, 16, 16, 3000, 80, dtype, seed=6)
    _check_attention(q, k, v, design="split", causal=True, window=3, softcap=20.0)


@pytest.mark.parametrize("dtype,sq,sk,design", [(torch.bfloat16, 17, 64, "wgmma"),
                                                (torch.float32, 17, 64, "fma"),
                                                (torch.bfloat16, 1, 64, "split")])
def test_flash_attention_beyond_65535_heads(cuda, dtype, sq, sk, design):
    """B * Hq = 70,000: every grid is one-dimensional, so no 65535 limit."""
    q, k, v = _qkv(cuda, 2, 35_000, 35_000, sq, sk, 32, dtype, seed=7)
    _check_attention(q, k, v, design=design, causal=False)


# ------------------------------------------------------------ LM serving


def _lm_params(cfg, device, seed=0):
    params = lm_model.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return params, tree_map(lambda a: a.to(device), params)


def _b5_counts(fn):
    """``fn()`` with B5's per-design counters set to 0 just before; returns
    (its result, the launches by design)."""
    fa.flash_attention.design_launches = dict.fromkeys(fa.DESIGNS, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, dict(fa.flash_attention.design_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 50.0)])
def test_lm_attend_launches_b5_and_matches_the_plain_route(cuda, dtype, window, softcap):
    """``_attend`` on CUDA tensors is one B5 launch (prefill: ``wgmma`` in
    bf16, ``fma`` in f32), held to its CPU route (the plain fp32 version)
    at B5's tolerance; ``[B, S, H, D]`` in and out, MQA 8:1 at D = 256."""
    gen = torch.Generator().manual_seed(11)
    q = torch.randn((2, 150, 8, 256), generator=gen).to(dtype)
    k, v = (torch.randn((2, 150, 1, 256), generator=gen).to(dtype) for _ in range(2))
    want = lm_attn._attend(q, k, v, causal=True, window=window, softcap=softcap)
    got, counts = _b5_counts(lambda: lm_attn._attend(q.to(cuda), k.to(cuda), v.to(cuda),
                                                     causal=True, window=window, softcap=softcap))
    design = "wgmma" if dtype == torch.bfloat16 else "fma"
    assert counts == {**dict.fromkeys(fa.DESIGNS, 0), design: 1}
    assert got.shape == q.shape and got.dtype == dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=ATT_TOL[dtype],
                               atol=ATT_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
def test_lm_decode_launches_the_split_kernel_unwrapped_and_wrapped(cuda, dtype, window):
    """``gqa_decode`` with one host ``cache_len`` launches B5's ``split``
    once, before and after the ring wraps, and matches the CPU route (the
    masked reference semantics) at B5's tolerance; a per-slot vector takes
    the plain masked route and launches nothing."""
    cfg = dataclasses.replace(get_smoke("gemma2-27b"), dtype="float32")
    gen = torch.Generator().manual_seed(12)
    params = lm_attn.init_gqa_params(gen, cfg, dtype, device="cpu")
    shape = (3, 8, cfg.n_kv_heads, cfg.head_dim)
    cache = {key: torch.randn(shape, generator=gen).to(dtype) for key in ("k", "v")}
    card_params = tree_map(lambda a: a.to(cuda), params)
    card_cache = tree_map(lambda a: a.to(cuda), cache)
    tol = dict(rtol=ATT_TOL[dtype], atol=ATT_TOL[dtype])
    for cl in (0, 3, 7, 8, 13, 30):
        x = torch.randn((3, 1, cfg.d_model), generator=gen).to(dtype)
        want, want_cache = lm_attn.gqa_decode(params, x, cache, cl, cfg, window=window)
        (got, got_cache), counts = _b5_counts(lambda: lm_attn.gqa_decode(
            card_params, x.to(cuda), card_cache, cl, cfg, window=window))
        assert counts == {**dict.fromkeys(fa.DESIGNS, 0), "split": 1}, (cl, counts)
        torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
        torch.testing.assert_close(got_cache["k"].cpu().float(), want_cache["k"].float(), **tol)
        lens = torch.tensor([cl, cl + 2, 1], device=cuda)
        _, counts = _b5_counts(lambda: lm_attn.gqa_decode(
            card_params, x.to(cuda), card_cache, lens, cfg, window=window))
        assert not any(counts.values())


@pytest.mark.parametrize("arch,long_mode", [("gemma-2b", False), ("gemma2-27b", False),
                                            ("granite-3-8b", True)])
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch, long_mode):
    """float32 smoke configs: logits at 1e-4 of the CPU route and greedy
    tokens equal, prefill then decode past the rings' wrap (Gemma-2's local
    window 16, Granite's long-context window cut to 8); one B5 launch per
    layer per call (``fma`` prefill, ``split`` decode)."""
    overrides = dict(long_context_window=8) if long_mode else {}
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **overrides)
    cpu_params, card_params = _lm_params(cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab, (2, 20)))
    kw = dict(cache_size=8 if long_mode else 32, long_mode=long_mode)
    want, want_c = lm_model.prefill(cpu_params, {"tokens": toks}, cfg, **kw)
    (got, got_c), counts = _b5_counts(
        lambda: lm_model.prefill(card_params, {"tokens": toks.to(cuda)}, cfg, **kw))
    assert counts == {**dict.fromkeys(fa.DESIGNS, 0), "fma": cfg.n_layers}
    for step in range(12):
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        nxt = torch.argmax(want[:, : cfg.vocab], -1)[:, None]
        assert torch.equal(torch.argmax(got[:, : cfg.vocab], -1)[:, None].cpu(), nxt)
        want, want_c = lm_model.decode_step(cpu_params, nxt, want_c, 20 + step, cfg,
                                            long_mode=long_mode)
        (got, got_c), counts = _b5_counts(lambda: lm_model.decode_step(
            card_params, nxt.to(cuda), got_c, 20 + step, cfg, long_mode=long_mode))
        assert counts == {**dict.fromkeys(fa.DESIGNS, 0), "split": cfg.n_layers}


def test_lm_prefill_then_decode_equals_a_longer_prefill_on_the_card(cuda):
    cfg = dataclasses.replace(get_smoke("gemma2-27b"), dtype="float32")
    _, params = _lm_params(cfg, cuda, seed=1)
    s = 17
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab, (2, s + 1))).to(cuda)
    lf, _ = lm_model.prefill(params, {"tokens": toks}, cfg, cache_size=s + 8)
    _, caches = lm_model.prefill(params, {"tokens": toks[:, :s]}, cfg, cache_size=s + 8)
    ld, _ = lm_model.decode_step(params, toks[:, s : s + 1], caches, s, cfg)
    torch.testing.assert_close(ld, lf, atol=2e-4, rtol=2e-4)


def test_lm_batched_server_on_the_card_matches_sequential_decoding(cuda):
    """Per-slot decode (plain torch) against the B5 route of a sequential
    prefill + decode of each request, float32, greedy."""
    cfg = dataclasses.replace(get_smoke("gemma2-27b"), dtype="float32")
    _, params = _lm_params(cfg, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 9, 13, 7, 11, 21)]
    server = lm_serve_engine.BatchedServer(cfg, params, slots=2, max_len=40)
    for i, p in enumerate(prompts):
        server.submit(p, 6, req_id=i)
    for req, prompt in zip(server.run(), prompts):
        logits, caches = lm_model.prefill(params, {"tokens": torch.from_numpy(prompt[None]).to(cuda)},
                                          cfg, cache_size=40)
        toks = [int(torch.argmax(logits[0, : cfg.vocab]))]
        for i in range(5):
            logits, caches = lm_model.decode_step(params, torch.tensor([[toks[-1]]], device=cuda),
                                                  caches, len(prompt) + i, cfg)
            toks.append(int(torch.argmax(logits[0, : cfg.vocab])))
        assert req.generated == toks, req.req_id


def test_lm_moe_top6_gives_the_same_bits_on_every_run_on_the_card(cuda):
    """DeepSeek-V2's top-6 in bfloat16: the combine adds each token's rows
    in a fixed order (no atomics), so repeated runs on the card give the
    same bits; the card's output is the CPU route's at the bfloat16
    whole-model tolerance (atol 3e-2, rtol 1e-2)."""
    cfg = get_smoke("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=16, top_k=6))
    params = lm_moe.init_moe_params(torch.Generator().manual_seed(15), cfg, torch.bfloat16,
                                    device="cpu")
    x = torch.randn((4, 256, cfg.d_model), generator=torch.Generator().manual_seed(16)).bfloat16()
    card = tree_map(lambda a: a.to(cuda), params)
    runs = [lm_moe.moe_ffn(card, x.to(cuda), cfg) for _ in range(4)]
    for out, aux in runs[1:]:
        assert torch.equal(out.view(torch.int16), runs[0][0].view(torch.int16))
        assert torch.equal(aux, runs[0][1])
    want, want_aux = lm_moe.moe_ffn(params, x, cfg)
    torch.testing.assert_close(runs[0][0].cpu().float(), want.float(), atol=3e-2, rtol=1e-2)
    torch.testing.assert_close(runs[0][1].cpu(), want_aux, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
def test_lm_moe_and_ssm_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """float32 smoke configs: logits at 1e-4 of the CPU route and greedy
    tokens equal over a prefill and 8 decode steps; one B5 launch per GQA
    layer per call (``fma`` prefill, ``split`` decode), none for RWKV-6
    and DeepSeek-V2's MLA."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cpu_params, card_params = _lm_params(cfg, cuda)
    gqa = sum(k in ("attn", "local") for k in cfg.layer_kinds()) if cfg.attn_kind == "gqa" else 0
    toks = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab, (2, 20)))
    want, want_c = lm_model.prefill(cpu_params, {"tokens": toks}, cfg, cache_size=32)
    (got, got_c), counts = _b5_counts(
        lambda: lm_model.prefill(card_params, {"tokens": toks.to(cuda)}, cfg, cache_size=32))
    assert counts == {**dict.fromkeys(fa.DESIGNS, 0), **({"fma": gqa} if gqa else {})}
    for step in range(8):
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        nxt = torch.argmax(want[:, : cfg.vocab], -1)[:, None]
        assert torch.equal(torch.argmax(got[:, : cfg.vocab], -1)[:, None].cpu(), nxt)
        want, want_c = lm_model.decode_step(cpu_params, nxt, want_c, 20 + step, cfg)
        (got, got_c), counts = _b5_counts(lambda: lm_model.decode_step(
            card_params, nxt.to(cuda), got_c, 20 + step, cfg))
        assert counts == {**dict.fromkeys(fa.DESIGNS, 0), **({"split": gqa} if gqa else {})}
    got_leaves, want_leaves = [], []
    tree_map(got_leaves.append, got_c)
    tree_map(want_leaves.append, want_c)
    for g, w in zip(got_leaves, want_leaves, strict=True):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)


def test_lm_jamba_launches_b5_once_per_prefill_and_decode_step_in_bfloat16(cuda):
    """Jamba's one attention layer per period runs on B5: in bfloat16 one
    ``wgmma`` launch per prefill and one ``split`` per decode step, as
    chip_smoke.py's phase 16 expects at full width; the Mamba layers and
    the MoE launch none."""
    cfg = get_smoke("jamba-v0.1-52b")
    _, params = _lm_params(cfg, cuda)
    toks = torch.from_numpy(np.random.default_rng(18).integers(0, cfg.vocab, (3, 40))).to(cuda)
    (logits, caches), counts = _b5_counts(
        lambda: lm_model.prefill(params, {"tokens": toks}, cfg, cache_size=48))
    assert counts == {**dict.fromkeys(fa.DESIGNS, 0), "wgmma": 1}
    for step in range(4):
        (logits, caches), counts = _b5_counts(lambda: lm_model.decode_step(
            params, torch.argmax(logits, -1)[:, None], caches, 40 + step, cfg))
        assert counts == {**dict.fromkeys(fa.DESIGNS, 0), "split": 1}
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("n_experts,k", [(4, 2), (16, 2), (160, 6)])
def test_router_top_k_keeps_the_lowest_index_first_on_the_card(cuda, n_experts, k):
    """The card's stable sort breaks ties as ``lax.top_k`` does (the CPU
    tests hold ``moe.top_k`` to it): equal values lowest index first, on
    rows of all-equal and of many-tied probabilities; and ``moe_ffn`` with
    a zeroed router gives the CPU route's output."""
    rng = np.random.default_rng(n_experts)
    x = rng.integers(0, 3, (4096, n_experts)).astype(np.float32)
    x[:7] = 1.0
    probs = torch.softmax(torch.from_numpy(x), -1)
    want_vals, want_idx = lm_moe.top_k(probs, k)
    got_vals, got_idx = lm_moe.top_k(probs.to(cuda), k)
    assert torch.equal(got_idx.cpu(), want_idx) and torch.equal(got_vals.cpu(), want_vals)
    assert torch.equal(want_idx[:7], torch.arange(k).expand(7, k))
    cfg = dataclasses.replace(get_smoke("phi3.5-moe-42b-a6.6b"), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=n_experts, top_k=k))
    params = lm_moe.init_moe_params(torch.Generator().manual_seed(19), cfg, torch.float32,
                                    device="cpu")
    params["router"].zero_()
    h = torch.randn((2, 33, cfg.d_model), generator=torch.Generator().manual_seed(20))
    want, want_aux = lm_moe.moe_ffn(params, h, cfg)
    got, got_aux = lm_moe.moe_ffn(tree_map(lambda a: a.to(cuda), params), h.to(cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,h,sq,sk,design", [
    (4, 16, 1024, 1024, "wgmma"),  # encoder self-attention, non-causal
    (4, 16, 256, 1024, "wgmma"),  # decoder cross-attention at prefill
    (4, 16, 1, 1024, "split"),  # cross-attention at decode
    (4, 16, 1, 272, "split"),  # self-attention at decode
])
def test_flash_attention_at_the_seamless_shapes(cuda, b, h, sq, sk, design):
    """SeamlessM4T-medium's attention (head dim 64, 16 heads, no GQA) at
    chip_smoke.py phase 17's shapes, non-causal: B5 in bfloat16 against
    ref.py (and ref.py in float32 for the tensor-core design)."""
    q, k, v = _qkv(cuda, b, h, h, sq, sk, 64, torch.bfloat16, seed=sq + sk)
    _check_attention(q, k, v, design=design, causal=False)


@pytest.mark.parametrize("arch", ["gemma-2b", "seamless-m4t-medium", "jamba-v0.1-52b"])
def test_lm_train_loss_on_the_card_launches_no_b5_and_matches_the_cpu(cuda, arch):
    """Under autograd ``_attend`` takes the plain route on the card (B5 has
    no backward): no B5 launch in the loss or its backward; the float32
    loss and every gradient leaf at 1e-4 of the CPU route (gradients at
    1e-4 of each leaf's largest |g|); an eval prefill of the same
    parameters then launches B5 again."""
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cpu_params, card_params = _lm_params(cfg, cuda, seed=2)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (2, 25))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.encoder_layers:
        batch["src_embeds"] = torch.from_numpy(rng.standard_normal((2, 30, cfg.d_model))).float()

    def loss_and_grads(params, device):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = lm_model.train_loss(tracked, {k: v.to(device) for k, v in batch.items()}, cfg)
        return loss, torch.autograd.grad(loss, tree_leaves(tracked))

    want, want_g = loss_and_grads(cpu_params, "cpu")
    (got, got_g), counts = _b5_counts(lambda: loss_and_grads(card_params, cuda))
    assert not any(counts.values()), counts
    torch.testing.assert_close(got.detach().cpu(), want.detach(), atol=1e-4, rtol=1e-4)
    for g, w in zip(got_g, want_g, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))
    eval_batch = {k: v.to(cuda) for k, v in batch.items() if k != "labels"}
    _, counts = _b5_counts(lambda: lm_model.prefill(card_params, eval_batch, cfg))
    assert sum(counts.values()) >= 1


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v2-236b"])
def test_lm_moe_aux_on_the_card_equals_the_cpu(cuda, arch):
    """The aux's expert counts are a float32 scatter-add of ones: exact
    integers, whatever order the card's atomics add them in, so the card's
    aux is the bincount formula's bits on the card's own router output,
    and within float32 rounding of the CPU's (whose router products round
    otherwise)."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = lm_moe.init_moe_params(torch.Generator().manual_seed(4), cfg, torch.float32,
                                    device="cpu")
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((3, 41, cfg.d_model))
                         .astype(np.float32))
    want, want_aux = lm_moe.moe_ffn(params, x, cfg)
    card = tree_map(lambda a: a.to(cuda), params)
    got, got_aux = lm_moe.moe_ffn(card, x.to(cuda), cfg)
    probs = torch.softmax(x.to(cuda).reshape(-1, cfg.d_model) @ card["router"], dim=-1)
    _, idx = lm_moe.top_k(probs, cfg.moe.top_k)
    e = cfg.moe.n_experts
    fe = torch.bincount(idx.reshape(-1), minlength=e).float() / idx.numel()
    assert torch.equal(got_aux, e * torch.sum(fe * probs.mean(0)))
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-6, atol=0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-v0.1-52b"])
def test_lm_remat_dots_on_the_card_equals_whole_remat(cuda, arch):
    """The float32 smoke config's loss and every gradient under the
    ``"dots"`` remat policy equal whole-repeat remat's on the card."""
    from repro_torch.models.lm import tp as lm_tp
    from repro_torch.utils.tree import tree_leaves

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    _, params = _lm_params(cfg, cuda, seed=3)
    toks = torch.from_numpy(np.random.default_rng(23).integers(0, cfg.vocab, (2, 33))).to(cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def loss_and_grads():
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = lm_model.train_loss(tracked, batch, cfg)
        return loss, torch.autograd.grad(loss, tree_leaves(tracked))

    want, want_g = loss_and_grads()
    lm_tp.set_remat_policy("dots")
    try:
        got, got_g = loss_and_grads()
    finally:
        lm_tp.set_remat_policy(None)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for g, w in zip(got_g, want_g, strict=True):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_lm_expert_parallel_moe_on_a_unit_mesh_on_the_card(cuda):
    """``_moe_ffn_shard_map`` on a 1 x 1 mesh equals the dense ``moe_ffn``
    on the card (1e-5, aux too); a larger model axis raises on card tensors."""
    from repro_torch.launch.mesh import AbstractMesh

    cfg = dataclasses.replace(get_smoke("jamba-v0.1-52b"), dtype="float32")
    params = tree_map(lambda a: a.to(cuda), lm_moe.init_moe_params(
        torch.Generator().manual_seed(5), cfg, torch.float32, device="cpu"))
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator().manual_seed(6)).to(cuda)
    want, want_aux = lm_moe.moe_ffn(params, x, cfg)
    for shape, ok in (((1, 1), True), ((1, 2), False)):
        lm_moe.set_shard_map_context(AbstractMesh(("data", "model"), shape), ("data",), "model")
        try:
            if not ok:
                with pytest.raises(RuntimeError, match="cards"):
                    lm_moe.moe_ffn(params, x, cfg)
                continue
            got, got_aux = lm_moe.moe_ffn(params, x, cfg)
        finally:
            lm_moe.set_shard_map_context(None)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_aux, want_aux, rtol=1e-5, atol=1e-5)
