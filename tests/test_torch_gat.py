"""GAT on the port's sampled and layer-wise paths, on the CPU.

The port's layer runs in the fewest-operations order (the score vectors
folded through the heads' maps, the attention over the input rows, then the
maps); the benchmark's plain reference (``bench/models/gat.py``) runs the
paper's order in float64.  The port is held to it at 1e-5 of the largest
logit: float32 against float64, the products summed in another order (read:
up to 1.4e-7 at these sizes).  GraphSAGE and GCN keep their bits.  The CUDA
kernel is held to ``ref.py`` on the card by tests/test_torch_kernels_gpu.py.
"""

import hashlib

import numpy as np
import pytest
import torch

from bench import models as bench_models
from bench import reference as bench_ref
from repro_torch.core.config import EngineConfig
from repro_torch.core.trace import Tracer, summarize_trace
from repro_torch.graph.datasets import load_dataset
from repro_torch.kernels.gat_attend import kernel as ga
from repro_torch.kernels.gat_attend.ref import gat_attend_ref
from repro_torch.models.gnn import models as gm
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

GAT = bench_models.load("gat")
SMALL_HEADS = (2, 3, 4)  # 3 layers: 2 and 3 heads of 16 concatenated, 4 averaged


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(in_dim, classes, heads, head_dim):
    return {"dataset": {"feat_dim": in_dim, "num_classes": classes}, "heads": list(heads),
            "head_dim": head_dim, "residual": list(range(1, len(heads) - 1)),
            "negative_slope": 0.2, "activation": "elu"}


def _params(in_dim=24, classes=5, seed=3, heads=SMALL_HEADS, head_dim=16):
    """Small GAT weights in the engine's layout: the benchmark's ``init``
    draws what ``init_params`` draws at the paper's widths (see
    test_the_benchmark_draws_the_engines_weights), and takes any."""
    return GAT.init(_config(in_dim, classes, heads, head_dim),
                    torch.Generator().manual_seed(seed), "cpu")


def _block(gen, batch, fanouts, rows, f):
    positions = bench_ref.frontier_sizes(batch, fanouts)[-1]
    table = torch.randn((rows, f), generator=gen)
    frontier = torch.randint(0, rows, (positions,), generator=gen)
    return table, frontier


def test_init_params_gat_layout_at_the_papers_widths():
    params = gm.init_params(torch.Generator().manual_seed(0), "gat", 100, 47)
    shapes = [{k: tuple(v.shape) for k, v in p.items()} for p in params]
    assert shapes == [
        {"w": (100, 1024), "a_src": (4, 256), "a_dst": (4, 256), "b": (1024,)},
        {"w": (1024, 1024), "a_src": (4, 256), "a_dst": (4, 256), "w_res": (1024, 1024),
         "b_res": (1024,), "b": (1024,)},
        {"w": (1024, 282), "a_src": (6, 47), "a_dst": (6, 47), "b": (47,)},
    ]
    assert [gm.out_width(p) for p in params] == [1024, 1024, 47]
    assert all(not p["b"].any() for p in params)
    two = gm.init_params(torch.Generator().manual_seed(0), "gat", 100, 47, hidden=64, n_layers=2)
    assert [tuple(p["a_src"].shape) for p in two] == [(4, 256), (6, 47)]  # hidden: not GAT's
    assert [gm.out_width(p) for p in two] == [1024, 47] and not any("w_res" in p for p in two)


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_out_width_is_the_output_width_of_every_model(model):
    params = gm.init_params(torch.Generator().manual_seed(0), model, 100, 47)
    assert [gm.out_width(p) for p in params] == [p["w_self"].shape[1] for p in params]


def test_the_benchmark_draws_the_engines_weights():
    """``bench/models/gat.py`` draws the port's layout in the port's order."""
    config = _config(24, 5, (gm.GAT_HIDDEN_HEADS,) * 2 + (gm.GAT_OUTPUT_HEADS,), gm.GAT_HEAD_DIM)
    mine = gm.init_params(torch.Generator().manual_seed(11), "gat", 24, 5)
    theirs = GAT.init(config, torch.Generator().manual_seed(11), "cpu")
    assert [sorted(p) for p in mine] == [sorted(p) for p in theirs]
    assert all(torch.equal(a[k], b[k]) for a, b in zip(mine, theirs) for k in a)


# ------------------------------------------------------------------ gat_attend


@pytest.mark.parametrize("num_dst,fanout,f,heads", [(7, 3, 10, 1), (33, 15, 12, 4), (5, 1, 3, 6),
                                                     (16, 5, 64, 8)])
def test_gat_attend_indexed_and_dense_forms_agree_bit_for_bit(num_dst, fanout, f, heads):
    gen = torch.Generator().manual_seed(num_dst * 100 + f)
    table = torch.randn((50, f), generator=gen)
    idx = torch.randint(0, 50, (num_dst * (1 + fanout),), generator=gen, dtype=torch.int32)
    u = torch.randn((2, heads, f), generator=gen)
    kw = dict(num_dst=num_dst, fanout=fanout, negative_slope=0.2)
    indexed = gat_attend_ref(table, idx, u, **kw)
    dense = gat_attend_ref(table[idx.long()], None, u, **kw)
    assert indexed.shape == (num_dst, heads, f) and torch.equal(indexed, dense)
    before = ga.gat_attend.launches
    assert torch.equal(ga.gat_attend(table, idx, u, **kw), indexed)  # the CPU route is ref.py
    assert ga.gat_attend.launches == before


def test_gat_attend_is_the_papers_attention_folded():
    """``sum_j alpha_j x_j`` mapped by ``W_k`` equals the paper's
    ``sum_j alpha_j W_k x_j`` with ``alpha`` from ``a_k^T [W_k x_i || W_k x_j]``."""
    gen = torch.Generator().manual_seed(5)
    num_dst, fanout, f, heads, width = 9, 4, 7, 3, 5
    x = torch.randn((num_dst * (1 + fanout), f), generator=gen, dtype=torch.float64)
    w = torch.randn((f, heads * width), generator=gen, dtype=torch.float64)
    a_src, a_dst = torch.randn((2, heads, width), generator=gen, dtype=torch.float64)
    u = torch.einsum("fhd,shd->shf", w.view(f, heads, width), torch.stack((a_src, a_dst)))
    att = gat_attend_ref(x, None, u, num_dst=num_dst, fanout=fanout, negative_slope=0.2)
    mine = torch.einsum("nhf,fhd->nhd", att, w.view(f, heads, width))
    for i in range(num_dst):
        slots = [i] + [num_dst + i * fanout + j for j in range(fanout)]
        z = (x[slots] @ w).view(len(slots), heads, width)
        for k in range(heads):
            e = torch.stack([torch.dot(a_dst[k], z[0, k]) + torch.dot(a_src[k], z[s, k])
                             for s in range(len(slots))])
            alpha = torch.softmax(torch.where(e > 0, e, 0.2 * e), 0)
            torch.testing.assert_close(mine[i, k], (alpha[:, None] * z[:, k]).sum(0),
                                       rtol=1e-12, atol=1e-12)


def test_gat_attend_refuses_what_it_cannot_read():
    table = torch.randn(10, 4)
    idx = torch.zeros(8, dtype=torch.int32)
    u = torch.randn(2, 2, 4)
    kw = dict(num_dst=2, fanout=3, negative_slope=0.2)
    with pytest.raises(ValueError, match="int32"):
        ga.gat_attend(table, idx.long(), u, **kw)
    with pytest.raises(ValueError, match=r"idx must be \[8\]"):
        ga.gat_attend(table, idx[:7], u, **kw)
    with pytest.raises(ValueError, match="dense form needs 8 rows"):
        ga.gat_attend(table, None, u, **kw)
    with pytest.raises(ValueError, match=r"u must be \[2, H, 4\]"):
        ga.gat_attend(table, idx, u[:, :, :3], **kw)
    with pytest.raises(ValueError, match="fanout >= 1"):
        ga.gat_attend(table, idx, u, num_dst=2, fanout=0, negative_slope=0.2)


def test_gat_team_covers_every_vector_of_a_row():
    assert ga._team(100) == 1  # products' layer 0: 25 lanes of a warp
    assert ga._team(1024) == 8  # layers 1-2: a 256-thread block
    assert (ga._team(128), ga._team(132), ga._team(512), ga._team(516)) == (1, 2, 4, 8)
    for f in range(4, ga.MAX_F + 1, 4):  # the fewest warps with a thread a 16-byte vector
        warps = ga._team(f)
        assert 128 * warps >= f and (warps == 1 or 64 * warps < f)


# --------------------------------------------------------------- the model


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_the_benchmarks_plain_reference(seed):
    gen = torch.Generator().manual_seed(seed)
    params = _params(seed=seed)
    fanouts, batch = (4, 3, 2), 5
    table, frontier = _block(gen, batch, fanouts, 300, 24)
    want = bench_ref.block_forward(params, GAT, table, frontier, batch, fanouts)
    got = gm.forward(params, table[frontier], model="gat", fanouts=fanouts)
    assert got.shape == want.shape == (batch, 5)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    indexed = gm.forward(params, table[uniq], model="gat", fanouts=fanouts,
                         inverse_index=inverse.to(torch.int32))
    assert torch.equal(indexed, got)


def test_forward_records_attend_and_project_on_the_model_lane():
    gen = torch.Generator().manual_seed(9)
    params = _params()
    fanouts, batch = (4, 3, 2), 3
    table, frontier = _block(gen, batch, fanouts, 100, 24)
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    tracer = Tracer()
    plain = gm.GNN(params, model="gat", fanouts=fanouts)(table[uniq], inverse.to(torch.int32))
    traced = gm.GNN(params, model="gat", fanouts=fanouts)(
        table[uniq], inverse.to(torch.int32), tracer=tracer)
    assert torch.equal(plain, traced)
    spans = [e for e in tracer.events if e.get("ph") == "X"]
    assert [e["name"] for e in spans] == ["attend", "project"] * 3
    assert {e["tid"] for e in spans} == {tracer.lane("model")}
    sizes = bench_ref.frontier_sizes(batch, fanouts)
    assert [e["args"] for e in spans[::2]] == [
        {"layer": li, "rows": sizes[2 - li], "positions": sizes[3 - li], "indexed": li == 0}
        for li in range(3)
    ]


@pytest.mark.parametrize("model", ["graphsage", "gcn", "gat"])
def test_gnn_counts_a_forward_whose_layer_0_ran_in_one_kernel_once(monkeypatch, model):
    """``fused_forwards`` counts forwards, not launches: GAT launches its
    kernel at every layer, GraphSAGE and GCN at layer 0 alone.  On the CPU
    nothing launches; a counting stand-in for the card's launch shows it."""
    name = "gat_attend" if model == "gat" else "seg_agg_indexed"
    real = getattr(gm, name)

    def launched(*args, **kw):
        launched.launches += 1
        return real(*args, **kw)

    launched.launches = 0
    gen = torch.Generator().manual_seed(2)
    params = _params() if model == "gat" else gm.init_params(gen, model, 24, 5)
    fanouts, batch = (4, 3, 2), 3
    table, frontier = _block(gen, batch, fanouts, 100, 24)
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    net = gm.GNN(params, model=model, fanouts=fanouts)
    net(table[uniq], inverse.to(torch.int32))
    assert net.fused_forwards == 0  # the CPU launches nothing
    monkeypatch.setattr(gm, name, launched)
    net(table[uniq], inverse.to(torch.int32))
    net(table[frontier])
    assert net.fused_forwards == 2
    assert launched.launches == (6 if model == "gat" else 2)


def test_forward_layer_attends_over_the_exact_neighbourhood_and_itself():
    """Node 1 has no in-edge: its attention is its own row alone."""
    params = _params(in_dim=6, heads=(2, 3), head_dim=4)
    gen = torch.Generator().manual_seed(4)
    self_feats = torch.randn((3, 6), generator=gen)
    nbr = torch.randn((4, 6), generator=gen)
    seg = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    deg = torch.tensor([2.0, 0.0, 2.0])
    got = gm.forward_layer(params[0], self_feats, nbr, seg, deg, model="gat", num_dst=3)
    x = torch.cat([self_feats, nbr])
    dst = torch.tensor([0, 0, 2, 2])
    src = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    full = GAT.full_layer(params[0], x.double(), dst, src, None, torch.float64, 3, last=False)
    torch.testing.assert_close(got.double(), full[:3], rtol=1e-6, atol=1e-6)
    lone = (self_feats[1] @ params[0]["w"]) + params[0]["b"]
    torch.testing.assert_close(got[1], lone, rtol=1e-6, atol=1e-6)
    relu = gm.forward_layer(params[0], self_feats, nbr, seg, deg, model="gat", num_dst=3,
                            relu=True)
    assert torch.equal(relu, torch.nn.functional.elu(got))


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engine():
    torch.set_num_threads(1)
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, model="gat", fanouts=(3, 2, 2), batch_size=64,
                             params=_params(in_dim=ds.spec.feat_dim, classes=ds.spec.num_classes),
                             seed=1, device="cpu")
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    base = eng.run(config=EngineConfig(pipeline_depth=1), max_batches=3, collect_outputs=True)
    return eng, base, np.stack(eng.last_outputs)


ROUTES = [(dedup, use_kernel, prefetch, depth) for dedup in (False, True)
          for use_kernel in (False, True) for prefetch in (False, True) for depth in (1, 2)]


@pytest.mark.parametrize("dedup,use_kernel,prefetch,depth", ROUTES)
def test_gat_logits_are_equal_on_every_route(engine, dedup, use_kernel, prefetch, depth):
    eng, base, want = engine
    rep = eng.run(config=EngineConfig(dedup=dedup, use_kernel=use_kernel, prefetch=prefetch,
                                      pipeline_depth=depth), max_batches=3, collect_outputs=True)
    np.testing.assert_array_equal(np.stack(eng.last_outputs), want)
    assert (rep.feat_hits, rep.adj_hits) == (base.feat_hits, base.adj_hits)
    assert rep.fused_batches == 0  # no kernel on the CPU


def test_gat_auto_depth_and_serving_give_the_same_logits(engine):
    from repro_torch.core.config import ServeConfig
    from repro_torch.runtime.gnn_serve import MultiStreamServer

    eng, _, want = engine
    eng.run(config=EngineConfig(pipeline_depth="auto"), max_batches=3, collect_outputs=True)
    np.testing.assert_array_equal(np.stack(eng.last_outputs), want)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(dedup=True)))
    state = server.add_stream(eng._batches(3), seed=eng.seed, collect_outputs=True)
    server.run(warmup=False)
    np.testing.assert_array_equal(np.stack(state.runtime.outputs), want)


def test_gat_layerwise_matches_the_reference_on_every_route(engine):
    eng, _, _ = engine
    ds = eng.dataset
    col_ptr = torch.as_tensor(np.asarray(ds.graph.col_ptr))
    rows = torch.as_tensor(np.asarray(ds.graph.row_index))
    params = [{k: v for k, v in layer.items()} for layer in eng.model.layers]
    want = bench_ref.full_forward(params, GAT, col_ptr, rows, torch.as_tensor(ds.features))
    outs = []
    for prefetch, use_kernel, depth in ((False, False, 1), (True, True, 2)):
        rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=700, prefetch=prefetch,
                                          use_kernel=use_kernel, pipeline_depth=depth))
        outs.append(np.array(rep.outputs))
    assert outs[0].shape == (ds.graph.num_nodes, ds.spec.num_classes)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - want.numpy()).max() / want.abs().max() <= 1e-5


# ------------------------------------------- GraphSAGE, GCN and GAT unchanged

# sha256 (first 32 hex digits) of the weights, the logits of the indexed and
# the dense form and one layer-wise layer, at the seed and sizes below:
# GraphSAGE's and GCN's read from the code before GAT came, GAT's from the
# code before the Graph Transformer came.
PINNED = {
    "graphsage": ("7868f1c48e11e2105f44bab21b751f28", "76175824442941ccab4cd4652ef051ac",
                  "76175824442941ccab4cd4652ef051ac", "633dae2df685eb5b4b05a8852fd55d3d"),
    "gcn": ("74017db95e1c4280525a31a0993a033e", "ea27656f5d37b400cf8af93caa870fe6",
            "ea27656f5d37b400cf8af93caa870fe6", "daab10c5a31d0a793bfa332d134c0d08"),
    "gat": ("912da372c04cd57c2d6e9ed8ed158218", "82149fdd756b53c92780e145569c3462",
            "82149fdd756b53c92780e145569c3462", "465c6f6b2347384f91e20caf5100886b"),
}


def _digest(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:32]


@pytest.mark.parametrize("model", sorted(PINNED))
def test_graphsage_and_gcn_keep_their_bits(model):
    gen = torch.Generator().manual_seed(29)
    params = gm.init_params(gen, model, 24, 5)
    fanouts = (4, 3, 2)
    positions = 6 * 5 * 4 * 3
    uniq = torch.randn((positions // 2, 24), generator=gen)
    inverse = torch.randint(0, positions // 2, (positions,), generator=gen, dtype=torch.int32)
    indexed = gm.forward(params, uniq, model=model, fanouts=fanouts, inverse_index=inverse)
    dense = gm.forward(params, uniq[inverse.long()], model=model, fanouts=fanouts)
    deg = torch.tensor([2, 0, 3, 1], dtype=torch.float32)
    seg = torch.tensor([0, 0, 2, 2, 2, 3, 4, 4], dtype=torch.int32)
    layer = gm.forward_layer(params[0], uniq[:4], uniq[4:12], seg, deg, model=model, num_dst=4,
                             relu=True)
    weights = torch.cat([p[k].flatten() for p in params for k in sorted(p)])
    assert (_digest(weights), _digest(indexed), _digest(dense), _digest(layer)) == PINNED[model]
