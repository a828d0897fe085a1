"""The Graph Transformer (UniMP's ``TransformerConv``) on the port's sampled and
layer-wise paths, on the CPU.

The port's layer runs in the fewest-operations order (each destination's query
folded through the heads' key maps, the attention over the neighbours' input rows,
then the value maps); the benchmark's plain reference
(``bench/models/graph_transformer.py``) runs the paper's order (keys and values
projected) in float64.  In float64 both orders agree to rounding (1e-10).  The
port in float32 is held to the reference at 1e-5 of the largest logit: float32
against float64, the products summed in another order and LayerNorm's division by
each row's spread (read: up to 2.9e-7 at these sizes).  GraphSAGE, GCN and GAT
keep their bits (tests/test_torch_gat.py pins them).  The CUDA kernel is held to
``ref.py`` on the card by tests/test_torch_kernels_gpu.py.
"""

import numpy as np
import pytest
import torch

from bench import models as bench_models
from bench import reference as bench_ref
from repro_torch.core.config import EngineConfig, ServeConfig
from repro_torch.core.trace import Tracer
from repro_torch.graph.datasets import load_dataset
from repro_torch.kernels.dot_attend import kernel as da
from repro_torch.kernels.dot_attend.ref import dot_attend_ref
from repro_torch.models.gnn import models as gm
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

GT = bench_models.load("graph_transformer")
MODEL = "graph_transformer"
SMALL_HEADS = (2, 3, 4)  # 3 layers: 2 and 3 heads of 16 concatenated, 4 averaged


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(in_dim, classes, heads, head_dim):
    return {"dataset": {"feat_dim": in_dim, "num_classes": classes}, "heads": list(heads),
            "head_dim": head_dim, "layer_norm_eps": 1e-5, "activation": "relu"}


def _params(in_dim=24, classes=5, seed=3, heads=SMALL_HEADS, head_dim=16):
    """Small weights in the engine's layout: the benchmark's ``init`` draws
    what ``init_params`` draws at UniMP's widths (see
    test_the_benchmark_draws_the_engines_weights), and takes any."""
    return GT.init(_config(in_dim, classes, heads, head_dim),
                   torch.Generator().manual_seed(seed), "cpu")


def _block(gen, batch, fanouts, rows, f, dtype=torch.float32):
    positions = bench_ref.frontier_sizes(batch, fanouts)[-1]
    table = torch.randn((rows, f), generator=gen, dtype=dtype)
    frontier = torch.randint(0, rows, (positions,), generator=gen)
    return table, frontier


def test_init_params_layout_at_unimps_widths():
    params = gm.init_params(torch.Generator().manual_seed(0), MODEL, 100, 47)
    shapes = [{k: tuple(v.shape) for k, v in p.items()} for p in params]
    hidden = lambda d_in: {  # noqa: E731
        "w_q": (d_in, 512), "b_q": (4, 128), "w_k": (d_in, 512), "b_k": (4, 128),
        "w_v": (d_in, 512), "b_v": (4, 128), "w_r": (d_in, 512), "b_r": (512,),
        "w_g": (1536,), "ln_w": (512,), "ln_b": (512,)}
    assert shapes == [hidden(100), hidden(512), {
        "w_q": (512, 188), "b_q": (4, 47), "w_k": (512, 188), "b_k": (4, 47),
        "w_v": (512, 188), "b_v": (4, 47), "w_r": (512, 47), "b_r": (47,), "w_g": (141,)}]
    assert [list(p) for p in params] == [list(s) for s in shapes]  # the order they are drawn in
    assert [gm.out_width(p) for p in params] == [512, 512, 47]
    assert all(bool(v.ne(0).all()) for p in params for v in p.values())  # every term enters
    assert all(abs(float(p["ln_w"].mean()) - 1) < 0.05 for p in params[:2])
    two = gm.init_params(torch.Generator().manual_seed(0), MODEL, 100, 47, hidden=64, n_layers=2)
    assert [gm.out_width(p) for p in two] == [512, 47]  # hidden: not UniMP's


def test_the_benchmark_draws_the_engines_weights():
    """``bench/models/graph_transformer.py`` draws the port's layout in the port's order."""
    config = _config(24, 5, (gm.GT_HEADS,) * 3, gm.GT_HEAD_DIM)
    mine = gm.init_params(torch.Generator().manual_seed(11), MODEL, 24, 5)
    theirs = GT.init(config, torch.Generator().manual_seed(11), "cpu")
    assert [list(p) for p in mine] == [list(p) for p in theirs]
    assert all(torch.equal(a[k], b[k]) for a, b in zip(mine, theirs) for k in a)


# ------------------------------------------------------------------ dot_attend


@pytest.mark.parametrize("num_dst,fanout,f,heads", [(7, 3, 10, 1), (33, 15, 12, 4), (5, 1, 3, 6),
                                                     (16, 5, 64, 8)])
def test_dot_attend_indexed_and_dense_forms_agree_bit_for_bit(num_dst, fanout, f, heads):
    gen = torch.Generator().manual_seed(num_dst * 100 + f)
    table = torch.randn((50, f), generator=gen)
    idx = torch.randint(0, 50, (num_dst * (1 + fanout),), generator=gen, dtype=torch.int32)
    u = torch.randn((num_dst, heads, f), generator=gen)
    kw = dict(num_dst=num_dst, fanout=fanout)
    indexed = dot_attend_ref(table, idx, u, **kw)
    dense = dot_attend_ref(table[idx.long()], None, u, **kw)
    assert indexed.shape == (num_dst, heads, f) and torch.equal(indexed, dense)
    before = da.dot_attend.launches
    assert torch.equal(da.dot_attend(table, idx, u, **kw), indexed)  # the CPU route is ref.py
    assert da.dot_attend.launches == before


def test_dot_attend_reads_the_neighbour_slots_alone():
    """A self slot's row, whatever it holds, changes nothing."""
    gen = torch.Generator().manual_seed(2)
    num_dst, fanout, f = 6, 4, 8
    x = torch.randn((num_dst * (1 + fanout), f), generator=gen)
    u = torch.randn((num_dst, 3, f), generator=gen)
    want = dot_attend_ref(x, None, u, num_dst=num_dst, fanout=fanout)
    x[:num_dst] = float("nan")
    assert torch.equal(dot_attend_ref(x, None, u, num_dst=num_dst, fanout=fanout), want)


def test_dot_attend_is_the_papers_attention_folded():
    """``W_v^k sum_j alpha_j h_j + b_v^k`` with ``alpha`` from the folded queries
    equals the paper's ``sum_j alpha_j v_j`` with ``alpha`` from ``q_i . k_j /
    sqrt(D)``: the key bias cancels, the value bias enters once."""
    gen = torch.Generator().manual_seed(5)
    num_dst, fanout, f, heads, width = 9, 4, 7, 3, 5
    x = torch.randn((num_dst * (1 + fanout), f), generator=gen, dtype=torch.float64)
    p = {k: torch.randn(s, generator=gen, dtype=torch.float64) for k, s in (
        ("w_q", (f, heads * width)), ("b_q", (heads, width)), ("w_k", (f, heads * width)),
        ("b_k", (heads, width)), ("w_v", (f, heads * width)), ("b_v", (heads, width)))}
    u = gm._gt_query(p, x[:num_dst])
    att = dot_attend_ref(x, None, u, num_dst=num_dst, fanout=fanout)
    mine = torch.einsum("nhf,fhd->nhd", att, p["w_v"].view(f, heads, width)) + p["b_v"]
    for i in range(num_dst):
        nbr = x[num_dst + i * fanout:num_dst + (i + 1) * fanout]
        q = (x[i] @ p["w_q"]).view(heads, width) + p["b_q"]
        k = (nbr @ p["w_k"]).view(fanout, heads, width) + p["b_k"]
        v = (nbr @ p["w_v"]).view(fanout, heads, width) + p["b_v"]
        for h in range(heads):
            alpha = torch.softmax(k[:, h] @ q[h] / width ** 0.5, 0)
            torch.testing.assert_close(mine[i, h], (alpha[:, None] * v[:, h]).sum(0),
                                       rtol=1e-12, atol=1e-12)


def test_dot_attend_refuses_what_it_cannot_read():
    table = torch.randn(10, 4)
    idx = torch.zeros(8, dtype=torch.int32)
    u = torch.randn(2, 2, 4)
    kw = dict(num_dst=2, fanout=3)
    with pytest.raises(ValueError, match="int32"):
        da.dot_attend(table, idx.long(), u, **kw)
    with pytest.raises(ValueError, match=r"idx must be \[8\]"):
        da.dot_attend(table, idx[:7], u, **kw)
    with pytest.raises(ValueError, match="dense form needs 8 rows"):
        da.dot_attend(table, None, u, **kw)
    with pytest.raises(ValueError, match=r"u must be \[2, H, 4\]"):
        da.dot_attend(table, idx, u[:, :, :3], **kw)
    with pytest.raises(ValueError, match=r"u must be \[2, H, 4\]"):
        da.dot_attend(table, idx, u[:1], **kw)
    with pytest.raises(ValueError, match="fanout >= 1"):
        da.dot_attend(table, idx, u, num_dst=2, fanout=0)


def test_dot_team_covers_every_vector_of_a_row():
    assert da._team(100) == 1  # products' layer 0: 25 lanes of a warp
    assert da._team(512) == 4  # layers 1-2: four warps
    for f in range(4, da.MAX_F + 1, 4):  # the fewest warps with a thread a 16-byte vector
        warps = da._team(f)
        assert 128 * warps >= f and (warps == 1 or 64 * warps < f)


# --------------------------------------------------------------- the model


def test_the_fold_first_order_is_the_paper_order_in_float64():
    """The whole forward in float64: the port's order and the reference's
    agree to rounding, so every difference in float32 is rounding."""
    gen = torch.Generator().manual_seed(4)
    params = [{k: v.double() for k, v in p.items()} for p in _params(seed=4)]
    fanouts, batch = (4, 3, 2), 5
    table, frontier = _block(gen, batch, fanouts, 300, 24, torch.float64)
    want = bench_ref.block_forward(params, GT, table, frontier, batch, fanouts)
    got = gm.forward(params, table[frontier], model=MODEL, fanouts=fanouts)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_the_benchmarks_plain_reference(seed):
    gen = torch.Generator().manual_seed(seed)
    params = _params(seed=seed)
    fanouts, batch = (4, 3, 2), 5
    table, frontier = _block(gen, batch, fanouts, 300, 24)
    want = bench_ref.block_forward(params, GT, table, frontier, batch, fanouts)
    got = gm.forward(params, table[frontier], model=MODEL, fanouts=fanouts)
    assert got.shape == want.shape == (batch, 5)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    indexed = gm.forward(params, table[uniq], model=MODEL, fanouts=fanouts,
                         inverse_index=inverse.to(torch.int32))
    assert torch.equal(indexed, got)


def test_forward_records_four_spans_a_layer_on_the_model_lane():
    gen = torch.Generator().manual_seed(9)
    params = _params()
    fanouts, batch = (4, 3, 2), 3
    table, frontier = _block(gen, batch, fanouts, 100, 24)
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    tracer = Tracer()
    plain = gm.GNN(params, model=MODEL, fanouts=fanouts)(table[uniq], inverse.to(torch.int32))
    traced = gm.GNN(params, model=MODEL, fanouts=fanouts)(
        table[uniq], inverse.to(torch.int32), tracer=tracer)
    assert torch.equal(plain, traced)
    spans = [e for e in tracer.events if e.get("ph") == "X"]
    assert [e["name"] for e in spans] == ["query", "attend", "project", "gate"] * 3
    assert {e["tid"] for e in spans} == {tracer.lane("model")}
    sizes = bench_ref.frontier_sizes(batch, fanouts)
    assert [e["args"] for e in spans] == [
        {"layer": li, "rows": sizes[2 - li], "positions": sizes[3 - li], "indexed": li == 0}
        for li in range(3) for _ in range(4)
    ]


def test_gnn_counts_a_forward_that_ran_in_dot_attend_once(monkeypatch):
    """``fused_forwards`` counts forwards, not launches: the Graph Transformer
    launches its kernel at every layer.  On the CPU nothing launches; a
    counting stand-in for the card's launch shows it."""
    real = gm.dot_attend

    def launched(*args, **kw):
        launched.launches += 1
        return real(*args, **kw)

    launched.launches = 0
    gen = torch.Generator().manual_seed(2)
    fanouts, batch = (4, 3, 2), 3
    table, frontier = _block(gen, batch, fanouts, 100, 24)
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    net = gm.GNN(_params(), model=MODEL, fanouts=fanouts)
    net(table[uniq], inverse.to(torch.int32))
    assert net.fused_forwards == 0  # the CPU launches nothing
    monkeypatch.setattr(gm, "dot_attend", launched)
    net(table[uniq], inverse.to(torch.int32))
    net(table[frontier])
    assert net.fused_forwards == 2 and launched.launches == 6


def test_forward_layer_attends_over_the_exact_in_neighbourhood_alone():
    """Node 1 has no in-edge: it attends to nothing, and the gate mixes 0 with
    its skip."""
    params = _params(in_dim=6, heads=(2, 3), head_dim=4)
    p = params[0]
    gen = torch.Generator().manual_seed(4)
    self_feats = torch.randn((3, 6), generator=gen)
    nbr = torch.randn((5, 6), generator=gen)
    seg = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32)
    deg = torch.tensor([2.0, 0.0, 3.0])
    got = gm.forward_layer(p, self_feats, nbr, seg, deg, model=MODEL, num_dst=3)
    x = torch.cat([self_feats, nbr])
    dst = torch.tensor([0, 0, 2, 2, 2])
    src = torch.tensor([3, 4, 5, 6, 7], dtype=torch.int32)
    for edge_block in (2, 1 << 20):
        full = GT.full_layer(p, x.double(), dst, src, None, torch.float64, edge_block, last=False)
        torch.testing.assert_close(got.double(), full[:3], rtol=1e-5, atol=1e-5)
    skip = self_feats[1] @ p["w_r"] + p["b_r"]
    beta = torch.sigmoid(torch.cat([torch.zeros_like(skip), skip, -skip]) @ p["w_g"])
    lone = torch.nn.functional.layer_norm(beta * skip, (8,), p["ln_w"], p["ln_b"], eps=1e-5)
    torch.testing.assert_close(got[1], lone, rtol=1e-5, atol=1e-5)
    relu = gm.forward_layer(p, self_feats, nbr, seg, deg, model=MODEL, num_dst=3, relu=True)
    assert torch.equal(relu, torch.relu(got))


def test_forward_layer_in_levels_equals_one_level():
    """``levels`` (a chunk plan's bounded pieces, each summed in order, then
    the pieces in order) give the one-level result to float32 rounding."""
    params = _params(in_dim=6, heads=(2, 3), head_dim=4)
    gen = torch.Generator().manual_seed(6)
    self_feats = torch.randn((3, 6), generator=gen)
    nbr = torch.randn((6, 6), generator=gen)
    seg = torch.tensor([0, 0, 0, 0, 2, 2], dtype=torch.int32)
    deg = torch.tensor([4.0, 0.0, 2.0])
    kw = dict(model=MODEL, num_dst=3)
    one = gm.forward_layer(params[0], self_feats, nbr, seg, deg, **kw)
    pieces = (torch.tensor([2, 2, 2]), torch.tensor([2, 0, 1, 0]))
    torch.testing.assert_close(
        gm.forward_layer(params[0], self_feats, nbr, seg, deg, levels=pieces, **kw), one,
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engine():
    torch.set_num_threads(1)
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, model=MODEL, fanouts=(3, 2, 2), batch_size=64,
                             params=_params(in_dim=ds.spec.feat_dim, classes=ds.spec.num_classes),
                             seed=1, device="cpu")
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    base = eng.run(config=EngineConfig(pipeline_depth=1), max_batches=3, collect_outputs=True)
    return eng, base, np.stack(eng.last_outputs)


ROUTES = [(dedup, use_kernel, prefetch, depth) for dedup in (False, True)
          for use_kernel in (False, True) for prefetch in (False, True) for depth in (1, 2)]


@pytest.mark.parametrize("dedup,use_kernel,prefetch,depth", ROUTES)
def test_logits_are_equal_on_every_route(engine, dedup, use_kernel, prefetch, depth):
    eng, base, want = engine
    rep = eng.run(config=EngineConfig(dedup=dedup, use_kernel=use_kernel, prefetch=prefetch,
                                      pipeline_depth=depth), max_batches=3, collect_outputs=True)
    np.testing.assert_array_equal(np.stack(eng.last_outputs), want)
    assert (rep.feat_hits, rep.adj_hits) == (base.feat_hits, base.adj_hits)
    assert rep.fused_batches == 0  # no kernel on the CPU


def test_auto_depth_and_serving_give_the_same_logits(engine):
    from repro_torch.runtime.gnn_serve import MultiStreamServer
    from repro_torch.runtime.request_queue import Request, RequestQueueServer

    eng, _, want = engine
    eng.run(config=EngineConfig(pipeline_depth="auto"), max_batches=3, collect_outputs=True)
    np.testing.assert_array_equal(np.stack(eng.last_outputs), want)
    server = MultiStreamServer(eng, config=ServeConfig(engine=EngineConfig(dedup=True)))
    state = server.add_stream(eng._batches(3), seed=eng.seed, collect_outputs=True)
    server.run(warmup=False)
    np.testing.assert_array_equal(np.stack(state.runtime.outputs), want)
    queue = RequestQueueServer(eng, config=ServeConfig(engine=EngineConfig(use_kernel=True,
                                                                           dedup=True)))
    requests = [Request(request_id=i, stream_id=0, seeds=s, arrival_s=0.0)
                for i, s in enumerate(eng._batches(3))]
    state = queue.add_request_stream(requests, seed=eng.seed, collect_outputs=True)
    queue.run(warmup=False)
    assert len(state.completed) == 3
    np.testing.assert_array_equal(np.stack(state.runtime.outputs), want)


def test_layerwise_matches_the_reference_on_every_route(engine):
    eng, _, _ = engine
    ds = eng.dataset
    col_ptr = torch.as_tensor(np.asarray(ds.graph.col_ptr))
    rows = torch.as_tensor(np.asarray(ds.graph.row_index))
    params = [{k: v for k, v in layer.items()} for layer in eng.model.layers]
    want = bench_ref.full_forward(params, GT, col_ptr, rows, torch.as_tensor(ds.features))
    outs = []
    for prefetch, use_kernel, depth in ((False, False, 1), (True, True, 2)):
        rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=700, prefetch=prefetch,
                                          use_kernel=use_kernel, pipeline_depth=depth))
        outs.append(np.array(rep.outputs))
    assert outs[0].shape == (ds.graph.num_nodes, ds.spec.num_classes)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - want.numpy()).max() / want.abs().max() <= 1e-5
