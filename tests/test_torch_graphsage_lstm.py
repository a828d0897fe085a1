"""GraphSAGE-LSTM (Hamilton et al., NeurIPS 2017: the LSTM aggregator) on the port's
sampled and layer-wise paths, on the CPU.

The port's layer maps the rows the recurrence reads to gate rows first (one product),
runs the recurrence over them (``kernels/lstm_agg``: ``ref.py`` on the CPU), then the
self and neighbour maps; the benchmark's plain reference
(``bench/models/graphsage_lstm.py``) maps every slot's row inside its loop, in float64.
In float64 both agree to rounding (1e-10).  The port in float32 is held to the
reference at 1e-5 of the largest logit: float32 against float64 over 25 dependent
steps and the L2 norm (read: up to 2.2e-7 at these sizes).  The CUDA kernel is held to
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
from repro_torch.kernels.lstm_agg import kernel as la
from repro_torch.kernels.lstm_agg.ref import lstm_agg_ref
from repro_torch.models.gnn import models as gm
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

LSTM = bench_models.load("graphsage_lstm")
MODEL = "graphsage_lstm"


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _config(in_dim=24, classes=5, layers=3, hidden=8, lstm=16):
    return {"dataset": {"feat_dim": in_dim, "num_classes": classes}, "layers": layers,
            "hidden": hidden, "lstm_hidden": lstm, "concat": True, "activation": "relu",
            "forget_bias": 1.0}


def _params(seed=3, **kw):
    """Small weights in the engine's layout: the benchmark's ``init`` draws what
    ``init_params`` draws at the published widths (see
    test_the_benchmark_draws_the_engines_weights), and takes any."""
    return LSTM.init(_config(**kw), torch.Generator().manual_seed(seed), "cpu")


def _block(gen, batch, fanouts, rows, f, dtype=torch.float32):
    positions = bench_ref.frontier_sizes(batch, fanouts)[-1]
    table = torch.randn((rows, f), generator=gen, dtype=dtype)
    frontier = torch.randint(0, rows, (positions,), generator=gen)
    return table, frontier


def test_init_params_layout_at_the_published_widths():
    params = gm.init_params(torch.Generator().manual_seed(0), MODEL, 602, 41, n_layers=2)
    shapes = [{k: tuple(v.shape) for k, v in p.items()} for p in params]
    layer = lambda d_in: {  # noqa: E731
        "w_ih": (d_in, 512), "w_hh": (128, 512), "b_lstm": (512,), "w_self": (d_in, 128),
        "w_nbr": (128, 128)}
    assert shapes == [layer(602), {**layer(256), "w_pred": (256, 41), "b_pred": (41,)}]
    assert [list(p) for p in params] == [list(s) for s in shapes]  # the order they are drawn in
    assert [gm.out_width(p) for p in params] == [256, 41]
    assert all(bool(v.ne(0).all()) for p in params for v in p.values())  # every term enters
    three = gm.init_params(torch.Generator().manual_seed(0), MODEL, 100, 47, hidden=64)
    assert [gm.out_width(p) for p in three] == [128, 128, 47]
    assert three[1]["w_hh"].shape == (gm.LSTM_HIDDEN, 4 * gm.LSTM_HIDDEN)  # the LSTM stays 128


def test_the_benchmark_draws_the_engines_weights():
    """``bench/models/graphsage_lstm.py`` draws the port's layout in the port's order."""
    config = _config(hidden=128, lstm=gm.LSTM_HIDDEN)
    mine = gm.init_params(torch.Generator().manual_seed(11), MODEL, 24, 5)
    theirs = LSTM.init(config, torch.Generator().manual_seed(11), "cpu")
    assert [list(p) for p in mine] == [list(p) for p in theirs]
    assert all(torch.equal(a[k], b[k]) for a, b in zip(mine, theirs) for k in a)


# ------------------------------------------------------------------- lstm_agg


def _loop(g, idx, w_hh, num_dst, fanout):
    """One destination and one step at a time, TF's BasicLSTMCell in float64."""
    hidden = w_hh.shape[0]
    g, w_hh = g.double(), w_hh.double()
    out = []
    for d in range(num_dst):
        h = torch.zeros(hidden, dtype=torch.float64)
        c = torch.zeros(hidden, dtype=torch.float64)
        for t in range(fanout):
            pos = num_dst + d * fanout + t
            row = g[d * fanout + t] if idx is None else g[int(idx[pos])]
            z = row + h @ w_hh
            i, j, f, o = (z[k * hidden:(k + 1) * hidden] for k in range(4))
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(j)
            h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out)


@pytest.mark.parametrize("num_dst,fanout,hidden", [(7, 3, 4), (5, 1, 8), (12, 25, 16), (3, 10, 2)])
def test_lstm_agg_ref_is_the_step_by_step_cell(num_dst, fanout, hidden):
    gen = torch.Generator().manual_seed(num_dst * 10 + fanout)
    g = torch.randn((40, 4 * hidden), generator=gen, dtype=torch.float64)
    w_hh = torch.randn((hidden, 4 * hidden), generator=gen, dtype=torch.float64) / hidden ** 0.5
    idx = torch.randint(0, 40, (num_dst * (1 + fanout),), generator=gen, dtype=torch.int32)
    kw = dict(num_dst=num_dst, fanout=fanout)
    torch.testing.assert_close(lstm_agg_ref(g, idx, w_hh, **kw), _loop(g, idx, w_hh, **kw),
                               rtol=1e-12, atol=1e-12)
    dense = g[idx[num_dst:].long()]
    torch.testing.assert_close(lstm_agg_ref(dense, None, w_hh, **kw),
                               _loop(dense, None, w_hh, **kw), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("num_dst,fanout", [(7, 3), (33, 25), (5, 1), (16, 10)])
def test_lstm_agg_indexed_and_dense_forms_agree_bit_for_bit(num_dst, fanout):
    gen = torch.Generator().manual_seed(num_dst * 100 + fanout)
    g = torch.randn((50, 64), generator=gen)
    w_hh = torch.randn((16, 64), generator=gen) / 4
    idx = torch.randint(0, 50, (num_dst * (1 + fanout),), generator=gen, dtype=torch.int32)
    kw = dict(num_dst=num_dst, fanout=fanout)
    indexed = lstm_agg_ref(g, idx, w_hh, **kw)
    assert indexed.shape == (num_dst, 16)
    assert torch.equal(indexed, lstm_agg_ref(g[idx[num_dst:].long()], None, w_hh, **kw))
    before = la.lstm_agg.launches
    assert torch.equal(la.lstm_agg(g, idx, w_hh, **kw), indexed)  # the CPU route is ref.py
    assert la.lstm_agg.launches == before


def test_lstm_agg_reads_the_neighbour_slots_alone_and_in_their_order():
    """A self slot's row, whatever it holds, changes nothing; two slots swapped
    change the state (the aggregator is no sum)."""
    gen = torch.Generator().manual_seed(2)
    num_dst, fanout = 6, 4
    g = torch.randn((30, 32), generator=gen)
    w_hh = torch.randn((8, 32), generator=gen)
    idx = torch.randint(1, 30, (num_dst * (1 + fanout),), generator=gen, dtype=torch.int32)
    kw = dict(num_dst=num_dst, fanout=fanout)
    want = lstm_agg_ref(g, idx, w_hh, **kw)
    g[0] = float("nan")
    idx[:num_dst] = 0
    assert torch.equal(lstm_agg_ref(g, idx, w_hh, **kw), want)
    swapped = idx.clone()
    swapped[num_dst], swapped[num_dst + 1] = idx[num_dst + 1], idx[num_dst]
    assert not torch.allclose(lstm_agg_ref(g, swapped, w_hh, **kw)[0], want[0])


def test_lstm_agg_refuses_what_it_cannot_read():
    g = torch.randn(10, 16)
    w_hh = torch.randn(4, 16)
    idx = torch.zeros(8, dtype=torch.int32)
    kw = dict(num_dst=2, fanout=3)
    with pytest.raises(ValueError, match="int32"):
        la.lstm_agg(g, idx.long(), w_hh, **kw)
    with pytest.raises(ValueError, match=r"idx must be \[8\]"):
        la.lstm_agg(g, idx[:7], w_hh, **kw)
    with pytest.raises(ValueError, match="dense form needs 6 rows"):
        la.lstm_agg(g, None, w_hh, **kw)
    with pytest.raises(ValueError, match=r"\[H, 4H\]"):
        la.lstm_agg(g, idx, torch.randn(4, 12), **kw)
    with pytest.raises(ValueError, match=r"\[H, 4H\]"):
        la.lstm_agg(g[:, :12], idx, w_hh, **kw)
    with pytest.raises(ValueError, match="fanout >= 1"):
        la.lstm_agg(g, idx, w_hh, num_dst=2, fanout=0)


# --------------------------------------------------------------- the model


def test_the_map_first_order_is_the_papers_in_float64():
    """The whole forward in float64: the port's order and the reference's
    agree to rounding, so every difference in float32 is rounding."""
    gen = torch.Generator().manual_seed(4)
    params = [{k: v.double() for k, v in p.items()} for p in _params(seed=4)]
    fanouts, batch = (4, 3, 2), 5
    table, frontier = _block(gen, batch, fanouts, 300, 24, torch.float64)
    want = bench_ref.block_forward(params, LSTM, table, frontier, batch, fanouts)
    got = gm.forward(params, table[frontier], model=MODEL, fanouts=fanouts)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_matches_the_benchmarks_plain_reference(seed):
    gen = torch.Generator().manual_seed(seed)
    params = _params(seed=seed)
    fanouts, batch = (4, 3, 2), 5
    table, frontier = _block(gen, batch, fanouts, 300, 24)
    want = bench_ref.block_forward(params, LSTM, table, frontier, batch, fanouts)
    got = gm.forward(params, table[frontier], model=MODEL, fanouts=fanouts)
    assert got.shape == want.shape == (batch, 5)
    assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-5
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    inverse = inverse.to(torch.int32)
    indexed = gm.forward(params, table[uniq], model=MODEL, fanouts=fanouts, inverse_index=inverse)
    assert torch.equal(indexed, got)
    padded = torch.cat([table[uniq], torch.full((5, 24), float("nan"))])  # a pow2 bucket's pad
    live = gm.forward(params, padded, model=MODEL, fanouts=fanouts, inverse_index=inverse,
                      num_rows=uniq.shape[0])
    assert torch.equal(live, got)


def test_forward_records_three_spans_a_layer_on_the_model_lane():
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
    assert [e["name"] for e in spans] == ["input-map", "recur", "combine"] * 3
    assert {e["tid"] for e in spans} == {tracer.lane("model")}
    sizes = bench_ref.frontier_sizes(batch, fanouts)
    rev = fanouts[::-1]
    assert [e["args"] for e in spans] == [
        {"layer": li, "rows": sizes[2 - li], "positions": sizes[3 - li], "indexed": li == 0,
         "steps": rev[2 - li]}
        for li in range(3) for _ in range(3)
    ]


def test_gnn_counts_a_forward_that_ran_in_lstm_agg_once(monkeypatch):
    """``fused_forwards`` counts forwards, not launches: GraphSAGE-LSTM
    launches its kernel at every layer.  On the CPU nothing launches; a
    counting stand-in for the card's launch shows it."""
    real = gm.lstm_agg

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
    monkeypatch.setattr(gm, "lstm_agg", launched)
    net(table[uniq], inverse.to(torch.int32), num_rows=uniq.shape[0])
    net(table[frontier])
    assert net.fused_forwards == 2 and launched.launches == 6


def test_forward_layer_runs_over_the_exact_in_neighbourhood_in_csc_order():
    """Node 1 has no in-edge (``h = 0``: its neighbour map adds nothing), node 2
    a multi-edge (the same source twice, both in the sequence), node 3 one edge;
    the nodes' sequences are of different lengths, so they finish at different
    steps."""
    p = _params(in_dim=6, layers=2)[0]
    gen = torch.Generator().manual_seed(4)
    self_feats = torch.randn((4, 6), generator=gen)
    nbr = torch.randn((6, 6), generator=gen)
    nbr[3] = nbr[2]  # node 2's second in-edge repeats its first source
    seg = torch.tensor([0, 0, 2, 2, 2, 3], dtype=torch.int32)
    deg = torch.tensor([2.0, 0.0, 3.0, 1.0])
    got = gm.forward_layer(p, self_feats, nbr, seg, deg, model=MODEL, num_dst=4)
    x = torch.cat([self_feats, nbr])
    dst = torch.tensor([0, 0, 2, 2, 2, 3])
    src = torch.tensor([4, 5, 6, 6, 8, 9], dtype=torch.int32)
    for edge_block in (1, 1 << 20):
        full = LSTM.full_layer(p, x.double(), dst, src, None, torch.float64, edge_block,
                               last=False)
        torch.testing.assert_close(got.double(), full[:4], rtol=1e-5, atol=1e-5)
    lone = torch.cat([self_feats[1] @ p["w_self"], torch.zeros(8)])
    torch.testing.assert_close(got[1], lone, rtol=1e-6, atol=1e-6)
    relu = gm.forward_layer(p, self_feats, nbr, seg, deg, model=MODEL, num_dst=4, relu=True)
    assert torch.equal(relu, torch.relu(got))


def test_forward_layer_ignores_the_pad_edges_and_the_levels():
    """Pad edge rows past the live ones are not read, and a chunk plan's
    ``levels`` leave the sequence as it is."""
    p = _params(in_dim=6, layers=1)[0]
    gen = torch.Generator().manual_seed(6)
    self_feats = torch.randn((3, 6), generator=gen)
    nbr = torch.randn((6, 6), generator=gen)
    seg = torch.tensor([0, 0, 0, 0, 2, 2], dtype=torch.int32)
    deg = torch.tensor([4.0, 0.0, 2.0])
    kw = dict(model=MODEL, num_dst=3)
    one = gm.forward_layer(p, self_feats, nbr, seg, deg, **kw)
    padded = torch.cat([nbr, torch.full((2, 6), float("nan"))])
    pieces = (torch.tensor([2, 2, 2]), torch.tensor([2, 0, 1, 0]))
    assert torch.equal(gm.forward_layer(p, self_feats, padded, seg, deg, levels=pieces, **kw), one)
    assert gm.out_width(p) == 5 and one.shape == (3, 5)  # the last layer: L2 norm, output map


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
    want = bench_ref.full_forward(params, LSTM, col_ptr, rows, torch.as_tensor(ds.features))
    outs = []
    for prefetch, use_kernel, depth in ((False, False, 1), (True, True, 2)):
        rep = eng.run(config=EngineConfig(mode="layerwise", chunk_size=700, prefetch=prefetch,
                                          use_kernel=use_kernel, pipeline_depth=depth))
        outs.append(np.array(rep.outputs))
    assert outs[0].shape == (ds.graph.num_nodes, ds.spec.num_classes)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.abs(outs[0] - want.numpy()).max() / want.abs().max() <= 1e-5
