"""GraphSAGE-LSTM in the benchmark (``bench/models/graphsage_lstm.py``,
``configs/sage-lstm-reddit.json``, ``metrics/lstm_roofline.py``,
``metrics/lstm_dispatch_ms.py``), on the CPU."""

import json
import pathlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import drive, models
from bench import reference as ref
from bench.flops import full_graph_flops, layer_dims, sampled_flops
from bench.harness import _reader, cell_spec, run_cell

HERE = pathlib.Path(__file__).resolve().parent
CELL = "sage-lstm-reddit.offline4096"
LSTM = models.load("graphsage_lstm")
SEED = 2**31 + 35


def _config():
    return cell_spec(CELL)[2]


@pytest.fixture
def tiny():
    """A configuration narrow enough for exact loops: 3 layers, maps of 3, an LSTM of 4,
    6 features, 2 classes."""
    return {"dataset": {"feat_dim": 6, "num_classes": 2}, "layers": 3, "hidden": 3,
            "lstm_hidden": 4, "concat": True, "activation": "relu", "forget_bias": 1.0}


def test_the_configuration_is_the_papers_on_gcn_reddits_graph():
    config = _config()
    gcn = cell_spec("gcn-reddit.offline4096")[2]
    assert layer_dims(config) == [602, 256, 41]
    assert (config["model"], config["layers"], config["fanouts"]) == ("graphsage_lstm", 2, [25, 10])
    assert (config["hidden"], config["lstm_hidden"], config["concat"], config["forget_bias"],
            config["activation"]) == (128, 128, True, 1.0, "relu")
    assert config["reduced"] == [] and len(config["assumed"]) == 7
    for key in ("dataset", "policy", "n_presample", "cache_mb", "use_kernel", "dedup",
                "prefetch", "pipeline_depth", "precision"):
        assert config[key] == gcn[key], key
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "sage-lstm-reddit")
    assert entry["source"] == config["source"] and entry["reduced"] == []
    assert "arXiv:1706.02216" in entry["source"]
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("sage-lstm-reddit", "offline4096", 1)
    reported = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                if CELL in m.get("workloads", [CELL])}
    assert reported == {"nodes_per_s", "setup_s", "prep_s", "eq1_adj_share", "adj_hit_rate",
                        "feat_hit_rate", "gather_roofline", "mfu", "idle_share", "dispatch_ms",
                        "wait_ms", "waits_per_item", "sample_ms", "device_syncs_per_item",
                        "lstm_roofline", "lstm_dispatch_ms"}


def test_operations_a_batch_are_pinned():
    """At the cell's shapes: layer 0 maps 45,056 rows (the port maps more, the
    frontier's distinct rows) and runs 45,056 x 25 steps; layer 1 maps its 40,960
    neighbour rows and runs 4,096 x 10 steps."""
    config = _config()
    dims = layer_dims(config)
    per_layer = [LSTM.layer_flops(rows, rows * f, dims[i], dims[i + 1], config=config, layer=i)
                 for i, (rows, f) in enumerate(((45_056, 25), (4096, 10)))]
    assert per_layer == [178_655_330_304, 16_106_819_584]
    assert sampled_flops("graphsage_lstm", 4096, config["fanouts"], dims,
                         config) == 194_762_149_888
    assert full_graph_flops("graphsage_lstm", 232_965, 11_605_996, dims,
                            config) == 6_259_679_928_525


def test_layer_0s_count_by_hand():
    """Layer 0 term by term: 45,056 destinations, 1,126,400 neighbour slots, 602
    features in, an LSTM of 128, maps of 128."""
    n, t, f, h, d = 45_056, 1_126_400, 602, 128, 128
    input_map = 2 * n * f * 4 * h + n * 4 * h  # counted over the destinations' rows
    recurrence = (t - n) * (2 * h * 4 * h + 5 * h) + n * 2 * h
    maps = 2 * n * f * d + 2 * n * h * d
    assert input_map + recurrence + maps == 178_655_330_304
    assert LSTM.layer_flops(n, t, f, 2 * d, config=_config(), layer=0) == 178_655_330_304
    assert LSTM.recur_flops(n, t, config=_config()) == recurrence


def _port_flops(rows, fanout, d_in, d_out, mapped, config, last):
    """What the port's layer runs, term by term: the input map and its bias over
    ``mapped`` rows, a product with ``w_hh`` and its sums at every step after a
    destination's first, the cell's five operations an element a step (two at the
    first), the two maps, and on the last layer the L2 norm (at least a square and an
    add an element, and a scale) and the output map with its bias."""
    h, d = config["lstm_hidden"], config["hidden"]
    total = 2 * mapped * d_in * 4 * h + mapped * 4 * h
    total += rows * (fanout - 1) * (2 * h * 4 * h + 5 * h) + rows * 2 * h
    total += 2 * rows * d_in * d + 2 * rows * h * d
    if last:
        total += 3 * rows * 2 * d + 2 * rows * 2 * d * d_out + rows * d_out
    return total


def test_layer_flops_reads_at_or_under_what_the_port_runs():
    """On a card layer 0 maps the frontier's distinct rows, at least the
    destinations' (about 104,000 at the cell's batches), and on the CPU every
    neighbour slot's; layer 1 maps its neighbour slots' rows."""
    config = _config()
    dims = layer_dims(config)
    shapes = ((45_056, 25), (4096, 10))
    for li, (rows, f) in enumerate(shapes):
        counted = LSTM.layer_flops(rows, rows * f, dims[li], dims[li + 1], config=config, layer=li)
        mapped = (rows, 104_000, rows * f) if li == 0 else (rows * f,)
        for m in mapped:
            ran = _port_flops(rows, f, dims[li], dims[li + 1], m, config, li == len(shapes) - 1)
            assert counted <= ran, (li, m)
        assert counted == _port_flops(rows, f, dims[li], dims[li + 1], mapped[0], config,
                                      li == len(shapes) - 1)


def test_the_ports_products_on_the_cpu_are_the_hand_counts_products(tiny):
    """FlopCounterMode over the port's forward on the CPU (its layer 0 maps every
    neighbour slot's row) counts exactly the products of ``_port_flops``."""
    from repro_torch.models.gnn import models as gm

    params = LSTM.init(tiny, torch.Generator().manual_seed(1), "cpu")
    fanouts, batch = (3, 2, 4), 5
    sizes = ref.frontier_sizes(batch, fanouts)
    frontier = torch.randint(0, 40, (sizes[-1],), generator=torch.Generator().manual_seed(2))
    table = torch.randn((40, 6), generator=torch.Generator().manual_seed(3))
    uniq, inverse = torch.unique(frontier, return_inverse=True)
    with FlopCounterMode(display=False) as counter:
        gm.forward(params, table[uniq], model="graphsage_lstm", fanouts=fanouts,
                   inverse_index=inverse.to(torch.int32))
    dims, h, d = LSTM.dims(tiny), tiny["lstm_hidden"], tiny["hidden"]
    products = 0
    for li, l in enumerate(range(len(fanouts) - 1, -1, -1)):
        rows, f = sizes[l], fanouts[::-1][l]
        products += 2 * rows * f * dims[li] * 4 * h + rows * (f - 1) * 2 * h * 4 * h
        products += 2 * rows * dims[li] * d + 2 * rows * h * d
    products += 2 * batch * 2 * d * dims[-1]
    assert counter.get_total_flops() == products


def test_recur_bytes_are_pinned():
    """Layer 0 at the cell's shape with 104,000 distinct rows through the index;
    layer 1 reads every neighbour slot's row in place; each destination writes its
    128-wide state."""
    config = _config()
    assert LSTM.recur_bytes(45_056, 1_126_400, config=config, distinct_rows=104_000,
                            indexed=True) == 4 * (104_000 * 512 + 1_126_400 + 45_056 * 128)
    assert LSTM.recur_bytes(4096, 40_960, config=config, distinct_rows=40_960,
                            indexed=False) == 4 * (40_960 * 512 + 4096 * 128)


def _loop_layer(p, x_self, nbr, last):
    """One destination and one step at a time, straight from BasicLSTMCell's
    equations, the maps and (last) the L2 norm and the output map."""
    p = {k: v.double() for k, v in p.items()}
    hidden = p["w_hh"].shape[0]
    outs = []
    for i in range(x_self.shape[0]):
        h = torch.zeros(hidden, dtype=torch.float64)
        c = torch.zeros(hidden, dtype=torch.float64)
        for x in nbr[i]:
            z = x @ p["w_ih"] + h @ p["w_hh"] + p["b_lstm"]
            gates = [z[k * hidden:(k + 1) * hidden] for k in range(4)]
            c = torch.sigmoid(gates[2] + 1) * c + torch.sigmoid(gates[0]) * torch.tanh(gates[1])
            h = torch.sigmoid(gates[3]) * torch.tanh(c)
        o = torch.cat([x_self[i] @ p["w_self"], h @ p["w_nbr"]])
        if last:
            o = o / o.norm() @ p["w_pred"] + p["b_pred"]
        outs.append(o)
    return torch.stack(outs)


def test_block_layer_is_the_papers_equations(tiny):
    params = LSTM.init(tiny, torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    dims = LSTM.dims(tiny)
    for i, p in enumerate(params):
        last = i == len(params) - 1
        x_self = torch.randn((5, dims[i]), generator=gen, dtype=torch.float64)
        nbr = torch.randn((5, 3, dims[i]), generator=gen, dtype=torch.float64)
        got = LSTM.block_layer(p, x_self, nbr, 3, torch.float64, last=last)
        torch.testing.assert_close(got, _loop_layer(p, x_self, nbr, last), rtol=1e-12, atol=1e-12)


def test_full_layer_equals_block_layer_where_the_block_is_the_neighbourhood(tiny):
    """Every node with exactly three in-neighbours, in CSC order: the sampled block
    that draws them in that order is the exact neighbourhood."""
    params = LSTM.init(tiny, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(4)
    n, fanout = 8, 3
    src = torch.randint(0, n, (n * fanout,), generator=gen, dtype=torch.int32)
    dst = torch.arange(n).repeat_interleave(fanout)
    dims = LSTM.dims(tiny)
    for i, p in enumerate(params):
        last = i == len(params) - 1
        x = torch.randn((n, dims[i]), generator=gen, dtype=torch.float64)
        block = LSTM.block_layer(p, x, x[src.long()].view(n, fanout, -1), fanout, torch.float64,
                                 last=last)
        for edge_block in (5, 1 << 20):
            full = LSTM.full_layer(p, x, dst, src, None, torch.float64, edge_block, last=last)
            torch.testing.assert_close(full, block, rtol=1e-12, atol=1e-12)


def test_full_layer_gives_a_node_with_no_in_edge_a_zero_state(tiny):
    params = LSTM.init(tiny, torch.Generator().manual_seed(7), "cpu")
    p = {k: v.double() for k, v in params[0].items()}
    x = torch.randn((3, 6), generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    dst, src = torch.tensor([0, 2, 2]), torch.tensor([1, 1, 0], dtype=torch.int32)
    full = LSTM.full_layer(p, x, dst, src, None, torch.float64, 4, last=False)
    torch.testing.assert_close(full[1], torch.cat([x[1] @ p["w_self"], torch.zeros(3,
                                                    dtype=torch.float64)]), rtol=0, atol=0)
    assert torch.isfinite(full).all()


def test_block_layer_splits_its_destinations_exactly(tiny, monkeypatch):
    params = LSTM.init(tiny, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(6)
    x_self = torch.randn((9, 6), generator=gen, dtype=torch.float64)
    nbr = torch.randn((9, 2, 6), generator=gen, dtype=torch.float64)
    whole = LSTM.block_layer(params[0], x_self, nbr, 2, torch.float64, last=False)
    monkeypatch.setattr(LSTM, "SUB_ROWS", 4)
    assert torch.equal(LSTM.block_layer(params[0], x_self, nbr, 2, torch.float64, last=False),
                       whole)


def test_init_holds_the_configuration_to_the_papers_cell(tiny):
    for key, value in (("concat", False), ("activation", "tanh"), ("forget_bias", 0.0)):
        with pytest.raises(ValueError, match="concatenates"):
            LSTM.init({**tiny, key: value}, torch.Generator(), "cpu")


def test_the_weights_are_the_seeds():
    config = {**_config(), "hidden": 8, "lstm_hidden": 8}
    a = drive.make_params(config, SEED, torch.device("cpu"))
    b = drive.make_params(config, SEED, torch.device("cpu"))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    layer = ["w_ih", "w_hh", "b_lstm", "w_self", "w_nbr"]
    assert [list(p) for p in a] == [layer, layer + ["w_pred", "b_pred"]]


@pytest.fixture
def narrow(small):
    """``small`` with maps and an LSTM of 16: the cell's structure at a width a CPU test
    holds."""
    small["config"].update(hidden=16, lstm_hidden=16)
    return small


def test_the_cell_runs_correct_on_the_cpu(narrow):
    result = run_cell(CELL, SEED, 0.3, False, device="cpu", overrides=narrow, log=lambda m: None)
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"nodes_per_s", "setup_s"}
    assert result["checks"]["logit_gap"]["value"] <= 1e-5
    assert all(result["checks"][k]["value"] == 0 for k in ("count_gap", "eq1_gap", "missing"))


def test_the_traced_cell_reads_the_new_spans_and_no_kernel_on_the_cpu(narrow):
    result = run_cell(CELL, SEED + 1, 0.3, True, device="cpu", overrides=narrow,
                      log=lambda m: None)
    metrics = result["metrics"]
    assert metrics["lstm_dispatch_ms"]["value"] > 0
    assert "lstm_roofline" not in metrics  # the CPU launches no lstm_agg
    assert "gt_dispatch_ms" not in metrics and "dot_attn_roofline" not in metrics  # GT's cell's
    assert 0 < metrics["mfu"]["value"] < 100


def _ctx(kernel_s, model=LSTM, batches=3):
    config = _config()
    out = type("Outcome", (), {"nodes": batches * 4096})()
    return dict(trace={"kernel_s": kernel_s}, gather_groups=[(400_000, 158_000, 2408)],
                model=model, config=config, mix={"batch_size": 4096}, outcome=out)


def test_lstm_roofline_reads_the_larger_bound_over_the_kernels_time():
    read = _reader("lstm_roofline")
    kernel = "void (anonymous namespace)::lstm_agg_kernel(float const*, int const*, float const*"
    gt = "void (anonymous namespace)::dot_attend_kernel<4>(float const*, int const*"
    ctx = _ctx({kernel: 0.01, gt: 5.0, "void gather_blocks_kernel": 1.0})
    config = _config()
    layer0 = max(LSTM.recur_flops(3 * 45_056, 3 * 1_126_400, config=config) / 67e12,
                 LSTM.recur_bytes(3 * 45_056, 3 * 1_126_400, config=config,
                                  distinct_rows=558_000, indexed=True) / 3.35e12)
    layer1 = max(LSTM.recur_flops(3 * 4096, 3 * 40_960, config=config) / 67e12,
                 LSTM.recur_bytes(3 * 4096, 3 * 40_960, config=config, distinct_rows=3 * 40_960,
                                  indexed=False) / 3.35e12)
    assert layer0 == LSTM.recur_flops(3 * 45_056, 3 * 1_126_400, config=config) / 67e12
    assert read(ctx) == pytest.approx(100 * (layer0 + layer1) / 0.01)
    assert read(_ctx({gt: 1.0})) is None
    assert read(_ctx({kernel: 0.01}, model=models.load("graphsage"))) is None


def test_lstm_dispatch_ms_reads_the_three_spans_per_item(monkeypatch):
    from bench import spans

    stages = {"batch": {"count": 4, "self_ms": 99.0}, "input-map": {"self_ms": 1.0},
              "recur": {"self_ms": 2.0}, "combine": {"self_ms": 5.0},
              "compute": {"self_ms": 50.0}}
    monkeypatch.setattr(spans, "summary", lambda: {"stages": stages})
    assert _reader("lstm_dispatch_ms")({}) == pytest.approx(8.0 / 4)
    gt_only = {k: v for k, v in stages.items() if k in ("batch", "compute")}
    gt_only.update(query={"self_ms": 1.0}, attend={"self_ms": 1.0})
    monkeypatch.setattr(spans, "summary", lambda: {"stages": gt_only})
    assert _reader("lstm_dispatch_ms")({}) is None  # a Graph Transformer run's spans
    monkeypatch.setattr(spans, "summary", lambda: None)
    assert _reader("lstm_dispatch_ms")({}) is None
