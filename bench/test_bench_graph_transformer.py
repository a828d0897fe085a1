"""The Graph Transformer in the benchmark (``bench/models/graph_transformer.py``,
``configs/gt-products.json``, ``metrics/dot_attn_roofline.py``,
``metrics/gt_dispatch_ms.py``), on the CPU."""

import json
import math
import pathlib

import pytest
import torch

from bench import drive, models
from bench.flops import full_graph_flops, layer_dims, sampled_flops
from bench.harness import _reader, cell_spec, run_cell

HERE = pathlib.Path(__file__).resolve().parent
CELL = "gt-products.offline4096"
GT = models.load("graph_transformer")
SEED = 2**31 + 33


def _config():
    return cell_spec(CELL)[2]


@pytest.fixture
def tiny():
    """A configuration narrow enough for exact loops: 2 and 3 heads of 4, 2 heads
    averaged, 6 features, 3 classes."""
    return {"dataset": {"feat_dim": 6, "num_classes": 3}, "heads": [2, 3, 2], "head_dim": 4,
            "layer_norm_eps": 1e-5, "activation": "relu"}


def test_the_configuration_is_unimps_on_sage_products_graph():
    config = _config()
    gat = cell_spec("gat-products.offline4096")[2]
    assert layer_dims(config) == [100, 512, 512, 47]
    assert (config["model"], config["layers"], config["heads"], config["head_dim"]) == (
        "graph_transformer", 3, [4, 4, 4], 128)
    assert (config["hidden_size"], config["layer_norm_eps"], config["activation"]) == (
        128, 1e-5, "relu")
    assert config["reduced"] == [] and len(config["assumed"]) == 7
    for key in ("dataset", "fanouts", "policy", "n_presample", "cache_mb", "use_kernel", "dedup",
                "prefetch", "pipeline_depth", "precision"):
        assert config[key] == gat[key], key
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "gt-products")
    assert entry["source"] == config["source"] and entry["reduced"] == []
    assert "arXiv:2009.03509" in entry["source"]
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("gt-products", "offline4096", 1)


def test_operations_a_batch_are_pinned():
    """The fewest-operations order at the cell's shapes: 175.32 GFLOP a batch
    (projecting keys and values first would be about 800)."""
    config = _config()
    dims = layer_dims(config)
    per_layer = [GT.layer_flops(rows, rows * f, dims[i], dims[i + 1], config=config, layer=i)
                 for i, (rows, f) in enumerate(((270_336, 15), (24_576, 10), (4096, 5)))]
    assert per_layer == [118_878_633_984, 53_703_868_416, 2_733_572_096]
    assert sampled_flops("graph_transformer", 4096, config["fanouts"], dims,
                         config) == 175_316_074_496
    assert full_graph_flops("graph_transformer", 2_449_029, 61_207_482, dims,
                            config) == 8_804_068_318_512


def test_layer_0s_count_by_hand():
    """Layer 0 term by term: 270,336 destinations, 4,055,040 neighbour slots, 100
    features in, 4 heads of 128 out."""
    n, t, f, h, d, out = 270_336, 4_055_040, 100, 4, 128, 512
    query = 2 * n * f * h * d + n * h * d  # the map and its bias
    fold = 2 * n * h * d * f  # through the key maps
    scores = attend = 2 * t * h * f  # a dot and a weighted add per slot, head and feature
    values = 2 * n * h * f * d + n * out  # the heads' value maps and their bias
    skip = 2 * n * f * out + n * out
    gate = n * out + 2 * n * 3 * out + 2 * n * out  # h' - r, the dot with w_g, the mix
    assert query + fold + scores + attend + values + skip + gate == 118_878_633_984
    assert GT.layer_flops(n, t, f, out, config=_config(), layer=0) == 118_878_633_984


def test_attend_bytes_are_pinned():
    """Layer 0 at the cell's shape with 2,030,047 distinct rows through the
    index; layers 1 and 2 read every position's row in place; each destination
    writes the narrower of its 4 heads' sums and its outputs."""
    config = _config()
    kw = dict(config=config)
    assert GT.attend_bytes(100, 512, layer=0, dst=270_336, positions=4_325_376,
                           distinct_rows=2_030_047, indexed=True, **kw) == 4 * (
        2_030_047 * 100 + 4_325_376 + 270_336 * 400) == 1_261_857_904
    assert GT.attend_bytes(512, 512, layer=1, dst=24_576, positions=270_336,
                           distinct_rows=270_336, indexed=False, **kw) == 4 * (
        270_336 * 512 + 24_576 * 512) == 603_979_776
    assert GT.attend_bytes(512, 47, layer=2, dst=4096, positions=24_576,
                           distinct_rows=24_576, indexed=False, **kw) == 4 * (
        24_576 * 512 + 4096 * 47) == 51_101_696


def _loop_layer(p, x_self, nbr, last):
    """One destination, one head at a time, straight from the paper's equations
    (3)-(6) and LayerNorm."""
    heads, width = p["b_q"].shape
    p = {k: v.double() for k, v in p.items()}
    outs = []
    for i in range(x_self.shape[0]):
        per_head = []
        for k in range(heads):
            cols = slice(k * width, (k + 1) * width)
            q = x_self[i] @ p["w_q"][:, cols] + p["b_q"][k]
            keys = nbr[i] @ p["w_k"][:, cols] + p["b_k"][k]
            vals = nbr[i] @ p["w_v"][:, cols] + p["b_v"][k]
            alpha = torch.softmax(torch.stack([q @ key for key in keys]) / math.sqrt(width), 0)
            per_head.append((alpha[:, None] * vals).sum(0))
        h = torch.stack(per_head).mean(0) if last else torch.cat(per_head)
        r = x_self[i] @ p["w_r"] + p["b_r"]
        beta = torch.sigmoid(torch.cat([h, r, h - r]) @ p["w_g"])
        o = beta * r + (1 - beta) * h
        if not last:
            o = (o - o.mean()) / torch.sqrt(o.var(unbiased=False) + 1e-5) * p["ln_w"] + p["ln_b"]
        outs.append(o)
    return torch.stack(outs)


def test_block_layer_is_the_papers_equations(tiny):
    params = GT.init(tiny, torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    dims = GT.dims(tiny)
    for i, p in enumerate(params):
        last = i == len(params) - 1
        x_self = torch.randn((5, dims[i]), generator=gen, dtype=torch.float64)
        nbr = torch.randn((5, 3, dims[i]), generator=gen, dtype=torch.float64)
        got = GT.block_layer(p, x_self, nbr, 3, torch.float64, last=last)
        torch.testing.assert_close(got, _loop_layer(p, x_self, nbr, last), rtol=1e-12, atol=1e-12)


def test_full_layer_equals_block_layer_where_the_block_is_the_neighbourhood(tiny):
    """Every node with exactly three in-neighbours: the sampled block that takes
    each once is the exact neighbourhood."""
    params = GT.init(tiny, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(4)
    n, fanout = 8, 3
    src = torch.randint(0, n, (n * fanout,), generator=gen, dtype=torch.int32)
    dst = torch.arange(n).repeat_interleave(fanout)
    deg = torch.full((n, 1), float(fanout), dtype=torch.float64)
    dims = GT.dims(tiny)
    for i, p in enumerate(params):
        last = i == len(params) - 1
        x = torch.randn((n, dims[i]), generator=gen, dtype=torch.float64)
        block = GT.block_layer(p, x, x[src.long()].view(n, fanout, -1), fanout, torch.float64,
                               last=last)
        for edge_block in (5, 1 << 20):
            full = GT.full_layer(p, x, dst, src, deg, torch.float64, edge_block, last=last)
            torch.testing.assert_close(full, block, rtol=1e-12, atol=1e-12)


def test_full_layer_gives_a_node_with_no_in_edge_its_gated_skip(tiny):
    params = GT.init(tiny, torch.Generator().manual_seed(7), "cpu")
    p = {k: v.double() for k, v in params[-1].items()}
    x = torch.randn((3, 12), generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    dst, src = torch.tensor([0, 2]), torch.tensor([1, 1], dtype=torch.int32)
    full = GT.full_layer(p, x, dst, src, None, torch.float64, 4, last=True)
    r = x[1] @ p["w_r"] + p["b_r"]
    beta = torch.sigmoid(torch.cat([torch.zeros_like(r), r, -r]) @ p["w_g"])
    torch.testing.assert_close(full[1], beta * r, rtol=1e-12, atol=1e-12)
    assert torch.isfinite(full).all()


def test_block_layer_splits_its_destinations_exactly(tiny, monkeypatch):
    params = GT.init(tiny, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(6)
    x_self = torch.randn((9, 6), generator=gen, dtype=torch.float64)
    nbr = torch.randn((9, 2, 6), generator=gen, dtype=torch.float64)
    whole = GT.block_layer(params[0], x_self, nbr, 2, torch.float64, last=False)
    monkeypatch.setattr(GT, "SUB_ROWS", 4)
    assert torch.equal(GT.block_layer(params[0], x_self, nbr, 2, torch.float64, last=False), whole)


def test_init_holds_the_configuration_to_layer_norm_and_relu(tiny):
    for key, value in (("layer_norm_eps", 1e-6), ("activation", "gelu")):
        with pytest.raises(ValueError, match="LayerNorm"):
            GT.init({**tiny, key: value}, torch.Generator(), "cpu")


def test_the_weights_are_the_seeds():
    config = {**_config(), "head_dim": 8}
    a = drive.make_params(config, SEED, torch.device("cpu"))
    b = drive.make_params(config, SEED, torch.device("cpu"))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    hidden = ["w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_r", "b_r", "w_g", "ln_w", "ln_b"]
    assert [list(p) for p in a] == [hidden, hidden, hidden[:-2]]


@pytest.fixture
def narrow(small):
    """``small`` with heads of 16: the cell's structure at a width a CPU test holds."""
    small["config"]["head_dim"] = 16
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
    assert metrics["gt_dispatch_ms"]["value"] > 0
    assert "dot_attn_roofline" not in metrics  # the CPU launches no dot_attend
    assert "gat_dispatch_ms" not in metrics and "attn_roofline" not in metrics  # GAT's cell's
    assert 0 < metrics["mfu"]["value"] < 100


def _ctx(kernel_s, model=GT, batches=3):
    config = _config()
    out = type("Outcome", (), {"nodes": batches * 4096})()
    return dict(trace={"kernel_s": kernel_s}, gather_groups=[(1_500_000, 530_047, 400)],
                model=model, config=config, mix={"batch_size": 4096}, outcome=out)


def test_dot_attn_roofline_reads_the_least_bytes_over_the_kernels_time():
    read = _reader("dot_attn_roofline")
    kernel = "void (anonymous namespace)::dot_attend_kernel<4>(float const*, int const*"
    gat = "void (anonymous namespace)::gat_attend_kernel<4>(float const*, int const*"
    ctx = _ctx({kernel: 0.002, gat: 5.0, "void gather_blocks_kernel": 1.0})
    layer0 = 4 * (2_030_047 * 100 + 3 * 4_325_376 + 3 * 270_336 * 400)
    rest = 3 * (603_979_776 + 51_101_696)
    assert read(ctx) == pytest.approx(100 * (layer0 + rest) / 3.35e12 / 0.002)
    assert read(_ctx({gat: 1.0})) is None
    assert read(_ctx({kernel: 0.002}, model=models.load("graphsage"))) is None


def test_gt_dispatch_ms_reads_the_four_spans_per_item(monkeypatch):
    from bench import spans

    stages = {"batch": {"count": 4, "self_ms": 99.0}, "query": {"self_ms": 1.0},
              "attend": {"self_ms": 2.0}, "project": {"self_ms": 3.0}, "gate": {"self_ms": 6.0},
              "compute": {"self_ms": 50.0}}
    monkeypatch.setattr(spans, "summary", lambda: {"stages": stages})
    assert _reader("gt_dispatch_ms")({}) == pytest.approx(12.0 / 4)
    gat_only = {k: stages[k] for k in ("batch", "attend", "project")}
    monkeypatch.setattr(spans, "summary", lambda: {"stages": gat_only})
    assert _reader("gt_dispatch_ms")({}) is None  # a GAT run's spans are not the model's
    monkeypatch.setattr(spans, "summary", lambda: None)
    assert _reader("gt_dispatch_ms")({}) is None
