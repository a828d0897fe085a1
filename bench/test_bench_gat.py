"""GAT in the benchmark (``bench/models/gat.py``, ``configs/gat-products.json``,
``metrics/attn_roofline.py``, ``metrics/gat_dispatch_ms.py``), on the CPU."""

import json
import pathlib

import pytest
import torch

from bench import drive, models
from bench.flops import full_graph_flops, layer_dims, sampled_flops
from bench.harness import _reader, cell_spec, run_cell

HERE = pathlib.Path(__file__).resolve().parent
CELL = "gat-products.offline4096"
GAT = models.load("gat")
SEED = 2**31 + 29


def _config():
    return cell_spec(CELL)[2]


@pytest.fixture
def tiny():
    """A GAT configuration narrow enough for exact loops: 2 and 3 heads of 4,
    2 heads averaged, 6 features, 3 classes."""
    return {"dataset": {"feat_dim": 6, "num_classes": 3}, "heads": [2, 3, 2], "head_dim": 4,
            "residual": [1], "negative_slope": 0.2, "activation": "elu"}


def test_the_configuration_is_the_papers_on_sage_products_graph():
    config = _config()
    sage = cell_spec("sage-products.offline4096")[2]
    assert layer_dims(config) == [100, 1024, 1024, 47]
    assert (config["model"], config["layers"], config["heads"], config["head_dim"]) == (
        "gat", 3, [4, 4, 6], 256)
    assert (config["residual"], config["negative_slope"], config["activation"]) == ([1], 0.2, "elu")
    assert config["reduced"] == []
    for key in ("dataset", "fanouts", "policy", "n_presample", "cache_mb", "use_kernel", "dedup",
                "prefetch", "pipeline_depth", "precision"):
        assert config[key] == sage[key], key
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "gat-products")
    assert entry["source"] == config["source"] and entry["reduced"] == []


def test_operations_a_batch_are_pinned():
    """The fewest-operations order at the cell's shapes: 173.56 GFLOP a batch
    (projecting first would be about 983)."""
    config = _config()
    dims = layer_dims(config)
    per_layer = [GAT.layer_flops(rows, rows * f, dims[i], dims[i + 1], config=config, layer=i)
                 for i, (rows, f) in enumerate(((270_336, 15), (24_576, 10), (4096, 5)))]
    assert per_layer == [62_778_916_864, 107_764_252_672, 3_021_438_976]
    assert sampled_flops("gat", 4096, config["fanouts"], dims, config) == 173_564_608_512
    assert full_graph_flops("gat", 2_449_029, 61_207_482, dims, config) == 14_957_031_512_630


def test_attend_bytes_are_pinned():
    """Layer 0 at the cell's shape with 2,030,047 distinct rows through the
    index; layers 1 and 2 read every position's row in place."""
    config = _config()
    kw = dict(config=config)
    assert GAT.attend_bytes(100, 1024, layer=0, dst=270_336, positions=4_325_376,
                            distinct_rows=2_030_047, indexed=True, **kw) == 1_261_857_904
    assert GAT.attend_bytes(1024, 1024, layer=1, dst=24_576, positions=270_336,
                            distinct_rows=270_336, indexed=False, **kw) == 1_207_959_552
    assert GAT.attend_bytes(1024, 47, layer=2, dst=4096, positions=24_576,
                            distinct_rows=24_576, indexed=False, **kw) == 101_433_344


def _loop_layer(p, x_self, nbr, last):
    """One destination, one head at a time, straight from Eqs. 2-4 and 6."""
    heads, width = p["a_src"].shape
    outs = []
    for i in range(x_self.shape[0]):
        rows = torch.cat([x_self[i:i + 1], nbr[i]])
        per_head = []
        for k in range(heads):
            w = p["w"].double()[:, k * width:(k + 1) * width]
            z = rows @ w
            a = torch.cat([p["a_dst"][k], p["a_src"][k]]).double()
            e = torch.stack([torch.cat([z[0], z[j]]) @ a for j in range(rows.shape[0])])
            alpha = torch.softmax(torch.nn.functional.leaky_relu(e, 0.2), 0)
            per_head.append((alpha[:, None] * z).sum(0))
        y = torch.stack(per_head).mean(0) if last else torch.cat(per_head)
        y = y + p["b"].double()
        if "w_res" in p:
            y = y + x_self[i] @ p["w_res"].double() + p["b_res"].double()
        outs.append(y)
    return torch.stack(outs)


def test_block_layer_is_the_papers_equations(tiny):
    params = GAT.init(tiny, torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    dims = GAT.dims(tiny)
    for i, p in enumerate(params):
        last = i == len(params) - 1
        x_self = torch.randn((5, dims[i]), generator=gen, dtype=torch.float64)
        nbr = torch.randn((5, 3, dims[i]), generator=gen, dtype=torch.float64)
        got = GAT.block_layer(p, x_self, nbr, 3, torch.float64, last=last)
        torch.testing.assert_close(got, _loop_layer(p, x_self, nbr, last), rtol=1e-12, atol=1e-12)


def test_full_layer_equals_block_layer_where_the_block_is_the_neighbourhood(tiny):
    """Every node with exactly three in-neighbours: the sampled block that takes
    each once is the exact neighbourhood."""
    params = GAT.init(tiny, torch.Generator().manual_seed(3), "cpu")
    gen = torch.Generator().manual_seed(4)
    n, fanout = 8, 3
    src = torch.randint(0, n, (n * fanout,), generator=gen, dtype=torch.int32)
    dst = torch.arange(n).repeat_interleave(fanout)
    deg = torch.full((n, 1), float(fanout), dtype=torch.float64)
    dims = GAT.dims(tiny)
    for i, p in enumerate(params):
        last = i == len(params) - 1
        x = torch.randn((n, dims[i]), generator=gen, dtype=torch.float64)
        block = GAT.block_layer(p, x, x[src.long()].view(n, fanout, -1), fanout, torch.float64,
                                last=last)
        for edge_block in (5, 1 << 20):
            full = GAT.full_layer(p, x, dst, src, deg, torch.float64, edge_block, last=last)
            torch.testing.assert_close(full, block, rtol=1e-12, atol=1e-12)


def test_block_layer_splits_its_destinations_exactly(tiny, monkeypatch):
    params = GAT.init(tiny, torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(6)
    x_self = torch.randn((9, 6), generator=gen, dtype=torch.float64)
    nbr = torch.randn((9, 2, 6), generator=gen, dtype=torch.float64)
    whole = GAT.block_layer(params[0], x_self, nbr, 2, torch.float64, last=False)
    monkeypatch.setattr(GAT, "SUB_ROWS", 4)
    assert torch.equal(GAT.block_layer(params[0], x_self, nbr, 2, torch.float64, last=False), whole)


def test_init_holds_the_configuration_to_the_papers_activation(tiny):
    for key, value in (("negative_slope", 0.1), ("activation", "relu")):
        with pytest.raises(ValueError, match="LeakyReLU"):
            GAT.init({**tiny, key: value}, torch.Generator(), "cpu")


def test_the_weights_are_the_seeds(tiny):
    config = _config()
    a = drive.make_params({**config, "head_dim": 8}, SEED, torch.device("cpu"))
    b = drive.make_params({**config, "head_dim": 8}, SEED, torch.device("cpu"))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert [sorted(p) for p in a] == [["a_dst", "a_src", "b", "w"],
                                      ["a_dst", "a_src", "b", "b_res", "w", "w_res"],
                                      ["a_dst", "a_src", "b", "w"]]


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


def test_the_traced_cell_reads_the_gat_spans_and_no_kernel_on_the_cpu(narrow):
    result = run_cell(CELL, SEED + 1, 0.3, True, device="cpu", overrides=narrow,
                      log=lambda m: None)
    metrics = result["metrics"]
    assert metrics["gat_dispatch_ms"]["value"] > 0
    assert "attn_roofline" not in metrics  # the CPU launches no gat_attend
    assert 0 < metrics["mfu"]["value"] < 100


def _ctx(kernel_s, model=GAT, batches=3):
    config = _config()
    out = type("Outcome", (), {"nodes": batches * 4096})()
    return dict(trace={"kernel_s": kernel_s}, gather_groups=[(1_500_000, 530_047, 400)],
                model=model, config=config, mix={"batch_size": 4096}, outcome=out)


def test_attn_roofline_reads_the_least_bytes_over_the_kernels_time():
    read = _reader("attn_roofline")
    kernel = "void (anonymous namespace)::gat_attend_kernel<4, 1, 4>(float const*, int const*"
    ctx = _ctx({kernel: 0.002, "void gather_blocks_kernel": 1.0})
    layer0 = 4 * (2_030_047 * 100 + 3 * 4_325_376 + 3 * 270_336 * 400)
    rest = 3 * (1_207_959_552 + 101_433_344)
    assert read(ctx) == pytest.approx(100 * (layer0 + rest) / 3.35e12 / 0.002)
    assert read(_ctx({"void gather_blocks_kernel": 1.0})) is None
    assert read(_ctx({kernel: 0.002}, model=models.load("graphsage"))) is None
