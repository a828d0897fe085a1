"""The model seam (``bench/models/``): each configuration's widths, weights,
reference layers and operation count come from its model's file, GraphSAGE's
and GCN's bit for bit as before they moved there; on the CPU."""

import ast
import hashlib
import json
import pathlib
import re

import pytest
import torch

from bench import drive, models
from bench import reference as ref
from bench.data import make_graph, sub_seed
from bench.flops import full_graph_flops, layer_dims, sampled_flops
from bench.harness import cell_spec, run_cell

HERE = pathlib.Path(__file__).resolve().parent
SEED = 2**31 + 123

# Read from the code before the move, at the seed above: sha256 (first 32
# hex digits) of every weight's bytes, layer by layer in key order; the
# operations of a batch of 4096 at fan-outs 15,10,5 and of the full graph at
# the stand-in's node and edge counts; the logits of the two reference
# forwards on a 0.2% graph seeded 5 (the sampled one over 6 seeds and a
# frontier drawn by a generator seeded 7).
PINNED = {
    "sage-products": dict(
        dims=[100, 128, 128, 47], weights="0922d3d97fc23678ec0efa5f25ceedd0",
        nodes=2_449_029, edges=61_207_482, sampled=16_035_143_680, full=367_225_404_042,
        graph=(4898, 119_930), block="04dbd88dda88940e66576bbeb5b98e9e",
        full_forward="bcca103e1dd006f6ad47688af6a6719d",
    ),
    "gcn-reddit": dict(
        dims=[602, 128, 128, 41], weights="8c8fdaa95afa0d2333a9af1a6971d9b1",
        nodes=232_965, edges=11_605_996, sampled=45_189_861_376, full=56_208_718_983,
        graph=(465, 20_031), block="dd50b237892410305d613e95f782f4ee",
        full_forward="b778a6a376a7afb5a1bf5a0c1d232f47",
    ),
}
CELLS = {"sage-products": "sage-products.offline4096", "gcn-reddit": "gcn-reddit.offline4096"}


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


def _config(name):
    return cell_spec(CELLS[name])[2]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_widths_weights_and_counts_are_the_pinned_ones(name):
    pin, config = PINNED[name], _config(name)
    dims = layer_dims(config)
    assert dims == pin["dims"]
    params = drive.make_params(config, SEED, torch.device("cpu"))
    assert _digest(*[p[k] for p in params for k in sorted(p)]) == pin["weights"]
    assert sampled_flops(config["model"], 4096, config["fanouts"], dims, config) == pin["sampled"]
    assert full_graph_flops(config["model"], pin["nodes"], pin["edges"], dims, config) == pin["full"]


@pytest.mark.parametrize("name", sorted(PINNED))
def test_reference_forwards_are_the_pinned_ones(name):
    pin, config = PINNED[name], _config(name)
    model = models.load(config["model"])
    params = drive.make_params(config, SEED, torch.device("cpu"))
    data = make_graph(config["dataset"], 5, device="cpu", scale=0.002)
    assert (data.num_nodes, data.num_edges) == pin["graph"]
    feats = torch.as_tensor(data.features)
    batch = 6
    size = ref.frontier_sizes(batch, config["fanouts"])[-1]
    frontier = torch.randint(0, data.num_nodes, (size,), generator=torch.Generator().manual_seed(7))
    whole = ref.block_forward(params, model, feats, frontier, batch, config["fanouts"])
    chunked = ref.block_forward(params, model, feats, frontier, batch, config["fanouts"], chunk_rows=7)
    assert whole.dtype == torch.float64 and _digest(whole) == pin["block"]
    assert torch.equal(whole, chunked)
    col_ptr, rows = torch.as_tensor(data.col_ptr), torch.as_tensor(data.row_index)
    exact = ref.full_forward(params, model, col_ptr, rows, feats)
    assert _digest(exact) == pin["full_forward"]
    assert torch.equal(exact, ref.full_forward(params, model, col_ptr, rows, feats, edge_block=1000))


TOY = '''"""A toy: the mean of the neighbours through one map ``m``, tanh between layers."""
import torch

activation = torch.tanh


def dims(config):
    return [config["dataset"]["feat_dim"], 3, config["dataset"]["num_classes"]]


def init(config, gen, device):
    w = dims(config)
    return [{"m": torch.randn((w[i], w[i + 1]), generator=gen, device=device)}
            for i in range(len(w) - 1)]


def block_layer(p, x_self, nbr, fanout, dtype, *, last):
    return nbr.mean(1) @ p["m"].to(dtype)


def full_layer(p, x, dst, src, deg, dtype, edge_block, *, last):
    agg = torch.zeros_like(x).index_add_(0, dst, x[src.long()])
    return (agg / deg) @ p["m"].to(dtype)


def layer_flops(rows, terms, d_in, d_out, *, config, layer):
    return 1000 * layer + rows + terms
'''


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """A models directory that holds the toy alone, and a configuration of it."""
    config = {**_config("sage-products"), "model": "toy"}
    (tmp_path / "toy.py").write_text(TOY)
    monkeypatch.setattr(models, "HERE", tmp_path)
    return config


def test_a_new_model_is_its_file_alone(toy):
    config = toy
    assert layer_dims(config) == [100, 3, 47]
    params = drive.make_params(config, SEED, torch.device("cpu"))
    gen = torch.Generator().manual_seed(sub_seed(SEED, 2))
    assert [sorted(p) for p in params] == [["m"], ["m"]]
    assert torch.equal(params[0]["m"], torch.randn((100, 3), generator=gen))
    assert torch.equal(params[1]["m"], torch.randn((3, 47), generator=gen))
    model = models.load("toy")
    m0, m1 = (p["m"].double() for p in params)

    # Sampled: one seed, fan-outs 2,2: 3 destinations of the deepest layer.
    feats = torch.randn(20, 100, generator=gen)
    frontier = torch.randint(0, 20, (9,), generator=gen)
    x = feats[frontier].double()
    h = torch.tanh(x[3:9].reshape(3, 2, -1).mean(1) @ m0)
    want = h[1:3].mean(0, keepdim=True) @ m1
    torch.testing.assert_close(ref.block_forward(params, model, feats, frontier, 1, [2, 2]), want)

    # Exact: four nodes, in-neighbours (by CSC column) {1, 2}, {0}, {0, 3}, {2}.
    col_ptr = torch.tensor([0, 2, 3, 5, 6])
    rows = torch.tensor([1, 2, 0, 0, 3, 2], dtype=torch.int32)
    adj = torch.zeros(4, 4, dtype=torch.float64)
    adj[[0, 0, 1, 2, 2, 3], [1, 2, 0, 0, 3, 2]] = 1.0
    mean = adj / adj.sum(1, keepdim=True)
    x = feats[:4].double()
    want = (mean @ torch.tanh((mean @ x) @ m0)) @ m1
    torch.testing.assert_close(ref.full_forward(params, model, col_ptr, rows, feats[:4]), want)

    # Operations: layer 0 counts rows 2 and terms 4, layer 1 adds 1000.
    assert sampled_flops("toy", 2, (2,), [3, 4]) == 2 + 4
    assert full_graph_flops("toy", 5, 9, [3, 4, 2]) == (5 + 9) + (1000 + 5 + 9)


def test_a_model_without_a_file_fails_at_cell_spec(monkeypatch, tmp_path):
    monkeypatch.setattr(models, "HERE", tmp_path)
    name = json.loads((HERE / "configs" / "sage-products.json").read_text())["model"]
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path / f"{name}.py"))):
        cell_spec("sage-products.offline4096")


def test_a_reader_gets_the_model(monkeypatch, small):
    from bench import harness

    seen = []
    monkeypatch.setattr(harness, "_reader", lambda name: lambda ctx: seen.append(ctx["model"]))
    run_cell("gcn-reddit.offline4096", 2**31 + 9, 0.3, False, device="cpu", overrides=small,
             log=lambda msg: None)
    config = _config("gcn-reddit")
    assert seen and all(m.dims(config) == PINNED["gcn-reddit"]["dims"] for m in seen)
    assert {m.__file__ for m in seen} == {str(models.find(config["model"]))}


def test_no_harness_module_branches_on_a_model():
    """Model names live in ``bench/models/``, ``bench/configs/`` and tests."""
    names = {json.loads(p.read_text())["model"] for p in (HERE / "configs").glob("*.json")}
    branch = re.compile(r"""\[["']model["']\]\s*[!=]=|model\s*[!=]=\s*["']""")
    for path in HERE.glob("*.py"):
        if path.name.startswith("test_") or path.name == "conftest.py":
            continue
        text = path.read_text()
        assert not branch.search(text), path.name
        for name in names:
            assert f'"{name}"' not in text and f"'{name}'" not in text, (path.name, name)


@pytest.mark.parametrize("path", sorted((HERE / "models").glob("*.py")), ids=lambda p: p.name)
def test_a_model_file_imports_nothing_of_the_program(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "bench", "importlib", "math", "pathlib", "torch", "types"}
