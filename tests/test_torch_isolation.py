"""The port stays separate from the JAX package, and never hides the card.

``src/repro_torch`` imports neither ``jax`` nor the reference package
``repro``; importing its engine leaves ``jax`` out of ``sys.modules``; and
an entry point with no card and no ``device="cpu"`` raises.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.allocation import CacheAllocation
from repro_torch.core.cache import DualCache
from repro_torch.core.policies import prepare
from repro_torch.device import resolve_device
from repro_torch.graph.datasets import load_dataset
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CHIP_SMOKE = PORT.parents[1] / "chip_smoke.py"


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
    ids=lambda p: str(p.relative_to(PORT.parents[1])),
)
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_engine_import_leaves_jax_out():
    code = (
        "import sys, repro_torch.runtime.gnn_engine, repro_torch.launch.infer_gnn; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120
    )
    assert out.stdout.strip() == "[]"


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = load_dataset("reddit", scale=0.001, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GNNInferenceEngine(ds, fanouts=(2,), batch_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare("dgl", ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DualCache.build(
            ds,
            node_counts=np.zeros(ds.num_nodes, np.int32),
            edge_counts=np.zeros(ds.graph.num_edges, np.int32),
            allocation=CacheAllocation(0, 0, 0, 0.0),
        )
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_raises_without_a_card(monkeypatch):
    from repro_torch.launch import infer_gnn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer_gnn.main(["--dataset", "reddit", "--scale", "0.001"])


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card chip_smoke exits non-zero and prints no result — from
    the repo and from a directory holding nothing but the script."""
    for cwd, script in ((PORT.parents[1], CHIP_SMOKE), (tmp_path, tmp_path / "chip_smoke.py")):
        if script != CHIP_SMOKE:
            script.write_text(CHIP_SMOKE.read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
