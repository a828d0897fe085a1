"""The port's package re-exports against the JAX package's.

``repro_torch.core``, ``repro_torch.graph`` and ``repro_torch.models.gnn``
export the reference's public names (``__all__`` read from the reference's
``__init__.py`` with ``ast``, so no JAX is imported for it), each bound to
the port's own object; and a module that the packages' ``__init__`` files
reach round a cycle still imports first, alone in a fresh interpreter.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PACKAGES = ["core", "graph", "models/gnn"]


def _reference_all(package: str) -> list[str]:
    tree = ast.parse((SRC / "repro" / package / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in repro/{package}/__init__.py")


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_the_reference_names_from_the_port(package):
    mod = importlib.import_module("repro_torch." + package.replace("/", "."))
    want = _reference_all(package)
    assert list(mod.__all__) == want
    for name in want:
        obj = getattr(mod, name)
        owner = getattr(obj, "__module__", None) or mod.__name__  # constants have none
        assert owner.startswith("repro_torch."), (name, owner)


def test_the_reference_examples_imports_resolve():
    from repro_torch.core import DualCache, prepare, run_presampling  # noqa: F401
    from repro_torch.graph import FeatureStore, load_dataset, sample_blocks  # noqa: F401
    from repro_torch.models.gnn import forward, forward_layer  # noqa: F401

    from repro_torch.core.policies import prepare as direct

    assert prepare is direct


@pytest.mark.parametrize("module", ["repro_torch.runtime.pipeline",
                                    "repro_torch.runtime.gnn_engine", "repro_torch.core.config",
                                    "repro_torch.graph.sampling"])
def test_module_imports_alone_in_a_fresh_interpreter(module):
    out = subprocess.run([sys.executable, "-c", f"import {module}"], capture_output=True,
                         text=True, timeout=120, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
