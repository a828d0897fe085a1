"""Minimal dependency-free checkpointing: tensor tree <-> .npz with path keys.

The reference's format (``src/repro/checkpoint/io.py``), so that each
package loads the other's files: a leaf's key is its path's dict keys and
sequence indices joined by ``||``, and a bfloat16 leaf is stored as
float32 under ``key@bf16`` (numpy has no bfloat16).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_path, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint"]

_SEP = "||"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            out[_key(path) + "@bf16"] = t.float().numpy()
        else:
            out[_key(path)] = t.numpy()
    return out


def save_checkpoint(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_flatten(tree))


def load_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (shapes validated), each
    leaf on its ``like`` leaf's device, in the stored dtype."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        flat = dict(data.items())

    def restore(path_keys, leaf):
        key = _key(path_keys)
        if key + "@bf16" in flat:
            t = torch.from_numpy(flat[key + "@bf16"]).to(torch.bfloat16)
        else:
            t = torch.from_numpy(flat[key])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint mismatch at {key}: {tuple(t.shape)} vs "
                             f"{tuple(leaf.shape)}")
        return t.to(leaf.device)

    return tree_unflatten(like, [restore(p, leaf) for p, leaf in tree_leaves_with_path(like)])
