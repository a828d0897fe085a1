"""Sharding rules: per-leaf parameter, batch and cache specs.

Classification is by leaf name (parameters are named for their
parallelism style): column-parallel weights shard the output feature dim
on ``model``, row-parallel ones the input dim, MoE expert tensors the
expert dim (expert parallelism), embeddings the vocab dim.  Leading
stacking dims (the repeat axis, the MoE expert axis where explicit) are
padded with ``None``.

Batch dims shard over the data axes (``("pod", "data")`` on two pods);
KV-cache *sequence* dims shard over ``model``, which is uniform and
always divisible, unlike kv-head counts (1 to 16 across the zoo).

A spec is a plain tuple with one entry per dimension: an axis name, a
tuple of axis names, or ``None`` (replicated).  Spec trees keep their
tree's layout (dicts and tuples); the leaf names come from the dict keys
on each leaf's path.  ``to_placements`` turns a spec into
``torch.distributed.tensor`` placements, one per mesh axis.
"""

from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from repro_torch.utils.tree import tree_leaves_with_path, tree_unflatten

__all__ = [
    "param_specs",
    "batch_specs",
    "cache_specs",
    "to_placements",
    "data_axes",
    "is_spec",
    "spec_leaves",
    "entry_axes",
]

# output-feature (last dim) on model
_COL = {
    "wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w1", "w3", "in_proj", "dt_proj",
    "w_r", "w_k", "w_v", "w_g", "w_in", "w_lora_b", "lm_head", "conv_w", "u_bonus",
}
# input-feature (second-to-last dim) on model
_ROW = {"wo", "w_o", "w2", "out_proj", "x_proj", "w_out"}
# expert-parallel: (E, d, ff) etc, expert dim on model
_EXPERT = {"we1", "we2", "we3"}
# 1-D vectors over a model-sharded feature dim
_VEC = {"conv_b", "dt_bias", "d_skip"}
_REPL = {"router", "mu", "w0", "w_lora_a", "w_dq", "w_dkv", "w_kr", "b"}


def _names(path: tuple) -> list[str]:
    return [k for k in path if isinstance(k, str)]


def _pad(nd: int, tail: tuple) -> tuple:
    return (None,) * (nd - len(tail)) + tuple(tail)


def _map_with_path(fn, tree):
    return tree_unflatten(tree, [fn(path, leaf) for path, leaf in tree_leaves_with_path(tree)])


def _param_leaf_spec(path: tuple, leaf) -> tuple:
    names = _names(path)
    name = names[-1] if names else ""
    nd = leaf.dim()
    if name == "embed":
        return ("model", None)
    if name == "scale":
        if len(names) >= 2 and names[-2] == "ln_x":
            return _pad(nd, ("model",))
        return (None,) * nd
    if name in _EXPERT:
        return _pad(nd, ("model", None, None))
    if name in _COL:
        return _pad(nd, (None, "model"))
    if name in _ROW:
        return _pad(nd, ("model", None))
    if name in _VEC:
        return _pad(nd, ("model",))
    if name == "a_log":
        return _pad(nd, ("model", None))
    # _REPL, scalars and anything unclassified (norm scales, biases): replicated
    return (None,) * nd


def param_specs(params):
    return _map_with_path(_param_leaf_spec, params)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _entry(axes: tuple):
    """A dim's spec entry for ``axes``: None, the one name, or the names
    (as ``PartitionSpec`` normalizes a tuple of one name)."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def batch_specs(batch, batch_axes: tuple):
    first = _entry(batch_axes)
    return _map_with_path(lambda path, x: (first,) + (None,) * (x.dim() - 1), batch)


def _cache_leaf_spec(path: tuple, leaf, batch_axes: tuple) -> tuple:
    names = _names(path)
    name = names[-1] if names else ""
    ba = _entry(batch_axes)
    # All cache leaves are stacked over repeats: leading R dim, then batch.
    if name in ("k", "v"):  # (R, B, S, Hkv, Dh)
        return (None, ba, "model", None, None)
    if name in ("c_kv", "k_rope"):  # (R, B, S, r)
        return (None, ba, "model", None)
    if name == "conv":  # (R, B, d_conv-1, d_inner)
        return (None, ba, None, "model")
    if name == "ssm":  # (R, B, d_inner, d_state)
        return (None, ba, "model", None)
    if name == "state":  # (R, B, H, Dk, Dv) -> shard Dk
        return (None, ba, None, "model", None)
    if name == "shift":  # (R, B, d)
        return (None, ba, None)
    return (None,) * leaf.dim()


def cache_specs(caches, batch_axes: tuple):
    return _map_with_path(lambda p, leaf: _cache_leaf_spec(p, leaf, batch_axes), caches)


def entry_axes(entry) -> tuple:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def is_spec(x) -> bool:
    """A spec tuple: every entry ``None``, an axis name or a tuple of names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and e
                                            and all(isinstance(a, str) for a in e))
        for e in x)


def spec_leaves(spec_tree) -> list[tuple]:
    """The specs of a spec tree, in its leaves' order."""
    if is_spec(spec_tree):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for v in spec_tree.values() for s in spec_leaves(v)]
    if isinstance(spec_tree, (tuple, list)):
        return [s for v in spec_tree for s in spec_leaves(v)]
    if spec_tree is None:
        return []
    raise TypeError(f"not a spec tree: {spec_tree!r}")


def _placements(mesh, spec: tuple) -> tuple:
    dim_of = {}
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a in dim_of:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            dim_of[a] = dim
    unknown = set(dim_of) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not in {mesh.axis_names}")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh.axis_names)


def to_placements(mesh, spec_tree):
    """Each spec of ``spec_tree`` as ``torch.distributed.tensor``
    placements, one per mesh axis: ``Shard(dim)`` where the spec puts
    that axis on ``dim``, else ``Replicate()``.  Needs no process group."""
    if is_spec(spec_tree):
        return _placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: to_placements(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (tuple, list)):
        return type(spec_tree)(to_placements(mesh, v) for v in spec_tree)
    raise TypeError(f"not a spec tree: {spec_tree!r}")
