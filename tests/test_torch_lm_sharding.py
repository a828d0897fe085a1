"""The port's sharding rules against the JAX package's PartitionSpecs.

Specs are plain tuples in the port, ``PartitionSpec``s in the reference;
leaves are matched by path (dict keys and tuple indices).  Every arch's
full config: parameter specs equal the reference's leaf for leaf, and
every ``model``-sharded dimension divides by 16 (the reference's
tests/test_infra.py check that keeps configs dry-run compatible).  Batch
and cache specs equal the reference's on the same trees, on one pod's
and two pods' data axes.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec
from jax.tree_util import DictKey, SequenceKey
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.launch import specs as JS
from repro.models.lm import model as JM
from repro.models.lm import sharding as JSH
from repro_torch.configs import ARCH_IDS, InputShape, get_config, get_smoke
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models.lm.model import abstract_params
from repro_torch.models.lm import sharding as SH
from repro_torch.utils.tree import tree_leaves_with_path

ONE_POD, TWO_PODS = ("data",), ("pod", "data")


def _ref_specs(tree) -> dict:
    """The reference's spec tree as {path: spec tuple}."""
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec)):
        key = tuple(p.key if isinstance(p, DictKey) else p.idx for p in path
                    if isinstance(p, (DictKey, SequenceKey)))
        out[key] = tuple(spec)
    return out


def _port_specs(spec_tree, tree) -> dict:
    paths = [p for p, _ in tree_leaves_with_path(tree)]
    specs = SH.spec_leaves(spec_tree)
    assert len(paths) == len(specs)
    return dict(zip(paths, specs))


def _padded(spec: tuple, nd: int) -> tuple:
    return tuple(spec) + (None,) * (nd - len(spec))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference_and_divide_by_16(arch):
    params = abstract_params(get_config(arch))
    got = _port_specs(SH.param_specs(params), params)
    want = _ref_specs(JSH.param_specs(JM.abstract_params(jax_config(arch))))
    assert got.keys() == want.keys()
    leaves = dict(tree_leaves_with_path(params))
    for path, spec in got.items():
        assert _padded(spec, leaves[path].dim()) == _padded(want[path], leaves[path].dim()), path
        assert len(spec) <= leaves[path].dim(), (path, spec)
        for size, axis in zip(leaves[path].shape, spec):
            if axis == "model":
                assert size % 16 == 0, f"{path}: {size} % 16 != 0"


@pytest.mark.parametrize("axes", [ONE_POD, TWO_PODS], ids=["one_pod", "two_pods"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch, axes):
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    _, _, batch = TS.abstract_train_inputs(cfg, InputShape("smoke", 16, 2, "train"))
    jbatch = JS._batch_dict(jcfg, 2, 16, labels=True)
    assert _port_specs(SH.batch_specs(batch, axes), batch) == _ref_specs(
        JSH.batch_specs(jbatch, axes))
    caches = TS.abstract_caches(cfg, 2, 16, long_mode=False)
    jcaches = JS.abstract_caches(jcfg, 2, 16, long_mode=False)
    for ba in (axes, ()):
        assert _port_specs(SH.cache_specs(caches, ba), caches) == _ref_specs(
            JSH.cache_specs(jcaches, ba))


def test_to_placements_gives_one_placement_per_mesh_axis():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert SH.to_placements(one, ("model", None)) == (Replicate(), Shard(0))
    assert SH.to_placements(one, (None, None, "model")) == (Replicate(), Shard(2))
    assert SH.to_placements(two, (TWO_PODS, None, "model")) == (Shard(0), Shard(0), Shard(2))
    assert SH.to_placements(two, ()) == (Replicate(),) * 3
    tree = {"a": ("model", None), "b": ({"c": (None,)},)}
    assert SH.to_placements(one, tree) == {"a": (Replicate(), Shard(0)),
                                           "b": ({"c": (Replicate(), Replicate())},)}
    with pytest.raises(ValueError, match="twice"):
        SH.to_placements(one, ("model", "model"))
    with pytest.raises(ValueError, match="not in"):
        SH.to_placements(one, ("pod",))
    assert SH.data_axes(one) == ONE_POD and SH.data_axes(two) == TWO_PODS
    assert (one.shape, one.size, two.axis_names) == ({"data": 16, "model": 16}, 256,
                                                     ("pod", "data", "model"))
    assert AbstractMesh(("data", "model"), (1, 1)).label() == "1x1"


def test_param_leaf_names_come_from_the_dict_keys_on_the_path():
    """A leaf's name is its last dict key: ``scale`` under ``ln_x`` shards,
    any other ``scale`` replicates; tuple indices are not names."""
    tree = {"blocks": ({"tm": {"ln_x": {"scale": torch.empty(4, 64, device="meta")}},
                        "norm": {"scale": torch.empty(4, 64, device="meta")},
                        "w2": torch.empty(4, 64, 32, device="meta")},)}
    specs = SH.param_specs(tree)
    assert specs["blocks"][0]["tm"]["ln_x"]["scale"] == (None, "model")
    assert specs["blocks"][0]["norm"]["scale"] == (None, None)
    assert specs["blocks"][0]["w2"] == (None, "model", None)
