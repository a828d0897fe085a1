"""The port's AdamW (``optim/adamw.py``) and checkpoints
(``checkpoint/io.py``) against the JAX package's, on the CPU.

AdamW: three steps on one tree of float32 and bfloat16 leaves with the
same gradients: float32 parameters and the moments at rtol 1e-6, bfloat16
parameters equal or one ulp apart (a float32 difference in the last place
can round to the other bfloat16), the step count exactly; the cosine
schedule at rtol 1e-6.  Checkpoints: each package loads the other's
``.npz`` bit for bit, and both write the same keys.
"""


import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as JIO
from repro.configs import get_smoke as jax_smoke
from repro.models.lm import model as JM
from repro.optim import adamw as JA
from repro_torch.checkpoint import io as TIO
from repro_torch.models.lm.model import params_from_jax
from repro_torch.optim import adamw as TA
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)


def _tree(rng):
    return {
        "w": rng.standard_normal((4, 8)).astype(np.float32),
        "blocks": ({"a": rng.standard_normal((16,)).astype(ml_dtypes.bfloat16),
                    "b": rng.standard_normal((3, 5)).astype(np.float32)},
                   {"a": (0.1 * rng.standard_normal((2, 7))).astype(ml_dtypes.bfloat16)}),
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().astype(np.int32) if t.dtype == torch.bfloat16 else None


@pytest.mark.parametrize("lr,base_lr", [(None, 0.5), (1e-2, 3e-4)])
def test_adamw_three_steps_match_the_reference(lr, base_lr):
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, _tree(rng))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jstate, tstate = JA.init_adamw(jp), TA.init_adamw(tp)
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    assert all(m.dtype == torch.float32 for m in tree_leaves(tstate["m"]))
    for _ in range(3):
        grads = _tree(rng)
        jp, jstate = JA.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jstate, lr=lr,
                                     base_lr=base_lr)
        tp, tstate = TA.adamw_update(tp, params_from_jax(grads), tstate, lr=lr, base_lr=base_lr)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for field in ("m", "v"):
        for t, j in zip(tree_leaves(tstate[field]), jax.tree.leaves(jstate[field])):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert str(t.dtype) == f"torch.{j.dtype}"
        if t.dtype == torch.bfloat16:
            want = np.asarray(j).view(np.int16).astype(np.int32)
            assert np.abs(_bits(t) - want).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_adamw_leaves_its_inputs_as_they_were():
    tp = params_from_jax(_tree(np.random.default_rng(1)))
    state = TA.init_adamw(tp)
    before = [t.clone() for t in tree_leaves(tp)]
    TA.adamw_update(tp, params_from_jax(_tree(np.random.default_rng(2))), state, lr=0.1)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))
    assert int(state["step"]) == 0 and not any(m.any() for m in tree_leaves(state["m"]))


def test_cosine_schedule_matches_the_reference():
    steps = np.array([0, 1, 2, 50, 99, 100, 101, 1234, 5000, 9999, 10_000, 20_000], np.int32)
    for kw in ({}, dict(base_lr=1e-3, warmup=10, total=500, min_frac=0.0)):
        got = TA.cosine_schedule(torch.from_numpy(steps), **kw).numpy()
        want = np.asarray(JA.cosine_schedule(jnp.asarray(steps), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _state_trees():
    """The reference's smoke parameters (bfloat16 weights, float32 norm
    scales) and AdamW state after one step, and the same trees in the port."""
    jcfg = jax_smoke("gemma-2b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = JA.adamw_update(jp, jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), jp),
                             JA.init_adamw(jp), lr=0.01)[1]
    jtree = {"params": jp, "opt": jstate}
    return jtree, params_from_jax(jax.tree.map(np.asarray, jtree))


def _equal_bits(t_tree, j_tree):
    got, want = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(got) == len(want)
    for t, j in zip(got, want):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def test_checkpoints_load_across_the_packages_bit_for_bit(tmp_path):
    jtree, ttree = _state_trees()
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(ttree))
    JIO.save_checkpoint(str(tmp_path / "jax.npz"), jtree)
    TIO.save_checkpoint(str(tmp_path / "port.npz"), ttree)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files)
        assert any(k.endswith("@bf16") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    # JAX save -> port load, and port save -> JAX load.
    zeros = jax.tree.map(lambda t: torch.zeros_like(t), ttree,
                         is_leaf=lambda x: isinstance(x, torch.Tensor))
    _equal_bits(TIO.load_checkpoint(str(tmp_path / "jax.npz"), zeros), jtree)
    _equal_bits(ttree, JIO.load_checkpoint(str(tmp_path / "port"), jtree))


def test_load_checkpoint_validates_shapes(tmp_path):
    TIO.save_checkpoint(str(tmp_path / "c.npz"), {"a": torch.zeros(3, 4), "b": (torch.ones(2),)})
    with pytest.raises(ValueError, match="a"):
        TIO.load_checkpoint(str(tmp_path / "c.npz"), {"a": torch.zeros(4, 3),
                                                      "b": (torch.ones(2),)})
    back = TIO.load_checkpoint(str(tmp_path / "c"), {"a": torch.empty(3, 4), "b": (torch.empty(2),)})
    assert isinstance(back["b"], tuple) and torch.equal(back["b"][0], torch.ones(2))
