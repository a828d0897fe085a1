"""The port's GraphSAGE/GCN forward against the JAX reference.

Parameters come from the reference's ``init_params`` and cross through
``params_from_jax``.  Tolerance: ``rtol = atol = 1e-4`` on float32 logits,
because XLA:CPU and torch sum the fan-out and the matmuls in different
orders.  Within the port the dedup form is bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import models as jmodels
from repro_torch.models.gnn import models as tmodels

# One intra-op thread: these tests share the machine with other test workers.
torch.set_num_threads(1)

FANOUTS = (3, 2)
IN_DIM, CLASSES = 24, 5


def _inputs(seed, num_seeds=16, fanouts=FANOUTS):
    mult = 1
    for f in fanouts:
        mult *= 1 + f
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((num_seeds * mult, IN_DIM)).astype(np.float32)
    return feats


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
@pytest.mark.parametrize("fanouts", [(3, 2), (4, 3, 2)])
def test_forward_matches_jax(model, fanouts):
    jparams = jmodels.init_params(jax.random.PRNGKey(1), model, IN_DIM, CLASSES, n_layers=len(fanouts))
    tparams = tmodels.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in jparams])
    feats = _inputs(2, fanouts=fanouts)
    want = np.array(jmodels.forward(jparams, jnp.asarray(feats), model=model, fanouts=fanouts))
    got = tmodels.forward(tparams, torch.from_numpy(feats), model=model, fanouts=fanouts)
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-4, atol=1e-4)
    module = tmodels.GNN(tparams, model=model, fanouts=fanouts)
    assert torch.equal(module(torch.from_numpy(feats)), got)


@pytest.mark.parametrize("model", ["graphsage", "gcn"])
def test_forward_inverse_index_matches_jax(model):
    """Unique rows + inverse map: close to the reference's own inverse
    form, and bit-identical to the port's duplicate-carrying form."""
    jparams = jmodels.init_params(jax.random.PRNGKey(3), model, IN_DIM, CLASSES, n_layers=2)
    tparams = tmodels.params_from_jax([{k: np.asarray(v) for k, v in p.items()} for p in jparams])
    rng = np.random.default_rng(4)
    uniq = rng.standard_normal((40, IN_DIM)).astype(np.float32)
    inverse = rng.integers(0, 37, 16 * 12).astype(np.int32)  # rows 37-39 are pad, never read
    want = np.array(
        jmodels.forward(jparams, jnp.asarray(uniq), model=model, fanouts=FANOUTS,
                        inverse_index=jnp.asarray(inverse))
    )
    got = tmodels.forward(tparams, torch.from_numpy(uniq), model=model, fanouts=FANOUTS,
                          inverse_index=torch.from_numpy(inverse))
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=1e-4, atol=1e-4)
    dense = tmodels.forward(tparams, torch.from_numpy(uniq[inverse]), model=model, fanouts=FANOUTS)
    assert torch.equal(got, dense)


def test_gcn_divides_by_fanout_plus_one():
    """The sampled GCN layer's mean is over {self} ∪ fanout draws."""
    params = [{"w_self": torch.eye(2), "b": torch.zeros(2)}]
    h = torch.tensor([[3.0, 0.0], [1.0, 1.0], [2.0, 2.0]])  # one seed, fanout 2
    out = tmodels.forward(params, h, model="gcn", fanouts=(2,))
    torch.testing.assert_close(out, torch.tensor([[2.0, 1.0]]))


def test_init_params_shapes_and_seed():
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = tmodels.init_params(gen(), "graphsage", IN_DIM, CLASSES)
    b = tmodels.init_params(gen(), "graphsage", IN_DIM, CLASSES)
    dims = [IN_DIM, 128, 128, CLASSES]
    for i, layer in enumerate(a):
        assert layer["w_self"].shape == layer["w_nbr"].shape == (dims[i], dims[i + 1])
        assert layer["b"].shape == (dims[i + 1],) and not layer["b"].any()
        assert all(torch.equal(layer[k], b[i][k]) for k in layer)
    gcn = tmodels.init_params(gen(), "gcn", IN_DIM, CLASSES, n_layers=2)
    assert len(gcn) == 2 and "w_nbr" not in gcn[0]
    with pytest.raises(ValueError):
        tmodels.init_params(gen(), "gin", IN_DIM, CLASSES)


def test_forward_keeps_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    params = tmodels.init_params(torch.Generator().manual_seed(0), "gcn", IN_DIM, CLASSES)
    tmodels.forward(params, torch.from_numpy(_inputs(0, fanouts=(1, 1, 1))), model="gcn",
                    fanouts=(1, 1, 1))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
