"""The port's training step (``launch/steps.py``) and train CLI
(``launch/train.py``) against the JAX package's, on the CPU.

``make_train_step`` on the yi-6b smoke config in float32 from the
reference's parameters: the first three losses and every parameter after
them at atol = rtol = 1e-4.  The reference's end-to-end check
(tests/test_system.py: the loss falls over 30 steps) on the port.  The
CLI runs ``--smoke --device cpu`` with ``--save`` (the checkpoint loads
into the model's tree), and raises without a card unless asked for the
CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.launch.steps import make_train_step as jax_train_step
from repro.models.lm import model as JM
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro_torch.checkpoint.io import load_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import TokenStream, batches
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm.model import init_params, params_from_jax
from repro_torch.optim.adamw import init_adamw
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def test_train_steps_match_the_reference():
    jcfg = dataclasses.replace(jax_smoke("yi-6b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke("yi-6b"), dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    jopt, topt = jax_init_adamw(jp), init_adamw(tp)
    jstep = jax.jit(jax_train_step(jcfg, base_lr=3e-2))
    tstep = make_train_step(cfg, base_lr=3e-2)
    start = [t.clone() for t in tree_leaves(tp)]
    for b in batches(TokenStream(vocab=cfg.vocab, seed=0), batch=2, seq=24, steps=3):
        jp, jopt, jl = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()})
        tp, topt, tl = tstep(tp, topt, {k: torch.from_numpy(v) for k, v in b.items()})
        assert not tl.requires_grad
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):  # both in key order
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert int(topt["step"]) == 3
    assert any(not torch.equal(a, b) for a, b in zip(start, tree_leaves(tp)))


def test_lm_training_loss_decreases():
    """tests/test_system.py::test_lm_training_loss_decreases on the port."""
    cfg = dataclasses.replace(get_smoke("yi-6b"), vocab=512)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    opt = init_adamw(params)
    step = make_train_step(cfg, base_lr=3e-3)
    stream = TokenStream(vocab=cfg.vocab, seed=0)
    losses = []
    for b in batches(stream, batch=4, seq=32, steps=30):
        params, opt, loss = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_cli_trains_on_the_cpu_and_saves_a_checkpoint(tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    losses = train.main(["--arch", "yi-6b", "--smoke", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--log-every", "1", "--save", path])
    printed = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "step     3 loss" in printed and "final loss" in printed and path in printed
    cfg = get_smoke("yi-6b")
    like = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    back = load_checkpoint(path, {"params": like, "opt": init_adamw(like)})
    assert int(back["opt"]["step"]) == 3
    assert tree_leaves(back["params"])[0].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b", "jamba-v0.1-52b"])
def test_cli_trains_the_encoder_decoder_embeds_and_hybrid_archs(arch, capsys):
    losses = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--layers", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])
