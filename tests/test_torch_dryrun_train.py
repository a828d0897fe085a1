"""The port's training step counted on meta tensors against the JAX
package's ``value_and_grad(train_loss)`` HLO (float32 smoke configs, both
remat policies).  The port counts more by named terms only:

* the CE chunk's recompute: the port checkpoints each 512-token loss
  chunk, so its backward pass runs the logits product ``[B*S, d] x [d, V]``
  once more (2*B*S*d*V FLOPs, that product's operand and result bytes);
* outer products in the backward pass of the per-token scans: the
  gradient of a per-token ``einsum`` against a state (RWKV-6's ``r @ (S +
  u k^T v)``, Mamba's ``h @ c_t``) forms an outer product, a contraction
  of size 1.  torch's autograd runs it as ``bmm`` with k = 1, which the
  counter counts; XLA's algebraic simplifier turns a dot with a unit
  contraction into a multiply, which ``analyze_hlo`` does not.  RWKV-6:
  one ``[B*H, Dk, 1] x [B*H, 1, Dv]`` per token and layer; Jamba: one
  ``[B, d_inner, 1] x [B, 1, d_state]`` per token and Mamba layer.
"""

import dataclasses

import jax
import pytest
import torch
from _torch_dryrun import B, S, jax_params, reference_counts, sds

from repro.configs import get_smoke as jax_smoke
from repro.models.lm import model as JM
from repro.models.lm import tp as JTP
from repro_torch.analysis.counts import count_step
from repro_torch.configs import ARCH_IDS, InputShape, get_smoke
from repro_torch.launch import specs as TS
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import model as TM
from repro_torch.models.lm import tp as TTP
from repro_torch.utils.tree import tree_leaves, tree_map

F32 = 4


def configs(arch):
    return (dataclasses.replace(get_smoke(arch), dtype="float32"),
            dataclasses.replace(jax_smoke(arch), dtype="float32"))


def named_terms(cfg) -> tuple[int, int]:
    """(FLOPs, dot bytes) the port's training step counts beyond the
    reference's: the CE recompute and the scans' outer products."""
    t, d, v = B * S, cfg.d_model, cfg.vocab_padded
    flops, nbytes = 2 * t * d * v, F32 * (t * d + d * v + t * v)
    kinds = cfg.block_pattern
    if "rwkv" in kinds:
        h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        n = cfg.n_layers * S
        flops += n * 2 * B * h * dh * dh
        nbytes += n * F32 * (B * h * dh + B * h * dh + B * h * dh * dh)
    if "mamba" in kinds:
        d_inner, d_state = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
        n = cfg.n_layers // len(kinds) * kinds.count("mamba") * S
        flops += n * 2 * B * d_inner * d_state
        nbytes += n * F32 * (B * d_inner + B * d_state + B * d_inner * d_state)
    return flops, nbytes


@pytest.mark.parametrize("policy", [None, "dots"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_counts_the_reference_plus_named_terms(arch, policy):
    """The train step (loss, gradients, AdamW) against the reference's
    ``value_and_grad`` of ``train_loss``, under either remat policy."""
    cfg, jcfg = configs(arch)
    params, opt, batch = TS.abstract_train_inputs(cfg, InputShape("smoke", S, B, "train"))

    def grads(p, b):
        tracked = tree_map(lambda x: x.detach().requires_grad_(), p)
        with torch.enable_grad():
            return torch.autograd.grad(TM.train_loss(tracked, b, cfg), tree_leaves(tracked))

    TTP.set_remat_policy(policy)
    JTP.set_remat_policy(policy)
    try:
        _, got = count_step(grads, params, batch)
        _, step = count_step(make_train_step(cfg), params, opt, batch)
        want = reference_counts(jax.value_and_grad(lambda p, b: JM.train_loss(p, b, jcfg)),
                                jax_params(jcfg), tree_map(sds, batch))
    finally:
        TTP.set_remat_policy(None)
        JTP.set_remat_policy(None)
    flops, nbytes = named_terms(cfg)
    assert (got.flops, got.dot_bytes) == (want.flops + flops, want.dot_bytes + nbytes)
    assert (step.flops, step.dot_bytes) == (got.flops, got.dot_bytes)  # AdamW has no product
