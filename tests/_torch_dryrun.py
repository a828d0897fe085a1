"""Shared set-up of the dry-run counter tests (``tests/test_torch_dryrun*.py``,
``test_torch_counts.py``): the port's step counted on meta tensors beside
the reference's jitted on one CPU device and read by ``analyze_hlo``."""

import jax
import jax.numpy as jnp
import torch

from repro.analysis.hlo import analyze_hlo
from repro.launch import specs as JS
from repro.models.lm import model as JM
from repro_torch.analysis.counts import count_step
from repro_torch.configs import InputShape
from repro_torch.launch import specs as TS
from repro_torch.models.lm import model as TM
from repro_torch.utils.tree import tree_map

B, S = 2, 16
_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}


def sds(t: torch.Tensor):
    """A meta tensor as the reference's ShapeDtypeStruct."""
    return jax.ShapeDtypeStruct(tuple(t.shape), _JAX_DTYPES[t.dtype])


def reference_counts(fn, *abstract):
    return analyze_hlo(jax.jit(fn).lower(*abstract).compile().as_text())


def jax_params(jcfg):
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))


def prefill_pair(cfg, jcfg):
    params, batch = TS.abstract_prefill_inputs(cfg, InputShape("smoke", S, B, "prefill"))
    _, got = count_step(lambda p, b: TM.prefill(p, b, cfg, cache_size=S), params, batch)
    want = reference_counts(lambda p, b: JM.prefill(p, b, jcfg, cache_size=S), jax_params(jcfg),
                            tree_map(sds, batch))
    return got, want


def decode_pair(cfg, jcfg, monkeypatch):
    monkeypatch.setattr(TS, "DECODE_ENC_LEN", S)
    monkeypatch.setattr(JS, "DECODE_ENC_LEN", S)
    params, tokens, caches, cache_len = TS.abstract_decode_inputs(
        cfg, InputShape("smoke", S, B, "decode"), long_mode=False)
    _, got = count_step(lambda *a: TM.decode_step(*a, cfg), params, tokens, caches, cache_len)
    _, host = count_step(lambda p, t, c: TM.decode_step(p, t, c, S - 1, cfg), params, tokens,
                         caches)
    assert host.flops == got.flops and host.dot_bytes == got.dot_bytes
    want = reference_counts(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg), jax_params(jcfg),
                            sds(tokens), JS.abstract_caches(jcfg, B, S, long_mode=False),
                            sds(cache_len))
    return got, want
