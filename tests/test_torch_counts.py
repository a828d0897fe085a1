"""The counter's dot bytes against the JAX package's HLO analysis, in
float32 (smoke configs).

XLA on the CPU computes a bfloat16 dot in float32, so the reference's
optimized HLO holds float32 dot operands for a bfloat16 model; the byte
counts are therefore compared in float32, where both packages' products
have the same operands: prefill and decode count equal dot bytes (and
FLOPs).  Training is in ``test_torch_dryrun_train.py``.
"""

import dataclasses

import pytest

from repro.configs import get_smoke as jax_smoke
from repro_torch.configs import ARCH_IDS, get_smoke
from _torch_dryrun import decode_pair, prefill_pair


def configs(arch):
    return (dataclasses.replace(get_smoke(arch), dtype="float32"),
            dataclasses.replace(jax_smoke(arch), dtype="float32"))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dot_bytes_equal_the_reference_hlo_in_float32(arch, kind, monkeypatch):
    cfg, jcfg = configs(arch)
    got, want = prefill_pair(cfg, jcfg) if kind == "prefill" else decode_pair(cfg, jcfg,
                                                                              monkeypatch)
    assert (got.flops, got.dot_bytes) == (want.flops, want.dot_bytes)


