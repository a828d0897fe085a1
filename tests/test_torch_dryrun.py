"""The port's dry-run counter against the JAX package's HLO analysis.

Each step of the port runs once on meta tensors under
``analysis.counts.count_step``; the reference's step is jitted on one CPU
device and its optimized HLO read by ``analyze_hlo``.  On the ten smoke
configs (as they are, bfloat16) prefill and decode count the same matmul
FLOPs exactly, and decode counts the same whether ``cache_len`` is a 0-d
tensor (the masked per-slot route, as the dry-run's abstract inputs give
it) or a host integer (the route that takes B5 on the card).
"""

import pytest
from _torch_dryrun import decode_pair, prefill_pair

from repro.configs import get_smoke as jax_smoke
from repro_torch.configs import ARCH_IDS, get_smoke


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counted_flops_equal_the_reference_hlo(arch, kind, monkeypatch):
    cfg, jcfg = get_smoke(arch), jax_smoke(arch)
    got, want = (prefill_pair(cfg, jcfg) if kind == "prefill"
                 else decode_pair(cfg, jcfg, monkeypatch))
    assert got.flops == want.flops
    # every input's bytes; XLA drops entry parameters the step never reads
    # (RWKV-6's decode never reads cache_len, SeamlessM4T's its encoder's weights)
    assert got.parameter_bytes >= want.parameter_bytes
    assert got.num_whiles == 0 and got.unresolved_trip_counts == 0
    assert sum(got.collective_bytes.values()) == 0
