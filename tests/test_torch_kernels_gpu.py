"""The CUDA gather kernels against ``ref.py`` on the card (marked ``gpu``).

Every test takes the ``cuda`` fixture, which skips when no card is present
— decided inside the fixture, never at import time, so every worker
collects the same tests.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Copies are exact, so every comparison is ``torch.equal``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.config import EngineConfig
from repro_torch.graph.datasets import load_dataset
from repro_torch.kernels.cached_gather import kernel as tk
from repro_torch.kernels.cached_gather.ops import cached_feature_gather
from repro_torch.kernels.cached_gather.ref import cached_gather_ref
from repro_torch.runtime.gnn_engine import GNNInferenceEngine

pytestmark = pytest.mark.gpu

KERNELS = {
    "db": tk.cached_gather,
    "blocks": tk.cached_gather_blocks,
    "select": tk.cached_gather_select,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the H100")
    return torch.device("cuda")


def _tables(cuda, h, n, f, dtype, host_on):
    gen = torch.Generator().manual_seed(h * 1000 + n + f)
    hot = torch.randn((h, f), generator=gen).to(dtype).to(cuda)
    host = torch.randn((n, f), generator=gen).to(dtype)
    host = host.to(cuda) if host_on == "device" else host.pin_memory()
    return hot, host


def _ids(cuda, s, h, n, seed, sorted_runs=False):
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, n, (s,), generator=gen, dtype=torch.int32)
    pos = torch.randint(-1, h, (s,), generator=gen, dtype=torch.int32)
    if sorted_runs:
        idx = torch.sort(idx).values
        pos = torch.where(pos >= 0, torch.arange(s, dtype=torch.int32) % h, pos)
    return idx.to(cuda), pos.to(cuda)


@pytest.mark.parametrize("kind", sorted(KERNELS))
@pytest.mark.parametrize("host_on", ["pinned", "device"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,n,f,s", [(16, 100, 64, 32), (8, 50, 602, 7), (64, 4096, 100, 5000),
                                     (1, 10, 3, 1), (300, 2000, 602, 4099)])
def test_kernel_matches_ref(cuda, kind, host_on, dtype, h, n, f, s):
    hot, host = _tables(cuda, h, n, f, dtype, host_on)
    idx, pos = _ids(cuda, s, h, n, seed=s, sorted_runs=kind == "blocks")
    before = KERNELS[kind].launches
    out = KERNELS[kind](hot, host, idx, pos)
    torch.cuda.synchronize()
    assert KERNELS[kind].launches == before + 1
    assert out.is_cuda and out.dtype == dtype
    assert torch.equal(out, cached_gather_ref(hot, host, idx, pos))


@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_edge_cases(cuda, kind):
    hot, host = _tables(cuda, 12, 40, 602, torch.float32, "pinned")
    s = 24
    ids = torch.arange(s, dtype=torch.int32, device=cuda)
    for pos in (torch.arange(s, dtype=torch.int32, device=cuda) % 12,  # all hits
                torch.full((s,), -1, dtype=torch.int32, device=cuda)):  # all misses
        assert torch.equal(KERNELS[kind](hot, host, ids, pos), cached_gather_ref(hot, host, ids, pos))
    idx = torch.tensor([0, 39, 40, 1000, -3, 5, 7, 2], dtype=torch.int32, device=cuda)
    pos = torch.tensor([-1, 11, 12, -1, 100, -7, 3, 0], dtype=torch.int32, device=cuda)
    assert torch.equal(KERNELS[kind](hot, host, idx, pos), cached_gather_ref(hot, host, idx, pos))
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = KERNELS[kind].launches
    out = KERNELS[kind](hot, host, empty, empty)
    assert out.shape == (0, 602) and KERNELS[kind].launches == before


def test_blocks_runs_and_row_blocks(cuda):
    hot, host = _tables(cuda, 64, 256, 100, torch.float32, "pinned")
    ids = torch.arange(10, 74, dtype=torch.int32, device=cuda)
    hit_run = torch.arange(0, 64, dtype=torch.int32, device=cuda)
    miss_run = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    for pos in (hit_run, miss_run):
        mode, _ = tk.classify_blocks(ids, pos, 64, 256, tk.ROW_BLOCK)
        assert bool((mode > 0).all())
        for rb in (1, 2, 8, 16, 100):
            out = tk.cached_gather_blocks(hot, host, ids[:61], pos[:61], row_block=rb)
            assert torch.equal(out, cached_gather_ref(hot, host, ids[:61], pos[:61]))


def test_wrappers_refuse_what_they_cannot_read(cuda):
    hot, host = _tables(cuda, 4, 20, 16, torch.float32, "device")
    idx, pos = _ids(cuda, 9, 4, 20, seed=1)
    with pytest.raises(ValueError, match="pinned"):
        tk.cached_gather(hot, host.cpu(), idx, pos)  # pageable host memory
    with pytest.raises(ValueError):
        tk.cached_gather(hot, host, idx.cpu(), pos.cpu())  # indices off the card
    with pytest.raises(ValueError):
        tk.cached_gather(hot, host, idx, pos, gather_buffers=0)
    with pytest.raises(ValueError):
        tk.cached_gather_blocks(hot, host, idx, pos, row_block=0)
    with pytest.raises(ValueError, match="use_kernel"):
        cached_feature_gather(hot, host, idx, pos)  # the plain version stays on the CPU
    assert torch.equal(cached_feature_gather(hot, host, idx, pos, use_kernel=True),
                       cached_gather_ref(hot, host, idx, pos))


def test_engine_routes_agree_on_the_card(cuda):
    """Kernel, kernel+dedup and table routes give identical logits, and
    the main path launches kernels #1 and #2."""
    ds = load_dataset("ogbn-products", scale=0.002, seed=0)
    eng = GNNInferenceEngine(ds, fanouts=(4, 3), batch_size=128, device=cuda)
    eng.prepare("dci", total_cache_bytes=300_000, n_presample=2)
    outs = []
    n_db, n_blk = tk.cached_gather.launches, tk.cached_gather_blocks.launches
    for cfg in (EngineConfig(use_kernel=True, pipeline_depth=2),
                EngineConfig(use_kernel=True, dedup=True, pipeline_depth=2),
                EngineConfig(use_kernel=False, pipeline_depth=1)):
        rep = eng.run(config=cfg, max_batches=3, collect_outputs=True)
        outs.append(np.stack(eng.last_outputs))
        assert 0 < rep.feat_hit_rate < 1 and 0 < rep.adj_hit_rate < 1
    assert tk.cached_gather.launches > n_db and tk.cached_gather_blocks.launches > n_blk
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
