"""DCI's technique applied to LM serving — the cross-domain integration.

The paper's recipe is domain-agnostic:

  1. profile a small pre-serving workload sample, timing the two candidate
     stages (Eq. 1 inputs) and counting per-item visits;
  2. split one device-memory budget across two caches proportionally to the
     measured stage times (``core.allocation.allocate_capacity`` — the very
     same Eq. 1 implementation the GNN path uses);
  3. fill each cache with the sort-free above-mean heuristic.

For a transformer server the two gather-heavy stages are **embedding
rows** (vocab up to 256k × d_model; token frequency is zipfian — the
"node features" of this domain) and **expert weights** (MoE).  For a
dense config the expert stage takes no time, so Eq. 1 gives the whole
budget to the embedding cache (DCI's SCI special case).  The expert
branch (an MoE config) raises until ROADMAP A-item 18.2 ports MoE.

``build_serving_caches`` profiles token frequencies from a request sample
and returns the resident hot rows as a ``FeatureStore`` (hot table on the
params' device, the full fp32 table in pinned host memory beside a card)
with its position map.  On the card each embedding gather is timed up to
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.allocation import CacheAllocation, allocate_capacity
from repro_torch.graph.features import FeatureStore, build_feature_cache
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.moe import MOE_UNPORTED

__all__ = ["ServingCaches", "profile_and_allocate", "build_serving_caches"]


@dataclasses.dataclass
class ServingCaches:
    allocation: CacheAllocation
    embed_cache: FeatureStore  # hot embedding rows (position-map + hot table)
    hot_experts: np.ndarray | None  # expert ids resident per the budget
    expert_bytes_each: int
    token_counts: np.ndarray
    expert_counts: np.ndarray | None

    def embed_hit_rate(self, tokens: np.ndarray) -> float:
        pos = self.embed_cache.position_np()[np.asarray(tokens).reshape(-1)]
        return float((pos >= 0).mean())

    def expert_hit_rate(self, expert_ids: np.ndarray) -> float:
        """0.0: no expert cache (dense configs; MoE is not ported)."""
        return 0.0


def profile_and_allocate(
    cfg: LMConfig,
    params: dict,
    sample_tokens: np.ndarray,  # [n_req, seq] request sample (pre-serving)
    *,
    total_cache_bytes: int,
) -> tuple[CacheAllocation, np.ndarray, np.ndarray | None, list[float], list[float]]:
    """Stage timing + visit counting over the request sample (paper §IV-A/B).

    Stage A = embedding gather; stage B = expert selection (MoE, not
    ported) or nothing (dense: the split degenerates to all-embedding)."""
    if cfg.moe is not None:
        raise NotImplementedError(MOE_UNPORTED)
    embed = params["embed"]
    t_embed: list[float] = []
    t_expert: list[float] = []
    token_counts = np.zeros(cfg.vocab_padded, np.int64)
    for req in sample_tokens:
        ids = torch.as_tensor(np.asarray(req), device=embed.device).long()
        t0 = time.perf_counter()
        rows = embed[ids]
        if rows.is_cuda:
            torch.cuda.synchronize(rows.device)
        t_embed.append(time.perf_counter() - t0)
        np.add.at(token_counts, np.asarray(req), 1)
        t_expert.append(0.0)
    alloc = allocate_capacity(t_expert, t_embed, total_cache_bytes)
    # Eq.1 convention: "sample"-like stage (expert selection) ↔ adj budget.
    return alloc, token_counts, None, t_embed, t_expert


def build_serving_caches(
    cfg: LMConfig,
    params: dict,
    sample_tokens: np.ndarray,
    *,
    total_cache_bytes: int,
) -> ServingCaches:
    alloc, token_counts, expert_counts, _, _ = profile_and_allocate(
        cfg, params, sample_tokens, total_cache_bytes=total_cache_bytes
    )
    embed_np = params["embed"].float().cpu().numpy()
    embed_cache = build_feature_cache(embed_np, token_counts, alloc.feat_bytes,
                                      device=params["embed"].device)
    return ServingCaches(
        allocation=alloc,
        embed_cache=embed_cache,
        hot_experts=None,
        expert_bytes_each=0,
        token_counts=token_counts,
        expert_counts=expert_counts,
    )
