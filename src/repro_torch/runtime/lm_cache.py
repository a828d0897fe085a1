"""DCI's technique applied to LM serving — the cross-domain integration.

The paper's recipe is domain-agnostic:

  1. profile a small pre-serving workload sample, timing the two candidate
     stages (Eq. 1 inputs) and counting per-item visits;
  2. split one device-memory budget across two caches proportionally to the
     measured stage times (``core.allocation.allocate_capacity`` — the very
     same Eq. 1 implementation the GNN path uses);
  3. fill each cache with the sort-free above-mean heuristic.

For a transformer server the two gather-heavy stages are:

  * **embedding rows** (vocab up to 256k × d_model; token frequency is
    zipfian — the "node features" of this domain), and
  * **expert weights** (MoE: router selections are the "adjacency"
    workload; a decode batch touches a hot subset of experts).

For a dense config the expert stage takes no time, so Eq. 1 gives the
whole budget to the embedding cache (DCI's SCI special case).

``build_serving_caches`` profiles token and expert frequencies from a
request sample and returns the resident hot rows as a ``FeatureStore``
(hot table on the params' device, the full fp32 table in pinned host
memory beside a card) with its position map, and the hot experts.  As in
the reference, the expert cache is accounting: it names the experts
Eq. 1's share holds and counts their hits; no expert weights are paged.
On the card each stage lap is timed up to ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.allocation import CacheAllocation, allocate_capacity
from repro_torch.graph.features import FeatureStore, build_feature_cache
from repro_torch.models.lm.config import LMConfig

__all__ = ["ServingCaches", "profile_and_allocate", "build_serving_caches", "router_top_k"]


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
        if self.hot_experts is None:
            return 0.0
        resident = np.zeros(int(self.expert_counts.shape[0]), bool)
        resident[self.hot_experts] = True
        return float(resident[np.asarray(expert_ids).reshape(-1)].mean())


def _expert_param_bytes(cfg: LMConfig) -> int:
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert  # we1/we2/we3
    return per_expert * 2 * cfg.n_layers // max(m.every, 1)  # bf16


def _first_router(cfg: LMConfig, params: dict) -> torch.Tensor | None:
    """The first MoE block's router (any pattern position carrying
    ``moe``), repeat 0; None for a dense config."""
    if cfg.moe is None:
        return None
    for pos in range(cfg.pattern_period):
        if "moe" in params["blocks"][pos]:
            return params["blocks"][pos]["moe"]["router"][0]
    return None


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def router_top_k(cfg: LMConfig, params: dict, tokens: np.ndarray) -> np.ndarray | None:
    """The experts the first MoE block's router picks (top-k of its
    logits) for ``tokens``' embedding rows, as the profile counts them;
    None for a dense config."""
    router = _first_router(cfg, params)
    if router is None:
        return None
    ids = torch.as_tensor(np.asarray(tokens), device=params["embed"].device).long()
    logits = params["embed"][ids].float() @ router
    return torch.topk(logits, cfg.moe.top_k).indices.cpu().numpy()


def profile_and_allocate(
    cfg: LMConfig,
    params: dict,
    sample_tokens: np.ndarray,  # [n_req, seq] request sample (pre-serving)
    *,
    total_cache_bytes: int,
) -> tuple[CacheAllocation, np.ndarray, np.ndarray | None, list[float], list[float]]:
    """Stage timing + visit counting over the request sample (paper §IV-A/B).

    Stage A = embedding gather; stage B = expert selection (the first MoE
    block's router top-k) for MoE, or nothing for a dense config (the
    split then degenerates to all-embedding, DCI's SCI special case)."""
    embed = params["embed"]
    t_embed: list[float] = []
    t_expert: list[float] = []
    token_counts = np.zeros(cfg.vocab_padded, np.int64)
    expert_counts = np.zeros(cfg.moe.n_experts, np.int64) if cfg.moe is not None else None
    router = _first_router(cfg, params)
    for req in sample_tokens:
        ids = torch.as_tensor(np.asarray(req), device=embed.device).long()
        t0 = time.perf_counter()
        rows = embed[ids]
        _sync(rows)
        t_embed.append(time.perf_counter() - t0)
        np.add.at(token_counts, np.asarray(req), 1)
        if router is not None:
            t0 = time.perf_counter()
            top = torch.topk(rows.float() @ router, cfg.moe.top_k).indices
            _sync(top)
            t_expert.append(time.perf_counter() - t0)
            np.add.at(expert_counts, top.cpu().numpy().reshape(-1), 1)
        else:
            t_expert.append(0.0)
    alloc = allocate_capacity(t_expert, t_embed, total_cache_bytes)
    # Eq.1 convention: "sample"-like stage (expert selection) ↔ adj budget.
    return alloc, token_counts, expert_counts, t_embed, t_expert


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

    hot_experts = None
    per_expert = 0
    if cfg.moe is not None and expert_counts is not None:
        # The reference's accounting: _expert_param_bytes is one expert's
        # bytes over every MoE layer, divided here by the expert count again.
        per_expert = _expert_param_bytes(cfg) // cfg.moe.n_experts
        budget = max(alloc.adj_bytes // max(per_expert, 1), 0)
        mean = expert_counts.mean()
        hot = np.nonzero(expert_counts > mean)[0]
        if len(hot) > budget:
            hot = hot[np.argsort(-expert_counts[hot], kind="stable")[:budget]]
        elif len(hot) < budget:
            rest = np.nonzero(expert_counts <= mean)[0]
            rest = rest[np.argsort(-expert_counts[rest], kind="stable")]
            hot = np.concatenate([hot, rest[: budget - len(hot)]])
        hot_experts = np.sort(hot.astype(np.int32))

    return ServingCaches(
        allocation=alloc,
        embed_cache=embed_cache,
        hot_experts=hot_experts,
        expert_bytes_each=per_expert,
        token_counts=token_counts,
        expert_counts=expert_counts,
    )
