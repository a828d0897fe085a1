"""Cache-filling algorithms (paper §IV-B), re-exported from their homes.

The implementations live next to the data structures they fill:
  * adjacency cache (Alg. 1): ``repro_torch.graph.csc.two_level_sort`` +
    ``repro_torch.graph.csc.build_adj_cache``
  * feature cache (sort-free above-mean fill):
    ``repro_torch.graph.features.build_feature_cache``

This module is the documented entry point for "the filling algorithm" as a
concept; ``core.cache.DualCache.build`` composes them.
"""

from repro_torch.graph.csc import build_adj_cache, two_level_sort
from repro_torch.graph.features import build_feature_cache

__all__ = ["build_adj_cache", "two_level_sort", "build_feature_cache"]
