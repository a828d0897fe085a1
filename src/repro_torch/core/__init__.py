"""DCI core: the paper's contribution (allocation + filling + dual cache)."""

from repro_torch.core.allocation import (
    DEFAULT_RESERVE_BYTES,
    CacheAllocation,
    allocate_capacity,
    available_budget,
)
from repro_torch.core.cache import DualCache
from repro_torch.core.policies import POLICIES, PreparedPipeline, prepare
from repro_torch.core.presample import PresampleStats, run_presampling

__all__ = [
    "DEFAULT_RESERVE_BYTES",
    "CacheAllocation",
    "allocate_capacity",
    "available_budget",
    "DualCache",
    "POLICIES",
    "PreparedPipeline",
    "prepare",
    "PresampleStats",
    "run_presampling",
]
