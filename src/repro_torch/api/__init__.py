"""Public facade of the PyTorch port.

    from repro_torch.api import OverlapIndex

    ix = OverlapIndex.baseline(x)          # runs on "cuda" unless device= is given
    res = ix.search(q, k=10)               # SearchResult(dists, ids, stats)
"""
from repro_torch.api.config import (
    Config,
    ConfigError,
    IndexConfig,
    SearchConfig,
    as_index_config,
)
from repro_torch.api.index import OverlapIndex
from repro_torch.api.plan import PlanCache, PlanKey, SearchPlan, SearchResult

__all__ = [
    "Config", "ConfigError", "IndexConfig", "SearchConfig", "as_index_config",
    "OverlapIndex", "PlanCache", "PlanKey", "SearchPlan", "SearchResult",
]
