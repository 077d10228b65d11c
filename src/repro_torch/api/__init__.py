"""Public facade of the PyTorch port.

    from repro_torch.api import OverlapIndex

    ix = OverlapIndex.build(x, cfg)        # the paper's overlap forest, on "cuda"
    ix = OverlapIndex.baseline(x)          # the BCCF baseline; device= names another
    res = ix.search(q, k=10)               # SearchResult(dists, ids, stats)
    ix.ingest(batch)                       # streaming writes (delta buffers)
    ix.maintain()                          # overlap-drift monitor + rebuilds
    ds = ix.to_datastore(values)           # kNN-LM serving datastore

Overlap heuristics resolve through ``register_overlap_method`` /
``available_overlap_methods`` (VBM, DBM and OBM are the built-in entries).
"""
from repro_torch.api.config import (
    Config,
    ConfigError,
    IndexConfig,
    SearchConfig,
    StreamConfig,
    as_index_config,
)
from repro_torch.api.index import OverlapIndex
from repro_torch.api.plan import PlanCache, PlanKey, SearchPlan, SearchResult
from repro_torch.core.overlap import (
    available_overlap_methods,
    register_overlap_method,
    unregister_overlap_method,
)

__all__ = [
    "Config", "ConfigError", "IndexConfig", "SearchConfig", "StreamConfig", "as_index_config",
    "OverlapIndex", "PlanCache", "PlanKey", "SearchPlan", "SearchResult",
    "available_overlap_methods", "register_overlap_method",
    "unregister_overlap_method",
]
