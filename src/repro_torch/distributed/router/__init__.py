"""Routing tier over the shard islands (DIMS-style).

A small per-host :class:`RoutingTable` (host-region centers, radii, member
counts, per-(host, index) covers and the registered overlap rates between
host regions) lets the router answer, per query, which hosts can hold a
top-k member from metric lower bounds alone, and a cost model prices the
targeted dispatch against full fan-out with the all-gather rule of
``estimator.estimate_allgather_bytes``.

``table.py`` builds the table and holds the eligibility rule; ``cost.py``
prices targeted vs fan-all; ``exec.py`` composes both with
``knn_island.sharded_search`` (its ``host_sel``) into ``routed_search``:
the same results, fewer hosts doing work.
"""
from repro_torch.distributed.router.cost import DispatchCost, price_dispatch
from repro_torch.distributed.router.exec import RouterStats, route_dispatch, routed_search
from repro_torch.distributed.router.table import (
    RoutingTable,
    build_routing_table,
    host_eligibility,
    shard_owners,
)

__all__ = [
    "DispatchCost",
    "RouterStats",
    "RoutingTable",
    "build_routing_table",
    "host_eligibility",
    "price_dispatch",
    "route_dispatch",
    "routed_search",
    "shard_owners",
]
