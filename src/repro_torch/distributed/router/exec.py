"""``routed_search``: the routing tier composed over the shard islands.

The port of the JAX package's ``repro/distributed/router/exec.py``: the
contract of ``knn_island.sharded_search`` with one more trailing element,
:class:`RouterStats`.  The routing math (eligibility and pricing) runs once,
on island 0's device, and its decision reaches the islands as
``sharded_search``'s ``host_sel``.

Fanout (``RoutingConfig.fanout``):
  'all'       homogeneous: ``host_sel=None``, the plain sharded search (the
              router only reports the eligibility it would have used);
  'targeted'  heterogeneous: always mask to the eligible hosts;
  'auto'      the cost model's choice per query batch, kept on the device:
              ``host_sel = elig | ~targeted`` with ``targeted`` a tensor, so
              the fan-all branch is an all-True mask (arithmetically the
              identity) and no bool is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import knn as cknn
from repro_torch.core.metric import pairwise
from repro_torch.distributed import knn_island
from repro_torch.distributed.router.cost import price_dispatch
from repro_torch.distributed.router.table import RoutingTable, host_eligibility

Tensor = torch.Tensor


class RouterStats(NamedTuple):
    """Per-batch routing telemetry (tensors on island 0's device)."""

    eligible_hosts: Tensor  # (Q,) i32 hosts the lower bounds could not prune
    pruned_hosts: Tensor  # (Q,) i32 hosts actually skipped after the decision
    targeted: Tensor  # () bool: heterogeneous dispatch chosen
    wire_targeted: Tensor  # () f32 est. cross-host bytes, eligible subset
    wire_fanall: Tensor  # () f32 est. cross-host bytes, whole fleet
    cost_targeted: Tensor  # () f32 full targeted price (wire + work + overhead)
    cost_fanall: Tensor  # () f32 full fan-all price


def route_dispatch(
    mesh,
    forest: knn_island.IslandForest,
    q: Tensor,
    delta: tuple[cknn.DeltaView, ...] | None,
    table: RoutingTable,
    *,
    k: int,
    mode: str = "forest",
    kernel: bool = True,
    fanout: str = "auto",
) -> tuple[Tensor | None, RouterStats]:
    """The routing tier's decision for one query batch, on island 0's
    device: (host_sel (Q, S) bool or None for fan-all, RouterStats)."""
    dev0 = mesh.devices[0]
    s_hosts = mesh.size
    q0 = q.to(dev0)
    qn, n_dim = q0.shape
    f0 = forest.parts[0]
    n_idx = f0.index_centers.shape[0]
    w, cap = f0.bucket_x.shape[:2]
    n_cap = s_hosts * w * cap
    if delta is not None:
        n_cap += s_hosts * delta[0].x.shape[0] * delta[0].x.shape[1]
    kk = min(k, n_cap)

    d_sq, _ = cknn.route_points(f0.index_centers, q0, kernel=kernel)
    d_center = torch.sqrt(d_sq)
    sel, _, _ = cknn.route_select(f0, q0, mode=mode, kernel=kernel)
    d_host = pairwise(q0, table.host_centers, metric="l2", use_kernel=kernel)
    dkw = {}
    if delta is not None:
        # live buffer state of the logical rows (the islands' rows in order;
        # pad rows never hold members)
        pivot = torch.cat([d.pivot.to(dev0) for d in delta])[:n_idx]
        dkw = dict(
            d_delta=pairwise(q0, pivot, metric="l2", use_kernel=kernel),
            delta_radius=torch.cat([d.radius.to(dev0) for d in delta])[:n_idx],
            delta_count=torch.cat([
                torch.sum(d.mask, dim=1, dtype=torch.int32).to(dev0) for d in delta
            ])[:n_idx],
        )
    elig, _ = host_eligibility(table, d_center, d_host, sel, kk, **dkw)
    cost = price_dispatch(table, elig, sel, kk, n_dim=n_dim)

    if fanout == "all":
        host_sel = None
        targeted = torch.zeros((), dtype=torch.bool, device=dev0)
    elif fanout == "targeted":
        host_sel = elig
        targeted = torch.ones((), dtype=torch.bool, device=dev0)
    elif fanout == "auto":
        targeted = cost.cost_targeted < cost.cost_fanall
        host_sel = elig | ~targeted
    else:
        raise ValueError(f"fanout {fanout!r}")
    pruned = (
        torch.zeros((qn,), dtype=torch.int32, device=dev0) if host_sel is None
        else torch.sum(~host_sel, dim=1, dtype=torch.int32)
    )
    router = RouterStats(
        eligible_hosts=torch.sum(elig, dim=1, dtype=torch.int32),
        pruned_hosts=pruned,
        targeted=targeted,
        wire_targeted=cost.wire_targeted,
        wire_fanall=cost.wire_fanall,
        cost_targeted=cost.cost_targeted,
        cost_fanall=cost.cost_fanall,
    )
    return host_sel, router


def routed_search(
    mesh,
    forest: knn_island.IslandForest,
    q: Tensor,
    delta: tuple[cknn.DeltaView, ...] | None,
    table: RoutingTable,
    *,
    k: int,
    mode: str = "forest",
    beam: int = 1,
    kernel: bool = True,
    fanout: str = "auto",
    per_island: bool = False,
    explain: bool = False,
) -> tuple:
    """Routing tier + shard islands: ``sharded_search``'s tuple with
    ``RouterStats`` appended.  The results equal fan-all's and the single
    layout's bit for bit: the rule prunes only hosts whose lower bound
    clears an upper bound on the merged kth-best (``table.py``)."""
    host_sel, router = route_dispatch(mesh, forest, q, delta, table, k=k, mode=mode,
                                      kernel=kernel, fanout=fanout)
    outs = knn_island.sharded_search(
        mesh, forest, q, delta, k=k, mode=mode, beam=beam, kernel=kernel,
        per_island=per_island, explain=explain, host_sel=host_sel,
    )
    return (*outs, router)
