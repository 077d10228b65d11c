"""Dispatch pricing: targeted (heterogeneous) vs fan-all (homogeneous).

The port of the JAX package's ``repro/distributed/router/cost.py``: DIMS's
split, priced in the repo's own currencies with fleet semantics (a pruned
host receives nothing, so it skips its whole per-query pipeline):

  wire     the ring all-gather rule (``estimator.estimate_allgather_bytes``):
           the kNN merge gathers each participating host's (distance, id)
           top-k;
  route    every participating host routes the query against all I index
           centers (one D-dim read per center);
  bounds   each participating host bounds its non-empty buckets of the
           query's selected indexes (one D-dim pivot read per bound);
  scan     the selected members the host owns, floored at min(kk, host
           size): a participating host's scan spills until its carry holds
           kk candidates even when the query selected nothing it owns;
  router   targeted dispatch also pays for the routing tier itself
           (distance rows to S host centers and I delta pivots).

Every term is a tensor on the device, so ``fanout='auto'`` decides per
query batch without a read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.estimator import estimate_allgather_bytes
from repro_torch.distributed.router.table import RoutingTable

Tensor = torch.Tensor

# one merged candidate on the wire: (f32 distance, i32 id)
_PAIR_BYTES = 8.0


class DispatchCost(NamedTuple):
    """Pricing of one query batch (() f32 tensors, bytes)."""

    cost_targeted: Tensor  # wire + per-host work + routing-tier overhead
    cost_fanall: Tensor  # wire + per-host work at full fan-out
    wire_targeted: Tensor  # est. cross-host all-gather bytes, eligible subset
    wire_fanall: Tensor  # est. cross-host all-gather bytes, whole fleet


def price_dispatch(
    table: RoutingTable, elig: Tensor, sel: Tensor, kk: int, *, n_dim: int
) -> DispatchCost:
    """Price both dispatch modes for a batch with eligibility ``elig``
    (Q, S) and scan selection ``sel`` (Q, I)."""
    qn, s_hosts = elig.shape
    n_idx = table.count_hi.shape[1]
    payload = kk * _PAIR_BYTES
    wire_t = torch.sum(estimate_allgather_bytes(payload, torch.sum(elig, dim=1)))
    # a fill, not a copy from the host: pricing adds no host sync
    wire_a = qn * estimate_allgather_bytes(payload, torch.full(
        (), s_hosts, dtype=torch.float32, device=elig.device))

    vec_bytes = 4.0 * n_dim  # one D-dim f32 row read
    sel_f = sel.to(torch.float32)
    # per-(query, host) work if the host participates
    b_qh = sel_f @ table.nbuckets_hi.T.to(torch.float32)  # bound evaluations
    m_qh = sel_f @ table.count_hi.T.to(torch.float32)  # selected members
    spill = torch.clamp_max(table.host_counts.to(torch.float32), float(kk))
    work_qh = (n_idx + b_qh + torch.maximum(m_qh, spill[None])) * vec_bytes
    work_t = torch.sum(torch.where(elig, work_qh, 0.0))
    work_a = torch.sum(work_qh)

    # routing-tier overhead the homogeneous path skips: per query, distance
    # rows to S host centers and I delta pivots
    overhead = qn * (s_hosts + n_idx) * vec_bytes
    return DispatchCost(
        cost_targeted=wire_t + work_t + overhead,
        cost_fanall=wire_a + work_a,
        wire_targeted=wire_t,
        wire_fanall=wire_a,
    )
