"""The replicated routing table and the per-query host-pruning rule.

The port of the JAX package's ``repro/distributed/router/table.py``.

``build_routing_table`` runs on the host (numpy, f64 accumulation) over the
logical (unpadded, unquantized) forest at build, load and rebuild-swap time,
and mirrors the island placement exactly: bucket rows pad to
``ceil(NB/S)*S`` and island ``s`` owns the contiguous slice
``[s*W, (s+1)*W)``; delta rows pad to ``ceil(I/S)*S`` likewise.  A table
built for another island count would mis-describe ownership, so the routed
backend rebuilds it whenever the forest or the island count changes.

``host_eligibility`` is the pruning rule, on the device:

  upper bound   sort every selected region cover (per-(host, index) bucket
                covers ``d(q, c_i) + radius_hi[h, i]`` and per-index delta
                covers ``d(q, delta_pivot_i) + delta_radius_i``) by bound and
                take the bound at which the cumulative member count first
                reaches ``kk``: at least ``kk`` selected members lie within
                ``ub_sel``, so the merged kth-best cannot exceed it.  Fewer
                than ``kk`` selected members: ``+inf`` (nothing is pruned;
                the scan's underfill spill may reach anything).
  lower bound   per host, the selection-independent floor over everything
                the host could contribute: ``d(q, host_center) -
                host_radius`` (or the tighter per-(host, index) region
                floor) for its forest members, and ``d(q, delta_pivot_i) -
                delta_radius_i`` over its owned non-empty delta rows.

A host is pruned iff its lower bound exceeds ``ub_sel`` plus a small
relative margin for f32 rounding; every candidate it could produce then
lies beyond the merged kth-best, so masking it changes nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# relative inflation applied to host-side covers before the f64 -> f32 cast:
# keeps every table radius a true upper bound after rounding
_COVER_SLACK = 1e-5
# relative slack on the eligibility comparison, for f32 rounding in the
# device-side distance arithmetic
_ELIG_MARGIN = 1e-4


class RoutingTable(NamedTuple):
    """Per-host routing state (f32/i32, O(S * I))."""

    host_centers: Tensor  # (S, D) f32 member-weighted pivot centroid per host
    host_radii: Tensor  # (S,) f32 cover of all owned forest members
    host_counts: Tensor  # (S,) i32 owned forest member counts
    radius_hi: Tensor  # (S, I) f32 cover of host s's index-i members around c_i
    count_hi: Tensor  # (S, I) i32 members of index i living on host s
    nbuckets_hi: Tensor  # (S, I) i32 non-empty buckets of index i on host s
    delta_owned: Tensor  # (S, I) bool: host s owns index i's delta buffer
    host_rates: Tensor  # (S, S) f32 registered overlap rates between regions


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_owners(nb: int, shards: int) -> np.ndarray:
    """(NB,) owner island per real bucket row under the island padding."""
    w = _ceil_to(max(nb, 1), shards) // shards
    return (np.arange(nb) // w).astype(np.int32)


def _conservative_f32(a: np.ndarray) -> np.ndarray:
    return ((1.0 + _COVER_SLACK) * a + _COVER_SLACK).astype(np.float32)


def _dequantized_members(xs: np.ndarray) -> np.ndarray:
    """The int8 round trip of ``kernels/ops.quantize_datastore`` in numpy
    (the same f32 operations; ``np.rint`` rounds half to even as
    ``torch.round`` does): the positions an int8 scan measures."""
    nb, cap, dim = xs.shape
    flat = xs.reshape(nb * cap, dim).astype(np.float32)
    scale = np.maximum(np.max(np.abs(flat), axis=1), 1e-8) / 127.0
    xq = np.clip(np.rint(flat / scale[:, None]), -127, 127)
    return (xq.astype(np.float32) * scale[:, None].astype(np.float32)).reshape(nb, cap, dim)


def build_routing_table(
    f, shards: int, *, method: str = "dbm", quantize: bool = False, device=None
) -> RoutingTable:
    """Host-side table build from the logical forest ``f`` (ForestArrays),
    placed on ``device`` (default: the CPU).  ``method`` resolves through the
    overlap-method registry and rates the host regions; object-based methods
    see the real members with their owner host.

    ``quantize=True`` mirrors an int8 layout: the scan measures distances to
    the dequantized members, so every cover is taken around those."""
    from repro_torch.core.overlap import get_overlap_method

    pivots = np.asarray(f.bucket_pivot, np.float64)  # (NB, D)
    radii = np.asarray(f.bucket_radius, np.float64)  # (NB,)
    mask = np.asarray(f.bucket_mask)  # (NB, C)
    bidx = np.asarray(f.bucket_index, np.int64)  # (NB,)
    centers = np.asarray(f.index_centers, np.float64)  # (I, D)
    nb, n_idx = pivots.shape[0], centers.shape[0]
    counts = mask.sum(axis=1).astype(np.int64)  # (NB,)
    owner = shard_owners(nb, shards)
    members = np.asarray(f.bucket_x, np.float32)  # (NB, C, D)
    if quantize:
        members = _dequantized_members(members)
        d_pm = np.linalg.norm(members.astype(np.float64) - pivots[:, None, :], axis=2)
        radii = np.where(mask, d_pm, 0.0).max(axis=1)

    host_centers = np.zeros((shards, pivots.shape[1]), np.float64)
    host_radii = np.zeros((shards,), np.float64)
    host_counts = np.zeros((shards,), np.int64)
    radius_hi = np.zeros((shards, n_idx), np.float64)
    count_hi = np.zeros((shards, n_idx), np.int64)
    nbuckets_hi = np.zeros((shards, n_idx), np.int64)
    # cover of index i's members around c_i, per bucket: d(c_i, pivot_b) + r_b
    d_cb = np.linalg.norm(centers[bidx.clip(0, n_idx - 1)] - pivots, axis=1) + radii
    for s in range(shards):
        rows = (owner == s) & (counts > 0)
        host_counts[s] = counts[rows].sum()
        if host_counts[s] == 0:
            continue
        host_centers[s] = (pivots[rows] * counts[rows, None]).sum(axis=0) / host_counts[s]
        host_radii[s] = (
            np.linalg.norm(pivots[rows] - host_centers[s], axis=1) + radii[rows]
        ).max()
        np.add.at(count_hi[s], bidx[rows], counts[rows])
        np.add.at(nbuckets_hi[s], bidx[rows], 1)
        np.maximum.at(radius_hi[s], bidx[rows], d_cb[rows])

    # delta-row ownership mirrors the island padding of the delta buffers
    wd = _ceil_to(max(n_idx, 1), shards) // shards
    delta_owned = (np.arange(n_idx) // wd)[None, :] == np.arange(shards)[:, None]

    entry = get_overlap_method(method)
    x_m = assign_m = None
    if entry.needs_objects:
        x_m = torch.from_numpy(np.ascontiguousarray(members[mask]))
        assign_m = torch.from_numpy(
            np.ascontiguousarray(np.broadcast_to(owner[:, None], mask.shape)[mask]))
    rates = entry.matrix_fn(
        torch.from_numpy(host_centers.astype(np.float32)),
        torch.from_numpy(host_radii.astype(np.float32)),
        x=x_m,
        assign=assign_m,
    )

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return RoutingTable(
        host_centers=put(host_centers.astype(np.float32), torch.float32),
        host_radii=put(_conservative_f32(host_radii), torch.float32),
        host_counts=put(host_counts.astype(np.int32), torch.int32),
        radius_hi=put(_conservative_f32(radius_hi), torch.float32),
        count_hi=put(count_hi.astype(np.int32), torch.int32),
        nbuckets_hi=put(nbuckets_hi.astype(np.int32), torch.int32),
        delta_owned=put(delta_owned, torch.bool),
        host_rates=rates.to(device=device, dtype=torch.float32),
    )


def host_eligibility(
    table: RoutingTable,
    d_center: Tensor,
    d_host: Tensor,
    sel: Tensor,
    kk: int,
    *,
    d_delta: Tensor | None = None,
    delta_radius: Tensor | None = None,
    delta_count: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """(elig (Q, S) bool, ub_sel (Q,) f32): the pruning rule.

    ``d_center`` (Q, I) and ``d_host`` (Q, S) are L2 distances to the index
    centers and host-region centers; ``sel`` (Q, I) is the selection the
    scan will use (before host masking).  The delta keywords carry the live
    buffer state (pivot distances, radii, member counts of the logical I
    rows)."""
    s_hosts, n_idx = table.count_hi.shape
    qn = d_center.shape[0]
    inf = float("inf")

    # --- upper bound on the merged kth-best from selected region covers ---
    valid_hi = sel[:, None, :] & (table.count_hi > 0)[None]  # (Q, S, I)
    vals = torch.where(valid_hi, d_center[:, None, :] + table.radius_hi[None], inf).reshape(
        qn, s_hosts * n_idx)
    cnts = torch.where(valid_hi, table.count_hi[None], 0).reshape(qn, s_hosts * n_idx)
    if d_delta is not None:
        dvalid = sel & (delta_count > 0)[None]  # (Q, I)
        vals = torch.cat([vals, torch.where(dvalid, d_delta + delta_radius[None], inf)], dim=1)
        cnts = torch.cat([cnts, torch.where(dvalid, delta_count[None], 0)], dim=1)
    # stable, as jnp.argsort is
    vals_s, order = torch.sort(vals, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(cnts, 1, order), dim=1)
    reached = cum >= kk
    # first position reaching kk (argmax of a bool row: the first True)
    pos = torch.argmax(reached.to(torch.int32), dim=1)
    filled = cum[:, -1] >= kk
    ub_sel = torch.where(filled, torch.gather(vals_s, 1, pos[:, None])[:, 0], inf)

    # --- per-host lower bound over everything the host could contribute ---
    # two valid covers of the host's forest members, the tighter one taken:
    # the host ball, and the min over its (host, index) regions
    lb_ball = torch.where(
        (table.host_counts > 0)[None],
        torch.clamp_min(d_host - table.host_radii[None], 0.0),
        inf,
    )  # (Q, S)
    lb_region = torch.amin(
        torch.where(
            (table.count_hi > 0)[None],
            torch.clamp_min(d_center[:, None, :] - table.radius_hi[None], 0.0),
            inf,
        ),
        dim=2,
    )  # (Q, S); +inf for empty hosts, as lb_ball
    lb = torch.maximum(lb_ball, lb_region)
    if d_delta is not None:
        lb_d_i = torch.clamp_min(d_delta - delta_radius[None], 0.0)  # (Q, I)
        own_ne = table.delta_owned & (delta_count > 0)[None]  # (S, I)
        lb_d = torch.amin(torch.where(own_ne[None], lb_d_i[:, None, :], inf), dim=2)  # (Q, S)
        lb = torch.minimum(lb, lb_d)

    margin = _ELIG_MARGIN * (1.0 + torch.where(torch.isinf(ub_sel), 0.0, ub_sel))
    # empty hosts (lb == +inf) stay ineligible even when ub_sel == +inf
    elig = (lb <= ub_sel[:, None] + margin[:, None]) & ~torch.isinf(lb)
    return elig, ub_sel
