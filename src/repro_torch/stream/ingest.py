"""Streaming ingestion: batched inserts into per-index delta buffers.

The port of the JAX package's ``repro/stream/ingest.py``.  Every index owns
one fixed-capacity **delta bucket**, a device-resident tail laid out like
the forest's buckets (coordinates, global ids, -1 padding).  A batch is

  1. routed to its nearest index center (Alg. 2 STEP 1, the same
     ``core.knn.route_points`` the search uses: K2 on the card),
  2. appended into that index's buffer (a point past capacity is reported
     rejected, so the caller can run maintenance and retry it),
  3. folded into per-index running sums (count, coordinate sum, max
     distance to the buffer pivot), so the drift monitor recomputes the
     index geometry without reading the points again.

The search reads the buffers through ``core.knn.DeltaView``
(``delta_view``): one extra bucket per index, scanned by K1 as a second
phase seeded with the main phase's top-k.

Every function here is functional: it returns new tensors and never writes
into its inputs, so a caller may run a probe ingest and throw the result
away (``serve.retrieval.ingest_keys`` does).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.forest import ForestArrays
from repro_torch.core.knn import DeltaView, DeviceForest, route_points

Tensor = torch.Tensor


class DeltaBuffer(NamedTuple):
    """Per-index streaming append buffers and maintenance bookkeeping.

    The first five fields are the search-facing state (``delta_view``); the
    rest feed the drift monitor: the updated index centroid is
    ``(main_sum + sum_x) / (main_count + count)``.  ``dropped`` counts
    capacity-rejected appends per index; a nonzero entry is a standing
    maintenance trigger.
    """

    x: Tensor  # (I, CAPD, D) f32 member coords, zero pad
    ids: Tensor  # (I, CAPD) i32 global object ids, -1 pad
    count: Tensor  # (I,) i32 live members per buffer
    pivot: Tensor  # (I, D) f32 frozen bound reference (index center at alloc)
    radius: Tensor  # (I,) f32 running max d(member, pivot)
    sum_x: Tensor  # (I, D) f32 running coordinate sum of delta members
    main_count: Tensor  # (I,) i32 member count of the frozen main forest
    main_sum: Tensor  # (I, D) f32 coordinate sum of the frozen main members
    main_radius: Tensor  # (I,) f32 frozen index radius (about ``pivot``)
    dropped: Tensor  # (I,) i32 capacity-rejected appends since alloc

    @property
    def capacity(self) -> int:
        return int(self.x.shape[1])


def main_index_sums(forest: ForestArrays) -> tuple[np.ndarray, np.ndarray]:
    """Per-index (member count, coordinate sum) of the frozen forest: f64
    sums in numpy, rounded to f32 once, as the JAX package computes them."""
    n_idx = forest.n_indexes
    dim = forest.bucket_x.shape[2]
    counts = np.zeros((n_idx,), np.int32)
    sums = np.zeros((n_idx, dim), np.float64)
    bcount = forest.bucket_mask.sum(axis=1)
    bsum = (forest.bucket_x * forest.bucket_mask[..., None]).sum(axis=1)
    np.add.at(counts, forest.bucket_index, bcount.astype(np.int32))
    np.add.at(sums, forest.bucket_index, bsum)
    return counts, sums.astype(np.float32)


def alloc_delta(forest: ForestArrays, capacity: int, *, device) -> DeltaBuffer:
    """Empty delta buffers on ``device`` for every index of ``forest``."""
    n_idx = forest.n_indexes
    dim = forest.bucket_x.shape[2]
    main_count, main_sum = main_index_sums(forest)

    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return DeltaBuffer(
        x=torch.zeros((n_idx, capacity, dim), dtype=torch.float32, device=device),
        ids=torch.full((n_idx, capacity), -1, dtype=torch.int32, device=device),
        count=torch.zeros((n_idx,), dtype=torch.int32, device=device),
        pivot=put(forest.index_centers, torch.float32),
        radius=torch.zeros((n_idx,), dtype=torch.float32, device=device),
        sum_x=torch.zeros((n_idx, dim), dtype=torch.float32, device=device),
        main_count=put(main_count, torch.int32),
        main_sum=put(main_sum, torch.float32),
        main_radius=put(forest.index_radii, torch.float32),
        dropped=torch.zeros((n_idx,), dtype=torch.int32, device=device),
    )


def delta_view(delta: DeltaBuffer) -> DeltaView:
    """Search-facing view (``core.knn.DeltaView``) of the append buffers."""
    slots = torch.arange(delta.x.shape[1], device=delta.count.device)
    mask = slots[None, :] < delta.count[:, None]
    return DeltaView(x=delta.x, ids=delta.ids, mask=mask, pivot=delta.pivot,
                     radius=delta.radius)


def _drop_scatter(base: Tensor, rows: Tensor, vals: Tensor, ok: Tensor) -> Tensor:
    """``base`` with ``base.view(-1, ...)[rows[j]] = vals[j]`` where ``ok[j]``,
    as a new tensor: the rows that are not ok go to one extra trash row that
    is cut off again (the JAX package's ``mode="drop"``, without a mask
    that would need the host)."""
    n = base.shape[0]
    flat = torch.cat([base, base.new_zeros((1,) + tuple(base.shape[1:]))])
    flat.index_put_((torch.where(ok, rows, n),), vals)
    return flat[:n]


def _segment_sums(sum_x: Tensor, xb: Tensor, idx: Tensor, keep: Tensor,
                  order: Tensor) -> Tensor:
    """``sum_x`` plus the kept rows of ``xb`` added per destination index.

    On the CPU the rows are added one by one in batch order, as the JAX
    package's scatter-add does there.  A float ``index_add_`` on a CUDA
    device adds in no fixed order, so there the destination-sorted batch is
    summed run by run (``torch.segment_reduce``, each run in batch order)
    and each run's sum is added once: the same sums from run to run.
    """
    n_idx = sum_x.shape[0]
    add = torch.where(keep[:, None], xb, 0.0)
    if not xb.is_cuda:
        buf = torch.cat([sum_x, sum_x.new_zeros((1, sum_x.shape[1]))])
        return buf.index_add_(0, idx.long(), add)[:n_idx]
    runs = torch.bincount(idx.long(), minlength=n_idx + 1)  # parked rows: run I
    seg = torch.segment_reduce(add[order], "sum", lengths=runs, axis=0)
    return sum_x + seg[:n_idx]


def append_routed(
    delta: DeltaBuffer, xb: Tensor, ids: Tensor, idx: Tensor, valid: Tensor
) -> tuple[DeltaBuffer, Tensor]:
    """Append one already-routed batch; returns (new delta, accepted (B,)).

    ``idx`` (B,) i32 is each row's destination buffer; a value equal to the
    buffer count parks the row: it is written nowhere, takes no slot and
    counts nowhere, not even in ``dropped``.  ``valid`` (B,) bool marks the
    rows really in the batch this round (``accepted`` is False elsewhere).

    Slots go by a stable sort on the destination and the rank within each
    destination run (``torch.cummax`` over the run starts), so rows keep
    their batch order inside a buffer.  A slot at or past capacity is not
    written and its row is reported rejected.
    """
    b = xb.shape[0]
    n_idx = delta.count.shape[0]
    capd = delta.x.shape[1]
    dev = xb.device
    idx = idx.to(torch.int32)

    # 1. slot assignment: rank within same-destination runs of the batch
    order = torch.argsort(idx, stable=True)
    s = idx[order]  # (B,) sorted destinations
    pos = torch.arange(b, dtype=torch.int32, device=dev)
    run_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), s[1:] != s[:-1]])
    start_pos = torch.cummax(torch.where(run_start, pos, 0), dim=0).values
    rank = pos - start_pos  # position within the run
    # a parked row (s == I) reads the last count, as the JAX gather clamps;
    # none of its writes lands
    slot = delta.count[s.clamp_max(n_idx - 1).long()] + rank  # (B,) sorted order
    acc_sorted = slot < capd
    lands = acc_sorted & (s < n_idx)

    # 2. scatter-append into new buffers (rejected and parked rows drop)
    flat = s.long() * capd + slot.long()
    dim = delta.x.shape[2]
    new_x = _drop_scatter(delta.x.reshape(n_idx * capd, dim), flat, xb[order], lands)
    new_ids = _drop_scatter(delta.ids.reshape(n_idx * capd), flat, ids[order], lands)

    # unsort the accept mask back to batch order
    accepted = torch.zeros((b,), dtype=torch.bool, device=dev)
    accepted[order] = acc_sorted
    accepted = accepted & valid  # parked rows: slot math is meaningless

    # 3. running bookkeeping (accepted rows only; parked rows go to row I,
    #    which is cut off)
    d_piv = torch.sqrt(torch.clamp_min(
        torch.sum((xb - delta.pivot[idx.clamp_max(n_idx - 1).long()]) ** 2, dim=-1), 0.0))
    one = accepted.to(torch.int32)
    il = idx.long()

    def per_index(base: Tensor, vals: Tensor, reduce: str) -> Tensor:
        buf = torch.cat([base, base.new_zeros((1,))])
        return buf.scatter_reduce(0, il, vals, reduce=reduce)[:n_idx]

    new_count = per_index(delta.count, one, "sum")
    new_radius = per_index(
        delta.radius, torch.where(accepted, d_piv, float("-inf")), "amax")
    new_sum = _segment_sums(delta.sum_x, xb, idx, accepted, order)
    new_dropped = per_index(delta.dropped, 1 - one, "sum")

    return (
        delta._replace(
            x=new_x.reshape(n_idx, capd, dim), ids=new_ids.reshape(n_idx, capd),
            count=new_count, radius=new_radius, sum_x=new_sum, dropped=new_dropped,
        ),
        accepted,
    )


def ingest_impl(
    centers: Tensor,
    delta: DeltaBuffer,
    xb: Tensor,
    ids: Tensor,
    valid: Tensor | None = None,
) -> tuple[DeltaBuffer, Tensor]:
    """Route and append one batch; returns (new delta, accepted (B,) bool).

    ``accepted[j]`` is False when row j's destination buffer is full (or
    the row is masked out by ``valid``); the caller retries those rows after
    maintenance (``api.OverlapIndex.ingest`` never loses one).  A row with
    ``valid`` False is parked: it is stored nowhere and counts nowhere, so a
    retry loop keeps the batch's shape and flips the mask instead.
    """
    n_idx = delta.count.shape[0]
    xb = xb.to(torch.float32)
    ids = ids.to(torch.int32)
    _, idx = route_points(centers, xb, kernel=True)  # (B,), K2 on the card
    if valid is None:
        valid = torch.ones((xb.shape[0],), dtype=torch.bool, device=xb.device)
    else:
        idx = torch.where(valid, idx, n_idx)  # park: every write drops row I
    return append_routed(delta, xb, ids, idx, valid)


def updated_geometry(delta: DeltaBuffer) -> tuple[Tensor, Tensor]:
    """Post-ingest index geometry from the running sums, with no member scan.

    Returns (centers (I, D), radius upper bounds (I,)).  The center is the
    exact centroid of main + delta members.  Every member lies within
    ``max(r_main, r_delta)`` of the old center, so within that plus the
    center's shift of the new one: a conservative bound, which can only make
    the drift monitor fire early, never miss an overlapping pair.
    """
    total = torch.clamp_min(delta.main_count + delta.count, 1)
    centers = (delta.main_sum + delta.sum_x) / total[:, None].to(torch.float32)
    shift = torch.sqrt(torch.clamp_min(
        torch.sum((centers - delta.pivot) ** 2, dim=-1), 0.0))
    return centers, torch.maximum(delta.main_radius, delta.radius) + shift


def pull_delta_meta(delta: DeltaBuffer, *, ids: bool = False) -> dict[str, np.ndarray]:
    """Device -> host snapshot of the buffer metadata (the drift monitor reads
    it).  The (I, CAPD, D) coordinates stay on the device: rebuilds take
    rows from the caller's dataset by global id.  ``ids=True`` adds the
    (I, CAPD) id table (OBM assignment and rebuilds)."""
    names = ["count", "radius", "sum_x", "main_count", "main_sum", "main_radius", "dropped"]
    if ids:
        names.append("ids")
    return {n: getattr(delta, n).cpu().numpy() for n in names}


def route_batch_host(forest: DeviceForest, xb: np.ndarray) -> np.ndarray:
    """Destination index per point (routing only, no append), as numpy."""
    centers = forest.index_centers
    _, idx = route_points(centers, torch.as_tensor(np.asarray(xb, np.float32),
                                                   device=centers.device))
    return idx.cpu().numpy()
