"""k-NN search over the flattened forest (paper Algorithm 2).

Paper Alg. 2:  STEP 1 route the query to the closest index center and append
that index's neighbor overlap-indexes; STEP 2 run the kNN-BCCF
branch-and-bound on every selected index; STEP 3 gather.

As in the JAX package (``repro.core.knn``), the per-index branch-and-bound
descent is a *sorted-lower-bound masked bucket scan* over the forest's
flattened buckets:

  1. route:   d(q, index_centers) -> closest + neighbors -> eligibility mask
              over buckets (STEP 1).
  2. bound:   lb_b = max(0, d(q, bucket_pivot_b) - bucket_radius_b) for all
              eligible buckets (one K2 distance matrix), +inf elsewhere,
              then a stable sort.
  3. scan:    visit buckets in ascending-lb order; each step evaluates the
              next ``beam`` buckets per query (gather, distance, top-k merge)
              and the scan stops once lb > kth-best for every query (exact:
              lb is sorted and kth-best is non-increasing).

The JAX package runs step 3 as a ``lax.while_loop`` of kernel steps.  Here a
whole phase is one K1 launch: each query walks its own steps until its first
inactive one, and the phase's trip count (``steps``) is the most steps any
query took, which is the while_loop's.  Nothing is read back to the host
until the search returns.

``delta`` (a DeltaView) adds the streaming delta buckets as a second scan
phase over the per-index append buffers, seeded with the main phase's top-k
carry; lower bounds only prune, so splitting the scan keeps it exact.

Each step's work is entered as a device phase of ``obs.phases`` (``route``,
``bounds``, ``sort``, ``scan``, ``finish``): free unless a profiler records
or a sampled search times its phases.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.forest import FOREST_FIELDS, ForestArrays
from repro_torch.core.metric import pairwise
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.phases import current_run, phase

Tensor = torch.Tensor


class DeviceForest(NamedTuple):
    index_centers: Tensor  # (I, D)
    index_radii: Tensor  # (I,)
    neighbors: Tensor  # (I, MAXNBR) i32, -1 pad
    bucket_x: Tensor  # (NB, C, D) f32, or int8 when quantized
    bucket_ids: Tensor  # (NB, C) i32, -1 pad
    bucket_mask: Tensor  # (NB, C) bool
    bucket_pivot: Tensor  # (NB, D) f32 (bounds stay full precision)
    bucket_radius: Tensor  # (NB,)
    bucket_index: Tensor  # (NB,) i32
    bucket_scale: Tensor | None = None  # (NB, C) f32 dequant scales (int8 mode)


class DeltaView(NamedTuple):
    """Search-facing view of the streaming delta buffers: one delta bucket
    per index, with ``max(0, d(q, pivot) - radius)`` a valid lower bound on
    any member distance.  Unfilled slots carry id -1."""

    x: Tensor  # (I, CAPD, D) f32
    ids: Tensor  # (I, CAPD) i32, -1 pad
    mask: Tensor  # (I, CAPD) bool
    pivot: Tensor  # (I, D) f32
    radius: Tensor  # (I,) f32


class SearchStats(NamedTuple):
    buckets_visited: Tensor  # (Q,) i32
    distances: Tensor  # (Q,) i32  useful (unpadded) OBJECT distances
    bound_distances: Tensor  # (Q,) i32  routing (centers) + bucket-bound dists
    padded_distances: Tensor  # (Q,) i32  object distances incl. padding lanes
    comparisons: Tensor  # (Q,) i32  routing + bound + top-k comparisons
    steps: Tensor  # () i32  scan-loop trip count


_DTYPES = {
    "index_centers": torch.float32, "index_radii": torch.float32,
    "neighbors": torch.int32, "bucket_x": torch.float32,
    "bucket_ids": torch.int32, "bucket_mask": torch.bool,
    "bucket_pivot": torch.float32, "bucket_radius": torch.float32,
    "bucket_index": torch.int32,
}


def _put(a, dtype: torch.dtype, device) -> Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def device_forest_from_numpy(
    arrays: Mapping[str, np.ndarray], *, device, quantize: bool = False
) -> DeviceForest:
    """Upload a flattened forest given as numpy arrays by field name (the
    ``ForestArrays`` fields of either package).  ``quantize=True`` stores
    bucket members int8 with per-member scales (``ops.quantize_datastore``);
    bounds and pivots stay f32."""
    fields = {n: _put(arrays[n], dt, device) for n, dt in _DTYPES.items()}
    bucket_scale = None
    if quantize:
        nb, cap, dim = fields["bucket_x"].shape
        xq, scale = kops.quantize_datastore(fields["bucket_x"].reshape(nb * cap, dim))
        fields["bucket_x"] = xq.reshape(nb, cap, dim).contiguous()
        bucket_scale = scale.reshape(nb, cap).contiguous()
    return DeviceForest(**fields, bucket_scale=bucket_scale)


def device_forest(f: ForestArrays, *, device, quantize: bool = False) -> DeviceForest:
    """Upload the flattened forest (see ``device_forest_from_numpy``)."""
    return device_forest_from_numpy(
        {n: getattr(f, n) for n in FOREST_FIELDS}, device=device, quantize=quantize
    )


def delta_view_from_numpy(arrays: Mapping[str, np.ndarray], *, device) -> DeltaView:
    """A DeltaView from numpy arrays by field name (x, ids, mask, pivot,
    radius), e.g. the JAX package's ``stream.ingest.delta_view`` output."""
    return DeltaView(
        x=_put(arrays["x"], torch.float32, device),
        ids=_put(arrays["ids"], torch.int32, device),
        mask=_put(arrays["mask"], torch.bool, device),
        pivot=_put(arrays["pivot"], torch.float32, device),
        radius=_put(arrays["radius"], torch.float32, device),
    )


def route_points(centers: Tensor, q: Tensor, *, kernel: bool = True) -> tuple[Tensor, Tensor]:
    """Alg. 2 STEP 1 routing: distances to index centers + closest index.

    Returns (d_idx (Q, I) squared distances, closest (Q,) i32); ties go to
    the first index, as ``jnp.argmin``'s do.
    """
    d_idx = pairwise(q, centers, metric="sq_l2", use_kernel=kernel)  # (Q, I)
    return d_idx, torch.argmin(d_idx, dim=1).to(torch.int32)


def route_eligibility(closest: Tensor, neighbors: Tensor) -> Tensor:
    """(Q, I) bool: closest index + its overlap-index neighbors, per query.

    Scatter formulation: each query contributes 1 + MAXNBR (query, index)
    pairs, reduced per (query, index) cell with ``scatter_reduce`` amax (the
    JAX package's ``segment_max``).
    """
    n_idx = neighbors.shape[0]
    qn = closest.shape[0]
    nbrs = neighbors[closest.long()]  # (Q, MAXNBR)
    cand = torch.cat(
        [closest[:, None], torch.where(nbrs >= 0, nbrs, 0)], dim=1
    )  # (Q, 1 + MAXNBR), invalid links parked on index 0 with value 0
    val = torch.cat(
        [torch.ones((qn, 1), dtype=torch.int32, device=closest.device),
         (nbrs >= 0).to(torch.int32)], dim=1
    )
    seg = (
        cand.long() + n_idx * torch.arange(qn, device=closest.device)[:, None]
    ).ravel()
    sel = torch.zeros(qn * n_idx, dtype=torch.int32, device=closest.device)
    sel = sel.scatter_reduce(0, seg, val.ravel(), reduce="amax")
    return sel.reshape(qn, n_idx) > 0


class ScanOut(NamedTuple):
    """One executor's bounded-scan result before the stats rollup."""

    top_d: Tensor  # (Q, kk) ascending SQUARED distances
    top_i: Tensor  # (Q, kk) global object ids, -1 pad
    visits: Tensor  # (Q,) i32
    ndist: Tensor  # (Q,) i32
    npad: Tensor  # (Q,) i32
    steps: Tensor  # () i32 scan-loop trip count over both phases
    n_elig: Tensor  # (Q,) i32 eligible main buckets
    n_elig_d: Tensor  # (Q,) i32 eligible delta buckets
    # main-phase visits alone (visits - visits_main = the delta phase's);
    # the attribution layer decodes the visited rows from these and the
    # sorted visit orders
    visits_main: Tensor | None = None


class PhaseBounds(NamedTuple):
    """STEP 2a output for one scan phase: the ascending visit order, the
    sorted lower bounds (ineligible rows at +inf, padded to a beam multiple)
    and the per-query eligible-row count for the cost instrumentation."""

    order: Tensor  # (Q, n_steps*beam) i32
    lb_sorted: Tensor  # (Q, n_steps*beam) f32, ascending, +inf tail
    n_elig: Tensor  # (Q,) i32


def _sorted_bounds(lb: Tensor, beam: int) -> tuple[Tensor, Tensor, int]:
    """Ascending visit order + sorted bounds, padded to a beam multiple.
    The sort is stable, as ``jnp.argsort``'s is, so equal bounds keep row
    order."""
    nb = lb.shape[1]
    n_steps = -(-nb // beam)  # ceil
    pad = n_steps * beam - nb
    with phase("sort"):
        lb_sorted, order = torch.sort(lb, dim=1, stable=True)
        order = order.to(torch.int32)  # the kernels' index type, as in the JAX package
        if pad:
            order = torch.nn.functional.pad(order, (0, pad))
            lb_sorted = torch.nn.functional.pad(lb_sorted, (0, pad), value=float("inf"))
    return order, lb_sorted, n_steps


def _scan_phase(
    phase,
    q: Tensor,
    bounds: PhaseBounds,
    beam: int,
    top_d: Tensor,
    top_i: Tensor,
    scan_x: Tensor,
    scan_ids: Tensor,
    scan_scale: Tensor | None,
    bucket_count: Tensor,
    qmask: Tensor | None = None,
    *,
    extent: Tensor | None = None,
    staged: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One bounded best-first scan phase (main buckets or delta buckets) by
    ``phase``: a K1 dispatcher of ``kernels.ops`` or its plain version.
    ``extent`` (NB,) is one past each bucket's last live row, K1 staging and
    scoring nothing past it (None: derived from ``scan_ids``).  ``staged``
    (Q,), if given, tallies the rows staged (a sampled search's counter).

    The carry's top-k streams through phases: the delta phase starts from
    the main phase's result.  Returns (top_d, top_i, visits, ndist, npad,
    steps), the counters of this phase only and ``steps`` a () tensor.

    ``qmask`` (Q,) bool, if given, is a per-query kill switch: a False query
    visits nothing in this phase, not even the +inf-bound spill that an
    empty carry would otherwise make, so masking the selection alone would
    not do.  The routed layout uses it to make a pruned (query, island)
    pair zero work on that island.
    """
    top_d, top_i, visits, ndist, npad, qsteps = phase(
        q, scan_x, scan_ids, bucket_count, bounds.order, bounds.lb_sorted, beam,
        top_d, top_i, scan_scale, qmask=qmask, extent=extent, staged=staged,
    )
    steps = qsteps.max() if qsteps.numel() else qsteps.new_zeros(())
    return top_d, top_i, visits, ndist, npad, steps


def route_select(
    forest: DeviceForest, q: Tensor, *, mode: str = "forest", kernel: bool = True
) -> tuple[Tensor, Tensor, Tensor]:
    """Alg. 2 STEP 1: per-query index selection + the routing cost counters.

    Returns (sel (Q, I) bool, route_dists (Q,) i32, route_cmps (Q,) i32).
    """
    qn = q.shape[0]
    n_idx = forest.index_centers.shape[0]
    dev = q.device
    with phase("route"):
        if mode == "forest":
            _, closest = route_points(forest.index_centers, q, kernel=kernel)
            sel = route_eligibility(closest, forest.neighbors)  # (Q, I)
            route_dists = torch.full((qn,), n_idx, dtype=torch.int32, device=dev)
            route_cmps = torch.full((qn,), n_idx, dtype=torch.int32, device=dev)
        elif mode == "all":
            sel = torch.ones((qn, n_idx), dtype=torch.bool, device=dev)
            route_dists = torch.zeros((qn,), dtype=torch.int32, device=dev)
            route_cmps = torch.zeros((qn,), dtype=torch.int32, device=dev)
        else:
            raise ValueError(f"mode {mode!r}")
    return sel, route_dists, route_cmps


def bucket_bounds(
    forest: DeviceForest,
    q: Tensor,
    bucket_sel: Tensor,
    *,
    beam: int = 1,
    kernel: bool = True,
) -> PhaseBounds:
    """STEP 2a over the main bucket rows: eligibility -> pivot lower bounds
    -> sorted visit order.  The paper's Fig. 21 cost metric charges exactly
    the eligible bound count per query."""
    with phase("bounds"):
        elig = bucket_sel[:, forest.bucket_index.long()]  # (Q, NB) -> sel[q, owner(b)]
        n_elig = torch.sum(elig, dim=1, dtype=torch.int32)  # (Q,)
        d_piv = pairwise(q, forest.bucket_pivot, metric="l2", use_kernel=kernel)  # (Q, NB)
        lb = torch.clamp_min(d_piv - forest.bucket_radius[None, :], 0.0)
        lb = torch.where(elig, lb, float("inf"))
    order, lb_sorted, _ = _sorted_bounds(lb, beam)
    return PhaseBounds(order=order, lb_sorted=lb_sorted, n_elig=n_elig)


def delta_bounds(
    delta: DeltaView,
    q: Tensor,
    delta_sel: Tensor,
    *,
    beam: int = 1,
    kernel: bool = True,
) -> PhaseBounds:
    """STEP 2a over the delta rows (one streaming bucket per index; empty
    buffers are never eligible)."""
    with phase("bounds"):
        dcount = torch.sum(delta.mask, dim=1, dtype=torch.int32)  # (I_d,)
        elig_d = delta_sel & (dcount[None, :] > 0)  # (Q, I_d)
        n_elig_d = torch.sum(elig_d, dim=1, dtype=torch.int32)
        d_piv_d = pairwise(q, delta.pivot, metric="l2", use_kernel=kernel)
        lb_d = torch.clamp_min(d_piv_d - delta.radius[None, :], 0.0)
        lb_d = torch.where(elig_d, lb_d, float("inf"))
    order_d, lb_d_sorted, _ = _sorted_bounds(lb_d, beam)
    return PhaseBounds(order=order_d, lb_sorted=lb_d_sorted, n_elig=n_elig_d)


def scan_sorted(
    forest: DeviceForest,
    q: Tensor,
    bounds: PhaseBounds,
    *,
    kk: int,
    beam: int = 1,
    kernel: bool = True,
    delta: DeltaView | None = None,
    dbounds: PhaseBounds | None = None,
    qmask: Tensor | None = None,
) -> ScanOut:
    """STEP 2b/2c executor body: bounded best-first scan over the bucket
    rows (and delta rows), visiting in the precomputed ``PhaseBounds``
    order.  ``qmask`` (Q,) bool masks queries out of both phases (see
    ``_scan_phase``; the routing tier's host pruning).  A sampled search
    (``obs.phases.current_run``) also tallies the rows K1 staged against
    the padded capacity it visited."""
    qn = q.shape[0]
    dev = q.device
    run = current_run()
    with phase("scan"):
        top_d = torch.full((qn, kk), float("inf"), device=dev)
        top_i = torch.full((qn, kk), -1, dtype=torch.int32, device=dev)
        staged = None if run is None else torch.zeros((qn,), dtype=torch.int32, device=dev)
        # real (unpadded) member count per bucket, for the cost instrumentation
        bucket_count = torch.sum(forest.bucket_mask, dim=1, dtype=torch.int32)  # (NB,)
        top_d, top_i, visits, ndist, npad, steps = _scan_phase(
            kops.bucket_scan_phase if kernel else kref.bucket_scan_phase_ref,
            q, bounds, beam, top_d, top_i, forest.bucket_x, forest.bucket_ids,
            forest.bucket_scale, bucket_count, qmask, staged=staged,
        )
        visits_main = visits

        n_elig_d = torch.zeros((qn,), dtype=torch.int32, device=dev)
        if delta is not None:
            # the delta's live slots are a prefix: its count is its extent
            dcount = torch.sum(delta.mask, dim=1, dtype=torch.int32)  # (I_d,)
            top_d, top_i, dv, dd, dp, dsteps = _scan_phase(
                kops.delta_scan_topk if kernel else kref.bucket_scan_phase_ref,
                q, dbounds, beam, top_d, top_i, delta.x, delta.ids, None, dcount, qmask,
                extent=dcount, staged=staged,
            )
            visits, ndist, npad = visits + dv, ndist + dd, npad + dp
            steps = steps + dsteps
            n_elig_d = dbounds.n_elig
        if run is not None:
            run.count_rows(staged, npad)

    return ScanOut(
        top_d=top_d,
        top_i=top_i,
        visits=visits,
        ndist=ndist,
        npad=npad,
        steps=steps,
        n_elig=bounds.n_elig,
        n_elig_d=n_elig_d,
        visits_main=visits_main,
    )


def local_scan(
    forest: DeviceForest,
    q: Tensor,
    bucket_sel: Tensor,
    *,
    kk: int,
    beam: int = 1,
    kernel: bool = True,
    delta: DeltaView | None = None,
    delta_sel: Tensor | None = None,
) -> ScanOut:
    """STEP 2 executor body over the bucket rows AND delta rows it is given.
    ``bucket_sel`` (Q, I) is the selection table indexed by
    ``forest.bucket_index``; ``delta_sel`` (Q, I_d) selects per delta row
    (defaults to ``bucket_sel``)."""
    bounds = bucket_bounds(forest, q, bucket_sel, beam=beam, kernel=kernel)
    dbounds = None
    if delta is not None:
        if delta_sel is None:
            delta_sel = bucket_sel
        dbounds = delta_bounds(delta, q, delta_sel, beam=beam, kernel=kernel)
    return scan_sorted(
        forest, q, bounds, kk=kk, beam=beam, kernel=kernel,
        delta=delta, dbounds=dbounds,
    )


def merge_shard_topk(
    top_d: list[Tensor] | tuple[Tensor, ...],
    top_i: list[Tensor] | tuple[Tensor, ...],
    *,
    k: int,
) -> tuple[Tensor, Tensor]:
    """Cross-island top-k merge: each island's (Q, kk) carry, in island
    order, moves to island 0's device and the k smallest of the (Q, S * kk)
    concatenation are kept, the lower position winning a tie (the JAX
    package's all-gather + ``lax.top_k``).  k candidates per island make
    the merge exact: the global top-k is a subset of the union of the
    per-island top-ks.  ``top_i`` may hold ids or any values carried with
    the distances (the flat datastore merges token values)."""
    dev = top_d[0].device
    d_all = torch.cat([d.to(dev) for d in top_d], dim=1)
    i_all = torch.cat([i.to(dev) for i in top_i], dim=1)
    vals, pos = kref.topk_smallest(d_all, k)
    return vals, torch.gather(i_all, 1, pos)


def scan_stats(
    route_dists: Tensor, route_cmps: Tensor, out: ScanOut, *, kk: int
) -> SearchStats:
    """Roll a ``ScanOut`` + routing counters into the paper's ``SearchStats``."""
    return SearchStats(
        buckets_visited=out.visits,
        distances=out.ndist,
        bound_distances=route_dists + out.n_elig + out.n_elig_d,
        padded_distances=out.npad,
        comparisons=route_cmps
        + out.n_elig + out.n_elig_d  # bound comparisons (eligible buckets)
        # top-k merge comparisons over every padded lane actually scanned
        + out.npad * int(math.ceil(math.log2(max(kk, 2)))),
        steps=out.steps.to(torch.int32),
    )


def knn_search_impl(
    forest: DeviceForest,
    q: Tensor,
    *,
    k: int,
    mode: str = "forest",
    beam: int = 1,
    kernel: bool = True,
    delta: DeltaView | None = None,
) -> tuple[Tensor, Tensor, SearchStats]:
    """Batched kNN over the forest. Returns (dists (Q,k), ids (Q,k), stats).

    dists are true L2 distances; ids are global object ids (-1 if fewer than
    k objects were reachable).  ``kernel=True`` (default) routes every
    distance through the ``kernels.ops`` dispatch layer (the K1/K2 kernels on
    a CUDA tensor, the plain versions on a CPU tensor); ``kernel=False`` runs
    the plain versions on any device, as a reference.
    """
    n_idx = forest.index_centers.shape[0]
    nb, cap, _ = forest.bucket_x.shape
    n_cap = nb * cap
    if delta is not None:
        n_cap += n_idx * delta.x.shape[1]
    kk = min(k, n_cap)

    sel, route_dists, route_cmps = route_select(forest, q, mode=mode, kernel=kernel)
    out = local_scan(
        forest, q, sel, kk=kk, beam=beam, kernel=kernel,
        delta=delta, delta_sel=sel,
    )
    with phase("finish"):
        stats = scan_stats(route_dists, route_cmps, out, kk=kk)
        dists = torch.sqrt(out.top_d)
    return dists, out.top_i, stats


class VisitRows(NamedTuple):
    """Per-query visited-row evidence for the attribution layer
    (``obs/attribution.py``).

    The decode rests on a scan invariant: within one phase the visited
    buckets are exactly the first ``visits[0, q]`` entries of the ascending
    visit order.  K1 walks a query's ``order`` front to back, ``beam``
    entries a step, and visits an entry when its bound is <= the query's
    k-th best at the step's start.  ``lb_sorted`` ascends and the k-th best
    never grows, so once an entry fails every later one fails too: the
    visited entries are a prefix (+inf padding included while fewer than k
    are found).  So (order, per-phase visit counts) gives the visited set
    on the host without running anything again.

    The layout is the JAX package's single-device one: ``order`` (Q, W) and
    ``visits`` (1, Q), one island; ``dorder``/``dvisits`` are the delta
    phase's twin (``None`` without a delta phase).
    """

    order: Tensor  # (Q, W) i32 ascending-bound visit order
    visits: Tensor  # (1, Q) i32 main-phase visit counts
    dorder: Tensor | None  # (Q, Wd) delta visit order
    dvisits: Tensor | None  # (1, Q) i32 delta-phase visit counts


def knn_search_explain_impl(
    forest: DeviceForest,
    q: Tensor,
    *,
    k: int,
    mode: str = "forest",
    beam: int = 1,
    kernel: bool = True,
    delta: DeltaView | None = None,
) -> tuple[Tensor, Tensor, SearchStats, VisitRows]:
    """``knn_search_impl`` + the visited-row evidence (``VisitRows``).

    Runs the same op sequence as ``knn_search_impl`` (the same routing,
    bounds and scan phases on the same operands), so its results are
    bitwise equal to it, and also returns the sorted visit orders and
    per-phase visit counts that the search computes and drops.
    """
    n_idx = forest.index_centers.shape[0]
    nb, cap, _ = forest.bucket_x.shape
    n_cap = nb * cap
    if delta is not None:
        n_cap += n_idx * delta.x.shape[1]
    kk = min(k, n_cap)

    sel, route_dists, route_cmps = route_select(forest, q, mode=mode, kernel=kernel)
    bounds = bucket_bounds(forest, q, sel, beam=beam, kernel=kernel)
    dbounds = None
    if delta is not None:
        dbounds = delta_bounds(delta, q, sel, beam=beam, kernel=kernel)
    out = scan_sorted(
        forest, q, bounds, kk=kk, beam=beam, kernel=kernel,
        delta=delta, dbounds=dbounds,
    )
    with phase("finish"):
        stats = scan_stats(route_dists, route_cmps, out, kk=kk)
        rows = VisitRows(
            order=bounds.order,
            visits=out.visits_main[None],
            dorder=None if dbounds is None else dbounds.order,
            dvisits=None if delta is None else (out.visits - out.visits_main)[None],
        )
        dists = torch.sqrt(out.top_d)
    return dists, out.top_i, stats, rows


def knn_exact(x: Tensor, q: Tensor, *, k: int, kernel: bool = True) -> tuple[Tensor, Tensor]:
    """Brute-force oracle: exact kNN of q (Q, D) in x (N, D)."""
    d2 = pairwise(q, x, metric="sq_l2", use_kernel=kernel)
    vals, idx = kref.topk_smallest(d2, min(k, x.shape[0]))
    return torch.sqrt(torch.clamp_min(vals, 0.0)), idx.to(torch.int32)
