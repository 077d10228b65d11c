"""The sharded forest: shard islands for search and ingest.

The port of the JAX package's ``repro/distributed/knn_island.py``.  There,
one process drives a ``shard_map`` over a device mesh; here one process
drives a list of islands, one torch device each (``context.Mesh``), which
is the same single-controller design: the facade's ``search`` returns the
merged result in the calling process.

The forest's bucket rows and the per-index delta buffers are split over
the islands (leading dimension, NB and I); the routing state (index
centers, radii, neighbour lists) and the queries are copied to every
island's device.  Every island runs the single-device executor body
(``core.knn.route_select``, ``bucket_bounds`` / ``delta_bounds``,
``scan_sorted``; ``stream.ingest.append_routed``) over its own rows:

  search:  per-island top-kk carry -> concatenation on island 0's device
           and a global top-k (``core.knn.merge_shard_topk``, the merge the
           flat datastore's sharded ``knn_logits`` runs too); the cost
           counters come back as (S, Q) rows and are summed;
  ingest:  every island routes the whole batch and appends the rows whose
           delta buffer it owns; a row is accepted when its owner accepted
           it (an OR over the islands).

Islands on one device run one after another on its current stream.

Exactness: per-member distance arithmetic is island-local and the same,
and k candidates per island make the merged top-k exact, so the results
equal the single-device executor's bit for bit, with one exception the JAX
package shares: in ``mode="forest"`` an island whose eligible rows hold
fewer than k members scans on into other indexes' rows while its own carry
is unfilled, and where that finds rows closer than the routed indexes'
k-th the merged result is closer than the single layout's.

Padding convention (``place_forest`` / ``place_delta``):
  * bucket rows NB -> ceil(NB/S)*S, island ``s`` owning rows
    ``[s*W, (s+1)*W)``; pad buckets carry ``bucket_index = I`` (one past the
    real index count) and every island extends its selection table with an
    always-False sentinel column, so pad buckets are never eligible and the
    eligible/bound counts equal the single layout's (pad members are also
    id -1 / mask False);
  * delta rows I -> ceil(I/S)*S likewise; pad rows keep count 0 (never
    eligible, never routed to: routing only emits real index ids).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import knn as cknn
from repro_torch.core.forest import ForestArrays
from repro_torch.distributed.context import MODEL_AXIS, Mesh
from repro_torch.stream.ingest import DeltaBuffer, append_routed, delta_view

Tensor = torch.Tensor


def _ceil_div(n: int, m: int) -> int:
    return -(-n // m)


def default_mesh(shards: int, axis: str = MODEL_AXIS, devices=None) -> Mesh:
    """One-axis mesh of ``shards`` islands.

    ``devices`` lists one torch device per island (a device may repeat:
    ``["cuda:0"] * 4`` is four islands on one card); without it the islands
    are ``cuda:0 ... cuda:S-1``, and a host with fewer cards is an error."""
    from repro_torch.api.config import ConfigError

    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) < shards:
            raise ConfigError(
                f"LayoutConfig.shards={shards} needs one device per island but "
                f"device=[...] names {len(devices)}; pass a list of {shards} "
                "(a device may repeat, e.g. device=['cuda:0'] * 4 or ['cpu'] * 4) "
                "or lower shards"
            )
        return Mesh(devices[:shards], axis)
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shards > avail:
        raise ConfigError(
            f"LayoutConfig.shards={shards} exceeds the {avail} visible CUDA "
            "device(s); pass device=[...] with one device per island (a device "
            "may repeat: device=['cuda:0'] * 4 on one card, or ['cpu'] * 4 on "
            "the host) or lower shards"
        )
    return Mesh([torch.device("cuda", i) for i in range(shards)], axis)


class IslandForest(NamedTuple):
    """A ``core.knn.DeviceForest`` split over a mesh: ``parts[s]`` holds
    island ``s``'s W bucket rows and its own copy of the routing state, on
    ``mesh.devices[s]``.  The routing fields read island 0's copy."""

    parts: tuple[cknn.DeviceForest, ...]

    @property
    def index_centers(self) -> Tensor:
        return self.parts[0].index_centers

    @property
    def index_radii(self) -> Tensor:
        return self.parts[0].index_radii


class IslandDelta(NamedTuple):
    """A ``stream.ingest.DeltaBuffer`` split over a mesh: ``parts[s]`` holds
    island ``s``'s Wd delta rows on ``mesh.devices[s]``."""

    parts: tuple[DeltaBuffer, ...]


def _rows(t: Tensor | None, lo: int, hi: int, width: int, fill, dev) -> Tensor | None:
    """Rows [lo, hi) of ``t`` padded with ``fill`` to ``width`` rows, on
    ``dev`` (a view when nothing is padded or moved)."""
    if t is None:
        return None
    part = t[lo:hi]
    pad = width - part.shape[0]
    if pad:
        part = torch.cat([part, torch.full((pad,) + tuple(t.shape[1:]), fill,
                                           dtype=t.dtype, device=t.device)])
    return part.to(dev).contiguous()


def place_forest(mesh: Mesh, forest: ForestArrays, *, quantize: bool) -> IslandForest:
    """Upload ``forest`` split over the mesh's islands.

    The members are uploaded and quantized first, on island 0's device, as
    the single layout's ``core.knn.device_forest`` does, and only then
    padded and split: int8 scales equal the single path's, so int8 searches
    stay bitwise equal across layouts."""
    full = cknn.device_forest(forest, device=mesh.devices[0], quantize=quantize)
    nb = full.bucket_x.shape[0]
    n_idx = full.index_centers.shape[0]
    w = _ceil_div(max(nb, 1), mesh.size)
    parts = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * w, nb), min((s + 1) * w, nb)
        parts.append(cknn.DeviceForest(
            index_centers=full.index_centers.to(dev),
            index_radii=full.index_radii.to(dev),
            neighbors=full.neighbors.to(dev),
            bucket_x=_rows(full.bucket_x, lo, hi, w, 0, dev),
            bucket_ids=_rows(full.bucket_ids, lo, hi, w, -1, dev),
            bucket_mask=_rows(full.bucket_mask, lo, hi, w, False, dev),
            bucket_pivot=_rows(full.bucket_pivot, lo, hi, w, 0.0, dev),
            bucket_radius=_rows(full.bucket_radius, lo, hi, w, 0.0, dev),
            # pad buckets are owned by the sentinel index I
            bucket_index=_rows(full.bucket_index, lo, hi, w, n_idx, dev),
            bucket_scale=_rows(full.bucket_scale, lo, hi, w, 1.0, dev),
        ))
    return IslandForest(parts=tuple(parts))


def place_delta(mesh: Mesh, delta: DeltaBuffer) -> IslandDelta:
    """Split the logical delta buffers over the islands (pad rows zero:
    count 0 keeps them out of search and routing)."""
    n_idx = delta.count.shape[0]
    wd = _ceil_div(max(n_idx, 1), mesh.size)
    parts = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = min(s * wd, n_idx), min((s + 1) * wd, n_idx)
        parts.append(DeltaBuffer(*[_rows(x, lo, hi, wd, 0, dev) for x in delta]))
    return IslandDelta(parts=tuple(parts))


def logical_delta(delta: IslandDelta, n_indexes: int) -> DeltaBuffer:
    """The unpadded delta buffers on island 0's device (what the drift
    monitor, persistence and introspection read)."""
    dev = delta.parts[0].count.device
    return DeltaBuffer(*[
        torch.cat([getattr(p, f).to(dev) for p in delta.parts])[:n_indexes]
        for f in DeltaBuffer._fields
    ])


def island_delta_view(delta: IslandDelta) -> tuple[cknn.DeltaView, ...]:
    """Search-facing view of every island's delta rows."""
    return tuple(delta_view(p) for p in delta.parts)


class IslandStats(NamedTuple):
    """Per-island node-access counters on island 0's device, (S, Q) i32
    each: the bucket visits and member distances the island's scans did and
    the bound distances it took (its own routing of the queries, plus its
    eligible bucket and delta rows)."""

    buckets_visited: Tensor
    distances: Tensor
    bound_distances: Tensor


def sharded_search(
    mesh: Mesh,
    forest: IslandForest,
    q: Tensor,
    delta: tuple[cknn.DeltaView, ...] | None,
    *,
    k: int,
    mode: str = "forest",
    beam: int = 1,
    kernel: bool = True,
    per_island: bool = False,
    explain: bool = False,
    host_sel: Tensor | None = None,
) -> tuple:
    """Sharded twin of ``core.knn.knn_search_impl``: the same (dists, ids,
    SearchStats), bitwise equal.

    Every island routes the queries itself (``route_select``), bounds and
    sorts its own bucket rows (the sentinel column padded onto ``sel``) and
    its slice of the delta rows, and scans them with ``scan_sorted``; the
    islands' (Q, kk) carries then merge with ``merge_shard_topk``.  The
    per-query counters are summed over the islands; ``steps`` is the sum of
    the islands' trip counts (each island's scan ends on its own bound
    order, so it may exceed the single layout's count with equal results).

    ``per_island=True`` appends ``IslandStats`` ((S, Q) rows).  ``explain``
    (implies ``per_island``) puts ``core.knn.VisitRows`` before it: the
    islands' local visit orders stacked column-wise and (S, Q) per-phase
    visit counts.

    ``host_sel`` ((Q, S) bool, the routing tier's host eligibility) masks an
    island's selection for the queries it is False for and kills their scan
    there (``scan_sorted``'s ``qmask``): a pruned (query, island) pair does
    no bound distances and no member distances, and its carry stays
    (+inf, -1), which adds nothing to the merge.
    """
    n_isl = mesh.size
    dev0 = mesh.devices[0]
    qn = q.shape[0]
    w, cap = forest.parts[0].bucket_x.shape[:2]
    n_cap = n_isl * w * cap  # >= the real capacity (pad rows are empty)
    if delta is not None:
        n_cap += n_isl * delta[0].x.shape[0] * delta[0].x.shape[1]
    kk = min(k, n_cap)

    outs, bounds, dbounds, route = [], [], [], []
    for s, (fl, dev) in enumerate(zip(forest.parts, mesh.devices)):
        q_l = q.to(dev)
        n_idx = fl.index_centers.shape[0]
        sel, route_d, route_c = cknn.route_select(fl, q_l, mode=mode, kernel=kernel)
        hs = None
        if host_sel is not None:
            # routing tier: this island bounds and scans only the queries
            # that elected it; its routing counters stay (every island
            # still routes the queries)
            hs = host_sel[:, s].to(dev)
            sel = sel & hs[:, None]
        # sentinel column: pad buckets own index I, never eligible
        bucket_sel = torch.nn.functional.pad(sel, (0, 1))
        mb = cknn.bucket_bounds(fl, q_l, bucket_sel, beam=beam, kernel=kernel)
        dl = db = None
        if delta is not None:
            dl = delta[s]
            i_l = dl.x.shape[0]
            # this island's slice of the per-index selection (pad rows False)
            sel_pad = torch.nn.functional.pad(sel, (0, n_isl * i_l - n_idx))
            dsel = sel_pad[:, s * i_l:(s + 1) * i_l]
            db = cknn.delta_bounds(dl, q_l, dsel, beam=beam, kernel=kernel)
        out = cknn.scan_sorted(fl, q_l, mb, kk=kk, beam=beam, kernel=kernel,
                               delta=dl, dbounds=db, qmask=hs)
        outs.append(out)
        bounds.append(mb)
        dbounds.append(db)
        route.append((route_d, route_c))

    top_d, top_i = cknn.merge_shard_topk(
        [o.top_d for o in outs], [o.top_i for o in outs], k=kk)

    def rows(ts) -> Tensor:
        return torch.stack([t.to(dev0) for t in ts])

    visits_s = rows([o.visits for o in outs])
    ndist_s = rows([o.ndist for o in outs])
    n_elig_s = rows([o.n_elig for o in outs])
    n_elig_d_s = rows([o.n_elig_d for o in outs])
    merged = cknn.ScanOut(
        top_d=top_d,
        top_i=top_i,
        visits=torch.sum(visits_s, dim=0, dtype=torch.int32),
        ndist=torch.sum(ndist_s, dim=0, dtype=torch.int32),
        npad=torch.sum(rows([o.npad for o in outs]), dim=0, dtype=torch.int32),
        steps=torch.sum(rows([o.steps for o in outs]), dtype=torch.int32),
        n_elig=torch.sum(n_elig_s, dim=0, dtype=torch.int32),
        n_elig_d=torch.sum(n_elig_d_s, dim=0, dtype=torch.int32),
    )
    route_d0, route_c0 = route[0]
    stats = cknn.scan_stats(route_d0, route_c0, merged, kk=kk)
    result = (torch.sqrt(top_d), top_i, stats)
    if not (per_island or explain):
        return result
    # per-island bound work: every island routes the queries itself and
    # bounds its own eligible bucket and delta rows
    island = IslandStats(
        buckets_visited=visits_s,
        distances=ndist_s,
        bound_distances=rows([r[0] for r in route]) + n_elig_s + n_elig_d_s,
    )
    if not explain:
        return (*result, island)
    visits_main_s = rows([o.visits_main for o in outs])
    visit_rows = cknn.VisitRows(
        order=torch.cat([b.order.to(dev0) for b in bounds], dim=1),
        visits=visits_main_s,
        dorder=None if delta is None else torch.cat(
            [b.order.to(dev0) for b in dbounds], dim=1),
        dvisits=None if delta is None else visits_s - visits_main_s,
    )
    return (*result, visit_rows, island)


def sharded_ingest(
    mesh: Mesh,
    centers: Tensor,
    delta: IslandDelta,
    xb: Tensor,
    ids: Tensor,
    valid: Tensor | None = None,
) -> tuple[IslandDelta, Tensor]:
    """Sharded twin of ``stream.ingest.ingest_impl``.

    Every island routes the whole batch against the index centers on its
    own device, claims the rows whose delta row it owns and appends them
    with the shared ``append_routed`` body; rows owned by other islands
    arrive parked, so they take no slot and count nowhere there.  The
    islands' accept masks are disjoint (one owner per delta row), so their
    OR is the batch's accept mask, on island 0's device, capacity rejects
    included."""
    dev0 = mesh.devices[0]
    n = xb.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=xb.device)
    acc_any = torch.zeros((n,), dtype=torch.bool, device=dev0)
    parts = []
    for s, (dl, dev) in enumerate(zip(delta.parts, mesh.devices)):
        xb_l = xb.to(dev, torch.float32)
        ids_l = ids.to(dev, torch.int32)
        valid_l = valid.to(dev)
        _, idx = cknn.route_points(centers.to(dev), xb_l, kernel=True)  # (B,) global
        i_l = dl.count.shape[0]
        local = idx - s * i_l
        mine = valid_l & (local >= 0) & (local < i_l)
        new_l, acc = append_routed(dl, xb_l, ids_l, torch.where(mine, local, i_l), mine)
        parts.append(new_l)
        acc_any = acc_any | acc.to(dev0)
    return IslandDelta(parts=tuple(parts)), acc_any
