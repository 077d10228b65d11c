"""Decision-making stage (paper §4.3): classify pairwise overlap into
low / medium / high using thresholds (xi_min, xi_max) and restructure the
partition set accordingly:

* high   [xi_max, 1]   : merge the two partitions (union-find contraction).
* medium [xi_min, xi_max): extract the lens objects into a third *overlap
                           partition*, registered as a NEIGHBOR of both.
* low    (0, xi_min)   : move the lens objects of the smaller-cap partition
                           into the other partition.

Merges first (union-find on all high pairs), then the rates are re-estimated
on the merged groups, then medium pairs (descending rate; each object is
extracted at most once), then low pairs: the JAX package's order.  The
orchestration is host numpy, the JAX package's ``repro.core.decision`` line
for line; the rate matrices are computed in torch on ``device`` (the
overlap registry, ``core/overlap.py``) and brought back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import overlap as ovl
from repro_torch.device import resolve_device


@dataclass
class Partition:
    """A partition group emitted by the decision stage."""

    members: np.ndarray  # (m,) int64 object ids into the dataset
    pivot: np.ndarray  # (D,)
    radius: float
    neighbors: list[int] = field(default_factory=list)  # group-level links
    is_overlap_index: bool = False


@dataclass
class DecisionStats:
    n_initial: int = 0
    n_merged_pairs: int = 0
    n_overlap_indexes: int = 0
    n_low_moves: int = 0
    n_final: int = 0
    distance_computations: int = 0


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def _recompute(x: np.ndarray, members: np.ndarray) -> tuple[np.ndarray, float]:
    pts = x[members]
    pivot = pts.mean(axis=0)
    radius = float(np.sqrt(((pts - pivot) ** 2).sum(-1)).max()) if len(pts) else 0.0
    return pivot.astype(np.float32), radius


def _rate_matrix(
    method: str, x_dev: torch.Tensor, pivots: np.ndarray, radii: np.ndarray,
    assign: np.ndarray,
) -> np.ndarray:
    device = x_dev.device
    rates = ovl.overlap_matrix(
        method,
        torch.as_tensor(np.asarray(pivots, np.float32), device=device),
        torch.as_tensor(np.asarray(radii, np.float32), device=device),
        x=x_dev,
        assign=torch.as_tensor(assign, device=device),
    )
    return rates.cpu().numpy()


def _lens_members(
    x: np.ndarray, members: np.ndarray, pivot_other: np.ndarray, radius_other: float
) -> np.ndarray:
    """Object ids among ``members`` that also lie inside the other ball."""
    d = np.sqrt(((x[members] - pivot_other) ** 2).sum(-1))
    return members[d <= radius_other]


def decide(
    x: np.ndarray,
    pivots: np.ndarray,
    radii: np.ndarray,
    assign: np.ndarray,
    *,
    method: str,
    xi_min: float,
    xi_max: float,
    device=None,
) -> tuple[list[Partition], DecisionStats]:
    """Apply §4.3 to DBSCAN partitions. Returns final groups + stats.

    ``method`` resolves through the overlap-method registry
    (``core.overlap.register_overlap_method``); unknown names fail fast with
    the registered list, before any work is done.  The rate matrices run on
    ``device`` (``cuda`` unless named; without CUDA an error), where ``x``
    is uploaded once.
    """
    entry = ovl.get_overlap_method(method)
    x = np.asarray(x, np.float32)
    x_dev = torch.from_numpy(x).to(resolve_device(device))
    c0 = len(radii)
    stats = DecisionStats(n_initial=c0)
    stats.distance_computations += c0 * c0  # pivot-pivot distances
    if entry.needs_objects:
        stats.distance_computations += len(x) * c0  # ball membership pass

    rates = _rate_matrix(method, x_dev, pivots, radii, assign)

    # ---- high overlap: merge via union-find --------------------------------
    uf = _UnionFind(c0)
    hi, hj = np.where(np.triu(rates, 1) >= xi_max)
    for a, b in zip(hi.tolist(), hj.tolist()):
        uf.union(a, b)
    stats.n_merged_pairs = len(hi)
    root_of = np.array([uf.find(i) for i in range(c0)])
    roots, new_ids = np.unique(root_of, return_inverse=True)
    assign_g = new_ids[assign]  # object -> merged group
    groups: list[Partition] = []
    for g in range(len(roots)):
        members = np.where(assign_g == g)[0]
        pivot, radius = _recompute(x, members)
        groups.append(Partition(members=members, pivot=pivot, radius=radius))
        stats.distance_computations += len(members)

    # ---- re-estimate rates on merged groups --------------------------------
    if len(groups) > 1:
        pv = np.stack([g.pivot for g in groups])
        rd = np.array([g.radius for g in groups], np.float32)
        rates = _rate_matrix(method, x_dev, pv, rd, assign_g)
        stats.distance_computations += len(groups) ** 2
        if entry.needs_objects:
            stats.distance_computations += len(x) * len(groups)
    else:
        rates = np.zeros((1, 1), np.float32)

    # ---- medium overlap: extract lens objects into overlap indexes ---------
    med_i, med_j = np.where(np.triu(rates, 1) >= xi_min)
    med_mask = rates[med_i, med_j] < xi_max
    pairs = sorted(
        zip(med_i[med_mask].tolist(), med_j[med_mask].tolist()),
        key=lambda ij: -rates[ij[0], ij[1]],
    )
    extracted = np.zeros(len(x), bool)
    for a, b in pairs:
        ga, gb = groups[a], groups[b]
        lens_a = _lens_members(x, ga.members, gb.pivot, gb.radius)
        lens_b = _lens_members(x, gb.members, ga.pivot, ga.radius)
        stats.distance_computations += len(ga.members) + len(gb.members)
        lens = np.concatenate([lens_a, lens_b])
        lens = lens[~extracted[lens]]
        if len(lens) == 0:
            continue
        extracted[lens] = True
        oid = len(groups)
        pivot, radius = _recompute(x, lens)
        stats.distance_computations += len(lens)
        groups.append(
            Partition(members=lens, pivot=pivot, radius=radius,
                      neighbors=[a, b], is_overlap_index=True)
        )
        ga.neighbors.append(oid)
        gb.neighbors.append(oid)
        ga.members = ga.members[~np.isin(ga.members, lens_a)]
        gb.members = gb.members[~np.isin(gb.members, lens_b)]
        stats.n_overlap_indexes += 1

    # ---- low overlap: reassign smaller-cap lens objects --------------------
    low_i, low_j = np.where((np.triu(rates, 1) > 0) & (np.triu(rates, 1) < xi_min))
    for a, b in zip(low_i.tolist(), low_j.tolist()):
        ga, gb = groups[a], groups[b]
        d = float(np.sqrt(((ga.pivot - gb.pivot) ** 2).sum()))
        if d <= 0:
            continue
        # smaller cap = smaller cap height (equivalently smaller cap volume
        # for same-dim balls cut by the same radical plane ordering)
        ha = float(ovl.cap_height(ga.radius, ovl.cap_cos_theta(ga.radius, gb.radius, d)))
        hb = float(ovl.cap_height(gb.radius, ovl.cap_cos_theta(gb.radius, ga.radius, d)))
        src, dst = (a, b) if ha <= hb else (b, a)
        gs, gd = groups[src], groups[dst]
        lens_s = _lens_members(x, gs.members, gd.pivot, gd.radius)
        lens_s = lens_s[~extracted[lens_s]]
        stats.distance_computations += len(gs.members)
        if len(lens_s) == 0:
            continue
        gs.members = gs.members[~np.isin(gs.members, lens_s)]
        gd.members = np.concatenate([gd.members, lens_s])
        stats.n_low_moves += len(lens_s)

    # ---- finalize: drop empty groups, recompute geometry, remap neighbors --
    keep = [i for i, g in enumerate(groups) if len(g.members) > 0]
    remap = {old: new for new, old in enumerate(keep)}
    final: list[Partition] = []
    for old in keep:
        g = groups[old]
        pivot, radius = _recompute(x, g.members)
        stats.distance_computations += len(g.members)
        final.append(
            Partition(
                members=g.members,
                pivot=pivot,
                radius=radius,
                neighbors=sorted({remap[nb] for nb in g.neighbors if nb in remap}),
                is_overlap_index=g.is_overlap_index,
            )
        )
    # symmetrize neighbor links
    for i, g in enumerate(final):
        for nb in g.neighbors:
            if i not in final[nb].neighbors:
                final[nb].neighbors.append(i)
    for g in final:
        g.neighbors.sort()
    stats.n_final = len(final)
    return final, stats
