"""The plain derivation of a forest's routing table from its rows and the
configuration's build parameters (the paper's §4.1-§4.3): which index holds
each row, each index's center, and each index's overlap neighbours.  It is
what the routed search's reference (``routed.py``) routes queries by, worked
out again from the rows alone, so that a wrong build shows.

* ``dbscan``: Algorithm 1's clusters.  A row is core where at least
  ``min_pts`` rows (itself included) lie within ``eps``; core rows within
  ``eps`` of one another share a cluster (the connected components of that
  graph, to the end); a border row takes the cluster of its nearest core row
  within ``eps``; the rest are noise.  Clusters are numbered by their
  smallest core row.  Distances are float64 against ``eps`` squared in
  float32, as the build squares it.
* ``partitions``: each cluster's pivot (its mean) and radius (its farthest
  member), with every noise row given to its nearest pivot.
* ``rates``: the overlap rate of each pair of partitions by the
  configuration's method: VBM (lens volume over the two balls' volumes, from
  hyperspherical caps), DBM ((h1 + h2) / d) or OBM (rows inside both balls
  over the two partitions' rows); 0 for disjoint balls, 1 for a ball inside
  the other.
* ``decide``: high overlap (rate >= xi_max) merges partitions; the rates are
  taken again on the merged groups; each medium pair (xi_min <= rate <
  xi_max), the highest first, gives the rows of either group inside the
  other's ball, not taken before, to a new overlap index linked to both;
  each low pair (0 < rate < xi_min) moves the rows of the group with the
  smaller cap that lie inside the other's ball, not taken before, to the
  other; empty groups go and links are made mutual.
* ``derive``: all of it, as the ``Routing`` table of ``routed.py``.

Everything is float64 (the rows are the configuration's float32 rows) and
blockwise; nothing here reads the program.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import betainc

from bench.reference.knn import _blocks

_EPS = 1e-12


def _d2_blocks(x: torch.Tensor):
    """(rows slice, (rows, N) float64 squared distances to every row)."""
    n = x.shape[0]
    xd = x.double()
    xx = (xd * xd).sum(1)
    for qs, _ in _blocks(n, n):
        qb = xd[qs]
        yield qs, torch.clamp_min((qb * qb).sum(1)[:, None] + xx[None, :] - 2.0 * (qb @ xd.T),
                                  0.0)


def dbscan(x: torch.Tensor, eps: float, min_pts: int) -> np.ndarray:
    """(N,) int64 cluster of each row, -1 for noise (see the module doc)."""
    n = x.shape[0]
    eps2 = float(np.float32(eps) ** 2)
    dev = x.device
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    for qs, d2 in _d2_blocks(x):
        counts[qs] = (d2 <= eps2).sum(1)
    core = counts >= min_pts
    none = torch.tensor(n, device=dev)
    lab = torch.where(core, torch.arange(n, device=dev), none)
    while True:
        new = lab.clone()
        for qs, d2 in _d2_blocks(x):
            near = (d2 <= eps2) & core[None, :]
            new[qs] = torch.minimum(lab[qs], torch.where(near, lab[None, :], none).amin(1))
        new = torch.where(core, new, none)
        while True:  # every label to its label's label, until none moves
            ext = torch.cat([new, none[None]])
            jumped = ext[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    out = lab.clone()
    for qs, d2 in _d2_blocks(x):
        d2 = torch.where(core[None, :], d2, float("inf"))
        dmin, j = d2.min(1)
        out[qs] = torch.where(core[qs], lab[qs], torch.where(dmin <= eps2, lab[j], none))
    out = out.cpu().numpy()
    labels = np.full(n, -1, np.int64)
    live = out < n
    labels[live] = np.unique(out[live], return_inverse=True)[1]
    return labels


def _geometry(x: np.ndarray, members: np.ndarray) -> tuple[np.ndarray, float]:
    pts = x[members]
    pivot = pts.mean(0)
    return pivot, float(np.sqrt(((pts - pivot) ** 2).sum(-1)).max()) if len(pts) else 0.0


def partitions(x: np.ndarray, labels: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pivots (C, D), radii (C,), the partition of each row (N,))."""
    c = int(labels.max()) + 1
    if c == 0:
        pivot, radius = _geometry(x, np.arange(len(x)))
        return pivot[None], np.array([radius]), np.zeros(len(x), np.int64)
    live = labels >= 0
    pivots = np.zeros((c, x.shape[1]))
    np.add.at(pivots, labels[live], x[live])
    pivots /= np.maximum(np.bincount(labels[live], minlength=c), 1)[:, None]
    assign = labels.copy()
    noise = np.nonzero(~live)[0]
    if len(noise):
        assign[noise] = _dist(x[noise], pivots).argmin(1)
    radii = np.zeros(c)
    np.maximum.at(radii, assign, np.sqrt(((x - pivots[assign]) ** 2).sum(-1)))
    return pivots, radii, assign


def _dist(x: np.ndarray, pivots: np.ndarray) -> np.ndarray:
    """(N, C) distances of rows to pivots, a pivot at a time."""
    return np.stack([np.sqrt(((x - p) ** 2).sum(-1)) for p in pivots], 1)


def _cos(ri, rj, d):
    return np.clip((ri ** 2 + d ** 2 - rj ** 2) / np.maximum(2.0 * ri * d, _EPS), -1.0, 1.0)


def _cap_share(n_dim: int, cos):
    """A hyperspherical cap's volume over its ball's."""
    half = 0.5 * betainc(0.5 * (n_dim + 1), 0.5, np.clip(1.0 - cos ** 2, 0.0, 1.0))
    return np.where(cos >= 0.0, half, 1.0 - half)


def rates(method: str, x: np.ndarray, pivots: np.ndarray, radii: np.ndarray,
          assign: np.ndarray) -> np.ndarray:
    """(C, C) overlap rates, 0 on the diagonal."""
    d = np.sqrt(((pivots[:, None, :] - pivots[None, :, :]) ** 2).sum(-1))
    r1, r2 = radii[:, None], radii[None, :]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        c1, c2 = _cos(r1, r2, d), _cos(r2, r1, d)
        if method == "vbm":
            # V(r) = C_n r^n: C_n cancels, and the powers are taken over the larger radius
            n_dim = x.shape[1]
            top = np.maximum(np.maximum(r1, r2), _EPS)
            v1, v2 = (r1 / top) ** n_dim, (r2 / top) ** n_dim
            partial = (v1 * _cap_share(n_dim, c1) + v2 * _cap_share(n_dim, c2)) / (v1 + v2)
            # balls that cut one another share a lens of some volume, however small
            partial = np.maximum(partial, np.finfo(np.float64).tiny)
        elif method == "dbm":
            partial = np.clip((r1 * (1.0 - c1) + r2 * (1.0 - c2)) / np.maximum(d, _EPS), 0.0, 1.0)
        elif method == "obm":
            inside = _dist(x, pivots) <= radii[None, :]
            shared = inside.T.astype(np.int64) @ inside.astype(np.int64)
            sizes = np.bincount(assign, minlength=len(radii))
            partial = shared / np.maximum(sizes[:, None] + sizes[None, :], 1)
        else:
            raise ValueError(f"unknown overlap method {method!r}")
    out = np.where(d >= r1 + r2, 0.0, np.where(d <= np.abs(r1 - r2), 1.0, partial))
    np.fill_diagonal(out, 0.0)
    return out


def _inside(x: np.ndarray, members: np.ndarray, pivot: np.ndarray, radius: float) -> np.ndarray:
    return members[np.sqrt(((x[members] - pivot) ** 2).sum(-1)) <= radius]


def decide(x: np.ndarray, pivots: np.ndarray, radii: np.ndarray, assign: np.ndarray, *,
           method: str, xi_min: float, xi_max: float) -> tuple[np.ndarray, np.ndarray,
                                                                list[list[int]]]:
    """(the index of each row (N,), index centers (I, D), each index's
    neighbours), by the rules of the module doc."""
    c0 = len(radii)
    r = rates(method, x, pivots, radii, assign)
    # high: each partition joins the smallest partition it is linked to by a chain
    root = np.arange(c0)
    hi_i, hi_j = np.nonzero(np.triu(r, 1) >= xi_max)
    while True:
        low = np.minimum(root[hi_i], root[hi_j])
        new = root.copy()
        np.minimum.at(new, hi_i, low)
        np.minimum.at(new, hi_j, low)
        new = new[new]
        if np.array_equal(new, root):
            break
        root = new
    group_of = np.unique(root, return_inverse=True)[1][assign]
    members = [np.nonzero(group_of == g)[0] for g in range(group_of.max() + 1)]
    geo = [_geometry(x, m) for m in members]
    piv = np.stack([p for p, _ in geo])
    rad = np.array([rr for _, rr in geo])
    r = rates(method, x, piv, rad, group_of) if len(members) > 1 else np.zeros((1, 1))
    links: list[list[int]] = [[] for _ in members]
    taken = np.zeros(len(x), bool)
    n_merged = len(members)
    # medium: highest rate first, ties in row-major order
    med_i, med_j = np.nonzero((np.triu(r, 1) >= xi_min) & (np.triu(r, 1) < xi_max))
    for t in np.argsort(-r[med_i, med_j], kind="stable"):
        a, b = int(med_i[t]), int(med_j[t])
        lens_a = _inside(x, members[a], piv[b], rad[b])
        lens_b = _inside(x, members[b], piv[a], rad[a])
        lens = np.concatenate([lens_a, lens_b])
        lens = lens[~taken[lens]]
        if not len(lens):
            continue
        taken[lens] = True
        links.append([a, b])
        links[a].append(len(members))
        links[b].append(len(members))
        members.append(lens)
        members[a] = members[a][~np.isin(members[a], lens_a)]
        members[b] = members[b][~np.isin(members[b], lens_b)]
    # low: the smaller cap's rows inside the other ball move, in row-major order
    upper = np.triu(r, 1)
    for a, b in zip(*np.nonzero((upper > 0) & (upper < xi_min))):
        a, b = int(a), int(b)
        d = float(np.sqrt(((piv[a] - piv[b]) ** 2).sum()))
        if d <= 0:
            continue
        ha = rad[a] * (1.0 - _cos(rad[a], rad[b], d))
        hb = rad[b] * (1.0 - _cos(rad[b], rad[a], d))
        src, dst = (a, b) if ha <= hb else (b, a)
        move = _inside(x, members[src], piv[dst], rad[dst])
        move = move[~taken[move]]
        if len(move):
            members[src] = members[src][~np.isin(members[src], move)]
            members[dst] = np.concatenate([members[dst], move])
    assert len(links) == len(members) and n_merged <= len(members)
    keep = [g for g, m in enumerate(members) if len(m)]
    renum = {old: new for new, old in enumerate(keep)}
    owner = np.empty(len(x), np.int64)
    centers = np.zeros((len(keep), x.shape[1]))
    nbrs: list[set[int]] = [set() for _ in keep]
    for new, old in enumerate(keep):
        owner[members[old]] = new
        centers[new] = x[members[old]].mean(0)
        for nb in links[old]:
            if nb in renum:
                nbrs[new].add(renum[nb])
                nbrs[renum[nb]].add(new)
    return owner, centers, [sorted(s) for s in nbrs]


def derive(x: torch.Tensor, index: dict):
    """The ``routed.Routing`` of the forest that the configuration's
    ``index`` entry builds over the rows ``x`` (N, D)."""
    from bench.reference.routed import Routing

    labels = dbscan(x, index["eps"], int(index["min_pts"]))
    xh = x.double().cpu().numpy()
    pivots, radii, assign = partitions(xh, labels)
    owner, centers, nbrs = decide(xh, pivots, radii, assign, method=index["method"],
                                  xi_min=index["xi_min"], xi_max=index["xi_max"])
    routed = np.eye(len(centers), dtype=bool)
    for i, row in enumerate(nbrs):
        routed[i, row] = True
    return Routing(torch.from_numpy(centers), torch.from_numpy(routed), torch.from_numpy(owner))
