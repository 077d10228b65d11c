"""BCCF-tree construction (paper Def. 12; baseline of [5]).

Internal node: two pivots (p1, p2) with covering radii (r1, r2) taken over
*all* objects of the subtree; children partition objects by the GH rule
(d(o,p1) <= d(o,p2)).  Leaves are buckets of capacity c_max = sqrt(n).

Two pivot-selection strategies:
* ``kmeans`` — the BCCF baseline: recursive 2-means (pivots = objects nearest
  to the converged centroids).  Expensive: ~2m distances per iteration.
* ``gh``     — the paper's proposed refinement (§4.3): cheap GH pivots
  (random p1, farthest-point p2), single assignment pass.

Construction is host numpy, the same code as the JAX package's
``repro.core.bccf``, so the same seed gives the same tree bit for bit.  Every
distance evaluation and comparison is counted: those counters are the
paper's construction-cost metric (Fig. 20).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BuildCounters:
    distances: int = 0
    comparisons: int = 0


@dataclass
class TreeStructure:
    """Structure-evaluation metrics (paper Figs. 6-19)."""

    n_internal: int = 0
    n_leaves: int = 0
    height: int = 0
    bucket_sizes: list[int] = field(default_factory=list)
    nodes_per_level: dict[int, int] = field(default_factory=dict)


@dataclass
class FlatTree:
    """Flattened BCCF tree. ``node_children`` entries: >= 0 -> internal node
    id; < 0 -> bucket id encoded as -(local_bucket_id + 1); for single-bucket
    trees ``node_pivots`` is empty and the only bucket is bucket 0."""

    node_pivots: np.ndarray  # (M, 2, D) f32
    node_radii: np.ndarray  # (M, 2) f32
    node_children: np.ndarray  # (M, 2) i32
    bucket_members: list[np.ndarray]  # local bucket id -> global object ids
    structure: TreeStructure
    counters: BuildCounters


def _dists(a: np.ndarray, b: np.ndarray, counters: BuildCounters) -> np.ndarray:
    """Row-wise distances from points ``a`` (m, D) to single point ``b``."""
    counters.distances += len(a)
    return np.sqrt(np.maximum(((a - b) ** 2).sum(-1), 0.0))


def _pivots_gh(pts: np.ndarray, rng: np.random.Generator, c: BuildCounters):
    i1 = int(rng.integers(len(pts)))
    d1 = _dists(pts, pts[i1], c)
    c.comparisons += len(pts)
    i2 = int(d1.argmax())
    if i2 == i1:  # all points identical
        i2 = (i1 + 1) % len(pts)
    return i1, i2, d1


def _pivots_kmeans(
    pts: np.ndarray, rng: np.random.Generator, c: BuildCounters, max_iter: int = 10
):
    """2-means; returns indices of the objects closest to the centroids."""
    i1, i2, _ = _pivots_gh(pts, rng, c)  # far-pair init
    cent = np.stack([pts[i1], pts[i2]]).astype(np.float64)
    prev = None
    for _ in range(max_iter):
        d0 = _dists(pts, cent[0], c)
        d1 = _dists(pts, cent[1], c)
        c.comparisons += len(pts)
        assign = (d1 < d0).astype(np.int32)
        if prev is not None and np.array_equal(assign, prev):
            break
        prev = assign
        for k in (0, 1):
            sel = pts[assign == k]
            if len(sel):
                cent[k] = sel.mean(axis=0)
    j1 = int(_dists(pts, cent[0], c).argmin())
    j2 = int(_dists(pts, cent[1], c).argmin())
    c.comparisons += 2 * len(pts)
    if j1 == j2:
        j2 = (j1 + 1) % len(pts)
    return j1, j2


def build_tree(
    x: np.ndarray,
    ids: np.ndarray,
    *,
    c_max: int,
    pivot_method: str = "gh",
    seed: int = 0,
) -> FlatTree:
    """Build a flattened BCCF tree over ``x`` (m, D) with object ids ``ids``."""
    x = np.asarray(x, np.float32)
    ids = np.asarray(ids)
    if len(ids) == 0:
        raise ValueError("cannot build a tree over zero objects")
    rng = np.random.default_rng(seed)
    counters = BuildCounters()
    structure = TreeStructure()

    node_pivots: list[np.ndarray] = []
    node_radii: list[np.ndarray] = []
    node_children: list[list[int]] = []
    buckets: list[np.ndarray] = []

    def make_leaf(sub_ids: np.ndarray, level: int) -> int:
        bucket_id = len(buckets)
        buckets.append(sub_ids)
        structure.n_leaves += 1
        structure.bucket_sizes.append(len(sub_ids))
        structure.height = max(structure.height, level)
        structure.nodes_per_level[level] = structure.nodes_per_level.get(level, 0) + 1
        return -(bucket_id + 1)

    def rec(sub: np.ndarray, sub_ids: np.ndarray, level: int) -> int:
        if len(sub_ids) <= c_max:
            return make_leaf(sub_ids, level)
        if pivot_method == "kmeans":
            i1, i2 = _pivots_kmeans(sub, rng, counters)
            d1 = _dists(sub, sub[i1], counters)
            d2 = _dists(sub, sub[i2], counters)
        elif pivot_method == "gh":
            i1, i2, d1 = _pivots_gh(sub, rng, counters)
            d2 = _dists(sub, sub[i2], counters)
        else:
            raise ValueError(f"pivot_method {pivot_method!r}")
        counters.comparisons += len(sub_ids)
        left = d1 <= d2
        # Degenerate split (duplicate-heavy nodes): balanced fallback.
        if left.all() or (~left).all():
            order = np.argsort(d1, kind="stable")
            left = np.zeros(len(sub_ids), bool)
            left[order[: len(sub_ids) // 2]] = True
        # Def. 12: radii are max distance over the WHOLE node per pivot.
        r1 = float(d1.max())
        r2 = float(d2.max())
        node_id = len(node_children)
        node_pivots.append(np.stack([sub[i1], sub[i2]]))
        node_radii.append(np.array([r1, r2], np.float32))
        node_children.append([0, 0])
        structure.n_internal += 1
        structure.nodes_per_level[level] = structure.nodes_per_level.get(level, 0) + 1
        cl = rec(sub[left], sub_ids[left], level + 1)
        cr = rec(sub[~left], sub_ids[~left], level + 1)
        node_children[node_id] = [cl, cr]
        return node_id

    rec(x, ids, 0)
    d = x.shape[1]
    return FlatTree(
        node_pivots=(np.stack(node_pivots) if node_pivots else np.zeros((0, 2, d), np.float32)),
        node_radii=(np.stack(node_radii) if node_radii else np.zeros((0, 2), np.float32)),
        node_children=(np.array(node_children, np.int32) if node_children else np.zeros((0, 2), np.int32)),
        bucket_members=buckets,
        structure=structure,
        counters=counters,
    )
