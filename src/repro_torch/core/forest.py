"""Forest of BCCF indexes — the flattened structure the search consumes.

The decision stage (§4.3) emits groups with neighbor links; each group is
indexed by one BCCF tree.  This module packs the whole forest into fixed-shape
host numpy arrays, the same layout as the JAX package's
``repro.core.forest.ForestArrays``, which ``core/knn.device_forest`` uploads:

  index_centers  (I, D)        group pivot (Alg. 2 step-1 routing)
  index_radii    (I,)
  neighbors      (I, MAXNBR)   i32, -1 padded (overlap-index links)
  bucket_x       (NB, C, D)    bucket member coordinates, zero padded
  bucket_ids     (NB, C)       i32 global object ids, -1 padded
  bucket_mask    (NB, C)       bool
  bucket_pivot   (NB, D)       bucket centroid (lower-bound reference point)
  bucket_radius  (NB,)         max distance member -> pivot
  bucket_index   (NB,)         i32 owning index id
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.bccf import BuildCounters, FlatTree, build_tree
from repro_torch.core.decision import Partition

# the array fields, by name: what crosses between the two packages
FOREST_FIELDS = (
    "index_centers", "index_radii", "neighbors", "is_overlap_index",
    "bucket_x", "bucket_ids", "bucket_mask", "bucket_pivot", "bucket_radius",
    "bucket_index",
)


@dataclass
class ForestArrays:
    index_centers: np.ndarray
    index_radii: np.ndarray
    neighbors: np.ndarray
    is_overlap_index: np.ndarray  # (I,) bool
    bucket_x: np.ndarray
    bucket_ids: np.ndarray
    bucket_mask: np.ndarray
    bucket_pivot: np.ndarray
    bucket_radius: np.ndarray
    bucket_index: np.ndarray
    c_max: int
    trees: list[FlatTree] = field(default_factory=list, repr=False)
    build_stats: dict[str, Any] = field(default_factory=dict)

    @property
    def n_indexes(self) -> int:
        return int(self.index_centers.shape[0])

    @property
    def n_buckets(self) -> int:
        return int(self.bucket_x.shape[0])

    def aggregate_structure(self) -> dict[str, Any]:
        """Structure-evaluation rollup (paper Figs. 6-19), from the per-tree
        host copies in ``self.trees``; refuses to report numbers that
        disagree with the flattened arrays the search scans."""
        total_leaves = sum(t.structure.n_leaves for t in self.trees)
        if self.trees and total_leaves != self.n_buckets:
            raise RuntimeError(
                f"stale forest structure: trees report {total_leaves} leaves "
                f"but the flattened arrays hold {self.n_buckets} buckets"
            )
        per_tree = []
        for t in self.trees:
            s = t.structure
            per_tree.append(
                dict(
                    n_internal=s.n_internal,
                    n_leaves=s.n_leaves,
                    height=s.height,
                    bucket_sizes=list(s.bucket_sizes),
                    nodes_per_level=dict(s.nodes_per_level),
                )
            )
        all_buckets = [b for t in per_tree for b in t["bucket_sizes"]]
        return dict(
            n_trees=len(per_tree),
            trees=per_tree,
            total_internal=sum(t["n_internal"] for t in per_tree),
            total_leaves=sum(t["n_leaves"] for t in per_tree),
            max_height=max((t["height"] for t in per_tree), default=0),
            bucket_fill_mean=float(np.mean(all_buckets)) if all_buckets else 0.0,
            bucket_fill_median=float(np.median(all_buckets)) if all_buckets else 0.0,
        )


def _flatten_trees(
    x: np.ndarray, trees: list[FlatTree], *, c_max: int
) -> dict[str, np.ndarray]:
    """Flatten per-tree buckets into the fixed-shape SoA device layout."""
    dim = x.shape[1]
    bucket_rows: list[np.ndarray] = []
    bucket_idrows: list[np.ndarray] = []
    bucket_owner: list[int] = []
    for gi, tree in enumerate(trees):
        for members in tree.bucket_members:
            bucket_rows.append(x[members])
            bucket_idrows.append(np.asarray(members, np.int64))
            bucket_owner.append(gi)

    nb = len(bucket_rows)
    cap = max(c_max, max((len(b) for b in bucket_rows), default=1))
    bucket_x = np.zeros((nb, cap, dim), np.float32)
    bucket_ids = np.full((nb, cap), -1, np.int32)
    bucket_mask = np.zeros((nb, cap), bool)
    bucket_pivot = np.zeros((nb, dim), np.float32)
    bucket_radius = np.zeros((nb,), np.float32)
    for i, (pts, bids) in enumerate(zip(bucket_rows, bucket_idrows)):
        m = len(pts)
        bucket_x[i, :m] = pts
        bucket_ids[i, :m] = bids
        bucket_mask[i, :m] = True
        piv = pts.mean(axis=0)
        bucket_pivot[i] = piv
        bucket_radius[i] = np.sqrt(((pts - piv) ** 2).sum(-1)).max() if m else 0.0
    return dict(
        bucket_x=bucket_x,
        bucket_ids=bucket_ids,
        bucket_mask=bucket_mask,
        bucket_pivot=bucket_pivot,
        bucket_radius=bucket_radius,
        bucket_index=np.array(bucket_owner, np.int32),
        c_max=int(cap),
    )


def build_forest(
    x: np.ndarray,
    groups: list[Partition],
    *,
    c_max: int,
    pivot_method: str = "gh",
    seed: int = 0,
) -> ForestArrays:
    """Build one BCCF tree per decision group and flatten into a forest."""
    x = np.asarray(x, np.float32)
    trees: list[FlatTree] = []
    counters = BuildCounters()
    for gi, g in enumerate(groups):
        tree = build_tree(
            x[g.members], g.members, c_max=c_max, pivot_method=pivot_method, seed=seed + gi
        )
        trees.append(tree)
        counters.distances += tree.counters.distances
        counters.comparisons += tree.counters.comparisons

    flat = _flatten_trees(x, trees, c_max=c_max)
    max_nbr = max((len(g.neighbors) for g in groups), default=0)
    neighbors = np.full((len(groups), max(max_nbr, 1)), -1, np.int32)
    for i, g in enumerate(groups):
        neighbors[i, : len(g.neighbors)] = np.asarray(g.neighbors, np.int32)

    return ForestArrays(
        index_centers=np.stack([g.pivot for g in groups]).astype(np.float32),
        index_radii=np.array([g.radius for g in groups], np.float32),
        neighbors=neighbors,
        is_overlap_index=np.array([g.is_overlap_index for g in groups], bool),
        trees=trees,
        build_stats=dict(
            tree_distances=counters.distances,
            tree_comparisons=counters.comparisons,
            rebuilds=0,
        ),
        **flat,
    )


def swap_trees(
    forest: ForestArrays,
    x: np.ndarray,
    replacements: dict[int, FlatTree],
    *,
    index_centers: np.ndarray | None = None,
    index_radii: np.ndarray | None = None,
) -> ForestArrays:
    """Swap freshly rebuilt per-index trees into a forest (the hot rebuild).

    Returns a new ForestArrays (the old one keeps serving until the caller
    swaps the device upload) with the bucket arrays re-flattened from the
    updated tree set by ``_flatten_trees``, the host ``trees`` refreshed (so
    ``aggregate_structure`` describes the live trees), ``build_stats``
    accumulated over the build and every rebuild (the paper's construction
    cost includes maintenance) with a ``rebuilds`` tally, and optionally the
    post-ingest index geometry.  ``x`` must cover every global object id any
    tree references.
    """
    x = np.asarray(x, np.float32)
    trees = list(forest.trees)
    add = BuildCounters()
    for gi, tree in replacements.items():
        if not (0 <= gi < len(trees)):
            raise ValueError(f"replacement for unknown index {gi}")
        trees[gi] = tree
        add.distances += tree.counters.distances
        add.comparisons += tree.counters.comparisons

    flat = _flatten_trees(x, trees, c_max=forest.c_max)
    centers = forest.index_centers.copy() if index_centers is None else (
        np.asarray(index_centers, np.float32)
    )
    radii = forest.index_radii.copy() if index_radii is None else (
        np.asarray(index_radii, np.float32)
    )
    stats = dict(forest.build_stats)
    stats["tree_distances"] = stats.get("tree_distances", 0) + add.distances
    stats["tree_comparisons"] = stats.get("tree_comparisons", 0) + add.comparisons
    stats["rebuilds"] = stats.get("rebuilds", 0) + len(replacements)
    return ForestArrays(
        index_centers=centers,
        index_radii=radii,
        neighbors=forest.neighbors.copy(),
        is_overlap_index=forest.is_overlap_index.copy(),
        trees=trees,
        build_stats=stats,
        **flat,
    )
