"""End-to-end index pipeline (paper §4): preprocessing -> overlap estimation
-> decision-making -> forest construction, the JAX package's
``repro.core.pipeline``.  The ``OverlapIndex`` facade wraps both builds:

  build_index_core(x, cfg, device=)  the paper's proposed method: DBSCAN
                                     (K3-K5 on the card) and the overlap
                                     rates on ``device``, the decision and
                                     the trees on the host
  build_baseline_core(x, cfg)        the BCCF-tree baseline (single tree,
                                     host numpy)
"""
from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core.dbscan import dbscan, partitions_from_labels
from repro_torch.core.decision import Partition, decide
from repro_torch.core.forest import ForestArrays, build_forest
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class IndexConfig:
    method: str = "vbm"  # vbm | dbm | obm
    xi_min: float = 0.4
    xi_max: float = 0.8
    eps: float = 1.0
    min_pts: int = 8
    c_max: int | None = None  # default sqrt(n)
    pivot_method: str = "gh"  # proposed trees use GH partitioning (§4.3)
    seed: int = 0
    dbscan_block: int = 1024


@dataclass
class BuildReport:
    config: IndexConfig
    n_objects: int = 0
    n_clusters: int = 0
    n_indexes: int = 0
    n_overlap_indexes: int = 0
    dbscan_distances: int = 0
    overlap_distances: int = 0
    tree_distances: int = 0
    tree_comparisons: int = 0
    wall_time_s: float = 0.0
    detail: dict[str, Any] = field(default_factory=dict)
    # wall seconds per build phase (dbscan, decide, forest); the JAX
    # package's report has no such field
    phase_s: dict[str, float] = field(default_factory=dict)


def default_c_max(n: int) -> int:
    """Paper Def. 12: c_max = sqrt(n)."""
    return max(4, int(math.sqrt(n)))


def default_delta_capacity(n: int) -> int:
    """Per-index streaming delta-bucket capacity: one c_max-sized tail per
    index, floor 64 so tiny seed sets still buffer usefully."""
    return max(64, default_c_max(n))


def build_index_core(x, cfg: IndexConfig, *, device=None) -> tuple[ForestArrays, BuildReport]:
    """The paper's pipeline: DBSCAN -> overlap -> decision -> forest.

    DBSCAN and the overlap rates run on ``device`` (``cuda`` unless named;
    without CUDA an error, ``device="cpu"`` runs the plain versions); the
    decision and the BCCF trees are host numpy.
    """
    device = resolve_device(device)
    t0 = time.perf_counter()
    x = np.asarray(x, np.float32)
    n = len(x)
    c_max = cfg.c_max or default_c_max(n)
    report = BuildReport(config=cfg, n_objects=n)

    # (i) preprocessing: DBSCAN (§4.1)
    res = dbscan(x, cfg.eps, cfg.min_pts, block=cfg.dbscan_block, device=device)
    report.dbscan_distances = res.distance_computations
    report.n_clusters = res.n_clusters
    pivots, radii, assign = partitions_from_labels(x, res.labels, res.n_clusters)
    t1 = time.perf_counter()

    # (ii)+(iii) overlap estimation + decision (§4.2, §4.3)
    groups, dstats = decide(
        x, pivots, radii, assign,
        method=cfg.method, xi_min=cfg.xi_min, xi_max=cfg.xi_max, device=device,
    )
    report.overlap_distances = dstats.distance_computations
    report.n_overlap_indexes = dstats.n_overlap_indexes
    t2 = time.perf_counter()

    # indexing: one BCCF tree per group, GH pivots (§4.3)
    forest = build_forest(
        x, groups, c_max=c_max, pivot_method=cfg.pivot_method, seed=cfg.seed
    )
    report.n_indexes = forest.n_indexes
    report.tree_distances = forest.build_stats["tree_distances"]
    report.tree_comparisons = forest.build_stats["tree_comparisons"]
    t3 = time.perf_counter()
    report.wall_time_s = t3 - t0
    report.phase_s = dict(dbscan=t1 - t0, decide=t2 - t1, forest=t3 - t2)
    report.detail = dict(
        decision=dstats.__dict__,
        dbscan_iterations=res.n_iterations,
        structure=forest.aggregate_structure(),
    )
    return forest, report


def build_baseline_core(
    x, cfg: IndexConfig | None = None
) -> tuple[ForestArrays, BuildReport]:
    """BCCF-tree baseline [5]: one recursive tree over all data.

    The documented baseline semantics is 2-means ('kmeans') pivot selection
    — that is what ``cfg=None`` builds.  An explicit ``cfg`` is honored,
    including its ``pivot_method``; a non-kmeans choice emits a UserWarning
    because the result is then a single-tree ablation, not the paper's BCCF
    baseline.
    """
    t0 = time.perf_counter()
    x = np.asarray(x, np.float32)
    n = len(x)
    if cfg is None:
        cfg = IndexConfig(pivot_method="kmeans")
    elif cfg.pivot_method != "kmeans":
        warnings.warn(
            f"build_baseline honors cfg.pivot_method={cfg.pivot_method!r}, but "
            "the documented BCCF baseline uses 'kmeans' 2-means pivots; pass "
            "pivot_method='kmeans' (or cfg=None) to reproduce the paper's "
            "baseline",
            UserWarning,
            stacklevel=3,
        )
    c_max = cfg.c_max or default_c_max(n)
    pivot = x.mean(axis=0).astype(np.float32)
    radius = float(np.sqrt(((x - pivot) ** 2).sum(-1)).max())
    groups = [Partition(members=np.arange(n), pivot=pivot, radius=radius)]
    forest = build_forest(
        x, groups, c_max=c_max, pivot_method=cfg.pivot_method, seed=cfg.seed
    )
    report = BuildReport(config=cfg, n_objects=n, n_clusters=1, n_indexes=1)
    report.tree_distances = forest.build_stats["tree_distances"]
    report.tree_comparisons = forest.build_stats["tree_comparisons"]
    report.wall_time_s = time.perf_counter() - t0
    report.detail = dict(structure=forest.aggregate_structure())
    return forest, report
