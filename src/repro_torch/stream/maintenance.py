"""Overlap-driven online index maintenance.

The port of the JAX package's ``repro/stream/maintenance.py``.  The paper
computes the VBM/DBM/OBM overlap rates once, at build time.  Under
streaming ingest the delta appends shift centroids and inflate radii, so
the overlap the layout was chosen for stops being true.  ``OverlapMonitor``
re-evaluates the same heuristic (``core/overlap.py``, on the index's
device) on the updated geometry that ``stream/ingest.py`` keeps
incrementally, and past the thresholds schedules per-index host rebuilds
(``core/bccf.build_tree``) that absorb the delta into fresh trees
(``core/forest.swap_trees``).

Triggers (``DriftReport.reasons``):

  overlap   max_j rate[i, j] >= xi_rebuild, above the build-time baseline;
  drift     rate[i, j] rose by >= drift_margin over the baseline (off unless
            drift_margin is set);
  fill      delta fill fraction >= fill_rebuild;
  overflow  capacity-rejected appends recorded;
  wasted    measured wasted-visit share >= wasted_rebuild (fed in through
            ``note_wasted``; off unless wasted_rebuild is set).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter
from typing import Any

import numpy as np
import torch

from repro_torch.core.bccf import build_tree
from repro_torch.core.forest import ForestArrays, swap_trees
from repro_torch.core.overlap import get_overlap_method, max_neighbor_rate, overlap_matrix
from repro_torch.stream.ingest import DeltaBuffer, pull_delta_meta, updated_geometry


@dataclass(frozen=True)
class MaintenanceConfig:
    """Thresholds and rebuild knobs of the drift monitor (the facade spells
    the same knobs as ``repro_torch.api.StreamConfig``)."""

    method: str = "dbm"  # any registered overlap method, re-evaluated online
    xi_rebuild: float = 0.8  # absolute overlap rate forcing repartition
    drift_margin: float | None = None  # optional rise-over-baseline trigger
    fill_rebuild: float = 0.75  # delta fill fraction forcing a merge-rebuild
    wasted_rebuild: float | None = None  # measured wasted-visit share trigger
    pivot_method: str = "gh"
    c_max: int | None = None  # default: keep the forest's bucket capacity
    seed: int = 1


@dataclass
class DriftReport:
    """One monitor evaluation: updated rates against the baseline, and the
    triggers that fired."""

    rates_baseline: np.ndarray  # (I, I) build-time overlap rates
    rates: np.ndarray  # (I, I) rates on the updated geometry
    centers: np.ndarray  # (I, D) post-ingest centroids
    radii: np.ndarray  # (I,) conservative radius upper bounds
    fill: np.ndarray  # (I,) delta fill fraction
    dropped: np.ndarray  # (I,) capacity-rejected appends
    triggers: list[int] = field(default_factory=list)
    reasons: dict[int, list[str]] = field(default_factory=dict)

    @property
    def should_rebuild(self) -> bool:
        return bool(self.triggers)


def object_assignment(
    forest: ForestArrays, delta_host: dict[str, np.ndarray] | None, n_total: int
) -> np.ndarray:
    """(N,) object id -> owning index across the main buckets and the delta
    tails (-1 for an object in neither); OBM needs it (Def. 11)."""
    assign = np.full(n_total, -1, np.int64)
    m = forest.bucket_mask
    assign[forest.bucket_ids[m]] = np.repeat(forest.bucket_index, m.sum(axis=1))
    if delta_host is not None:
        for i in range(forest.n_indexes):
            c = int(delta_host["count"][i])
            if c:
                assign[delta_host["ids"][i, :c]] = i
    return assign


def _rates(
    method: str,
    centers: np.ndarray,
    radii: np.ndarray,
    x: np.ndarray | None,
    assign: np.ndarray | None,
    *,
    device,
) -> np.ndarray:
    """The (I, I) rate matrix through the port's overlap registry, computed
    on ``device``."""
    if get_overlap_method(method).needs_objects and (x is None or assign is None):
        raise ValueError(
            f"object-based drift monitoring ({method!r}) needs the dataset "
            "+ assignment"
        )

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    if assign is not None:
        # an object in no index (-1: waiting for a retry) counts for the
        # last index, where the JAX package's scatter wraps a negative index
        assign = np.where(assign < 0, assign + len(centers), assign)
    rates = overlap_matrix(
        method, put(centers, torch.float32), put(radii, torch.float32),
        x=None if x is None else put(x, torch.float32),
        assign=None if assign is None else put(assign, torch.int64),
    )
    return rates.cpu().numpy()


class OverlapMonitor:
    """Re-evaluates the paper's overlap heuristic as the geometry drifts.

    The baseline is the forest's build-time geometry; ``check`` recomputes
    the same heuristic on the post-ingest geometry
    (``stream.ingest.updated_geometry``) and classifies each index against
    the thresholds.  O(I^2) rate arithmetic on the running sums, except OBM,
    which is defined over the objects and receives them.  The rates run on
    ``device``, the index's.
    """

    # minimum attributed visits into an index before the measured-waste
    # trigger may fire
    WASTED_MIN_VISITS = 16

    def __init__(
        self,
        forest: ForestArrays,
        cfg: MaintenanceConfig,
        *,
        x: np.ndarray | None = None,
        device,
    ):
        self.cfg = cfg
        self.forest = forest
        self.device = torch.device(device)
        assign = None
        if get_overlap_method(cfg.method).needs_objects:
            if x is None:
                raise ValueError(
                    f"object-based monitor ({cfg.method!r}) needs the dataset "
                    "at construction"
                )
            assign = object_assignment(forest, None, len(x))
        self.rates_baseline = _rates(
            cfg.method, forest.index_centers, forest.index_radii, x, assign,
            device=self.device,
        )
        n_idx = forest.n_indexes
        # measured-waste accumulators; recreated with the monitor after a
        # rebuild, when the geometry they judged stops existing
        self.wasted_visits = np.zeros(n_idx, np.int64)  # wasted, by visited
        self.attr_visits = np.zeros(n_idx, np.int64)  # all, by visited

    def note_wasted(self, wasted_pair: np.ndarray, visited_pair: np.ndarray) -> None:
        """Fold one explain report's (visited, home) pair matrices into the
        lifetime accumulators (rows: visited index)."""
        self.wasted_visits += np.asarray(wasted_pair, np.int64).sum(axis=1)
        self.attr_visits += np.asarray(visited_pair, np.int64).sum(axis=1)

    def wasted_share(self) -> np.ndarray:
        """(I,) share of attributed visits into each index that were wasted
        (0 where nothing was attributed yet)."""
        return self.wasted_visits / np.maximum(self.attr_visits, 1)

    def check(self, delta: DeltaBuffer, *, x: np.ndarray | None = None) -> DriftReport:
        cfg = self.cfg
        needs_objects = get_overlap_method(cfg.method).needs_objects
        centers_d, radii_d = updated_geometry(delta)
        centers = centers_d.cpu().numpy()
        radii = radii_d.cpu().numpy()
        host = pull_delta_meta(delta, ids=needs_objects)
        assign = None
        if needs_objects:
            if x is None:
                raise ValueError(
                    f"object-based drift check ({cfg.method!r}) needs the dataset"
                )
            assign = object_assignment(self.forest, host, len(x))
        rates = _rates(cfg.method, centers, radii, x, assign, device=self.device)

        capd = delta.capacity
        fill = host["count"].astype(np.float64) / max(capd, 1)
        report = DriftReport(
            rates_baseline=self.rates_baseline, rates=rates, centers=centers,
            radii=radii, fill=fill, dropped=host["dropped"],
        )
        worst = max_neighbor_rate(torch.from_numpy(rates)).numpy()
        worst_base = max_neighbor_rate(torch.from_numpy(self.rates_baseline)).numpy()
        for i in range(len(radii)):
            why = []
            # fire only on overlap the current layout does not account for:
            # where the baseline itself sits at or above the rate, a
            # per-index rebuild cannot lower it (that pair needs a merge,
            # the decision stage's job) and re-firing would churn forever
            if worst[i] >= cfg.xi_rebuild and worst[i] > worst_base[i] + 1e-6:
                why.append("overlap")
            if cfg.drift_margin is not None and (
                worst[i] - worst_base[i] >= cfg.drift_margin
            ):
                why.append("drift")
            if fill[i] >= cfg.fill_rebuild:
                why.append("fill")
            if host["dropped"][i] > 0:
                why.append("overflow")
            if (
                cfg.wasted_rebuild is not None
                and self.attr_visits[i] >= self.WASTED_MIN_VISITS
                and self.wasted_share()[i] >= cfg.wasted_rebuild
            ):
                why.append("wasted")
            if why:
                report.triggers.append(i)
                report.reasons[i] = why
        return report


def rebuild_indexes(
    forest: ForestArrays,
    delta: DeltaBuffer,
    x_all: np.ndarray,
    triggers: list[int],
    cfg: MaintenanceConfig,
) -> tuple[ForestArrays, dict[str, Any]]:
    """Rebuild the triggered indexes' BCCF trees with their delta absorbed.

    On the host: per index, the main members from the forest's tree copies
    plus the delta members, one ``core.bccf.build_tree`` (seed
    ``cfg.seed + index``), the exact centroid and radius, and one
    ``forest.swap_trees`` for all of them.  Returns (new ForestArrays,
    rebuild stats).
    """
    host = pull_delta_meta(delta, ids=True)
    replacements = {}
    centers = forest.index_centers.copy()
    radii = forest.index_radii.copy()
    n_absorbed = 0
    t0 = perf_counter()
    for gi in triggers:
        main_ids = np.concatenate(
            [np.asarray(m, np.int64) for m in forest.trees[gi].bucket_members]
        )
        c = int(host["count"][gi])
        d_ids = host["ids"][gi, :c].astype(np.int64)
        members = np.concatenate([main_ids, d_ids])
        n_absorbed += c
        pts = x_all[members]
        replacements[gi] = build_tree(
            pts, members, c_max=cfg.c_max or forest.c_max,
            pivot_method=cfg.pivot_method, seed=cfg.seed + gi,
        )
        center = pts.mean(axis=0).astype(np.float32)
        centers[gi] = center
        radii[gi] = float(np.sqrt(((pts - center) ** 2).sum(-1)).max())
    new_forest = swap_trees(
        forest, x_all, replacements, index_centers=centers, index_radii=radii
    )
    stats = dict(
        n_rebuilt=len(triggers),
        n_absorbed=n_absorbed,
        rebuild_distances=sum(t.counters.distances for t in replacements.values()),
        wall_time_s=perf_counter() - t0,
    )
    return new_forest, stats
