"""``OverlapIndex`` — the owner object for one forest and its searches.

    from repro_torch.api import OverlapIndex

    ix = OverlapIndex.build(x, cfg)          # the paper's overlap forest, on "cuda"
    ix = OverlapIndex.baseline(x)            # BCCF baseline, on "cuda"
    res = ix.search(q, k=10, beam=4)         # SearchResult: dists / ids / stats

The facade owns the host ``ForestArrays``, the device ``DeviceForest``
upload (quantized per ``cfg.search``), and a ``PlanCache`` of search
executors.  Entry points run on ``cuda`` unless the caller passes a
``device``; with no device given and no CUDA available they raise rather than
run on the CPU.  The port carries the overlap build, the baseline build and
search so far; streaming, persistence and serving come with later slices.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.api.config import (
    SEARCH_MODES,
    Config,
    ConfigError,
    as_index_config,
)
from repro_torch.api.executor import SingleDeviceBackend
from repro_torch.api.plan import PlanCache, PlanKey, SearchResult, results_to_host
from repro_torch.core.forest import ForestArrays
from repro_torch.core.knn import DeviceForest
from repro_torch.core.pipeline import (
    BuildReport,
    IndexConfig as _CoreIndexConfig,
    build_baseline_core,
    build_index_core,
    default_delta_capacity,
)
from repro_torch.device import resolve_device


def _as_config(cfg: Config | _CoreIndexConfig | None) -> Config:
    if cfg is None:
        return Config()
    if isinstance(cfg, Config):
        return cfg
    if isinstance(cfg, _CoreIndexConfig):  # incl. the validated subclass
        return Config(index=as_index_config(cfg))
    raise ConfigError(
        f"expected a repro_torch.api.Config (or an IndexConfig for the index "
        f"node), got {type(cfg).__name__}"
    )


def _check_data(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if x.ndim != 2 or len(x) == 0:
        raise ConfigError(
            f"dataset must be a non-empty (N, D) array, got shape {x.shape}"
        )
    return x


class OverlapIndex:
    """Lifecycle owner for one forest (see module doc)."""

    def __init__(self, *args, **kwargs):
        raise TypeError(
            "OverlapIndex is constructed via OverlapIndex.build(x, cfg) or "
            "OverlapIndex.baseline(x, cfg)"
        )

    @classmethod
    def _wire(
        cls, x: np.ndarray, forest: ForestArrays, cfg: Config,
        report: BuildReport, device: torch.device,
    ) -> "OverlapIndex":
        self = object.__new__(cls)
        self.cfg = cfg
        self.forest = forest
        self.build_report = report
        self.backend = SingleDeviceBackend(device)
        self._x = x
        self.n_total = len(x)
        self._device: DeviceForest | None = None  # lazy (see .device)
        self.capacity = default_delta_capacity(self.n_total)
        self.plans = PlanCache()
        return self

    @classmethod
    def build(
        cls, x, cfg: Config | _CoreIndexConfig | None = None, *, device=None
    ) -> "OverlapIndex":
        """The paper's proposed pipeline (§4): overlap-optimized forest.
        DBSCAN (K3-K5) and the overlap rates run on ``device`` (default
        ``cuda``), where searches run too; the decision and the trees are
        built on the host."""
        dev = resolve_device(device)
        cfg = _as_config(cfg)
        x = _check_data(x)
        forest, report = build_index_core(x, cfg.index, device=dev)
        return cls._wire(x, forest, cfg, report, dev)

    @classmethod
    def baseline(
        cls, x, cfg: Config | _CoreIndexConfig | None = None, *, device=None
    ) -> "OverlapIndex":
        """The BCCF-tree baseline: one tree over all data.  With no config
        this builds the paper's documented 2-means baseline; an explicit
        config is honored (see ``build_baseline_core``).  ``device`` is the
        torch device searches run on (default ``cuda``)."""
        dev = resolve_device(device)
        x = _check_data(x)
        if cfg is None:
            forest, report = build_baseline_core(x, None)
            cfg = Config(index=as_index_config(report.config))
        else:
            cfg = _as_config(cfg)
            forest, report = build_baseline_core(x, cfg.index)
        return cls._wire(x, forest, cfg, report, dev)

    # -- dataset bookkeeping -------------------------------------------------
    @property
    def x_all(self) -> np.ndarray:
        return self._x

    @property
    def n_indexes(self) -> int:
        return self.forest.n_indexes

    @property
    def device(self) -> DeviceForest:
        """Device upload of the forest, quantized per ``cfg.search``.  Lazy:
        host-only consumers never pay the upload; the first search does."""
        if self._device is None:
            self._device = self.backend.upload_forest(
                self.forest, quantize=self.cfg.search.quantize
            )
        return self._device

    # -- read path -----------------------------------------------------------
    def _plan_key(self, k, mode, beam, kernel) -> PlanKey:
        # per-call overrides get the same validation the config tree does
        sc = self.cfg.search
        key = PlanKey(
            k=sc.k if k is None else int(k),
            mode=sc.mode if mode is None else mode,
            beam=sc.beam if beam is None else int(beam),
            kernel=sc.kernel if kernel is None else bool(kernel),
            quantize=sc.quantize,
        )
        if key.k < 1:
            raise ConfigError(f"search k={key.k} must be >= 1 neighbors")
        if key.mode not in SEARCH_MODES:
            raise ConfigError(
                f"search mode {key.mode!r} is unknown; choose one of "
                f"{', '.join(SEARCH_MODES)}"
            )
        if key.beam < 1:
            raise ConfigError(f"search beam={key.beam} must be >= 1")
        return key

    def search(
        self, q, *, k: int | None = None, mode: str | None = None,
        beam: int | None = None, kernel: bool | None = None,
    ) -> SearchResult:
        """kNN over the forest.  Defaults come from ``cfg.search``; per-call
        overrides select (or create) the matching cached ``SearchPlan``.
        Returns a host-side ``SearchResult``."""
        key = self._plan_key(k, mode, beam, kernel)
        plan = self.plans.plan(key, self.backend)
        plan.calls += 1
        qt = torch.as_tensor(np.asarray(q, np.float32), device=self.backend.device)
        d, i, s = plan.executor(self.backend.search_operands(self.device), qt, None)
        d, i, stats = results_to_host(d, i, s)
        kk = min(key.k, self.n_total)  # Def. 4: |X| <= k -> whole set
        if d.shape[1] > kk:
            d, i = d[:, :kk], i[:, :kk]
        return SearchResult(dists=d, ids=i, stats=stats, plan=plan)

    # -- introspection -------------------------------------------------------
    def structure(self) -> dict[str, Any]:
        """aggregate_structure + delta occupancy (empty: this slice has no
        streaming ingest)."""
        s = self.forest.aggregate_structure()
        s["delta_fill"] = [0] * self.forest.n_indexes
        s["delta_capacity"] = self.capacity
        s["n_objects"] = self.n_total
        s["rebuilds"] = self.forest.build_stats.get("rebuilds", 0)
        return s

    def __repr__(self) -> str:
        return (
            f"OverlapIndex(n={self.n_total}, indexes={self.forest.n_indexes}, "
            f"buckets={self.forest.n_buckets}, method={self.cfg.index.method!r}, "
            f"device={self.backend.device}, plans={len(self.plans)})"
        )
