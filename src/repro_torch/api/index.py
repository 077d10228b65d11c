"""``OverlapIndex`` — the owner object for one forest, its searches and
its streaming writes.

    from repro_torch.api import OverlapIndex

    ix = OverlapIndex.build(x, cfg)          # the paper's overlap forest, on "cuda"
    ix = OverlapIndex.baseline(x)            # BCCF baseline, on "cuda"
    res = ix.search(q, k=10, beam=4)         # SearchResult: dists / ids / stats
    ix.ingest(batch)                         # streaming writes (delta buffers)
    ix.maintain()                            # overlap-drift monitor + rebuilds
    ds = ix.to_datastore(values)             # kNN-LM serving datastore

The facade owns the host ``ForestArrays``, the device ``DeviceForest``
upload (quantized per ``cfg.search``), the streaming ``DeltaBuffer``
(allocated at the first ingest), the drift monitor and a ``PlanCache`` of
search executors.  Entry points run on ``cuda`` unless the caller passes a
``device``; with no device given and no CUDA available they raise rather than
run on the CPU.  Persistence (``save`` / ``load``) comes with a later slice,
and so do the JAX facade's telemetry spans and counters (ROADMAP §1, item 3,
telemetry).
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
from repro_torch.core.overlap import get_overlap_method
from repro_torch.core.pipeline import (
    BuildReport,
    IndexConfig as _CoreIndexConfig,
    build_baseline_core,
    build_index_core,
    default_delta_capacity,
)
from repro_torch.device import resolve_device
from repro_torch.stream.ingest import DeltaBuffer, alloc_delta, delta_view, pull_delta_meta
from repro_torch.stream.maintenance import (
    DriftReport,
    MaintenanceConfig,
    OverlapMonitor,
    rebuild_indexes,
)


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
        self._x_parts: list[np.ndarray] = [x]
        self._x_cache: np.ndarray | None = x
        self.n_total = len(x)
        self._device: DeviceForest | None = None  # lazy (see .device)
        self.capacity = cfg.stream.capacity or default_delta_capacity(self.n_total)
        self._delta: DeltaBuffer | None = None  # allocated by the first ingest
        self.monitor: OverlapMonitor | None = None
        self._ingest_calls = 0
        self._ingest_shapes: set[int] = set()
        self.plans = PlanCache()
        self.rebuild_log: list[dict[str, Any]] = []
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
        """Every object ingested so far (the build's rows first), by id."""
        if self._x_cache is None or len(self._x_cache) != self.n_total:
            self._x_cache = np.concatenate(self._x_parts)
            self._x_parts = [self._x_cache]
        return self._x_cache

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

    @property
    def delta(self) -> DeltaBuffer | None:
        """The logical (unpadded) delta buffers: what the drift monitor and
        introspection read.  The same tensors as ``device_delta`` on the
        single-device layout."""
        if self._delta is None:
            return None
        return self.backend.logical_delta(self._delta, self.forest.n_indexes)

    @property
    def device_delta(self) -> DeltaBuffer | None:
        """The delta buffers as the executors see them; the serving
        datastore rides on these."""
        return self._delta

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
            delta_capacity=None if self._delta is None else self.capacity,
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
        """kNN over the forest and the streaming delta.  Defaults come from
        ``cfg.search``; per-call overrides select (or create) the matching
        cached ``SearchPlan``.  Returns a host-side ``SearchResult``."""
        key = self._plan_key(k, mode, beam, kernel)
        plan = self.plans.plan(key, self.backend)
        plan.calls += 1
        qt = torch.as_tensor(np.asarray(q, np.float32), device=self.backend.device)
        delta = None if self._delta is None else delta_view(self._delta)
        d, i, s = plan.executor(self.backend.search_operands(self.device), qt, delta)
        d, i, stats = results_to_host(d, i, s)
        kk = min(key.k, self.n_total)  # Def. 4: |X| <= k -> whole set
        if d.shape[1] > kk:
            d, i = d[:, :kk], i[:, :kk]
        return SearchResult(dists=d, ids=i, stats=stats, plan=plan)

    # -- write path ----------------------------------------------------------
    def _ensure_delta(self) -> None:
        if self._delta is None:
            self._delta = self.backend.place_delta(
                alloc_delta(self.forest, self.capacity, device=self.backend.device)
            )
            self.monitor = self._make_monitor()

    def _pad_batch(self, n: int) -> int:
        """Padded chunk length: the next power of two, clamped to the chunk
        ceiling (the delta capacity).  At most log2(capacity) batch shapes
        reach the ingest, with pad rows parked by the ``valid`` mask."""
        p = 1
        while p < n:
            p <<= 1
        return min(p, self.capacity)

    def ingest_stats(self) -> dict[str, int]:
        """Write-path counters: ``calls`` of the ingest executor (one per
        round, retries included) and ``shapes``, the distinct padded batch
        lengths it ran.  The JAX package reports compiled ``traces`` here;
        the port runs eagerly and has no trace to count."""
        return dict(calls=self._ingest_calls, shapes=len(self._ingest_shapes))

    def _make_monitor(self) -> OverlapMonitor:
        needs_x = get_overlap_method(self.cfg.stream.monitor_method).needs_objects
        return OverlapMonitor(
            self.forest, self._maint_cfg(), x=self.x_all if needs_x else None,
            device=self.backend.device,
        )

    def _maint_cfg(self) -> MaintenanceConfig:
        s = self.cfg.stream
        return MaintenanceConfig(
            method=s.monitor_method,
            xi_rebuild=s.xi_rebuild,
            drift_margin=s.drift_margin,
            fill_rebuild=s.fill_rebuild,
            wasted_rebuild=s.wasted_rebuild,
            pivot_method=s.pivot_method,
            c_max=s.c_max,
            seed=s.seed,
        )

    def ingest(self, xb) -> np.ndarray:
        """Insert a batch; returns the assigned global object ids.

        Chunks the batch to the per-index buffer capacity, so that a forced
        rebuild (which empties the destination buffers) always lets the
        retry succeed: ingestion neither drops a point nor livelocks.
        """
        self._ensure_delta()
        xb = np.asarray(xb, np.float32)
        if xb.ndim != 2 or xb.shape[1] != self.forest.bucket_x.shape[2]:
            raise ConfigError(
                f"ingest batch must be (B, {self.forest.bucket_x.shape[2]}), "
                f"got shape {xb.shape}"
            )
        ids = np.arange(self.n_total, self.n_total + len(xb), dtype=np.int64)
        self._x_parts.append(xb)
        self.n_total += len(xb)
        self._x_cache = None
        for lo in range(0, len(xb), self.capacity):
            self._ingest_chunk(xb[lo: lo + self.capacity], ids[lo: lo + self.capacity])
        return ids

    def _ingest_chunk(self, xc: np.ndarray, ic: np.ndarray) -> None:
        # Termination: a round that rejects any point force-rebuilds every
        # rejecting index, emptying its buffer into the main structure.  A
        # retried point (chunk <= buffer capacity) can be rejected again only
        # by routing to a different still-full buffer, and each round empties
        # at least one of those, so at most n_indexes rounds pass before
        # every point is accepted.  Retries flip the ``valid`` mask instead of
        # slicing the batch, and a ragged chunk pads up to a power of two
        # with its pad rows parked.
        b = len(xc)
        bp = self._pad_batch(b)
        if bp > b:
            xc = np.concatenate([xc, np.zeros((bp - b, xc.shape[1]), xc.dtype)])
            ic = np.concatenate([ic, np.full((bp - b,), -1, ic.dtype)])
        self._ingest_shapes.add(bp)
        pending = np.zeros(bp, bool)
        pending[:b] = True
        dev = self.backend.device
        xt = torch.from_numpy(xc).to(dev)
        it = torch.from_numpy(ic.astype(np.int32)).to(dev)
        run = self.backend.ingest_body()
        for _ in range(self.forest.n_indexes + 1):
            self._ingest_calls += 1
            self._delta, acc = run(
                self.device.index_centers, self._delta, xt, it,
                torch.from_numpy(pending).to(dev),
            )
            pending &= ~acc.cpu().numpy()
            if not pending.any():
                return
            # capacity hit: force-rebuild the rejecting indexes, retry the rest
            meta = pull_delta_meta(self.delta)
            full = [i for i in range(self.forest.n_indexes) if meta["dropped"][i] > 0]
            self._rebuild(full)
        raise RuntimeError(
            "ingest chunk still rejected after rebuilding every full index — "
            "invariant violation, please report"
        )

    # -- maintenance ---------------------------------------------------------
    def check(self) -> DriftReport:
        """Overlap-drift evaluation only (no rebuild) -> DriftReport."""
        self._ensure_delta()
        needs_x = get_overlap_method(self.cfg.stream.monitor_method).needs_objects
        return self.monitor.check(self.delta, x=self.x_all if needs_x else None)

    def maintain(self) -> DriftReport:
        """Run the drift monitor; rebuild and hot-swap every triggered index.

        The swap is atomic: a query sees the old (device, delta) pair or the
        new pair, never a partial state.  Returns the DriftReport.
        """
        report = self.check()
        if report.triggers:
            self._rebuild(report.triggers, report)
        return report

    def _rebuild(self, triggers: list[int], report: DriftReport | None = None) -> None:
        if triggers:
            self._rebuild_impl(triggers, report)

    def _rebuild_impl(self, triggers: list[int], report: DriftReport | None) -> None:
        x_all = self.x_all
        new_forest, stats = rebuild_indexes(
            self.forest, self.delta, x_all, triggers, self._maint_cfg()
        )
        # Survivors, the delta members of indexes not rebuilt, keep their
        # buffers whole: a kept index keeps its center, so the old buffer's
        # pivot/radius bound stays valid, and a buffer moved into a fresh one
        # of the same capacity cannot overflow.  Rebuilt indexes start empty
        # (their members went into the new trees); ``dropped`` resets, since
        # rejected points were never stored and their owners retry them.
        new_device = self.backend.upload_forest(new_forest, quantize=self.cfg.search.quantize)
        fresh = alloc_delta(new_forest, self.capacity, device=self.backend.device)
        keep = np.ones(self.forest.n_indexes, bool)
        keep[list(triggers)] = False
        old = self.delta  # logical view: the survivor select is index-aligned
        n_migrated = int(pull_delta_meta(old)["count"][keep].sum())
        kt = torch.from_numpy(keep).to(self.backend.device)
        new_delta = self.backend.place_delta(fresh._replace(
            x=torch.where(kt[:, None, None], old.x, fresh.x),
            ids=torch.where(kt[:, None], old.ids, fresh.ids),
            count=torch.where(kt, old.count, fresh.count),
            pivot=torch.where(kt[:, None], old.pivot, fresh.pivot),
            radius=torch.where(kt, old.radius, fresh.radius),
            sum_x=torch.where(kt[:, None], old.sum_x, fresh.sum_x),
        ))

        # ---- atomic swap: a query sees the old pair or the new pair --------
        self.backend.barrier(new_device, new_delta)
        self.forest, self._device, self._delta = new_forest, new_device, new_delta
        self.monitor = self._make_monitor()
        stats["triggers"] = list(triggers)
        stats["reasons"] = dict(report.reasons) if report is not None else {}
        stats["n_migrated"] = n_migrated
        self.rebuild_log.append(stats)

    # -- serving -------------------------------------------------------------
    def to_datastore(self, values, *, stream_capacity: int = 0, quantized: bool | None = None):
        """Wrap this index as a kNN-LM serving ``ForestDatastore``.

        ``values[i]`` is the token paired with object id ``i``, one value per
        object in the index (``n_total``).  A live delta rides along (its
        members stay retrievable, and ``serve.retrieval.ingest_keys`` appends
        into the same buffers).  ``stream_capacity`` preallocates a values
        tail for that many future serve-side inserts; ``quantized``
        overrides ``cfg.search.quantize`` for the datastore's buckets.
        """
        from repro_torch.serve.retrieval import datastore_from_index

        return datastore_from_index(
            self, values, stream_capacity=stream_capacity, quantized=quantized
        )

    # -- introspection -------------------------------------------------------
    def structure(self) -> dict[str, Any]:
        """aggregate_structure + live delta occupancy."""
        s = self.forest.aggregate_structure()
        if self._delta is not None:
            s["delta_fill"] = self.delta.count.cpu().numpy().tolist()
        else:
            s["delta_fill"] = [0] * self.forest.n_indexes
        s["delta_capacity"] = self.capacity
        s["n_objects"] = self.n_total
        s["rebuilds"] = self.forest.build_stats.get("rebuilds", 0)
        return s

    def __repr__(self) -> str:
        return (
            f"OverlapIndex(n={self.n_total}, indexes={self.forest.n_indexes}, "
            f"buckets={self.forest.n_buckets}, method={self.cfg.index.method!r}, "
            f"delta={'on' if self._delta is not None else 'off'}, "
            f"device={self.backend.device}, plans={len(self.plans)})"
        )
