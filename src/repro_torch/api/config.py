"""One frozen configuration tree for the index: ``Config(index=IndexConfig,
search=SearchConfig, stream=StreamConfig, layout=LayoutConfig, obs=ObsConfig)``.

Every field is validated at construction with an actionable message
(``ConfigError``), with the same texts as the JAX package's
``repro.api.config``.  ``IndexConfig`` subclasses ``core.pipeline.IndexConfig``
(same fields), so the validated tree flows into the core pipeline unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields

from repro_torch.core.overlap import available_overlap_methods
from repro_torch.core.pipeline import IndexConfig as _CoreIndexConfig

PIVOT_METHODS = ("gh", "kmeans")
SEARCH_MODES = ("forest", "all")
DEVICE_LAYOUTS = ("single", "sharded", "routed")
FANOUT_MODES = ("auto", "targeted", "all")


class ConfigError(ValueError):
    """A configuration field failed validation (message says how to fix it)."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ConfigError(msg)


def _check_method(name: str, *, owner: str, field_name: str) -> None:
    if name not in available_overlap_methods():
        raise ConfigError(
            f"{owner}.{field_name}={name!r} is not a registered overlap "
            f"method; choose one of {', '.join(available_overlap_methods())} "
            "or add yours with repro_torch.api.register_overlap_method(name, fn)"
        )


def _check_pivot(name: str, *, owner: str) -> None:
    _require(
        name in PIVOT_METHODS,
        f"{owner}.pivot_method={name!r} is unknown; choose 'gh' (the paper's "
        "cheap generalized-hyperplane pivots) or 'kmeans' (the BCCF "
        "baseline's 2-means pivots)",
    )


@dataclass(frozen=True)
class IndexConfig(_CoreIndexConfig):
    """Build-time knobs (paper §4.1-4.3); validated superset of
    ``core.pipeline.IndexConfig`` field-for-field."""

    def __post_init__(self) -> None:
        _check_method(self.method, owner="IndexConfig", field_name="method")
        _require(
            0.0 <= self.xi_min < self.xi_max <= 1.0,
            f"IndexConfig thresholds need 0 <= xi_min < xi_max <= 1, got "
            f"xi_min={self.xi_min}, xi_max={self.xi_max} (xi_min is the "
            "overlap-index extraction threshold, xi_max the merge threshold "
            "— paper §4.3)",
        )
        _require(
            self.eps > 0.0,
            f"IndexConfig.eps={self.eps} must be > 0 (DBSCAN neighborhood "
            "radius; try the k-dist elbow of your data, paper §4.1)",
        )
        _require(
            self.min_pts >= 1,
            f"IndexConfig.min_pts={self.min_pts} must be >= 1 (DBSCAN core-"
            "point density threshold)",
        )
        _require(
            self.c_max is None or self.c_max >= 2,
            f"IndexConfig.c_max={self.c_max} must be >= 2 or None (None "
            "picks the paper's Def. 12 default, sqrt(n))",
        )
        _check_pivot(self.pivot_method, owner="IndexConfig")
        _require(
            self.dbscan_block >= 1,
            f"IndexConfig.dbscan_block={self.dbscan_block} must be >= 1 "
            "(pairwise block size of the DBSCAN eps-graph sweep)",
        )


@dataclass(frozen=True)
class SearchConfig:
    """Query-time defaults; each ``OverlapIndex.search`` call may override
    ``k`` / ``mode`` / ``beam`` / ``kernel`` (each combination is one cached
    ``SearchPlan``)."""

    k: int = 10
    mode: str = "forest"  # forest (Alg. 2 routing) | all (exact, no routing)
    beam: int = 1  # buckets evaluated per scan step
    kernel: bool = True  # kernels/ops dispatch vs the plain versions
    quantize: bool = False  # int8 bucket-member storage on device

    def __post_init__(self) -> None:
        _require(
            self.k >= 1, f"SearchConfig.k={self.k} must be >= 1 neighbors"
        )
        _require(
            self.mode in SEARCH_MODES,
            f"SearchConfig.mode={self.mode!r} is unknown; choose 'forest' "
            "(Alg. 2 routed search) or 'all' (scan every index — exact "
            "global kNN at higher cost)",
        )
        _require(
            self.beam >= 1,
            f"SearchConfig.beam={self.beam} must be >= 1 (buckets evaluated "
            "per bounded-scan step)",
        )


@dataclass(frozen=True)
class StreamConfig:
    """Streaming ingest and online-maintenance knobs (``repro_torch.stream``)."""

    capacity: int | None = None  # per-index delta capacity; None -> sqrt(n)
    monitor_method: str = "dbm"  # overlap heuristic re-evaluated online
    xi_rebuild: float = 0.8  # absolute overlap rate forcing repartition
    drift_margin: float | None = None  # optional rise-over-baseline trigger
    fill_rebuild: float = 0.75  # delta fill fraction forcing a merge-rebuild
    # measured-waste trigger: rebuild when explain() attribution shows this
    # share of an index's bucket visits were wasted; None keeps it off
    wasted_rebuild: float | None = None
    pivot_method: str = "gh"  # pivot rule for maintenance rebuilds
    c_max: int | None = None  # rebuild bucket capacity; None -> keep forest's
    seed: int = 1

    def __post_init__(self) -> None:
        _require(
            self.capacity is None or self.capacity >= 1,
            f"StreamConfig.capacity={self.capacity} must be >= 1 or None "
            "(None sizes the per-index delta buffers at sqrt(n), floor 64)",
        )
        _check_method(
            self.monitor_method, owner="StreamConfig", field_name="monitor_method"
        )
        _require(
            0.0 < self.xi_rebuild <= 1.0,
            f"StreamConfig.xi_rebuild={self.xi_rebuild} must lie in (0, 1] "
            "(overlap rates are rates — 1.0 disables the absolute trigger "
            "short of full containment)",
        )
        _require(
            self.drift_margin is None or self.drift_margin > 0.0,
            f"StreamConfig.drift_margin={self.drift_margin} must be > 0 or "
            "None (None disables the rise-over-baseline trigger)",
        )
        _require(
            0.0 < self.fill_rebuild <= 1.0,
            f"StreamConfig.fill_rebuild={self.fill_rebuild} must lie in "
            "(0, 1] (fraction of delta capacity that forces a merge-rebuild)",
        )
        _require(
            self.wasted_rebuild is None or 0.0 < self.wasted_rebuild <= 1.0,
            f"StreamConfig.wasted_rebuild={self.wasted_rebuild} must lie in "
            "(0, 1] or None (share of MEASURED wasted bucket visits — from "
            "OverlapIndex.explain attribution — that flags an index for "
            "rebuild; None disables the trigger)",
        )
        _check_pivot(self.pivot_method, owner="StreamConfig")
        _require(
            self.c_max is None or self.c_max >= 2,
            f"StreamConfig.c_max={self.c_max} must be >= 2 or None (None "
            "keeps the forest's bucket capacity on rebuilds)",
        )


@dataclass(frozen=True)
class RoutingConfig:
    """Routing-tier knobs for ``LayoutConfig(kind='routed')`` (the DIMS-style
    layer, ``distributed/router/``).

    ``fanout`` picks the dispatch: ``'auto'`` lets the cost model choose per
    query batch between targeted routing (only the hosts whose regions can
    hold an answer) and full fan-out; ``'targeted'``/``'all'`` force one
    side.  ``overlap_method`` names the registered heuristic that rates the
    overlap between host regions in the routing table.
    """

    fanout: str = "auto"  # auto | targeted | all
    overlap_method: str = "dbm"  # host-region overlap rates in the table

    def __post_init__(self) -> None:
        _require(
            self.fanout in FANOUT_MODES,
            f"RoutingConfig.fanout={self.fanout!r} is unknown; choose 'auto' "
            "(cost model picks per batch), 'targeted' (always prune hosts) "
            "or 'all' (always fan out — DIMS homogeneous search)",
        )
        _check_method(
            self.overlap_method, owner="RoutingConfig",
            field_name="overlap_method",
        )


@dataclass(frozen=True)
class LayoutConfig:
    """Device layout of the executor layer (``api/executor.py``).

    ``kind='single'`` (default) keeps the whole forest and delta on one
    device.  ``kind='sharded'`` splits the bucket rows and delta buffers over
    ``shards`` islands along the ``axis`` mesh axis
    (``distributed/knn_island.py``), with results bitwise equal to the single
    layout.  ``kind='routed'`` is the sharded layout plus the routing tier
    (``distributed/router/``): a per-host routing table prunes the islands
    each query must touch and a cost model picks targeted routing or full
    fan-out, still bitwise equal to both other layouts.  The islands' devices
    come from the entry point's ``device=`` list.
    """

    kind: str = "single"  # single | sharded | routed
    shards: int | None = None  # sharded/routed: island count; None -> all
    axis: str = "model"  # mesh axis name the rows shard over
    routing: RoutingConfig = field(default_factory=RoutingConfig)

    def __post_init__(self) -> None:
        _require(
            self.kind in DEVICE_LAYOUTS,
            f"LayoutConfig.kind={self.kind!r} is unknown; choose 'single' "
            "(one device, the default), 'sharded' (bucket rows + delta "
            "buffers split over the model axis) or 'routed' (sharded plus "
            "the per-host routing table + cost-model dispatch)",
        )
        _require(
            self.shards is None or self.shards >= 1,
            f"LayoutConfig.shards={self.shards} must be >= 1 or None "
            "(None uses every local device under kind='sharded'/'routed')",
        )
        _require(
            self.kind in ("sharded", "routed") or self.shards is None,
            f"LayoutConfig.shards={self.shards} only applies to "
            "kind='sharded'/'routed' (the single layout always uses one "
            "device)",
        )
        _require(
            isinstance(self.axis, str) and len(self.axis) > 0,
            f"LayoutConfig.axis={self.axis!r} must be a non-empty mesh "
            "axis name (the serving mesh calls it 'model')",
        )
        if not isinstance(self.routing, RoutingConfig):
            raise ConfigError(
                "LayoutConfig.routing must be a RoutingConfig (got "
                f"{type(self.routing).__name__}); construct it as "
                "LayoutConfig(kind='routed', routing=RoutingConfig(...))"
            )

    @classmethod
    def from_dict(cls, d: dict | None) -> "LayoutConfig":
        """The inverse of ``dataclasses.asdict`` for a snapshot's ``layout``
        section (absent in pre-layout snapshots: the single layout)."""
        d = dict(d or {})
        d["routing"] = RoutingConfig(**d.get("routing", {}))
        return cls(**d)


@dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs (``repro_torch.obs``): the per-index metrics registry.

    ``enabled=False`` turns the whole layer into shared no-op objects;
    search results are bitwise-identical either way (metrics are host-side
    bookkeeping only).  ``events_path`` attaches a JSONL span/event log;
    ``None`` falls back to the ``REPRO_OBS_EVENTS`` environment variable,
    else events stay off.  ``trace_sample`` turns a fraction of ``search()``
    calls into traced requests (deterministic systematic sampling): their
    spans carry trace/span/parent ids, so ``repro_torch.obs.Trace.reconstruct``
    reassembles the per-request tree from the event log.
    ``events_max_bytes``/``events_backups`` bound the event log on disk by
    size-based rotation.
    """

    enabled: bool = True
    window: int = 2048  # histogram reservoir: exact percentiles up to this
    events_path: str | None = None  # JSONL event log destination
    trace_sample: float = 0.0  # fraction of searches traced (0 = off, 1 = all)
    events_max_bytes: int | None = None  # rotate event log past this size
    events_backups: int = 3  # rotated files kept (0 = truncate in place)

    def __post_init__(self) -> None:
        _require(
            self.window >= 1,
            f"ObsConfig.window={self.window} must be >= 1 (number of recent "
            "observations each histogram retains for percentiles)",
        )
        _require(
            self.events_path is None or len(str(self.events_path)) > 0,
            "ObsConfig.events_path must be a non-empty path or None (None "
            "defers to $REPRO_OBS_EVENTS, else JSONL events stay off)",
        )
        _require(
            0.0 <= self.trace_sample <= 1.0,
            f"ObsConfig.trace_sample={self.trace_sample} must lie in [0, 1] "
            "(fraction of search requests that emit linked trace spans)",
        )
        _require(
            self.events_max_bytes is None or self.events_max_bytes >= 1,
            f"ObsConfig.events_max_bytes={self.events_max_bytes} must be "
            ">= 1 or None (None never rotates the event log)",
        )
        _require(
            self.events_backups >= 0,
            f"ObsConfig.events_backups={self.events_backups} must be >= 0 "
            "(rotated event-log files kept; 0 truncates on rotation)",
        )


@dataclass(frozen=True)
class Config:
    """The index lifecycle in one immutable tree; ``dataclasses.replace``
    derives variants."""

    index: IndexConfig = field(default_factory=IndexConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    layout: LayoutConfig = field(default_factory=LayoutConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

    def __post_init__(self) -> None:
        for name, want in (("index", IndexConfig), ("search", SearchConfig),
                           ("stream", StreamConfig), ("layout", LayoutConfig),
                           ("obs", ObsConfig)):
            got = getattr(self, name)
            if not isinstance(got, want):
                raise ConfigError(
                    f"Config.{name} must be a {want.__name__} "
                    f"(got {type(got).__name__}); construct it as "
                    f"Config({name}={want.__name__}(...))"
                )


def as_index_config(cfg: _CoreIndexConfig | IndexConfig) -> IndexConfig:
    """Validate a flat ``core.pipeline.IndexConfig`` into the api subclass
    (no-op when already validated)."""
    if isinstance(cfg, IndexConfig):
        return cfg
    return IndexConfig(**{f.name: getattr(cfg, f.name) for f in fields(cfg)})
