"""One frozen configuration tree for the index: ``Config(index=IndexConfig,
search=SearchConfig)``.

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
class Config:
    """The index lifecycle in one immutable tree; ``dataclasses.replace``
    derives variants."""

    index: IndexConfig = field(default_factory=IndexConfig)
    search: SearchConfig = field(default_factory=SearchConfig)

    def __post_init__(self) -> None:
        for name, want in (("index", IndexConfig), ("search", SearchConfig)):
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
