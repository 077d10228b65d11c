"""``OverlapIndex`` — the owner object for one forest: its searches, its
streaming writes, its snapshots and its telemetry.

    from repro_torch.api import OverlapIndex

    ix = OverlapIndex.build(x, cfg)          # the paper's overlap forest, on "cuda"
    ix = OverlapIndex.baseline(x)            # BCCF baseline, on "cuda"
    res = ix.search(q, k=10, beam=4)         # SearchResult: dists / ids / stats
    rep = ix.explain(q, k=10)                # + contributing / wasted bucket visits
    ix.ingest(batch)                         # streaming writes (delta buffers)
    ix.maintain()                            # overlap-drift monitor + rebuilds
    ix.save("index.npz")                     # rebuild-free restart ...
    ix2 = OverlapIndex.load("index.npz")     # ... bitwise-identical searches
    ix.metrics()                             # one nested telemetry snapshot
    ds = ix.to_datastore(values)             # kNN-LM serving datastore

The facade owns the host ``ForestArrays``, the device ``DeviceForest``
upload (quantized per ``cfg.search``), the streaming ``DeltaBuffer``
(allocated at the first ingest), the drift monitor, a ``PlanCache`` of
search executors and a telemetry ``Registry`` (``cfg.obs``).  Entry points
run on ``cuda`` unless the caller passes a ``device``; with no device given
and no CUDA available they raise rather than run on the CPU.  Snapshots are
the JAX package's npz format (``api/persist.py``), readable by either
package.

``cfg.layout`` picks the device layout (``api/executor.py``): the single
device, or the sharded or routed islands, whose devices ``device=`` lists
one per island (``device=["cuda:0"] * 4`` puts four islands on one card).
The build stages run on the first island's device; every layout returns
the same results bit for bit.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.api.config import (
    SEARCH_MODES,
    Config,
    ConfigError,
    LayoutConfig,
    as_index_config,
)
from repro_torch.api import persist
from repro_torch.api.executor import IslandStats, make_backend
from repro_torch.api.plan import PlanCache, PlanKey, SearchResult, results_to_host
from repro_torch.core.forest import ForestArrays
from repro_torch.core.knn import DeviceForest, route_points
from repro_torch.core.overlap import get_overlap_method, overlap_matrix
from repro_torch.core.pipeline import (
    BuildReport,
    IndexConfig as _CoreIndexConfig,
    build_baseline_core,
    build_index_core,
    default_delta_capacity,
)
from repro_torch.obs import (
    EventLog,
    Registry,
    TraceContext,
    TraceSampler,
    current_trace,
    events_path_from_env,
    use_trace,
)
from repro_torch.obs.attribution import ExplainReport, attribute_visits
from repro_torch.obs.phases import PhaseClock, PhaseRun, attach, phase
from repro_torch.stream.ingest import DeltaBuffer, alloc_delta, pull_delta_meta
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
            "OverlapIndex is constructed via OverlapIndex.build(x, cfg), "
            ".baseline(x, cfg), or .load(path)"
        )

    @classmethod
    def _wire(
        cls, x: np.ndarray, forest: ForestArrays, cfg: Config,
        report: BuildReport, device, *,
        n_total: int | None = None,
        delta: DeltaBuffer | None = None,
        capacity: int | None = None,
        rebuild_log: list[dict[str, Any]] | None = None,
        monitor_baseline: np.ndarray | None = None,
        clamp_layout: bool = False,
        backend=None,
    ) -> "OverlapIndex":
        self = object.__new__(cls)
        self.cfg = cfg
        self.forest = forest
        self.build_report = report
        # the layout's backend: one device, or one device per island
        self.backend = backend or make_backend(
            cfg.layout, clamp=clamp_layout, devices=device)
        self._x_parts: list[np.ndarray] = [x]
        self._x_cache: np.ndarray | None = x
        self.n_total = len(x) if n_total is None else n_total
        self._device: DeviceForest | None = None  # lazy (see .device)
        self.capacity = (
            capacity or cfg.stream.capacity or default_delta_capacity(self.n_total)
        )
        self._delta: DeltaBuffer | None = (
            None if delta is None else self.backend.place_delta(delta)
        )
        self.monitor: OverlapMonitor | None = None
        if delta is not None:
            self.monitor = self._make_monitor()
            if monitor_baseline is not None:
                # the baseline captured at save time: recomputing it over
                # the restart-time dataset would shift object-based trigger
                # decisions mid-stream
                self.monitor.rates_baseline = np.asarray(monitor_baseline)
        self._ingest_calls = 0
        self._ingest_shapes: set[int] = set()
        # one telemetry registry per index: the plan cache, the spans and
        # the ingest / maintenance / per-island counters register here, and
        # metrics() is the one snapshot of it all
        events_path = cfg.obs.events_path or events_path_from_env()
        self.obs = Registry(
            enabled=cfg.obs.enabled,
            window=cfg.obs.window,
            events=None if events_path is None else EventLog(
                events_path,
                max_bytes=cfg.obs.events_max_bytes,
                backups=cfg.obs.events_backups,
            ),
        )
        # self-sampled searches (cfg.obs.trace_sample) get their own
        # TraceContext; an ambient one installed by a caller always wins
        self._tracer = TraceSampler(cfg.obs.trace_sample)
        self._clock: PhaseClock | None = None  # a sampled search's device phases
        self._searches_since_swap = 0  # maintenance.rebuild_age gauge
        self.plans = PlanCache(registry=self.obs)
        self.rebuild_log: list[dict[str, Any]] = rebuild_log or []
        return self

    @classmethod
    def build(
        cls, x, cfg: Config | _CoreIndexConfig | None = None, *, device=None
    ) -> "OverlapIndex":
        """The paper's proposed pipeline (§4): overlap-optimized forest.
        DBSCAN (K3-K5) and the overlap rates run on ``device`` (default
        ``cuda``), where searches run too; the decision and the trees are
        built on the host.  Under a sharded or routed ``cfg.layout``,
        ``device`` is a list of one device per island and the build stages
        run on the first."""
        cfg = _as_config(cfg)
        x = _check_data(x)
        backend = make_backend(cfg.layout, devices=device)  # refuses a bad layout first
        forest, report = build_index_core(x, cfg.index, device=backend.device)
        return cls._wire(x, forest, cfg, report, device, backend=backend)

    @classmethod
    def baseline(
        cls, x, cfg: Config | _CoreIndexConfig | None = None, *, device=None
    ) -> "OverlapIndex":
        """The BCCF-tree baseline: one tree over all data.  With no config
        this builds the paper's documented 2-means baseline; an explicit
        config is honored (see ``build_baseline_core``).  ``device`` is the
        torch device searches run on (default ``cuda``), or one per island
        under a sharded or routed ``cfg.layout``."""
        x = _check_data(x)
        layout = LayoutConfig() if cfg is None else _as_config(cfg).layout
        backend = make_backend(layout, devices=device)
        if cfg is None:
            forest, report = build_baseline_core(x, None)
            cfg = Config(index=as_index_config(report.config))
        else:
            cfg = _as_config(cfg)
            forest, report = build_baseline_core(x, cfg.index)
        return cls._wire(x, forest, cfg, report, device, backend=backend)

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
            shards=self.backend.shards,
            # routed layout: the dispatch policy is part of the executor
            fanout=(self.cfg.layout.routing.fanout
                    if self.backend.kind == "routed" else None),
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

    def _phase_run(self) -> PhaseRun | None:
        """The run a sampled search marks its device phases on: None for an
        unsampled search, and on a layout whose islands span more than one
        device (one stream's events order its phases)."""
        if not self.obs.enabled or current_trace() is None:
            return None
        if self._clock is None:
            devices = set(self.backend.devices)
            if len(devices) > 1:
                return None
            self._clock = PhaseClock(devices.pop(), self.obs)
        return self._clock.run()

    def _record_search(self, stats: dict[str, Any], isl: IslandStats, router=None) -> None:
        """Fold one search's host-side stats into the registry: the fleet
        node-access counters, the per-island breakdown (one island on the
        single layout) and, on the routed layout, the routing tier's
        dispatch telemetry.  A sampled search with an event log also gets
        the router's and each island's point events in its span tree."""
        obs = self.obs
        traced = obs.events is not None and current_trace() is not None
        obs.counter("search.queries").inc(len(stats["buckets_visited"]))
        for name in ("buckets_visited", "distances", "bound_distances"):
            obs.counter(f"search.{name}").inc(int(stats[name].sum()))
        if router is not None:
            mode = "targeted" if router.targeted else "all"
            obs.counter("router.queries").inc(len(router.eligible_hosts))
            obs.counter("router.eligible_hosts").inc(int(router.eligible_hosts.sum()))
            obs.counter("router.pruned_hosts").inc(int(router.pruned_hosts.sum()))
            obs.counter("router.fanout", mode=mode).inc(len(router.eligible_hosts))
            obs.counter("router.est_bytes", mode="targeted").inc(int(router.wire_targeted))
            obs.counter("router.est_bytes", mode="all").inc(int(router.wire_fanall))
            if traced:
                obs.emit_event({
                    "event": "router",
                    "fanout": mode,
                    "eligible_hosts": router.eligible_hosts.tolist(),
                    "pruned_hosts": int(router.pruned_hosts.sum()),
                    "est_bytes_targeted": float(router.wire_targeted),
                    "est_bytes_fanall": float(router.wire_fanall),
                })
        method = self.cfg.index.method
        for s_id in range(isl.buckets_visited.shape[0]):
            for name in ("buckets_visited", "distances", "bound_distances"):
                obs.counter(
                    f"search.island.{name}", island=s_id, method=method
                ).inc(int(getattr(isl, name)[s_id].sum()))
            if traced:
                obs.emit_event({
                    "event": "island",
                    "island": s_id,
                    "buckets_visited": int(isl.buckets_visited[s_id].sum()),
                    "distances": int(isl.distances[s_id].sum()),
                })

    def search(
        self, q, *, k: int | None = None, mode: str | None = None,
        beam: int | None = None, kernel: bool | None = None,
        trace: TraceContext | None = None,
    ) -> SearchResult:
        """kNN over the forest and the streaming delta.  Defaults come from
        ``cfg.search``; per-call overrides select (or create) the matching
        cached ``SearchPlan``.  Returns a host-side ``SearchResult``.

        ``trace`` joins this search to a caller-owned request trace; with no
        explicit context and no ambient one, ``cfg.obs.trace_sample``
        self-samples (the sampled search becomes its own trace root in the
        event log).  A sampled search also times its device phases
        (``obs/phases.py``: ``search/device/<phase>``, ``search/device``,
        ``search/host_only``, and ``search/host_transfer/{wait,copy}``).
        Telemetry is host bookkeeping around the executor: traced, untraced
        and metrics-off searches return bitwise-identical results.
        """
        obs = self.obs
        ctx = trace
        if ctx is None and obs.enabled and current_trace() is None:
            ctx = self._tracer.maybe_trace()
        self._searches_since_swap += 1
        obs.gauge("maintenance.rebuild_age").set(self._searches_since_swap)
        with use_trace(ctx), obs.span("search"), attach(self._phase_run()) as run:
            with obs.span("plan_lookup"):
                key = self._plan_key(k, mode, beam, kernel)
                plan = self.plans.plan(key, self.backend)
                plan.calls += 1
                delta = None if self._delta is None else self.backend.delta_view(self._delta)
            with obs.span("device_execute"):
                with phase("upload"):
                    qt = torch.as_tensor(np.asarray(q, np.float32), device=self.backend.device)
                d, i, s, *tail = plan.executor(
                    self.backend.search_operands(self.device), qt, delta)
            with obs.span("host_transfer"):
                # the layout's telemetry rides in the results' one copy
                d, i, stats, *tele = results_to_host(
                    d, i, s, *self.backend.pack_telemetry(tail))
            if obs.enabled:
                self._record_search(stats, *self.backend.unpack_telemetry(stats, tele))
        if run is not None:
            run.observe()
        kk = min(key.k, self.n_total)  # Def. 4: |X| <= k -> whole set
        if d.shape[1] > kk:
            d, i = d[:, :kk], i[:, :kk]
        return SearchResult(dists=d, ids=i, stats=stats, plan=plan)

    def explain(
        self, q, *, k: int | None = None, mode: str | None = None,
        beam: int | None = None, kernel: bool | None = None,
        feed_monitor: bool = True,
    ) -> ExplainReport:
        """Search + overlap attribution: which bucket visits contributed a
        final top-k member, which were wasted, and which (visited, home)
        index pairs the waste charges to (``obs/attribution.py``).

        Runs the search's op sequence through a separate cached plan that
        also returns the visited-row evidence (``core.knn.VisitRows``), so
        ``report.result`` is bitwise-identical to ``search()``; ``home`` is
        each query's routed index, by the same routing op.  The evidence,
        the home indexes and the delta's ids ride in the search's one copy
        to the host, where the attribution runs.  Per query, contributing +
        wasted == ``stats['buckets_visited']``.  Totals land in
        ``metrics()['overlap_health']`` and, with ``feed_monitor`` (the
        default), in the drift monitor's measured-waste accumulators
        (``StreamConfig.wasted_rebuild``).
        """
        obs = self.obs
        with obs.span("explain"):
            with obs.span("plan_lookup"):
                key = self._plan_key(k, mode, beam, kernel)._replace(explain=True)
                plan = self.plans.plan(key, self.backend)
                plan.calls += 1
                delta = None if self._delta is None else self.backend.delta_view(self._delta)
            with obs.span("device_execute"):
                qt = torch.as_tensor(np.asarray(q, np.float32), device=self.backend.device)
                d, i, s, rows, *tail = plan.executor(
                    self.backend.search_operands(self.device), qt, delta
                )
                _, home = route_points(self.device.index_centers, qt, kernel=key.kernel)
                tele = self.backend.pack_telemetry(tail)
                extra = [rows.order, rows.visits, home]
                if delta is not None:  # the delta phase's evidence and member ids
                    extra += [rows.dorder, rows.dvisits, self.delta.ids, self.delta.count]
            with obs.span("host_transfer"):
                d, i, stats, *host = results_to_host(d, i, s, *tele, *extra)
            tele, (order, visits, home, *dx) = host[:len(tele)], host[len(tele):]
            dorder, dvisits, delta_ids, delta_count = dx or (None,) * 4
            if obs.enabled:
                self._record_search(stats, *self.backend.unpack_telemetry(stats, tele))
            kk = min(key.k, self.n_total)
            if d.shape[1] > kk:
                d, i = d[:, :kk], i[:, :kk]
            with obs.span("attribute"):
                report = self._attribute(
                    order, visits, dorder, dvisits, i, home, delta_ids, delta_count
                )
        report.result = SearchResult(dists=d, ids=i, stats=stats, plan=plan)
        if obs.enabled:
            obs.counter("explain.queries").inc(report.queries)
            obs.counter("explain.contributing").inc(int(report.contributing.sum()))
            obs.counter("explain.wasted").inc(int(report.wasted.sum()))
            jj, ii = np.nonzero(report.wasted_pair)
            for j_v, i_h in zip(jj.tolist(), ii.tolist()):
                obs.counter(
                    "explain.wasted_pair", visited=j_v, home=i_h
                ).inc(int(report.wasted_pair[j_v, i_h]))
        if feed_monitor and self.monitor is not None:
            self.monitor.note_wasted(report.wasted_pair, report.visited_pair)
        return report

    def _attribute(
        self, order, visits, dorder, dvisits, result_ids, home, delta_ids, delta_count,
    ) -> ExplainReport:
        """Host-side decode of one explain run's visit evidence (see
        ``obs.attribution.attribute_visits`` for the semantics).  The rates
        are the monitor's baseline, or the geometric heuristic's matrix
        computed from the uploaded index geometry when no monitor runs
        yet."""
        forest = self.forest
        method = self.cfg.stream.monitor_method
        rates = None
        if self.monitor is not None:
            rates = self.monitor.rates_baseline
        elif not get_overlap_method(method).needs_objects:
            rates = overlap_matrix(
                method, self.device.index_centers, self.device.index_radii
            ).cpu().numpy()
        return attribute_visits(
            order=order,
            visits=visits,
            dorder=dorder,
            dvisits=dvisits,
            result_ids=result_ids,
            home=home,
            n_indexes=forest.n_indexes,
            bucket_index=forest.bucket_index,
            bucket_ids=forest.bucket_ids,
            bucket_mask=forest.bucket_mask,
            # global row = island-local row + island * the padded rows per island
            main_rows_per_shard=-(-forest.n_buckets // self.backend.shards),
            delta_rows_per_shard=-(-forest.n_indexes // self.backend.shards),
            delta_ids=delta_ids,
            delta_count=delta_count,
            rates=rates,
            method=method,
        )

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
        """Write-path counters, under the JAX package's keys: ``calls`` of
        the ingest executor (one per round, retries included) and
        ``traces``, the distinct padded batch lengths it ran.  The JAX
        package compiles one ingest program per such length; the port runs
        eagerly and compiles nothing, so ``traces`` counts the shapes."""
        return dict(traces=len(self._ingest_shapes), calls=self._ingest_calls)

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
        with self.obs.span("ingest"):
            self.obs.counter("ingest.points").inc(len(xb))
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
            with self.obs.span("device_execute"):
                self._delta, acc = run(
                    self.device.index_centers, self._delta, xt, it,
                    torch.from_numpy(pending).to(dev),
                )
                pending &= ~acc.cpu().numpy()
            if not pending.any():
                return
            # capacity hit: force-rebuild the rejecting indexes, retry the rest
            self.obs.counter("ingest.capacity_retries").inc()
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
        with self.obs.span("check"):
            needs_x = get_overlap_method(self.cfg.stream.monitor_method).needs_objects
            report = self.monitor.check(self.delta, x=self.x_all if needs_x else None)
        self.obs.counter("maintain.checks").inc()
        for i, f in enumerate(report.fill):
            self.obs.gauge("maintenance.delta_fill", index=i).set(float(f))
        for reasons in report.reasons.values():
            for why in reasons:
                self.obs.counter("maintain.triggers", reason=why).inc()
        return report

    def maintain(self) -> DriftReport:
        """Run the drift monitor; rebuild and hot-swap every triggered index.

        The swap is atomic: a query sees the old (device, delta) pair or the
        new pair, never a partial state.  Returns the DriftReport.
        """
        with self.obs.span("maintain"):
            report = self.check()
            if report.triggers:
                self._rebuild(report.triggers, report)
        return report

    def _rebuild(self, triggers: list[int], report: DriftReport | None = None) -> None:
        if not triggers:
            return
        with self.obs.span("rebuild"):
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
        self._searches_since_swap = 0
        self.obs.gauge("maintenance.rebuild_age").set(0)
        self.obs.counter("maintain.rebuilds").inc(len(triggers))
        self.obs.counter("maintain.migrated").inc(n_migrated)
        self.obs.histogram("maintain.rebuild_wall_s").observe(stats["wall_time_s"])

    # -- persistence ---------------------------------------------------------
    def save(self, path) -> str:
        """Serialize the whole index (forest, host trees, delta, monitor
        baseline, config, dataset) to one .npz in the JAX package's format;
        returns the path written.  A ``load`` of that file, by either
        package, serves bitwise-identical searches without rebuilding."""
        return persist.save_state(self, path)

    @classmethod
    def load(cls, path, *, layout: LayoutConfig | None = None, device=None) -> "OverlapIndex":
        """Rebuild-free restart from ``save`` output (this package's or the
        JAX package's) onto ``device`` (default ``cuda``; without CUDA and
        without a device it raises, as the other entry points do), or onto a
        list of one device per island.

        Snapshots hold the logical, unpadded state, so they are
        layout-independent: ``layout`` re-shards the loaded index onto
        another layout than it was saved under (searches stay bitwise
        equal).  Without it the saved layout is used, clamped with a warning
        to the islands ``device`` gives."""
        st = persist.load_state(path, device="cpu")
        cfg = st["cfg"]
        if layout is not None:
            from dataclasses import replace

            cfg = replace(cfg, layout=layout)
        backend = make_backend(cfg.layout, clamp=layout is None, devices=device)
        delta = st["delta"]
        if delta is not None:  # host copy -> the first island's device
            delta = DeltaBuffer(*[t.to(backend.device) for t in delta])
        return cls._wire(
            st["x_all"], st["forest"], cfg, st["build_report"], device,
            n_total=st["n_total"],
            delta=delta,
            capacity=st["capacity"],
            rebuild_log=st["rebuild_log"],
            monitor_baseline=st["monitor_baseline"],
            backend=backend,
        )

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
    def metrics(self) -> dict[str, Any]:
        """One nested telemetry snapshot of this index (JSON-serializable),
        with the JAX package's sections and keys:

          search       per-phase span histograms (``search``,
                       ``search/plan_lookup``, ``search/device_execute``,
                       ``search/host_transfer``) with p50/p95/p99 seconds,
                       and the node-access totals; after a sampled search
                       also ``staged_share``, the rows K1 staged over the
                       padded capacity of the buckets it visited;
          plan_cache   executor-table counters (hits / misses / evictions /
                       ``traces``: distinct operand shapes run, see
                       ``api/plan.py``);
          ingest       write-path counters (``ingest_stats()``, points
                       ingested, capacity-retry rounds);
          maintenance  drift-monitor checks, per-reason trigger counts,
                       rebuild totals, searches since the last swap;
          islands      per-executor-island node-access counters (the
                       paper's cost currency), one row per island;
          router       the routed layout's dispatch telemetry: queries,
                       eligible and pruned host totals, fanout counts
                       (``router.fanout{mode=...}``), the estimated wire
                       bytes of both dispatches, and ``table`` (hosts,
                       host member counts, the largest inter-host overlap
                       rate; None off the routed layout);
          overlap_health  ``explain()``'s attribution rollup: contributing
                       vs wasted visit totals, the wasted fraction, the
                       per-(visited, home) wasted-pair counters and the
                       monitor's measured-waste shares;
          registry     the raw registry snapshot (every counter, gauge and
                       histogram).

        ``Registry.to_prometheus()`` (or ``python -m repro_torch.obs.export``)
        renders the registry section in Prometheus text format.  With
        ``cfg.obs.enabled=False`` the structural sections (plan_cache,
        ingest traces/calls, rebuilds) remain and the registry-backed ones
        are empty.
        """
        obs = self.obs
        snap = obs.snapshot()
        islands: dict[int, dict[str, int]] = {}
        triggers: dict[str, int] = {}
        wasted_pairs: dict[str, int] = {}
        for (name, labels), val in obs.counters().items():
            if name.startswith("search.island."):
                lab = dict(labels)
                islands.setdefault(int(lab["island"]), {})[
                    name[len("search.island."):]
                ] = val
            elif name == "maintain.triggers":
                triggers[dict(labels).get("reason", "?")] = val
            elif name == "explain.wasted_pair":
                lab = dict(labels)
                wasted_pairs[f"{lab['visited']}->{lab['home']}"] = val
        contributing = obs.value("explain.contributing")
        wasted = obs.value("explain.wasted")
        table = getattr(self.backend, "table", None)
        router_table = None
        if table is not None:
            host_counts = table.host_counts.cpu().numpy()
            rates = table.host_rates.cpu().numpy()
            router_table = {
                "hosts": int(host_counts.shape[0]),
                "host_counts": host_counts.tolist(),
                "max_rate": float(rates.max()) if rates.size else 0.0,
            }
        search = {
            "spans": {
                k: v for k, v in snap["histograms"].items()
                if k == "search" or k.startswith("search/")
            },
            "queries": obs.value("search.queries"),
            "buckets_visited": obs.value("search.buckets_visited"),
            "distances": obs.value("search.distances"),
            "bound_distances": obs.value("search.bound_distances"),
        }
        capacity = obs.value("search.capacity_rows")
        if capacity:  # only sampled searches count K1's staged rows (obs/phases.py)
            search["staged_share"] = obs.value("search.staged_rows") / capacity
        return {
            "enabled": obs.enabled,
            "search": search,
            "plan_cache": self.plans.stats(),
            "ingest": {
                **self.ingest_stats(),
                "points": obs.value("ingest.points"),
                "capacity_retries": obs.value("ingest.capacity_retries"),
            },
            "maintenance": {
                "checks": obs.value("maintain.checks"),
                "triggers": triggers,
                "rebuilds": len(self.rebuild_log),
                "indexes_rebuilt": obs.value("maintain.rebuilds"),
                "migrated": obs.value("maintain.migrated"),
                # searches since the last rebuild swap (the gauge
                # maintenance.rebuild_age); per-index delta_fill gauges are
                # in the registry section
                "rebuild_age": self._searches_since_swap,
            },
            "islands": islands,
            "router": {
                "queries": obs.value("router.queries"),
                "eligible_hosts": obs.value("router.eligible_hosts"),
                "pruned_hosts": obs.value("router.pruned_hosts"),
                "fanout": {
                    m: obs.value("router.fanout", mode=m) for m in ("targeted", "all")
                },
                "est_bytes": {
                    m: obs.value("router.est_bytes", mode=m) for m in ("targeted", "all")
                },
                "table": router_table,
            },
            "overlap_health": {
                "explained_queries": obs.value("explain.queries"),
                "contributing": contributing,
                "wasted": wasted,
                "wasted_fraction": (
                    wasted / (contributing + wasted) if (contributing + wasted) else 0.0
                ),
                "wasted_pairs": wasted_pairs,
                "monitor_wasted_share": (
                    None if self.monitor is None
                    else self.monitor.wasted_share().tolist()
                ),
            },
            "registry": snap,
        }

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
            f"layout={self.backend.kind}"
            f"{f'x{self.backend.shards}' if self.backend.shards > 1 else ''}, "
            f"device={self.backend.device}, plans={len(self.plans)})"
        )
