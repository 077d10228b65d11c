"""Metrics primitives: counters, gauges, streaming histograms, and
phase-span timers, behind one ``Registry`` (the port's own copy of
``repro/obs/metrics.py``; of torch it reads only the profiler's flag).

The paper's whole argument is measured in observability terms — overlap
reduction is proven by node-access counts and search time — but until this
layer the repo's instrumentation was scattered shards (``SearchStats`` in
core, ``ingest_stats()`` on the facade, ``PlanCache.stats()``, raw
``perf_counter`` calls in serve).  Everything now registers into one
``Registry`` per owner object (``OverlapIndex``, ``ServeEngine``), and one
``snapshot()`` shows the coherent picture.

Design constraints, in order:

  * zero hot-path cost when disabled — a disabled registry hands out
    shared null metric objects whose methods are no-ops, and ``span()``
    short-circuits before touching the clock;
  * no effect on computation — every metric is HOST-side bookkeeping; the
    jitted executors are untouched, so a metrics-enabled search returns
    bitwise-identical results to a metrics-off search (tested);
  * exact percentiles where it matters — ``Histogram`` keeps a windowed
    reservoir of the last ``window`` observations and computes p50/p95/p99
    with numpy's linear interpolation rule over that window (exact, and
    testable against ``np.percentile``, whenever fewer than ``window``
    values were seen); count/sum/min/max are lifetime-exact regardless.

Spans nest: ``with reg.span("search"): with reg.span("plan_lookup"): ...``
records a duration histogram under the path ``"search/plan_lookup"`` — the
nesting stack is per-thread, so concurrent engines don't interleave paths.
While a ``torch.profiler`` records, a span is also a profiler range named by
its path, on the profiler's clock beside torch's own operators; otherwise it
costs one read of torch's "profiler enabled" flag more.  ``profiled_path``
names the innermost such range on the calling thread, whatever registry
opened it, so lower layers can nest their own ranges under it
(``obs/phases.py``).
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

import torch.autograd.profiler as _profiler

from repro_torch.obs import trace as trace_mod

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "profiled_path"]

MetricKey = tuple[str, tuple[tuple[str, Any], ...]]


def _key(name: str, labels: dict[str, Any]) -> MetricKey:
    return (name, tuple(sorted(labels.items())))


def _fmt(key: MetricKey) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic integer counter (calls, points, cache hits, node accesses)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value (queue depth, slot occupancy, fill fraction)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, d: float) -> None:
        self.value += float(d)


class Histogram:
    """Streaming duration/size distribution with windowed percentiles.

    Lifetime ``count``/``sum``/``min``/``max`` plus a ring buffer of the
    last ``window`` observations; ``percentile(q)`` sorts the window and
    interpolates linearly between ranks (numpy's default rule), so while
    ``count <= window`` the reported percentiles are EXACTLY
    ``np.percentile(observed, q)``.  Past that, percentiles describe the
    most recent ``window`` observations — the serving-relevant tail, not a
    lifetime average that staleness can't move.
    """

    __slots__ = ("window", "count", "total", "vmin", "vmax", "_buf", "_pos")

    def __init__(self, window: int = 2048) -> None:
        if window < 1:
            raise ValueError(f"Histogram window={window} must be >= 1")
        self.window = window
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._buf: list[float] = []
        self._pos = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if len(self._buf) < self.window:
            self._buf.append(v)
        else:
            self._buf[self._pos] = v
            self._pos = (self._pos + 1) % self.window

    def percentile(self, q: float) -> float:
        """q in [0, 100] over the retained window; NaN when empty."""
        if not self._buf:
            return math.nan
        s = sorted(self._buf)
        rank = (len(s) - 1) * (q / 100.0)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        frac = rank - lo
        return s[lo] * (1.0 - frac) + s[hi] * frac

    def snapshot(self) -> dict[str, float | int]:
        n = self.count
        return {
            "count": n,
            "sum": self.total,
            "min": self.vmin if n else math.nan,
            "max": self.vmax if n else math.nan,
            "mean": self.total / n if n else math.nan,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "window": min(len(self._buf), self.window),
        }


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: int = 1) -> None:  # noqa: ARG002 — intentionally inert
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    def add(self, d: float) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass


# the paths of the spans open as profiler ranges on this thread, innermost
# last, across registries
_ranges = threading.local()


def profiled_path() -> str | None:
    """The path of the innermost span open as a profiler range on this
    thread (``None``: none is, or no profiler records)."""
    st = getattr(_ranges, "stack", None)
    return st[-1] if st else None


def _ended_now(dur_s: float) -> int:
    """``start_ns`` of a span that ends now and lasted ``dur_s``."""
    return time.time_ns() - round(float(dur_s) * 1e9)


# shared inert instances a disabled Registry hands out — callers keep their
# unconditional `reg.counter(...).inc()` style at ~one dict-free call of cost
_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class Registry:
    """One namespace of metrics + the span stack + an optional event log.

    ``enabled=False`` turns every accessor into a shared no-op object and
    ``span()`` into a clock-free passthrough; flipping a config toggles the
    entire layer without touching any instrumented call site.

    ``events`` is an ``obs.events.EventLog`` (or anything with ``emit``);
    when set, every span exit emits one JSONL record.
    """

    def __init__(
        self,
        *,
        enabled: bool = True,
        window: int = 2048,
        events: Any | None = None,
    ) -> None:
        self.enabled = bool(enabled)
        self.window = int(window)
        self.events = events
        self._counters: dict[MetricKey, Counter] = {}
        self._gauges: dict[MetricKey, Gauge] = {}
        self._hists: dict[MetricKey, Histogram] = {}
        self._local = threading.local()

    # -- accessors (get-or-create) ------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        k = _key(name, labels)
        got = self._counters.get(k)
        if got is None:
            got = self._counters[k] = Counter()
        return got

    def gauge(self, name: str, **labels) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        k = _key(name, labels)
        got = self._gauges.get(k)
        if got is None:
            got = self._gauges[k] = Gauge()
        return got

    def histogram(self, name: str, **labels) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        k = _key(name, labels)
        got = self._hists.get(k)
        if got is None:
            got = self._hists[k] = Histogram(self.window)
        return got

    # -- spans ---------------------------------------------------------------
    def _stack(self) -> list[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **labels) -> Iterator[str | None]:
        """Time a phase; nested spans record under ``outer/inner`` paths.

        Yields the full path (or ``None`` when disabled).  The duration is
        observed into ``histogram(path)`` in SECONDS, and — when an event
        log is attached — emitted as one ``{"event": "span", ...}`` line
        whose ``start_ns`` is on the clock a ``torch.profiler`` stamps (Unix
        nanoseconds), so the log lines up with an exported chrome trace.
        While a profiler records, the span is also a profiler range named
        ``path``.  Exceptions propagate; the stack still unwinds and the
        (partial) duration is still recorded, so a failing phase stays
        visible.
        """
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        rng = None
        if _profiler._is_profiler_enabled:
            rng = _profiler.record_function(path)
            rng.__enter__()
            ranges = getattr(_ranges, "stack", None)
            if ranges is None:
                ranges = _ranges.stack = []
            ranges.append(path)
        # trace linkage: when an ambient sampled TraceContext is installed
        # (obs/trace.use_trace) AND events are attached, this span joins the
        # request's tree — parentage comes from the context's own stack, so
        # linkage survives across owner objects (engine registry -> index
        # registry) as long as the context flows
        ctx = trace_mod.current_trace() if self.events is not None else None
        sid = parent = None
        if ctx is not None:
            sid, parent = ctx.push()
        start_ns = time.time_ns() if self.events is not None else 0
        t0 = time.perf_counter()
        try:
            yield path
        finally:
            dur = time.perf_counter() - t0
            if rng is not None:
                ranges.pop()
                rng.__exit__(None, None, None)
            stack.pop()
            self.histogram(path, **labels).observe(dur)
            if ctx is not None:
                ctx.pop()
            if self.events is not None:
                rec = {"event": "span", "span": path, "start_ns": start_ns, "dur_s": dur}
                if labels:
                    rec["labels"] = dict(labels)
                if ctx is not None:
                    rec["trace_id"] = ctx.trace_id
                    rec["span_id"] = sid
                    rec["parent_id"] = parent
                self.events.emit(rec)

    def record_span(self, name: str, dur_s: float, **labels) -> None:
        """Record a span whose duration was measured externally and that
        ends now (e.g. queue wait = admission time minus submit time, at
        admission): observes the histogram
        under ``name`` and — with events attached — emits a span event with
        the same trace linkage a ``span()`` exit would carry."""
        if not self.enabled:
            return
        self.histogram(name, **labels).observe(float(dur_s))
        if self.events is None:
            return
        rec = {"event": "span", "span": name, "start_ns": _ended_now(dur_s),
               "dur_s": float(dur_s)}
        if labels:
            rec["labels"] = dict(labels)
        ctx = trace_mod.current_trace()
        if ctx is not None:
            sid, parent = ctx.link()
            rec["trace_id"] = ctx.trace_id
            rec["span_id"] = sid
            rec["parent_id"] = parent
        self.events.emit(rec)

    def emit_trace_root(self, ctx, name: str, dur_s: float, **labels) -> None:
        """Emit a trace's ROOT span record (parent ``None``) with an
        externally-measured duration — the owner (``ServeEngine``) calls
        this once per sampled request at completion, closing the tree every
        nested span already parented to ``ctx.root_id``."""
        if not self.enabled:
            return
        self.histogram(name, **labels).observe(float(dur_s))
        if self.events is None or ctx is None or not ctx.sampled:
            return
        rec = {
            "event": "span",
            "span": name,
            "start_ns": _ended_now(dur_s),
            "dur_s": float(dur_s),
            "trace_id": ctx.trace_id,
            "span_id": ctx.root_id,
            "parent_id": None,
        }
        if labels:
            rec["labels"] = dict(labels)
        self.events.emit(rec)

    def emit_event(self, event: dict[str, Any]) -> None:
        """Emit a structured point event, stamped with trace linkage when a
        sampled ambient trace is active (parented at the current span,
        nothing pushed).  Per-request annotations (``OverlapIndex``'s island
        and router events) are built only under a sampled trace with an
        event log, so steady-state logs never carry them."""
        if self.events is None or not self.enabled:
            return
        ctx = trace_mod.current_trace()
        if ctx is None:
            self.events.emit(event)
            return
        sid, parent = ctx.link()
        self.events.emit(
            {**event, "trace_id": ctx.trace_id, "span_id": sid,
             "parent_id": parent}
        )

    # -- reads ---------------------------------------------------------------
    def counters(self) -> dict[MetricKey, int]:
        """Raw (name, labels) -> value view, for structured consumers
        (``OverlapIndex.metrics`` groups per-island counters out of this)."""
        return {k: c.value for k, c in self._counters.items()}

    def value(self, name: str, **labels) -> int:
        """One counter's value; 0 when it was never touched (or disabled)."""
        got = self._counters.get(_key(name, labels))
        return 0 if got is None else got.value

    def snapshot(self) -> dict[str, Any]:
        """The whole registry as plain nested dicts (JSON-serializable).

        Labeled metrics format as ``name{k=v,...}`` keys; histograms expand
        to their ``{count,sum,min,max,mean,p50,p95,p99,window}`` dicts.
        """
        return {
            "enabled": self.enabled,
            "counters": {_fmt(k): c.value for k, c in self._counters.items()},
            "gauges": {_fmt(k): g.value for k, g in self._gauges.items()},
            "histograms": {
                _fmt(k): h.snapshot() for k, h in self._hists.items()
            },
        }

    def to_prometheus(self) -> str:
        """The whole registry in Prometheus text exposition format —
        counters, gauges, and histograms-as-summaries (quantile labels +
        ``_sum``/``_count``).  See ``obs/export.py`` for the renderer and
        the ``python -m repro_torch.obs.export`` CLI around it."""
        from repro_torch.obs.export import render_prometheus  # lazy: export is CLI-adjacent

        return render_prometheus(self.snapshot())
