"""Telemetry layer of the port: metrics registry, phase spans, JSONL
events, per-request traces, the Prometheus export and the visit
attribution behind ``explain`` — the port's own copy of the JAX package's
``repro.obs``.

    from repro_torch.obs import Registry

    reg = Registry()
    with reg.span("search"):
        with reg.span("device_execute"):
            ...                       # -> histogram "search/device_execute"
    reg.counter("search.queries").inc(64)
    reg.snapshot()                    # one nested, JSON-serializable dict
    reg.to_prometheus()               # Prometheus text exposition format

Consumed by ``repro_torch.api.OverlapIndex`` (per-phase search / ingest /
maintain spans and per-island node-access counters, exposed by
``.metrics()``) and ``repro_torch.serve.ServeEngine``.  Adjacent modules:
``repro_torch.obs.trace`` (trace propagation and ``Trace.reconstruct``),
``repro_torch.obs.attribution`` (contributing / wasted visits behind
``OverlapIndex.explain``), ``repro_torch.obs.export`` (Prometheus render and
parse, and the ``python -m repro_torch.obs.export`` CLI),
``repro_torch.obs.phases`` (the search's device phases: profiler ranges
while a profiler records, CUDA-event times on sampled searches).
"""
from repro_torch.obs.events import EventLog, events_path_from_env
from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import (
    SpanNode,
    Trace,
    TraceContext,
    TraceSampler,
    current_trace,
    new_trace,
    use_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "EventLog",
    "events_path_from_env",
    "SpanNode",
    "Trace",
    "TraceContext",
    "TraceSampler",
    "current_trace",
    "new_trace",
    "use_trace",
]
