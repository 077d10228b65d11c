"""Telemetry layer of the port: metrics registry, phase spans, JSONL
events, per-request traces — the port's own copy of the JAX package's
``repro.obs`` core (``events``, ``metrics``, ``trace``).

    from repro_torch.obs import Registry

    reg = Registry()
    with reg.span("serve.decode_step"):
        ...                           # -> histogram "serve.decode_step"
    reg.counter("serve.tokens").inc(8)
    reg.snapshot()                    # one nested, JSON-serializable dict

Consumed by ``repro_torch.serve.ServeEngine``.  The Prometheus export and
the visit attribution behind ``explain`` come with the telemetry slice.
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
