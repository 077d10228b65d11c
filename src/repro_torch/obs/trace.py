"""Per-request trace propagation + reconstruction over the JSONL events
(the port's own copy of ``repro/obs/trace.py``).

A ``TraceContext`` is one request's identity: a ``trace_id``, a span-id
allocator, and the sampling decision.  It flows *ambiently* — ``use_trace``
installs it in a thread-local and every ``Registry.span`` exit inside the
``with`` block stamps its event record with ``trace_id`` / ``span_id`` /
``parent_id`` — so the instrumented layers (``ServeEngine`` request ->
``OverlapIndex.search`` -> ``SearchPlan`` -> executor islands) need no
signature changes to participate: whoever holds the context wraps the call.

Parentage is a per-thread stack inside the context: a span entered while
another trace span is open parents to it; a span entered at the top level
parents to the context's ``root_id`` (the "request" span the owner emits
explicitly, with its externally-measured duration, when the request
completes).  Events are written at span *exit*, so children precede their
parent in the file — ``Trace.reconstruct`` links by id, not by order.

Sampling is deterministic and systematic (error-diffusion accumulator, no
RNG): ``TraceSampler(rate)`` admits exactly ``floor`-or-`ceil(n * rate)``
of the first n requests in a fixed, reproducible pattern — rate 1.0 traces
everything, rate 0 nothing.  An unsampled request gets no context at all,
so the untraced hot path stays bitwise-identical and pays nothing beyond
one attribute read.
"""
from __future__ import annotations

import threading
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Iterator

from repro_torch.obs.events import EventLog

__all__ = [
    "TraceContext",
    "TraceSampler",
    "Trace",
    "SpanNode",
    "current_trace",
    "new_trace",
    "use_trace",
]

_ambient = threading.local()


class TraceContext:
    """One request's tracing identity: id allocation + the parent stack.

    ``sampled=False`` contexts exist so callers can hold a request-scoped
    object unconditionally; the registry only emits linkage for sampled
    ones.  Span ids are ``<trace_id>.<n>`` — unique within the trace,
    allocation is thread-safe (``root_id`` is always ``.1``).

    ``clock`` is the ``obs.phases.PhaseRun`` the current thread's search
    marks its device phases on (``None`` outside a sampled
    ``OverlapIndex.search``).
    """

    __slots__ = ("trace_id", "sampled", "root_id", "_n", "_lock", "_local")

    def __init__(self, trace_id: str | None = None, *, sampled: bool = True):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.sampled = bool(sampled)
        self._n = 0
        self._lock = threading.Lock()
        self._local = threading.local()
        self.root_id = self.alloc()

    def alloc(self) -> str:
        with self._lock:
            self._n += 1
            return f"{self.trace_id}.{self._n}"

    def _stack(self) -> list[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def push(self) -> tuple[str, str]:
        """Enter a span: returns (span_id, parent_id) and makes the new
        span the parent of whatever nests inside it."""
        sid = self.alloc()
        st = self._stack()
        parent = st[-1] if st else self.root_id
        st.append(sid)
        return sid, parent

    def pop(self) -> None:
        self._stack().pop()

    @property
    def clock(self):
        return getattr(self._local, "clock", None)

    @clock.setter
    def clock(self, clock) -> None:
        self._local.clock = clock

    def link(self) -> tuple[str, str]:
        """Allocate an id parented at the current position WITHOUT pushing
        — for point events (island counters, plan annotations)."""
        sid = self.alloc()
        st = self._stack()
        return sid, (st[-1] if st else self.root_id)

    def __repr__(self) -> str:
        return (f"TraceContext({self.trace_id!r}, sampled={self.sampled}, "
                f"spans={self._n})")


def new_trace(*, sampled: bool = True) -> TraceContext:
    return TraceContext(sampled=sampled)


def current_trace() -> TraceContext | None:
    """The ambient context installed by ``use_trace``, if any (and only if
    sampled — unsampled contexts are never installed)."""
    return getattr(_ambient, "ctx", None)


@contextmanager
def use_trace(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Install ``ctx`` as the ambient trace for the block.  ``None`` (or an
    unsampled context) is a true no-op: whatever was ambient stays ambient,
    so call sites wrap unconditionally."""
    if ctx is None or not ctx.sampled:
        yield ctx
        return
    prev = getattr(_ambient, "ctx", None)
    _ambient.ctx = ctx
    try:
        yield ctx
    finally:
        _ambient.ctx = prev


class TraceSampler:
    """Deterministic systematic sampler (error-diffusion, no RNG).

    ``sample()`` accumulates ``rate`` per call and fires each time the
    accumulator crosses 1 — e.g. rate 0.25 admits request 4, 8, 12, ... —
    so runs are reproducible and the admitted fraction is exact in the
    long run.  Not thread-safe by design: each owner (engine, index) holds
    its own.
    """

    __slots__ = ("rate", "_acc")

    def __init__(self, rate: float):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"trace sample rate {rate} must lie in [0, 1]")
        self.rate = float(rate)
        self._acc = 0.0

    def sample(self) -> bool:
        if self.rate <= 0.0:
            return False
        self._acc += self.rate
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    def maybe_trace(self) -> TraceContext | None:
        return new_trace() if self.sample() else None


# ---------------------------------------------------------------------------
# reconstruction
# ---------------------------------------------------------------------------


@dataclass
class SpanNode:
    """One reconstructed span: its event record + child spans (file order)."""

    record: dict[str, Any]
    children: list["SpanNode"] = field(default_factory=list)

    @property
    def name(self) -> str:
        return str(self.record.get("span", self.record.get("event", "?")))

    @property
    def dur_s(self) -> float:
        return float(self.record.get("dur_s", 0.0))


@dataclass
class Trace:
    """One request's span tree, reassembled from an events JSONL.

    ``roots`` are the spans whose parent is absent from the file — normally
    exactly one, the owner-emitted ``request`` root.  ``records`` keeps
    every raw event of the trace (including point events) in file order.
    """

    trace_id: str
    roots: list[SpanNode]
    records: list[dict[str, Any]]

    @staticmethod
    def reconstruct(path: str, trace_id: str) -> "Trace":
        """Reassemble one trace from ``path`` (rotated files included —
        ``EventLog.read`` spans rotations oldest-first)."""
        recs = [
            r for r in EventLog.read(path) if r.get("trace_id") == trace_id
        ]
        nodes: dict[str, SpanNode] = {
            r["span_id"]: SpanNode(r) for r in recs if "span_id" in r
        }
        roots: list[SpanNode] = []
        for r in recs:
            sid = r.get("span_id")
            if sid is None:
                continue
            parent = r.get("parent_id")
            if parent is not None and parent in nodes and parent != sid:
                nodes[parent].children.append(nodes[sid])
            else:
                roots.append(nodes[sid])
        return Trace(trace_id=trace_id, roots=roots, records=recs)

    @staticmethod
    def trace_ids(path: str) -> list[str]:
        """Every trace id present in the log, in first-seen order."""
        seen: dict[str, None] = {}
        for r in EventLog.read(path):
            tid = r.get("trace_id")
            if tid is not None and tid not in seen:
                seen[tid] = None
        return list(seen)

    def span_names(self) -> set[str]:
        out: set[str] = set()

        def walk(n: SpanNode) -> None:
            out.add(n.name)
            for c in n.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return out

    def render(self) -> str:
        """Human-readable tree (the export CLI's ``--trace`` output)."""
        lines = [f"trace {self.trace_id}"]

        def walk(n: SpanNode, depth: int) -> None:
            lines.append(f"{'  ' * depth}- {n.name}  {n.dur_s * 1e3:.3f} ms")
            for c in n.children:
                walk(c, depth + 1)

        for r in self.roots:
            walk(r, 1)
        return "\n".join(lines)
