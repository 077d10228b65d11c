"""The reduction of ``torch.profiler`` traces to what the per-layer metrics
read: the device's operations, how much of the traced window the device was
busy, and what the host was doing while it was idle.

``trace_calls`` profiles two stretches of calls.  The first records the
device's activity alone (kernels, copies, fills and the CUDA runtime calls),
which costs the host little: its window is the host clock's span of the
stretch, synchronised at both ends, and device time is the union of the
intervals of the device's operations in it.  The second also records the
host's operators, inside one ``bench.window`` range and each call inside a
``bench.call`` range (spans from the benchmark's own code around the call
into the facade): an idle stretch of the device there is charged to the
innermost host operation running on the calling thread at that time, to
``bench.call`` where the host was in the facade's own Python, and to
``host_outside_any_operation`` elsewhere.  Recording every operator slows
the host, so the second stretch's gaps are longer than the first's; they say
where the host's time goes, and the first stretch says how much of it the
device waits through.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

OUTSIDE = "host_outside_any_operation"
WINDOW = "bench.window"
CALL = "bench.call"


@dataclass
class DeviceTrace:
    calls: int
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float]]  # (name, seconds) of every kernel launch
    device_ops: dict[str, float] = field(default_factory=dict)  # name -> seconds
    idle_gaps: dict[str, float] = field(default_factory=dict)  # host activity -> seconds

    def top(self, table: dict[str, float], n: int = 10) -> list[list]:
        return [[name, sec] for name, sec in
                sorted(table.items(), key=lambda kv: kv[1], reverse=True)[:n]]


def _ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, s + e.duration_ns()
    s = e.start_us() * 1000
    return s, s + e.duration_us() * 1000


def _is_device(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] in ("CUDA", "PrivateUse1")


def _is_annotation(e) -> bool:
    """A range the harness (or anyone) marked, which the profiler also draws
    on the device's timeline: no work of the device."""
    return e.name() in (WINDOW, CALL) or (
        hasattr(e, "is_user_annotation") and e.is_user_annotation())


def _is_launch(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def _union(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _host_segments(events: list[tuple[int, int, str]]) -> list[tuple[int, int, str]]:
    """(start, end, innermost operation) segments of nested host events."""
    segs: list[tuple[int, int, str]] = []
    stack: list[tuple[int, int, str]] = []
    t = None
    for s, e, name in sorted(events, key=lambda v: (v[0], -v[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            segs.append((t, top[1], top[2]))
            t = top[1]
        if stack and t is not None and s > t:
            segs.append((t, s, stack[-1][2]))
        t = s
        stack.append((s, min(e, stack[-1][1]) if stack else e, name))
    while stack:
        top = stack.pop()
        segs.append((t, top[1], top[2]))
        t = top[1]
    return [seg for seg in segs if seg[1] > seg[0]]


def _charge(gaps: list[tuple[int, int]], segs: list[tuple[int, int, str]]) -> dict[str, float]:
    out: dict[str, float] = defaultdict(float)
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        i = j
        while i < len(segs) and segs[i][0] < b:
            s, e, name = segs[i]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                out[name] += ov * 1e-9
                covered += ov
            i += 1
        if b - a > covered:
            out[OUTSIDE] += (b - a - covered) * 1e-9
    return dict(out)


def _device_events(events) -> list[tuple[int, int, str]]:
    return [(*_ns(e), e.name()) for e in events if _is_device(e) and not _is_annotation(e)]


def reduce_device(events, calls: int, window_s: float) -> DeviceTrace:
    """A ``DeviceTrace`` (without gaps) from a device-only stretch."""
    dev = _device_events(events)
    lo = min((s for s, _, _ in dev), default=0)
    hi = max((t for _, t, _ in dev), default=0)
    busy_ns = sum(t - s for s, t in _union([(s, t) for s, t, _ in dev], lo, hi))
    ops: dict[str, float] = defaultdict(float)
    kernels = []
    for s, t, name in dev:
        ops[name] += (t - s) * 1e-9
        if _is_launch(name):
            kernels.append((name, (t - s) * 1e-9))
    return DeviceTrace(calls=calls, window_s=window_s, busy_s=busy_ns * 1e-9,
                       kernels=kernels, device_ops=dict(ops))


def reduce_gaps(events) -> dict[str, float]:
    """Host activity during the device's idle time, from a stretch that
    recorded the host's operators inside a ``bench.window`` range."""
    window = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = _ns(window[0])
    thread = window[0].start_thread_id()
    host = [(*_ns(e), e.name()) for e in events
            if not _is_device(e) and e.start_thread_id() == thread
            and e.name() != WINDOW and not e.is_async()]
    busy = _union([(s, t) for s, t, _ in _device_events(events)], lo, hi)
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = t
    if hi > cur:
        gaps.append((cur, hi))
    return _charge(gaps, _host_segments(host))


def trace_calls(call: Callable[[int], object], n: int, n_host: int, *,
                cuda: bool) -> tuple[DeviceTrace, list]:
    """Profile ``call(i)`` for i < n with the device's activity alone, then
    for i < n_host with the host's operators too; returns the trace and the
    first stretch's results."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with warnings.catch_warnings():
        # torch warns that events do not outlive a profiler cycle: there is one
        warnings.filterwarnings("ignore", message=".*clears events.*")
        device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        results = []
        sync()
        with profile(activities=device_only) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                results.append(call(i))
            sync()
            window_s = time.perf_counter() - t0
        trace = reduce_device(prof.profiler.kineto_results.events() if cuda else [], n,
                              window_s)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof, record_function(WINDOW):
            for i in range(n_host):
                with record_function(CALL):
                    call(i)
            sync()
        trace.idle_gaps = reduce_gaps(prof.profiler.kineto_results.events())
    return trace, results
