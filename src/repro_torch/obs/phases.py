"""The device phases of a search, marked where their work is enqueued.

``OverlapIndex.search`` runs seven phases, each entered with ``phase(name)``
where its work is issued: ``upload`` (the queries' copy to the device,
``api/index.py``), ``route`` (``core.knn.route_select``), ``bounds`` (K2 and
the clamp / where of ``bucket_bounds`` and ``delta_bounds``), ``sort``
(``_sorted_bounds``), ``scan`` (K1's main phase and the delta phase),
``finish`` (the square root, ``scan_stats`` and the packing ``cat`` of
``api/plan.results_to_host``) and ``copy`` (the one device-to-host copy,
``to_host``).  A phase is cheap unless someone is looking:

  * nobody looking (no profiler, no sampled search): entering a phase reads
    the ambient trace (one thread-local) and torch's "profiler enabled" flag,
    and returns one shared inert object; no event, no sync, no allocation;
  * a ``torch.profiler`` records: the phase is also a profiler range named
    ``<span>/<phase>`` after the innermost span open as a range
    (``obs.metrics.profiled_path``: ``search/device_execute/scan``,
    ``search/host_transfer/copy``, or under a serving step's span when the
    serving engine runs the executor), the bare phase name under none; so
    the device's idle gaps are charged to the phase whose host work the
    device waited for;
  * a sampled search (``OverlapIndex.search`` attaches a ``PhaseRun`` of its
    index's ``PhaseClock`` to the ambient ``TraceContext``): entering a phase
    marks a boundary, a CUDA event recorded on the device's current stream
    (a host clock reading on the CPU, whose ops run synchronously).  The
    host waits for the device once, at the copy, as every search does; the
    split of that wait from the copy is the ``wait`` / ``copy`` spans under
    ``search/host_transfer``.  After the search, ``PhaseRun.observe`` turns
    the boundaries into seconds a phase (``search/device/<phase>``: from the
    phase's boundary to the next one), their sum from the first boundary to
    the last (``search/device``) and the run's host time outside it
    (``search/host_only``, a lower bound on the device's idle time in the
    call).  The scan also hands the run the rows K1 staged and the padded
    capacity of the buckets it visited (``PhaseRun.count_rows``), folded
    into the counters ``search.staged_rows`` and ``search.capacity_rows``
    and the gauge ``search.staged_share`` (their ratio).

Core functions keep their signatures: the run travels with the ambient
trace (``obs/trace.use_trace``), which keeps it per thread, and each thread
records on events of its own.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any

import numpy as np
import torch
import torch.autograd.profiler as _profiler

from repro_torch.obs.metrics import profiled_path
from repro_torch.obs.trace import current_trace

__all__ = ["PHASES", "PhaseClock", "PhaseRun", "attach", "current_run", "phase", "to_host"]

PHASES = ("upload", "route", "bounds", "sort", "scan", "finish", "copy")


class _Off:
    """The inert phase: what ``phase`` returns when nobody is looking."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def _range_name(name: str) -> str:
    """The profiler range of phase ``name``: under the innermost span open
    as a range on this thread, or bare under none."""
    outer = profiled_path()
    return name if outer is None else f"{outer}/{name}"


class _Phase:
    __slots__ = ("name", "run", "_range")

    def __init__(self, name: str, run: "PhaseRun | None") -> None:
        self.name = name
        self.run = run
        self._range = None

    def __enter__(self) -> None:
        if self.run is not None:
            self.run.mark(self.name)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(_range_name(self.name))
            self._range.__enter__()

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)


def current_run() -> "PhaseRun | None":
    """The sampled search's run on this thread, or None (unsampled)."""
    ctx = current_trace()
    return None if ctx is None else ctx.clock


def phase(name: str):
    """Enter the search phase ``name`` for the ``with`` block (module doc)."""
    run = current_run()
    if run is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Phase(name, run)


def attach(run: "PhaseRun | None"):
    """The ``with`` block's phases mark on ``run`` (``None``: nothing to
    attach; the block's target is then ``None`` too)."""
    return _OFF if run is None else run


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()`` as the ``copy`` phase: the search's one copy to the
    host, and its one wait for the device.  On a sampled search the wait
    (span ``wait``, on the copy's boundary: the device's last work before the
    copy) and the copy (span ``copy``) are timed apart, and the run's last
    boundary follows the copy."""
    run = current_run()
    if run is None:
        with phase("copy"):
            return t.cpu().numpy()
    run.mark("copy")
    with run.registry.span("wait"):
        run.wait()
    with run.registry.span("copy"):
        out = t.cpu().numpy()
    run.mark(None)
    return out


class PhaseClock:
    """An index's clock for the phases of its sampled searches on one device.

    ``run()`` gives each search its own ``PhaseRun``; the events a run
    records on a CUDA device come from a pool of the calling thread's, reused
    search after search (a search ends with a sync, so an event is free again
    by the next one on that thread).  ``registry`` is where the ``wait`` /
    ``copy`` spans and the phase histograms go.
    """

    def __init__(self, device: torch.device, registry) -> None:
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.registry = registry
        self._local = threading.local()

    def run(self) -> "PhaseRun":
        return PhaseRun(self)


class PhaseRun:
    """The boundaries of one search's phases.  As a context manager it
    attaches itself to the ambient sampled trace for the block (restoring
    whatever run it found there), and times the block on the host."""

    def __init__(self, clock: PhaseClock) -> None:
        self.clock = clock
        self.registry = clock.registry
        self.cuda = clock.cuda
        self._marks: list[tuple[str | None, Any]] = []
        self._rows: list[tuple[torch.Tensor, torch.Tensor]] = []  # (staged, capacity)
        self._pool: list[Any] = []
        self._stream = None
        self._ctx = None
        self._prev = None
        self._host_s = 0.0

    def __enter__(self) -> "PhaseRun":
        local = self.clock._local
        # the thread's pool; a search nested in this one takes a fresh pool
        self._pool = getattr(local, "pool", None) or []
        local.pool = None
        if self.cuda:
            self._stream = torch.cuda.current_stream(self.clock.device)
        self._ctx = current_trace()
        self._prev = self._ctx.clock
        self._ctx.clock = self
        self._host_s = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._host_s = time.perf_counter() - self._host_s
        self._ctx.clock = self._prev
        self.clock._local.pool = self._pool

    def _stamp(self):
        if not self.cuda:
            return time.perf_counter_ns()
        i = len(self._marks)
        if i == len(self._pool):
            self._pool.append(torch.cuda.Event(enable_timing=True))
        ev = self._pool[i]
        ev.record(self._stream)
        return ev

    def mark(self, name: str | None) -> None:
        """A boundary: phase ``name`` starts here (``None``: the last one
        ends)."""
        self._marks.append((name, self._stamp()))

    def count_rows(self, staged: torch.Tensor, capacity: torch.Tensor) -> None:
        """Keep a scan's (Q,) rows staged and padded capacity visited
        (``npad``) until ``observe``, which reads them after the search's
        copy has waited for the device."""
        self._rows.append((staged, capacity))

    def wait(self) -> None:
        """Block the host until the device has passed the latest boundary."""
        if self.cuda:
            self._marks[-1][1].synchronize()

    def _seconds(self, a, b) -> float:
        return a.elapsed_time(b) * 1e-3 if self.cuda else (b - a) * 1e-9

    def read(self) -> tuple[dict[str, float], float]:
        """(seconds a phase, seconds from the first boundary to the last) of
        the search just marked.  The last boundary follows the copy, which
        the host has waited for, so reading it waits for nothing more."""
        marks = self._marks
        if self.cuda:
            marks[-1][1].synchronize()
        out: dict[str, float] = defaultdict(float)
        for (name, a), (_, b) in zip(marks, marks[1:]):
            out[name] += self._seconds(a, b)
        return dict(out), self._seconds(marks[0][1], marks[-1][1])

    def observe(self) -> None:
        """Observe the search just run: ``search/device/<phase>``,
        ``search/device`` and ``search/host_only`` (the run's host seconds
        less ``search/device``).  Call it after the ``with`` block, before
        the thread starts another search (the run's events are the
        thread's again)."""
        phases, device_s = self.read()
        reg = self.registry
        for name, sec in phases.items():
            reg.histogram(f"search/device/{name}").observe(sec)
        reg.histogram("search/device").observe(device_s)
        reg.histogram("search/host_only").observe(self._host_s - device_s)
        if self._rows:
            reg.counter("search.staged_rows").inc(sum(int(s.sum()) for s, _ in self._rows))
            reg.counter("search.capacity_rows").inc(sum(int(c.sum()) for _, c in self._rows))
            capacity = reg.value("search.capacity_rows")
            if capacity:
                reg.gauge("search.staged_share").set(
                    reg.value("search.staged_rows") / capacity)
