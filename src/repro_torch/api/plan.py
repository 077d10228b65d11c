"""Search planning: one cached executor per static-option tuple.

  * ``PlanKey``     — the static options an executor is specialized on:
                      ``(k, mode, beam, kernel, quantize, delta_capacity,
                      shards, explain, fanout)``;
  * ``SearchPlan``  — the key plus the layout backend's executor body with
                      those options baked in, and call / shape counters;
  * ``PlanCache``   — the per-index table of plans with hit/miss counters,
                      bounded by ``max_plans`` with LRU eviction.

PyTorch runs eagerly, so a plan holds no compiled program (the JAX package's
plans hold a ``jax.jit`` executable and count its traces).  It keeps the
option tuple and its executor in one place so both packages key searches
alike, and counts as ``traces`` the distinct operand shapes it ran: the
specializations a compiled executor would trace.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.knn import SearchStats
from repro_torch.obs.phases import phase, to_host


class PlanKey(NamedTuple):
    """Static options one search executor is specialized on."""

    k: int
    mode: str
    beam: int
    kernel: bool
    quantize: bool
    delta_capacity: int | None = None  # None: no delta phase
    shards: int = 1  # device layout: 1 single, > 1 the sharded/routed islands
    # explain plans also return core.knn.VisitRows (the visited-row
    # evidence obs/attribution.py decodes); a separate plan keeps the
    # search executor's output contract untouched
    explain: bool = False
    # routed layout only: the dispatch policy ('auto' | 'targeted' | 'all');
    # None on the single and sharded layouts
    fanout: str | None = None


def _shapes(tree) -> tuple:
    """Shapes of every tensor in a nest of tuples (forest, its islands, the
    routing table, delta views)."""
    if tree is None:
        return ()
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape),)
    return tuple(s for t in tree for s in _shapes(t))


def _shape_signature(forest, q, delta) -> tuple:
    return (_shapes(forest), tuple(q.shape), _shapes(delta))


@dataclass
class SearchPlan:
    """A search program for one ``PlanKey``: ``executor(operands, q,
    delta)`` returns the device triple ``(dists, ids, SearchStats)``, an
    explain plan (``key.explain``) appends ``core.knn.VisitRows``, and the
    sharded and routed layouts append their telemetry after those (see
    ``api/executor.py``).
    ``calls`` counts executions through this plan, ``shapes`` the distinct
    operand shape signatures it ran."""

    key: PlanKey
    executor: Callable[..., tuple[Any, ...]] = None  # set by _build_plan
    calls: int = 0
    shapes: set = field(default_factory=set, repr=False)

    @property
    def traces(self) -> int:
        """Distinct operand shapes run: what a compiled executor would have
        traced (the port compiles nothing)."""
        return len(self.shapes)


def _build_plan(key: PlanKey, backend) -> SearchPlan:
    plan = SearchPlan(key=key)
    body = backend.explain_body(key) if key.explain else backend.search_body(key)

    def executor(forest, q, delta):
        plan.shapes.add(_shape_signature(forest, q, delta))
        return body(forest, q, delta)

    plan.executor = executor
    return plan


class PlanCache:
    """Per-``OverlapIndex`` table of search plans, LRU-bounded: exceeding
    ``max_plans`` evicts the least-recently-used plan.  With a ``registry``
    (``repro_torch.obs.Registry``) the hit/miss/eviction counts also go to
    its ``plan_cache.*`` counters."""

    def __init__(self, max_plans: int = 64, *, registry=None) -> None:
        if max_plans < 1:
            raise ValueError(f"max_plans={max_plans} must be >= 1")
        self._plans: OrderedDict[PlanKey, SearchPlan] = OrderedDict()
        self.max_plans = max_plans
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.evicted_traces = 0  # lifetime traces of plans no longer cached
        self._obs = registry

    def _count(self, name: str) -> None:
        if self._obs is not None:
            self._obs.counter(name).inc()

    def plan(self, key: PlanKey, backend) -> SearchPlan:
        got = self._plans.get(key)
        if got is None:
            self.misses += 1
            self._count("plan_cache.misses")
            got = self._plans[key] = _build_plan(key, backend)
            if len(self._plans) > self.max_plans:
                _, evicted = self._plans.popitem(last=False)
                self.evicted_traces += evicted.traces
                self.evictions += 1
                self._count("plan_cache.evictions")
        else:
            self.hits += 1
            self._count("plan_cache.hits")
            self._plans.move_to_end(key)
        return got

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._plans

    def keys(self) -> tuple[PlanKey, ...]:
        return tuple(self._plans)

    def stats(self) -> dict[str, int]:
        return dict(
            plans=len(self._plans),
            max_plans=self.max_plans,
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
            # lifetime specializations: live plans + plans eviction dropped
            traces=self.evicted_traces + sum(p.traces for p in self._plans.values()),
        )


@dataclass(frozen=True)
class SearchResult:
    """Structured result of ``OverlapIndex.search``: true L2 distances,
    global object ids (-1 where fewer than k objects were reachable), and
    the paper's per-query cost instrumentation — as host numpy.

    Iterates as ``(dists, ids, stats)``.
    """

    dists: np.ndarray  # (Q, k')
    ids: np.ndarray  # (Q, k')
    stats: dict[str, Any]
    plan: SearchPlan = field(repr=False, compare=False, default=None)

    def __iter__(self):
        yield from (self.dists, self.ids, self.stats)

    @property
    def k(self) -> int:
        return int(self.dists.shape[1])


_STAT_FIELDS = ("buckets_visited", "distances", "bound_distances",
                "padded_distances", "comparisons")


def results_to_host(
    d: torch.Tensor, i: torch.Tensor, s: SearchStats, *extra: torch.Tensor
) -> tuple[Any, ...]:
    """A search's (dists, ids, SearchStats) -> host arrays and the stats dict
    the JAX package reports (numpy int32 per-query arrays and an int
    ``steps``), in one device-to-host copy: the search's only sync.
    ``extra`` integer tensors (an explain run's visit orders, counts and
    home indexes) ride in the same copy and follow, as i32 numpy arrays of
    their shapes: ``(dists, ids, stats, *extra)``.  The packing is the
    search's ``finish`` device phase and the copy its ``copy`` phase
    (``obs/phases.py``)."""
    qn, kk = d.shape
    with phase("finish"):
        packed = torch.cat([
            d.to(torch.float32).view(torch.int32).reshape(-1), i.to(torch.int32).reshape(-1),
            *(getattr(s, f).to(torch.int32).reshape(-1) for f in _STAT_FIELDS),
            s.steps.to(torch.int32).reshape(1),
            *(t.to(torch.int32).reshape(-1) for t in extra),
        ])
    packed = to_host(packed)
    n = qn * kk
    stats = {f: packed[2 * n + j * qn: 2 * n + (j + 1) * qn] for j, f in enumerate(_STAT_FIELDS)}
    lo = 2 * n + len(_STAT_FIELDS) * qn
    stats["steps"] = int(packed[lo])
    lo += 1
    rest = []
    for t in extra:
        rest.append(packed[lo: lo + t.numel()].reshape(tuple(t.shape)))
        lo += t.numel()
    return (packed[:n].view(np.float32).reshape(qn, kk), packed[n:2 * n].reshape(qn, kk),
            stats, *rest)
