"""Search planning: one cached executor per static-option tuple.

  * ``PlanKey``     — the static options an executor is specialized on:
                      ``(k, mode, beam, kernel, quantize, delta_capacity)``;
  * ``SearchPlan``  — the key plus the layout backend's executor body with
                      those options baked in, and a call counter;
  * ``PlanCache``   — the per-index table of plans with hit/miss counters,
                      bounded by ``max_plans`` with LRU eviction.

PyTorch runs eagerly, so a plan holds no compiled program (the JAX package's
plans hold a ``jax.jit`` executable and count traces); it keeps the option
tuple and its executor in one place so both packages key searches alike.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.knn import SearchStats


class PlanKey(NamedTuple):
    """Static options one search executor is specialized on."""

    k: int
    mode: str
    beam: int
    kernel: bool
    quantize: bool
    delta_capacity: int | None = None  # None: no delta phase


@dataclass
class SearchPlan:
    """A search program for one ``PlanKey``: ``executor(device_forest, q,
    delta)`` returns the device triple ``(dists, ids, SearchStats)``;
    ``calls`` counts executions through this plan."""

    key: PlanKey
    executor: Callable[..., tuple[Any, ...]]
    calls: int = 0


class PlanCache:
    """Per-``OverlapIndex`` table of search plans, LRU-bounded: exceeding
    ``max_plans`` evicts the least-recently-used plan."""

    def __init__(self, max_plans: int = 64) -> None:
        if max_plans < 1:
            raise ValueError(f"max_plans={max_plans} must be >= 1")
        self._plans: OrderedDict[PlanKey, SearchPlan] = OrderedDict()
        self.max_plans = max_plans
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def plan(self, key: PlanKey, backend) -> SearchPlan:
        got = self._plans.get(key)
        if got is None:
            self.misses += 1
            got = self._plans[key] = SearchPlan(key=key, executor=backend.search_body(key))
            if len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)
                self.evictions += 1
        else:
            self.hits += 1
            self._plans.move_to_end(key)
        return got

    def __len__(self) -> int:
        return len(self._plans)

    def stats(self) -> dict[str, int]:
        return dict(
            plans=len(self._plans),
            max_plans=self.max_plans,
            hits=self.hits,
            misses=self.misses,
            evictions=self.evictions,
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
    d: torch.Tensor, i: torch.Tensor, s: SearchStats
) -> tuple[np.ndarray, np.ndarray, dict[str, Any]]:
    """A search's (dists, ids, SearchStats) -> host arrays and the stats dict
    the JAX package reports (numpy int32 per-query arrays and an int
    ``steps``), in one device-to-host copy: the search's only sync."""
    qn, kk = d.shape
    packed = torch.cat([
        d.to(torch.float32).view(torch.int32).reshape(-1), i.to(torch.int32).reshape(-1),
        *(getattr(s, f).to(torch.int32).reshape(-1) for f in _STAT_FIELDS),
        s.steps.to(torch.int32).reshape(1),
    ]).cpu().numpy()
    n = qn * kk
    stats = {f: packed[2 * n + j * qn: 2 * n + (j + 1) * qn] for j, f in enumerate(_STAT_FIELDS)}
    stats["steps"] = int(packed[-1])
    return packed[:n].view(np.float32).reshape(qn, kk), packed[n:2 * n].reshape(qn, kk), stats
