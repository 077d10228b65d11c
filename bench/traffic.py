"""The one traffic generator: a mix file's parameters in, the queries (and
writes) a run sends out.

Two kinds of mix (``traffic/<mix>.json``), both a closed loop of one client
that sends a call only after the last is answered, with ``k`` neighbours a
query:

* ``closed_loop_batches``: each call is one search of ``batch`` queries.
  Before the window the harness makes a pool of ``pool`` distinct batches
  from the seed, in host memory, and the window cycles through it for as
  long as it lasts.
* ``closed_loop_ingest``: each call writes ``ingest`` fresh readings of the
  configuration's geometry (``datasets.writes``, ``drift`` setting how fast
  a corridor between two classes takes over the batches), runs the index's
  maintenance, then searches ``batch`` queries: ``batch - recent`` cycled
  from a pool as above and ``recent`` drawn from the rows that call wrote,
  so every call reads its own writes back.  The window is the whole stream
  of ``calls`` calls, drawn before it: a fixed amount of work.

A query is the frozen recipe of ``benchmarks/bench_search.py``
(``_queries``): a row drawn from the dataset (or from a call's writes) plus
Gaussian noise of 0.05 times the dataset's standard deviation.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

from bench import datasets
from bench.datasets import sample_rng

KINDS = ("closed_loop_batches", "closed_loop_ingest")
COUNTS = {"closed_loop_batches": ("batch", "k", "pool", "check_calls"),
          "closed_loop_ingest": ("batch", "k", "pool", "check_calls", "ingest", "recent",
                                 "calls")}
# the uses of a run's seed by a stream (``datasets.sample_rng`` tags; 1-3
# are the rows, the pool and the window's sample of calls)
WINDOW, WARM, TRACE, JUDGED = 4, 5, 6, 7


def check_mix(mix: dict[str, Any]) -> None:
    kind = mix.get("kind")
    if kind not in KINDS:
        raise ValueError(f"traffic kind {kind!r} is not one of {KINDS}")
    for key in COUNTS[kind]:
        if int(mix[key]) < 1:
            raise ValueError(f"traffic {key}={mix[key]} must be >= 1")
    if streams(mix):
        if int(mix["recent"]) > min(int(mix["ingest"]), int(mix["batch"])):
            raise ValueError(f"traffic recent={mix['recent']} must be <= ingest and batch")
        if int(mix["check_calls"]) > int(mix["calls"]):
            raise ValueError(f"traffic check_calls={mix['check_calls']} must be <= calls")
        if float(mix["drift"]) < 0:
            raise ValueError(f"traffic drift={mix['drift']} must be >= 0")


def streams(mix: dict[str, Any]) -> bool:
    """Whether the mix writes between its searches."""
    return mix["kind"] == "closed_loop_ingest"


def queries(x: np.ndarray, n: int, g: np.random.Generator, scale=None) -> np.ndarray:
    """``n`` queries around distinct rows of ``x``; ``scale`` is the
    dataset's standard deviation (that of ``x`` where not given)."""
    idx = g.choice(len(x), n, replace=False)
    s = x.std() if scale is None else scale
    return (x[idx] + 0.05 * s * g.normal(size=(n, x.shape[1]))).astype(np.float32)


def query_pool(x: np.ndarray, mix: dict[str, Any], seed: int) -> list[np.ndarray]:
    """``mix['pool']`` distinct (batch, D) f32 query batches drawn from ``seed``."""
    g = sample_rng(seed, 2)
    return [queries(x, int(mix["batch"]), g) for _ in range(int(mix["pool"]))]


class Stream(NamedTuple):
    """The calls of a stretch of a write-and-search stream, in order."""

    writes: list[np.ndarray]  # (ingest, D) f32 rows each call writes
    queries: list[np.ndarray]  # (batch, D) f32 queries each call then searches


def stream(x: np.ndarray, geo, mix: dict[str, Any], pool: list[np.ndarray], seed: int,
           part: int, calls: int, start: int = 0) -> Stream:
    """``calls`` calls of one stretch (``part``: WARM, WINDOW or TRACE, each
    drawn from its own use of the seed), their writes the ``start``-th on
    of the stream (the drift's clock), their queries the pool's batches
    cycled in order with the last ``recent`` replaced by queries around the
    call's own writes."""
    g = sample_rng(seed, part)
    rows = datasets.writes(geo, calls, int(mix["ingest"]), g, drift=float(mix["drift"]),
                           start=start)
    keep = int(mix["batch"]) - int(mix["recent"])
    scale = x.std()
    qs = [np.concatenate([pool[i % len(pool)][:keep],
                          queries(w, int(mix["recent"]), g, scale)])
          for i, w in enumerate(rows)]
    return Stream(writes=rows, queries=qs)
