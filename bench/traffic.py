"""The one traffic generator: a mix file's parameters in, the queries a run
sends out.

A mix (``traffic/<mix>.json``) is a closed loop of one client sending batches
of ``batch`` queries, each the next only after the last is answered, with
``k`` neighbours a query.  Before the window the harness makes a pool of
``pool`` distinct batches from the seed, in host memory, and the window cycles
through it.  A query is the frozen recipe of ``benchmarks/bench_search.py``
(``_queries``): a row drawn from the dataset plus Gaussian noise of 0.05 times
the dataset's standard deviation.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from bench.datasets import sample_rng

KINDS = ("closed_loop_batches",)


def check_mix(mix: dict[str, Any]) -> None:
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic kind {mix.get('kind')!r} is not one of {KINDS}")
    for key in ("batch", "k", "pool", "check_calls"):
        if int(mix[key]) < 1:
            raise ValueError(f"traffic {key}={mix[key]} must be >= 1")


def queries(x: np.ndarray, n: int, g: np.random.Generator) -> np.ndarray:
    idx = g.choice(len(x), n, replace=False)
    return (x[idx] + 0.05 * x.std() * g.normal(size=(n, x.shape[1]))).astype(np.float32)


def query_pool(x: np.ndarray, mix: dict[str, Any], seed: int) -> list[np.ndarray]:
    """``mix['pool']`` distinct (batch, D) f32 query batches drawn from ``seed``."""
    g = sample_rng(seed, 2)
    return [queries(x, int(mix["batch"]), g) for _ in range(int(mix["pool"]))]
