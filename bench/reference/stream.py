"""The comparison of a stream of writes and searches (``closed_loop_ingest``):
read-your-writes, exact over every acknowledged row.

A judged call's answers are held by ``knn.judge`` to the brute force over
the build's rows and every batch acknowledged up to and including that call,
numbered in the order written (``rows_through``): ``kth_gap``, ``dist_err``
and ``bad_rows`` as there, an answered id past the rows acknowledged so far
counting in ``bad_rows``.  One number more:

* ``lost_rows``: the acknowledged rows that the index holds zero times or
  more than once across its main buckets and its delta buckets at the end of
  the run (``held``, copied from the program before it is freed), the ids it
  holds that name no acknowledged row, and the rows acknowledged under
  another id than their place in the stream.  Exact: its limit is 0.
"""
from __future__ import annotations

import numpy as np

from bench.reference import knn

NUMBERS = knn.NUMBERS + ("lost_rows",)  # what a stream's check compares, in its order


def expected_ids(first: int, batches: list[np.ndarray]) -> list[np.ndarray]:
    """The ids a sound write path acknowledges: the batches numbered on from
    ``first`` in the order they were written."""
    out, lo = [], first
    for b in batches:
        out.append(np.arange(lo, lo + len(b), dtype=np.int64))
        lo += len(b)
    return out


def misnumbered(acks: list[np.ndarray], batches: list[np.ndarray], first: int) -> int:
    """Rows acknowledged under another id than their place in the stream."""
    bad = 0
    for got, want in zip(acks, expected_ids(first, batches)):
        got = np.asarray(got).ravel()
        bad += len(want) if got.shape != want.shape else int((got != want).sum())
    return bad


def rows_through(x: np.ndarray, batches: list[np.ndarray], n: int) -> np.ndarray:
    """The build's rows and the first ``n`` batches written, by id."""
    return np.concatenate([x] + batches[:n])


def held(bucket_ids: np.ndarray, delta_ids: np.ndarray, delta_count: np.ndarray) -> np.ndarray:
    """Every id an index holds: its main buckets' (-1 pads left out) and the
    live prefix of each delta bucket."""
    main = np.asarray(bucket_ids).ravel()
    live = [np.asarray(delta_ids)[i, :int(c)] for i, c in enumerate(np.asarray(delta_count))]
    return np.concatenate([main[main >= 0]] + live).astype(np.int64)


def lost_rows(ids: np.ndarray, n: int) -> int:
    """Rows ``0 .. n - 1`` held other than once, and ids held outside them."""
    ok = (ids >= 0) & (ids < n)
    counts = np.bincount(ids[ok], minlength=n)
    return int((counts != 1).sum() + (~ok).sum())
