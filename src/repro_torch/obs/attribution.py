"""Overlap attribution: classify every bucket visit of a search as
*contributing* or *wasted*, and charge the waste to partition pairs (the
port's own copy of the JAX package's ``repro/obs/attribution.py``).

The paper's argument is causal — partition overlap drives node accesses,
node accesses drive search time — but fleet counters can't say WHICH
overlapping pair cost WHICH queries what.  This post-pass closes that gap
from evidence the executor already computed (``core.knn.VisitRows``: the
sorted visit orders + per-phase visit counts; see its docstring for the
prefix-decode invariant):

  contributing visit — at least one member of the visited bucket survived
      into the query's final top-k.  The visit was necessary under the
      scan's ordering: it supplied an answer.
  wasted visit — the bucket was scanned (its lower bound beat the running
      kth-best at visit time) but no member survived.  These are exactly
      the accesses overlap optimization exists to remove.

Every visit is one or the other, so per query

    contributing + wasted == SearchStats.buckets_visited      (gated in-suite)

Wasted visits are then attributed to the (visited_index, home_index) pair
— home is the index the query routes to — and weighted against the
registered VBM/DBM/OBM overlap-rate matrix: a pair with high waste AND a
high overlap score is the decision stage's merge/extract candidate; high
waste with a LOW score means the heuristic under-prices that pair (the
learned-overlap ROADMAP item's training signal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

__all__ = ["ExplainReport", "attribute_visits"]


@dataclass
class ExplainReport:
    """One ``OverlapIndex.explain`` call's attribution (host numpy).

    ``visited_pair[j, i]`` / ``wasted_pair[j, i]`` count visits of buckets
    owned by index ``j`` on behalf of queries homed at index ``i`` (the
    diagonal is intra-index work; off-diagonal is overlap-induced).
    """

    contributing: np.ndarray  # (Q,) i64 contributing visits per query
    wasted: np.ndarray  # (Q,) i64 wasted visits per query
    home: np.ndarray  # (Q,) i64 routed home index per query
    visited_pair: np.ndarray  # (I, I) i64 visits by (visited, home)
    wasted_pair: np.ndarray  # (I, I) i64 wasted visits by (visited, home)
    rates: np.ndarray | None  # (I, I) overlap-rate matrix, or None
    method: str = ""  # overlap method the rates came from
    result: Any = None  # the run's SearchResult (facade attaches it)

    @property
    def queries(self) -> int:
        return len(self.contributing)

    @property
    def total_visits(self) -> int:
        return int(self.contributing.sum() + self.wasted.sum())

    @property
    def wasted_fraction(self) -> float:
        tot = self.total_visits
        return float(self.wasted.sum()) / tot if tot else 0.0

    def top_pairs(self, n: int = 10) -> list[dict[str, Any]]:
        """The worst (visited, home) pairs by wasted visits, each with its
        overlap-rate score — the decision stage's work list."""
        j, i = np.unravel_index(
            np.argsort(self.wasted_pair, axis=None)[::-1], self.wasted_pair.shape
        )
        out = []
        for jj, ii in zip(j[:n], i[:n]):
            w = int(self.wasted_pair[jj, ii])
            if w == 0:
                break
            out.append({
                "visited": int(jj),
                "home": int(ii),
                "wasted": w,
                "visits": int(self.visited_pair[jj, ii]),
                "rate": (
                    None if self.rates is None else float(self.rates[jj, ii])
                ),
            })
        return out

    def to_dict(self) -> dict[str, Any]:
        """JSON-serializable rollup (the ``metrics()['overlap_health']``
        shape, minus the lifetime accumulation)."""
        return {
            "queries": self.queries,
            "contributing": int(self.contributing.sum()),
            "wasted": int(self.wasted.sum()),
            "wasted_fraction": self.wasted_fraction,
            "method": self.method,
            "top_pairs": self.top_pairs(),
        }


def _id_locations(
    n_ids: int,
    bucket_ids: np.ndarray,
    bucket_mask: np.ndarray,
    delta_ids: np.ndarray | None,
    delta_count: np.ndarray | None,
) -> tuple[np.ndarray, np.ndarray]:
    """Object id -> (main bucket row | -1, delta index row | -1).

    Bucket/delta membership is a strict partition of the live objects, so
    each id appears in exactly one of the two maps."""
    id_main = np.full(n_ids, -1, np.int64)
    m = np.asarray(bucket_mask, bool)
    ids = np.asarray(bucket_ids)
    rows = np.repeat(np.arange(ids.shape[0], dtype=np.int64), m.sum(axis=1))
    id_main[ids[m].astype(np.int64)] = rows
    id_delta = np.full(n_ids, -1, np.int64)
    if delta_ids is not None:
        d_ids = np.asarray(delta_ids)
        d_cnt = np.asarray(delta_count)
        for i in range(d_ids.shape[0]):
            c = int(d_cnt[i])
            if c:
                id_delta[d_ids[i, :c].astype(np.int64)] = i
    return id_main, id_delta


def attribute_visits(
    *,
    order: np.ndarray,
    visits: np.ndarray,
    dorder: np.ndarray | None,
    dvisits: np.ndarray | None,
    result_ids: np.ndarray,
    home: np.ndarray,
    n_indexes: int,
    bucket_index: np.ndarray,
    bucket_ids: np.ndarray,
    bucket_mask: np.ndarray,
    main_rows_per_shard: int,
    delta_rows_per_shard: int = 0,
    delta_ids: np.ndarray | None = None,
    delta_count: np.ndarray | None = None,
    rates: np.ndarray | None = None,
    method: str = "",
) -> ExplainReport:
    """Decode ``VisitRows`` (host numpy) and attribute every visit.

    ``order``/``dorder`` are the col-stacked per-shard-local sorted visit
    orders, ``visits``/``dvisits`` the (S, Q) per-phase visit counts (see
    ``core.knn.VisitRows``).  ``main_rows_per_shard`` is the PADDED bucket
    row count per shard (global row = local + shard * that);
    ``delta_rows_per_shard`` likewise for the delta phase.  ``home`` is
    each query's routed index; ``result_ids`` the final top-k (−1 pad).

    A query whose eligible buckets hold fewer than k members keeps scanning
    past the +inf lower bounds (inf <= inf), so decoded visits CAN land on
    ineligible rows and — under the sharded layout — on shard-alignment
    padding rows (owner = sentinel index I).  Padding rows hold no members,
    so such visits are always wasted; they stay in the per-query wasted
    counts (conservation against ``buckets_visited`` holds) but out of the
    (visited, home) pair matrices, since no real index owns them.
    """
    order = np.asarray(order)
    visits = np.asarray(visits)
    S, Q = visits.shape
    W = order.shape[1] // S
    Wd = 0
    if dorder is not None:
        dorder = np.asarray(dorder)
        dvisits = np.asarray(dvisits)
        Wd = dorder.shape[1] // S
    result_ids = np.asarray(result_ids)
    home = np.asarray(home, np.int64)
    bucket_index = np.asarray(bucket_index, np.int64)

    n_ids = max(
        int(np.asarray(bucket_ids).max(initial=-1)) + 1,
        int(result_ids.max(initial=-1)) + 1,
        (0 if delta_ids is None
         else int(np.asarray(delta_ids).max(initial=-1)) + 1),
        1,
    )
    id_main, id_delta = _id_locations(
        n_ids, bucket_ids, bucket_mask, delta_ids, delta_count
    )

    contributing = np.zeros(Q, np.int64)
    wasted = np.zeros(Q, np.int64)
    visited_pair = np.zeros((n_indexes, n_indexes), np.int64)
    wasted_pair = np.zeros((n_indexes, n_indexes), np.int64)

    for q in range(Q):
        surv = result_ids[q]
        surv = surv[surv >= 0].astype(np.int64)
        surv_main = set(id_main[surv][id_main[surv] >= 0].tolist())
        surv_delta = set(id_delta[surv][id_delta[surv] >= 0].tolist())
        h = int(home[q])
        for s in range(S):
            v = int(visits[s, q])
            if v:
                rows = (
                    order[q, s * W: s * W + v].astype(np.int64)
                    + s * main_rows_per_shard
                )
                real = rows < len(bucket_index)  # pad rows: sentinel owner
                owners = np.where(real, bucket_index[np.minimum(
                    rows, len(bucket_index) - 1)], n_indexes)
                hit = np.fromiter(
                    (r in surv_main for r in rows.tolist()), bool, len(rows)
                )
                contributing[q] += int(hit.sum())
                wasted[q] += int((~hit).sum())
                attr = owners < n_indexes  # no real index owns a pad row
                np.add.at(visited_pair, (owners[attr], h), 1)
                np.add.at(wasted_pair, (owners[~hit & attr], h), 1)
            if dorder is None:
                continue
            dv = int(dvisits[s, q])
            if dv:
                drows = (
                    dorder[q, s * Wd: s * Wd + dv].astype(np.int64)
                    + s * delta_rows_per_shard
                )
                # a delta row IS its owning index (one tail bucket per index;
                # rows >= n_indexes are shard-alignment padding)
                hit = np.fromiter(
                    (r in surv_delta for r in drows.tolist()), bool, len(drows)
                )
                contributing[q] += int(hit.sum())
                wasted[q] += int((~hit).sum())
                attr = drows < n_indexes
                np.add.at(visited_pair, (drows[attr], h), 1)
                np.add.at(wasted_pair, (drows[~hit & attr], h), 1)

    return ExplainReport(
        contributing=contributing,
        wasted=wasted,
        home=home,
        visited_pair=visited_pair,
        wasted_pair=wasted_pair,
        rates=None if rates is None else np.asarray(rates),
        method=method,
    )
