"""The plain reference of the routed search (the paper's Alg. 2, a search
with ``mode="forest"``), the comparison of a routed search's answers with it,
and the control that the comparison has to fail.

A routed search answers each query over its routed set: the rows of the
index whose center is nearest to the query and of that index's overlap
neighbours.  Its answers are exact over that set, not over every row.  Where
the set holds fewer than k rows, the search fills the rest with rows of
other indexes; those rows are judged only for form and distance.

* ``Routing``: the routing table (index centers, which indexes each index
  routes to, each row's index), as ``forest.derive`` works it out again from
  the rows and the configuration's build parameters.
* ``owner_of_forest`` and ``index_rows``: the index that the program's
  forest puts each row in, copied from its host arrays, and the number of
  rows on which it and the derived table disagree: the build's own check.
* ``nearest``: each query's nearest centers by float64 squared distance,
  every center within the K2 tolerance of the smallest,
  ``1e-5 + 1e-5 (||q||^2 + ||c||^2)``: a query with two such centers passes
  if it passes for either one.
* ``routed_knn``: for (query, center) pairs, the k nearest rows of the
  routed set in float64, blockwise, and the set's size.
* ``judge``: the numbers that ``correct`` compares for a batch:
  ``routed_gap``, the widest (exact d2 of the farthest answered row - exact
  d2 of a routed top-k row that was not answered) / (||q||^2 + ||x||^2),
  floored at 0; ``outside_rows``, answered rows outside the routed set of a
  query whose set holds k rows or more; ``dist_err`` and ``bad_rows`` as
  ``knn.judge`` has them.
* ``lowp_routed_knn``: the control, this reference in the program's place
  at the precision below the configuration's float32 with TF32 off: the
  routing's and the scan's products in TF32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bench.reference.knn import _blocks, _tf32, exact_d2, read_answers

BATCH_NUMBERS = ("routed_gap", "dist_err", "bad_rows", "outside_rows")  # what ``judge`` gives
NUMBERS = BATCH_NUMBERS + ("index_rows",)  # what a forest-mode run compares


class Routing(NamedTuple):
    centers: torch.Tensor  # (I, D) index centers
    routed: torch.Tensor  # (I, I) bool: index j is searched when index i is nearest
    owner: torch.Tensor  # (N,) int64 the index that holds each row

    @classmethod
    def of(cls, centers, neighbors, owner) -> Routing:
        """The table of index ``centers`` (I, D), each index's ``neighbors``
        (lists, or an (I, M) array padded with -1) and each row's ``owner``."""
        n_idx = len(centers)
        routed = np.eye(n_idx, dtype=bool)
        for i, row in enumerate(neighbors):
            row = [int(j) for j in row if j >= 0]
            if any(j >= n_idx for j in row):
                raise ValueError("a neighbour link names no index")
            routed[i, row] = True
        return cls(torch.as_tensor(np.asarray(centers, np.float64)), torch.from_numpy(routed),
                   torch.as_tensor(np.asarray(owner, np.int64)))

    def to(self, dev) -> Routing:
        return Routing(*(t.to(dev) for t in self))


def owner_of_forest(bucket_ids, bucket_index, n: int) -> np.ndarray:
    """(N,) the index whose buckets hold each row, from a flattened forest's
    host arrays (``bucket_ids`` (B, C) with -1 pads, ``bucket_index`` (B,));
    -1 for a row that no bucket holds, or that more than one holds."""
    ids = np.asarray(bucket_ids, np.int64)
    live = (ids >= 0) & (ids < n)
    owner = np.full(n, -1, np.int64)
    owner[ids[live]] = np.broadcast_to(np.asarray(bucket_index, np.int64)[:, None],
                                       ids.shape)[live]
    owner[np.bincount(ids[live], minlength=n) != 1] = -1
    return owner


def index_rows(program: np.ndarray, derived: np.ndarray) -> int:
    """Rows on which two partitions of the rows into indexes disagree,
    whatever their numbering: the rows outside the largest overlap of each
    index with one index of the other side, taken from whichever side has
    more (so a split and a merge both show).  A row that ``program`` gives
    no index (-1) always counts."""
    program = np.asarray(program, np.int64)
    derived = np.asarray(derived, np.int64)
    held = program >= 0
    pairs, count = np.unique(np.stack([program[held], derived[held]]), axis=1,
                             return_counts=True)
    worst = 0
    for side in (0, 1):
        best: dict[int, int] = {}
        for key, c in zip(pairs[side].tolist(), count.tolist()):
            best[key] = max(best.get(key, 0), c)
        worst = max(worst, int(held.sum()) - sum(best.values()))
    return worst + int((~held).sum())


class RoutedTruth(NamedTuple):
    ids: torch.Tensor  # (P, k) int64 the routed k nearest, -1 past the set's size
    d2: torch.Tensor  # (P, k) float64 their exact squared distances, +inf past the size
    size: torch.Tensor  # (P,) int64 rows in the routed set


def nearest(routing: Routing, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(query, center) pairs, ``pair_q`` ascending: every center whose
    float64 squared distance lies within the K2 tolerance of the query's
    smallest."""
    qd, cd = q.double(), routing.centers.double()
    d2 = ((qd[:, None, :] - cd[None, :, :]) ** 2).sum(-1)
    tol = 1e-5 + 1e-5 * ((qd * qd).sum(1)[:, None] + (cd * cd).sum(1)[None, :])
    near = d2 <= d2.min(1, keepdim=True).values + tol
    pair_q, pair_c = near.nonzero(as_tuple=True)
    return pair_q, pair_c


def routed_knn(x: torch.Tensor, q: torch.Tensor, k: int, routing: Routing,
               center: torch.Tensor) -> RoutedTruth:
    """The k nearest rows of ``x`` (N, D) to each query of ``q`` (P, D) among
    the rows routed from ``center`` (P,), by the float64 expansion, blockwise."""
    n = x.shape[0]
    k = min(k, n)
    xd, qd = x.double(), q.double()
    xx = (xd * xd).sum(1)
    sel = routing.routed[center]  # (P, I)
    ids_all = []
    for qs, cols in _blocks(q.shape[0], n):
        qb = qd[qs]
        qq = (qb * qb).sum(1)[:, None]
        best_d = torch.empty((qb.shape[0], 0), dtype=torch.float64, device=x.device)
        best_i = torch.empty((qb.shape[0], 0), dtype=torch.int64, device=x.device)
        for lo in range(0, n, cols):
            hi = min(n, lo + cols)
            d2 = qq + xx[None, lo:hi] - 2.0 * (qb @ xd[lo:hi].T)
            d2 = torch.where(sel[qs][:, routing.owner[lo:hi]], d2, float("inf"))
            vd, vi = torch.topk(d2, min(k, hi - lo), dim=1, largest=False)
            best_d = torch.cat([best_d, vd], 1)
            best_i = torch.cat([best_i, vi + lo], 1)
            best_d, pos = torch.topk(best_d, min(k, best_d.shape[1]), dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pos)
        ids_all.append(torch.where(torch.isfinite(best_d), best_i, -1))
    ids = torch.cat(ids_all)
    rows = torch.bincount(routing.owner, minlength=sel.shape[1])
    size = (sel.long() * rows[None, :]).sum(1)
    d2 = torch.where(ids >= 0, exact_d2(x, q, ids), float("inf"))
    return RoutedTruth(ids=ids, d2=d2, size=size)


def judge(x: torch.Tensor, q: torch.Tensor, dists, ids, k: int, routing: Routing,
          limits: dict[str, float]) -> dict[str, float]:
    """The compared numbers for one batch of a routed search's answers (see
    the module doc), and ``wrong_queries``: the queries whose answers break
    a limit for every nearest center they have."""
    n = x.shape[0]
    nq = q.shape[0]
    k = min(k, n)
    a = read_answers(x, q, dists, ids, k)
    if a is None:
        return dict(routed_gap=float("inf"), dist_err=float("inf"), bad_rows=float(nq),
                    outside_rows=float(nq * k), wrong_queries=nq)
    routing = routing.to(x.device)
    pair_q, pair_c = nearest(routing, q)
    truth = routed_knn(x, q[pair_q], k, routing, pair_c)
    ans, valid = a.ids[pair_q], a.valid[pair_q]
    # K: the exact d2 of each query's farthest answered row
    kth = torch.where(a.valid, a.exact, -float("inf")).amax(1)[pair_q]
    answered = (truth.ids[:, :, None] == ans[:, None, :]).any(-1)
    t_scale = ((x[truth.ids.clamp(0, n - 1)].double() ** 2).sum(-1)
               + (q[pair_q].double() ** 2).sum(1)[:, None])
    gap = torch.where((truth.ids >= 0) & ~answered, (kth[:, None] - truth.d2) / t_scale,
                      0.0).amax(1).clamp_min(0.0)
    inside = torch.gather(routing.routed[pair_c], 1, routing.owner[ans.clamp(0, n - 1)])
    outside = torch.where(truth.size >= k, (valid & ~inside).sum(1), 0)
    fails = (gap > limits["routed_gap"]) | (outside > limits["outside_rows"])
    # each query keeps the pair that passes, or else the least failing one
    pq = pair_q.cpu().numpy()
    pick = np.lexsort((outside.cpu().numpy(), gap.cpu().numpy(), fails.cpu().numpy(), pq))
    first = np.ones(len(pick), bool)
    first[1:] = pq[pick][1:] != pq[pick][:-1]
    keep = torch.as_tensor(pick[first], device=x.device)
    gap, outside, fails = gap[keep], outside[keep], fails[keep]
    wrong = a.bad | (a.err > limits["dist_err"]) | fails
    return dict(routed_gap=float(gap.max()), dist_err=float(a.err.max()),
                bad_rows=float(a.bad.sum()), outside_rows=float(outside.sum()),
                wrong_queries=int(wrong.sum()))


def lowp_routed_knn(x: torch.Tensor, q: torch.Tensor, k: int,
                    routing: Routing) -> tuple[np.ndarray, np.ndarray]:
    """The control: (dists, ids) as host arrays, like a search's, from the
    f32 expansion with its products in TF32 (on a CPU the operands rounded
    to TF32): the nearest center by those products, then the k nearest of
    the routed set, filled past the set's size with other rows, as the
    search fills them, and ordered by distance."""
    n = x.shape[0]
    k = min(k, n)
    routing = routing.to(x.device)
    xf, qf, cf = x.float(), q.float(), routing.centers.float()
    xx, cc = (xf * xf).sum(1), (cf * cf).sum(1)
    cuda = x.is_cuda
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True

    def prod(a, b):
        return a @ b.T if cuda else _tf32(a) @ _tf32(b).T

    try:
        out_d, out_i = [], []
        for qs, cols in _blocks(q.shape[0], n):
            qb = qf[qs]
            qq = (qb * qb).sum(1)[:, None]
            sel = routing.routed[torch.argmin(qq + cc[None, :] - 2.0 * prod(qb, cf), 1)]
            best_key = torch.empty((qb.shape[0], 0), device=x.device)
            best_d = torch.empty((qb.shape[0], 0), device=x.device)
            best_i = torch.empty((qb.shape[0], 0), dtype=torch.int64, device=x.device)
            for lo in range(0, n, cols):
                hi = min(n, lo + cols)
                d2 = torch.clamp_min(qq + xx[None, lo:hi] - 2.0 * prod(qb, xf[lo:hi]), 0.0)
                # rows outside the routed set come after every row inside it
                key = torch.where(sel[:, routing.owner[lo:hi]], d2, d2 + 1e30)
                _, pos = torch.topk(key, min(k, hi - lo), dim=1, largest=False)
                best_key = torch.cat([best_key, torch.gather(key, 1, pos)], 1)
                best_d = torch.cat([best_d, torch.gather(d2, 1, pos)], 1)
                best_i = torch.cat([best_i, pos + lo], 1)
                best_key, pos = torch.topk(best_key, min(k, best_key.shape[1]), dim=1,
                                           largest=False)
                best_d, best_i = torch.gather(best_d, 1, pos), torch.gather(best_i, 1, pos)
            best_d, pos = torch.sort(best_d, dim=1)
            out_d.append(torch.sqrt(best_d))
            out_i.append(torch.gather(best_i, 1, pos))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (torch.cat(out_d).cpu().numpy(),
            torch.cat(out_i).to(torch.int32).cpu().numpy())
