"""Exact k-nearest-neighbour search by brute force, the comparison of a
search's answers with it, and the control that the comparison has to fail.

* ``exact_knn``: every (query, row) squared L2 distance in float64, blockwise,
  and the k smallest of each query: the truth.  It takes only the rows and
  the queries, never anything the program derived from them.
* ``judge``: the numbers that ``correct`` compares, each beside its limit:
  ``kth_gap``, the widest margin by which an answered row's exact squared
  distance lies beyond the exact k-th nearest one; ``dist_err``, the widest
  gap between an answered distance and the exact distance of the row it
  names; ``bad_rows``, the queries answered with a missing, out-of-range or
  repeated id, a distance that is not finite or not ascending, or fewer than
  k neighbours.  The first two are over the rounding scale of an f32 squared
  distance by the expansion, ``||q||^2 + ||x||^2``.
* ``lowp_knn``: the control, this reference in the program's place at the
  precision below the configuration's float32 with TF32 off: the expansion's
  product in TF32 (the card's tensor cores; on a CPU the operands rounded to
  TF32's 10-bit mantissa, which is what the tensor cores multiply).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BLOCK_ELEMS = 1 << 28  # (query, row) pairs a block: 2 GiB of float64


NUMBERS = ("kth_gap", "dist_err", "bad_rows")  # what ``judge`` compares, in its order


class Truth(NamedTuple):
    ids: torch.Tensor  # (Q, k) int64
    kth_d2: torch.Tensor  # (Q,) float64 exact squared distance of the k-th nearest


def _blocks(nq: int, n: int):
    rows = max(1, min(nq, BLOCK_ELEMS // max(n, 1)))
    cols = max(1, min(n, BLOCK_ELEMS // rows))
    for qlo in range(0, nq, rows):
        yield slice(qlo, min(nq, qlo + rows)), cols


def exact_d2(x: torch.Tensor, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 squared distances of rows ``ids`` (Q, k) to their queries, by
    differences (no expansion)."""
    xs = x[ids.clamp(0, x.shape[0] - 1)].double()
    return ((xs - q.double()[:, None, :]) ** 2).sum(-1)


def exact_knn(x: torch.Tensor, q: torch.Tensor, k: int) -> Truth:
    """The k nearest rows of ``x`` (N, D) to each query of ``q`` (Q, D)."""
    n = x.shape[0]
    k = min(k, n)
    xd, qd = x.double(), q.double()
    xx = (xd * xd).sum(1)
    ids_all = []
    for qs, cols in _blocks(q.shape[0], n):
        qb = qd[qs]
        qq = (qb * qb).sum(1)[:, None]
        best_d = torch.empty((qb.shape[0], 0), dtype=torch.float64, device=x.device)
        best_i = torch.empty((qb.shape[0], 0), dtype=torch.int64, device=x.device)
        for lo in range(0, n, cols):
            hi = min(n, lo + cols)
            d2 = qq + xx[None, lo:hi] - 2.0 * (qb @ xd[lo:hi].T)
            vd, vi = torch.topk(d2, min(k, hi - lo), dim=1, largest=False)
            best_d = torch.cat([best_d, vd], 1)
            best_i = torch.cat([best_i, vi + lo], 1)
            best_d, pos = torch.topk(best_d, min(k, best_d.shape[1]), dim=1, largest=False)
            best_i = torch.gather(best_i, 1, pos)
        ids_all.append(best_i)
    ids = torch.cat(ids_all)
    return Truth(ids=ids, kth_d2=exact_d2(x, q, ids).max(dim=1).values)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties to even."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def lowp_knn(x: torch.Tensor, q: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The control: (dists, ids) as host arrays, like a search's, from the
    f32 expansion with its product in TF32."""
    n = x.shape[0]
    k = min(k, n)
    xf, qf = x.float(), q.float()
    xx = (xf * xf).sum(1)
    cuda = x.is_cuda
    if not cuda:
        xf_p, qf_p = _tf32(xf), _tf32(qf)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out_d, out_i = [], []
        for qs, cols in _blocks(q.shape[0], n):
            qb = qf[qs]
            qq = (qb * qb).sum(1)[:, None]
            best_d = torch.empty((qb.shape[0], 0), device=x.device)
            best_i = torch.empty((qb.shape[0], 0), dtype=torch.int64, device=x.device)
            for lo in range(0, n, cols):
                hi = min(n, lo + cols)
                prod = qb @ xf[lo:hi].T if cuda else qf_p[qs] @ xf_p[lo:hi].T
                d2 = torch.clamp_min(qq + xx[None, lo:hi] - 2.0 * prod, 0.0)
                vd, vi = torch.topk(d2, min(k, hi - lo), dim=1, largest=False)
                best_d = torch.cat([best_d, vd], 1)
                best_i = torch.cat([best_i, vi + lo], 1)
                best_d, pos = torch.topk(best_d, min(k, best_d.shape[1]), dim=1, largest=False)
                best_i = torch.gather(best_i, 1, pos)
            out_d.append(torch.sqrt(best_d))
            out_i.append(best_i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return (torch.cat(out_d).cpu().numpy(),
            torch.cat(out_i).to(torch.int32).cpu().numpy())


class Answers(NamedTuple):
    """A batch of answers read against the rows: what every search's check
    compares, whatever its truth."""

    ids: torch.Tensor  # (Q, k) int64 as answered
    valid: torch.Tensor  # (Q, k) bool: the id names a row
    bad: torch.Tensor  # (Q,) bool: the query's answers break a rule of form
    exact: torch.Tensor  # (Q, k) float64 exact squared distance of each answered row
    scale: torch.Tensor  # (Q, k) ||q||^2 + ||x||^2 of each answered row
    err: torch.Tensor  # (Q,) widest |answered d2 - exact d2| / scale


def read_answers(x: torch.Tensor, q: torch.Tensor, dists, ids, k: int) -> Answers | None:
    """The answers of one batch, checked for form and distance, or None
    where they have not the shape (Q, k)."""
    n = x.shape[0]
    nq = q.shape[0]
    dev = x.device
    ids = torch.as_tensor(np.asarray(ids), device=dev).long()
    dists = torch.as_tensor(np.asarray(dists), device=dev).double()
    if ids.shape != (nq, k) or dists.shape != (nq, k):
        return None
    valid = (ids >= 0) & (ids < n)
    srt = torch.sort(ids, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    order = (dists[:, 1:] < dists[:, :-1]).any(1) if k > 1 else torch.zeros_like(dup)
    bad = ~valid.all(1) | dup | ~torch.isfinite(dists).all(1) | order
    e = exact_d2(x, q, ids)
    xs = x[ids.clamp(0, n - 1)].double()
    scale = (xs ** 2).sum(-1) + (q.double() ** 2).sum(1)[:, None]
    err = torch.where(valid & torch.isfinite(dists), (dists ** 2 - e).abs() / scale,
                      0.0).amax(1)
    return Answers(ids=ids, valid=valid, bad=bad, exact=e, scale=scale, err=err)


def judge(x: torch.Tensor, q: torch.Tensor, dists, ids, truth: Truth,
          limits: dict[str, float]) -> dict[str, float]:
    """The compared numbers for one batch of answers (see the module doc),
    and ``wrong_queries``: the queries whose answers break a limit."""
    nq, k = truth.ids.shape
    a = read_answers(x, q, dists, ids, k)
    if a is None:
        return dict(kth_gap=float("inf"), dist_err=float("inf"), bad_rows=float(nq),
                    wrong_queries=nq)
    gap = torch.where(a.valid, (a.exact - truth.kth_d2[:, None]) / a.scale,
                      0.0).amax(1).clamp_min(0.0)
    wrong = a.bad | (gap > limits["kth_gap"]) | (a.err > limits["dist_err"])
    return dict(kth_gap=float(gap.max()), dist_err=float(a.err.max()),
                bad_rows=float(a.bad.sum()), wrong_queries=int(wrong.sum()))


COUNTS = ("bad_rows", "outside_rows")  # numbers that count, and so add up over batches


def combine(readings: list[dict[str, float]]) -> dict[str, float]:
    """The worst of each number over several batches."""
    keys = readings[0].keys()
    return {key: (sum(r[key] for r in readings) if key in COUNTS
                  else max(r[key] for r in readings)) for key in keys}
