"""DBSCAN preprocessing (paper §4.1, Algorithm 1), the parallel formulation
of the JAX package's ``repro.core.dbscan`` on a torch device.

1. *Core mask*: |N_eps(o)| >= MinPts, one K3 pass (``eps_count``).
2. *Core connectivity*: connected components of the eps-graph restricted to
   core points, by min-label propagation (one K4 pass, ``eps_min_label``,
   per sweep) plus three rounds of pointer jumping, until a sweep changes
   nothing or ``max_iter`` sweeps have run.
3. *Border points*: the label of the nearest core point within eps (one K5
   pass, ``eps_nearest_core``); points with no core point within eps are
   noise.

On the card each pass is one launch over all N rows; on the CPU the dispatch
layer runs the plain versions, over blocks of ``block`` query rows so no
(N, N) matrix is formed.  ``kernel=False`` runs the in-place plain
formulation instead (distances, threshold and reduction as separate torch
ops, in blocks): the oracle the kernel path is held against, on either
device.  The ``lax.while_loop`` of the JAX package is a Python loop with one
host sync per sweep (``torch.equal``).  ``partitions_from_labels``
(Algorithm 1, lines 9-11) is host numpy, the JAX package's code.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor


@dataclass(frozen=True)
class DBSCANResult:
    labels: np.ndarray  # (N,) int32 contiguous cluster ids; -1 for noise
    n_clusters: int
    core_mask: np.ndarray  # (N,) bool
    n_iterations: int
    distance_computations: int  # total pairwise distances evaluated


def _by_blocks(fn, x: Tensor, block: int, whole: bool):
    """``fn`` over the query rows of ``x``: in one call when ``whole`` (one
    kernel launch), else over blocks of ``block`` rows, concatenated."""
    if whole:
        return fn(x)
    parts = [fn(x[lo:lo + block]) for lo in range(0, x.shape[0], block)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _dbscan_device(
    x: Tensor, eps: float, *, min_pts: int, block: int, max_iter: int, kernel: bool
) -> tuple[Tensor, Tensor, int]:
    n = x.shape[0]
    eps_sq = float(np.float32(eps) ** 2)  # squared in f32, as the JAX package does
    sentinel = torch.tensor(n, dtype=torch.int32, device=x.device)
    whole = kernel and x.is_cuda

    def rows(fn):
        return _by_blocks(fn, x, block, whole)

    # -- 1. core mask ------------------------------------------------------
    if kernel:
        counts = rows(lambda qb: ops.eps_count(qb, x, eps_sq))
    else:
        counts = rows(lambda qb: torch.sum(kref.pairwise_sq_l2_ref(qb, x) <= eps_sq, dim=1))
    core = counts >= min_pts  # (N,)

    # -- 2. min-label propagation over core-core eps edges ------------------
    labels0 = torch.where(core, torch.arange(n, dtype=torch.int32, device=x.device), sentinel)

    def plain_min_label(qb, labels):
        adj = (kref.pairwise_sq_l2_ref(qb, x) <= eps_sq) & core[None, :]
        return torch.min(torch.where(adj, labels[None, :], sentinel), dim=1).values

    def sweep(labels):
        if kernel:
            new = rows(lambda qb: ops.eps_min_label(qb, x, labels, core, eps_sq))
        else:
            new = rows(lambda qb: plain_min_label(qb, labels))
        new = torch.minimum(new, labels)
        new = torch.where(core, new, labels)
        # pointer jumping (path halving), x3
        for _ in range(3):
            ext = torch.cat([new, sentinel[None]])
            jumped = ext[torch.clamp(new, 0, n).long()]
            new = torch.where(core & (jumped < new), jumped, new)
        return new

    prev, labels, iters = labels0, sweep(labels0), 1
    while iters < max_iter and not torch.equal(labels, prev):
        prev, labels, iters = labels, sweep(labels), iters + 1

    # -- 3. border points: nearest core neighbour within eps ----------------
    if kernel:
        dmin, lab = rows(lambda qb: ops.eps_nearest_core(qb, x, labels, core))
    else:
        def plain_nearest(qb):
            d = torch.where(core[None, :], kref.pairwise_sq_l2_ref(qb, x), float("inf"))
            j = torch.argmin(d, dim=1)
            return torch.gather(d, 1, j[:, None])[:, 0], labels[j]

        dmin, lab = rows(plain_nearest)
    border = torch.where(dmin <= eps_sq, lab, sentinel)
    final = torch.where(core, labels, border)
    return final, core, iters


def dbscan(
    x,
    eps: float,
    min_pts: int,
    *,
    block: int = 1024,
    max_iter: int = 64,
    kernel: bool = True,
    device=None,
) -> DBSCANResult:
    """Run DBSCAN on ``device``; returns contiguous labels (-1 = noise) on
    the host.  Without ``device``, a tensor stays where it lies and a numpy
    array goes to ``cuda`` (no CUDA: an error, never a quiet fall back to
    the CPU; pass ``device="cpu"`` for the plain versions on the host).

    ``kernel=True`` (default) runs each pass through the dispatch layer
    (K3-K5 on the card); ``kernel=False`` keeps the in-place plain
    formulation, the oracle the kernel path is held against.
    ``distance_computations`` is the JAX package's paper cost counter:
    ``(iterations + 2) * n_pad * n`` with ``n_pad`` = n rounded up to
    ``block``.
    """
    if isinstance(x, Tensor):
        device = x.device if device is None else device
    else:
        device = resolve_device(device)
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    x = x.to(device=device, dtype=torch.float32).contiguous()
    n = int(x.shape[0])
    block = int(min(block, max(128, n)))
    labels, core, iters = _dbscan_device(
        x, float(eps), min_pts=int(min_pts), block=block, max_iter=int(max_iter),
        kernel=bool(kernel),
    )
    labels = labels.cpu().numpy()
    core = core.cpu().numpy()
    # renumber to contiguous ids; sentinel (== n) -> -1
    out = np.full(n, -1, np.int32)
    valid = labels < n
    uniq, inv = np.unique(labels[valid], return_inverse=True)
    out[valid] = inv.astype(np.int32)
    n_pad = n + ((-n) % block)
    # sweeps: core-count pass + (iters propagation) + border pass, each n_pad*n
    dist_count = (iters + 2) * n_pad * n
    return DBSCANResult(
        labels=out,
        n_clusters=int(uniq.size),
        core_mask=core,
        n_iterations=iters,
        distance_computations=int(dist_count),
    )


def partitions_from_labels(
    x, labels: np.ndarray, n_clusters: int, *, assign_noise: bool = True
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Algorithm 1, lines 9-11: pivots (cluster means), radii (max distance
    to pivot), and the final object->partition assignment.

    Noise points (label -1) are assigned to their nearest pivot (radii are
    re-expanded accordingly) when ``assign_noise``.
    """
    x = np.asarray(x, np.float32)
    labels = np.asarray(labels).copy()
    if n_clusters == 0:
        # Degenerate: everything is noise -> single partition.
        pivot = x.mean(axis=0, keepdims=True)
        radii = np.array([np.sqrt(((x - pivot) ** 2).sum(-1)).max()], np.float32)
        return pivot.astype(np.float32), radii, np.zeros(len(x), np.int32)
    pivots = np.zeros((n_clusters, x.shape[1]), np.float64)
    counts = np.zeros(n_clusters, np.int64)
    np.add.at(pivots, labels[labels >= 0], x[labels >= 0])
    np.add.at(counts, labels[labels >= 0], 1)
    pivots = (pivots / np.maximum(counts[:, None], 1)).astype(np.float32)
    if assign_noise and (labels < 0).any():
        noise = np.where(labels < 0)[0]
        d = ((x[noise, None, :] - pivots[None, :, :]) ** 2).sum(-1)
        labels[noise] = d.argmin(axis=1).astype(np.int32)
    radii = np.zeros(n_clusters, np.float32)
    d_all = np.sqrt(((x - pivots[labels]) ** 2).sum(-1))
    np.maximum.at(radii, labels, d_all.astype(np.float32))
    return pivots, radii, labels.astype(np.int32)
