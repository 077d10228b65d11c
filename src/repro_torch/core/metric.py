"""Metric-space primitives (paper §2, Definitions 1-5).

Single-pair distances (``sq_l2``, ``l2``, ``l1``, ``cosine``, by name in
``METRICS``) and batched pairwise distances.  ``pairwise`` sends the L2
family through the dispatch layer (``kernels/ops.pairwise_sq_l2``: the K2
kernel on the card, the plain version on the CPU) when ``use_kernel``;
otherwise it runs the plain expansion directly.  L1 and cosine stay plain
torch.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Distance functions d : S x S -> R+  (p1-p4 of Definition 1)
# ---------------------------------------------------------------------------


def sq_l2(x: Tensor, y: Tensor) -> Tensor:
    """Squared euclidean distance between single objects (D,) x (D,)."""
    d = x - y
    return torch.sum(d * d)


def l2(x: Tensor, y: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(sq_l2(x, y), 0.0))


def l1(x: Tensor, y: Tensor) -> Tensor:
    return torch.sum(torch.abs(x - y))


def cosine(x: Tensor, y: Tensor) -> Tensor:
    """Cosine *distance* (1 - cosine similarity).  Not a metric (it fails
    p4 in general) but common for embedding datastores; for the retrieval
    layer, never for the tree-bound math (which assumes p4)."""
    nx = torch.linalg.norm(x) + 1e-12
    ny = torch.linalg.norm(y) + 1e-12
    return 1.0 - torch.dot(x, y) / (nx * ny)


METRICS: dict[str, Callable[[Tensor, Tensor], Tensor]] = {
    "l2": l2,
    "sq_l2": sq_l2,
    "l1": l1,
    "cosine": cosine,
}


# ---------------------------------------------------------------------------
# Batched pairwise distances
# ---------------------------------------------------------------------------


def pairwise(q: Tensor, x: Tensor, *, metric: str = "l2", use_kernel: bool = True) -> Tensor:
    """Pairwise distance matrix (Q, N) between rows of q (Q, D) and x (N, D)."""
    if metric in ("l2", "sq_l2"):
        sq = kops.pairwise_sq_l2(q, x) if use_kernel else kref.pairwise_sq_l2_ref(q, x)
        return sq if metric == "sq_l2" else torch.sqrt(torch.clamp_min(sq, 0.0))
    if metric == "l1":
        return torch.sum(torch.abs(q[:, None, :] - x[None, :, :]), dim=-1)
    if metric == "cosine":
        if q.is_cuda:
            kref.no_tf32()
        qn = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
        xn = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-12)
        return 1.0 - qn @ xn.T
    raise ValueError(f"unknown metric {metric!r}")


def distances_to_point(x: Tensor, p: Tensor, *, metric: str = "l2") -> Tensor:
    """Distances (N,) from every row of x (N, D) to a single point p (D,)."""
    return pairwise(p[None, :], x, metric=metric, use_kernel=False)[0]


def check_metric_axioms(d: Callable, pts: Tensor, atol: float = 1e-5) -> dict[str, bool]:
    """Empirically check p1-p4 on a point sample. Used by property tests."""
    dm = torch.vmap(lambda a: torch.vmap(lambda b: d(a, b))(pts))(pts)
    non_neg = bool(torch.all(dm >= -atol))
    sym = bool(torch.allclose(dm, dm.T, atol=atol, rtol=1e-5))
    ident = bool(torch.all(torch.abs(torch.diagonal(dm)) <= atol))
    # for all (i, j, k): d(i,j) + d(j,k) >= d(i,k)
    tri = bool(torch.all(dm[:, :, None] + dm[None, :, :] >= dm[:, None, :] - atol))
    return {"non_negativity": non_neg, "symmetry": sym, "identity": ident, "triangle": tri}
