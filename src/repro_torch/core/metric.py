"""Metric-space primitives (paper §2): batched pairwise distances.

``pairwise`` sends the L2 family through the dispatch layer
(``kernels/ops.pairwise_sq_l2``: the K2 kernel on the card, the plain version
on the CPU) when ``use_kernel``; otherwise it runs the plain expansion
directly.  L1 and cosine stay plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Tensor = torch.Tensor


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
