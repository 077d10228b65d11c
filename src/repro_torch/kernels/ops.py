"""The one dispatch layer for every kernel of the port.

Dispatch rule of each wrapper below, decided by where its tensors lie:

* a CUDA tensor gets the hand-written kernel (``pairwise_l2.py``,
  ``bucket_scan.py``, ``eps_graph.py``, ``topk.py``), or the call raises: there is no
  fallback and no switch that forces the plain version on the card;
* a CPU tensor gets the plain version from ``ref.py`` (the same math; this
  is what the CPU tests run).

Each kernel wrapper counts its own launches (``launch_counts``), so a run can
show that its main path went through the kernels.

The search's delta phase scans the streaming append buffers through the same
K1 phase, named ``delta_scan_topk`` at its call site; delta members always
scan f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bucket_scan import bucket_scan_phase_cuda
from repro_torch.kernels.eps_graph import (
    eps_count_cuda,
    eps_min_label_cuda,
    eps_nearest_core_cuda,
)
from repro_torch.kernels.pairwise_l2 import pairwise_sq_l2_cuda, pairwise_sq_l2_int8_cuda
from repro_torch.kernels.topk import knn_topk_cuda

Tensor = torch.Tensor

KERNELS = {
    "pairwise_sq_l2": pairwise_sq_l2_cuda,
    "bucket_scan_topk": bucket_scan_phase_cuda,
    "eps_count": eps_count_cuda,
    "eps_min_label": eps_min_label_cuda,
    "eps_nearest_core": eps_nearest_core_cuda,
    "knn_topk": knn_topk_cuda,
    "pairwise_sq_l2_int8": pairwise_sq_l2_int8_cuda,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def pairwise_sq_l2(q: Tensor, x: Tensor) -> Tensor:
    """(Q, D) x (N, D) -> (Q, N) squared L2 distances."""
    if q.is_cuda:
        return pairwise_sq_l2_cuda(q, x)
    return ref.pairwise_sq_l2_ref(q, x)


def bucket_scan_phase(
    q: Tensor,
    bucket_x: Tensor,
    bucket_ids: Tensor,
    bucket_count: Tensor,
    order: Tensor,
    lb_sorted: Tensor,
    beam: int,
    top_d: Tensor,
    top_i: Tensor,
    scale: Tensor | None = None,
    qmask: Tensor | None = None,
    *,
    extent: Tensor | None = None,
    staged: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One whole forest-scan phase (K1): every step's gather, distances and
    top-k merge, each query until its first inactive step.  Returns
    (top_d, top_i, visits, ndist, npad, qsteps).

    See ``bucket_scan.py`` for the kernel and ``ref.bucket_scan_phase_ref``
    for the plain version.  ``scale`` enables the int8 bucket storage path;
    ``qmask`` (Q,) bool masks queries out of the phase (they keep their
    carry and do no work); ``extent`` (NB,) bounds the rows scanned in each
    bucket (``ref.bucket_extent`` of ``bucket_ids`` when not given);
    ``staged`` (Q,) int32 accumulates the rows each query staged.
    """
    args = (q, bucket_x, bucket_ids, bucket_count, order, lb_sorted, beam, top_d, top_i, scale,
            qmask)
    kw = dict(extent=extent, staged=staged)
    if q.is_cuda:
        return bucket_scan_phase_cuda(*args, **kw)
    return ref.bucket_scan_phase_ref(*args, **kw)


def eps_count(q: Tensor, x: Tensor, eps_sq) -> Tensor:
    """DBSCAN core test: per-query count of eps-neighbours (K3)."""
    if q.is_cuda:
        return eps_count_cuda(q, x, eps_sq)
    return ref.eps_count_ref(q, x, eps_sq)


def eps_min_label(q: Tensor, x: Tensor, labels: Tensor, core: Tensor, eps_sq) -> Tensor:
    """DBSCAN label sweep: min label over core eps-neighbours, N if none (K4)."""
    if q.is_cuda:
        return eps_min_label_cuda(q, x, labels, core, eps_sq)
    return ref.eps_min_label_ref(q, x, labels, core, eps_sq)


def eps_nearest_core(q: Tensor, x: Tensor, labels: Tensor, core: Tensor) -> tuple[Tensor, Tensor]:
    """DBSCAN border pass: (d2, label) of each query's nearest core point (K5)."""
    if q.is_cuda:
        return eps_nearest_core_cuda(q, x, labels, core)
    return ref.eps_nearest_core_ref(q, x, labels, core)


def knn_topk(q: Tensor, x: Tensor, *, k: int) -> tuple[Tensor, Tensor]:
    """Fused streaming distance + top-k over a flat datastore (K6): (Q, k)
    ascending squared distances and i32 row indices, (+inf, -1) past N."""
    if q.is_cuda:
        return knn_topk_cuda(q, x, k)
    return ref.knn_topk_ref(q, x, k)


def pairwise_sq_l2_int8(q: Tensor, x_q: Tensor, scale: Tensor) -> Tensor:
    """f32 queries against int8 per-row-quantized rows -> (Q, N) (K7)."""
    if q.is_cuda:
        return pairwise_sq_l2_int8_cuda(q, x_q, scale)
    return ref.pairwise_sq_l2_int8_ref(q, x_q, scale)


# The delta phase dispatches through the identical kernel, named so a call
# site reads as what it scans.
delta_scan_topk = bucket_scan_phase


def quantize_datastore(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-row int8 quantization: (int8 rows, f32 per-row scales).

    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the result
    matches the JAX package's bit for bit.
    """
    x = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=1), 1e-8) / 127.0
    xq = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    return xq, scale.to(torch.float32)
