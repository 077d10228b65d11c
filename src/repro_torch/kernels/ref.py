"""Plain PyTorch versions of the port's kernels.

Each hand-written CUDA kernel (``pairwise_l2.py``, ``bucket_scan.py``,
``eps_graph.py``, ``topk.py``) is held against the function here on the same inputs; on a
CPU tensor the dispatch layer (``ops.py``) runs these directly.  The
arithmetic follows the JAX package's ``repro.kernels.ref`` line for line:
f32 throughout, the expansion ``max(||q||^2 + ||x||^2 - 2 q.x, 0)``, and a
top-k whose ties go to the lower position (``lax.top_k``'s order), taken here
with a stable ascending sort.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def no_tf32() -> None:
    """Keep f32 products in full f32 on the card: TF32 distances (about three
    decimal digits) break the bound pruning's exactness."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pairwise_sq_l2_ref(q: Tensor, x: Tensor) -> Tensor:
    """(Q, D) x (N, D) -> (Q, N) squared L2, via the expansion."""
    if q.is_cuda:
        no_tf32()
    q = q.float()
    x = x.float()
    qq = torch.sum(q * q, dim=-1)[:, None]
    xx = torch.sum(x * x, dim=-1)[None, :]
    return torch.clamp_min(qq + xx - 2.0 * (q @ x.T), 0.0)


def topk_smallest(d: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """k smallest values per row, ascending, ties to the lower position.

    A row shorter than k is padded with (+inf, -1), as the fused top-k
    kernel returns for a datastore of fewer than k rows."""
    vals, pos = torch.sort(d, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    short = k - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=float("inf"))
        pos = torch.nn.functional.pad(pos, (0, short), value=-1)
    return vals, pos


def knn_topk_ref(q: Tensor, x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Exact k smallest squared-L2 distances per query (plain K6):
    (Q, k) f32 ascending and (Q, k) i32 row indices, ties to the lower row,
    (+inf, -1) past the end of a datastore of fewer than k rows."""
    vals, idx = topk_smallest(pairwise_sq_l2_ref(q, x), k)
    return vals, idx.to(torch.int32)


def pairwise_sq_l2_int8_ref(q: Tensor, x_q: Tensor, scale: Tensor) -> Tensor:
    """(Q, N) squared L2 of f32 queries against int8 rows with per-row
    scales (plain K7): row j dequantizes to ``x_q[j] * scale[j]``, then the
    expansion of ``pairwise_sq_l2_ref``."""
    x = x_q.float() * scale[:, None].float()
    return pairwise_sq_l2_ref(q, x)


def bucket_scan_topk_ref(
    q: Tensor,
    bucket_x: Tensor,
    bucket_ids: Tensor,
    bsel: Tensor,
    act: Tensor,
    top_d: Tensor,
    top_i: Tensor,
    scale: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """One forest-scan step: gather selected buckets, distance, top-k merge.

    q (Q, D); bucket_x (NB, C, D) f32 or int8 (then ``scale`` (NB, C) holds
    per-member dequant scales); bsel/act (Q, beam); top_d/top_i (Q, kk) the
    running per-query top-k (squared distances ascending, object ids).
    Members with id < 0 (padding) and buckets with act == 0 contribute
    nothing.  Returns the merged (top_d, top_i).
    """
    if q.is_cuda:
        no_tf32()
    qn, kk = top_d.shape
    q = q.float()
    bsel = bsel.long()
    bx = bucket_x[bsel].float()  # (Q, beam, C, D)
    if scale is not None:
        bx = bx * scale[bsel][..., None].float()
    bids = bucket_ids[bsel]  # (Q, beam, C)
    live = (bids >= 0) & (act != 0)[:, :, None]
    d2 = (
        torch.sum(q * q, dim=-1)[:, None, None]
        + torch.sum(bx * bx, dim=-1)
        - 2.0 * torch.einsum("qbcd,qd->qbc", bx, q)
    )
    inf = torch.tensor(float("inf"), device=d2.device)
    d2 = torch.where(live, torch.clamp_min(d2, 0.0), inf)
    cand_d = d2.reshape(qn, -1)
    cand_i = torch.where(live, bids, -1).reshape(qn, -1).to(torch.int32)
    merged_d = torch.cat([top_d.float(), cand_d], dim=1)
    merged_i = torch.cat([top_i.to(torch.int32), cand_i], dim=1)
    vals, pos = topk_smallest(merged_d, kk)
    return vals, torch.gather(merged_i, 1, pos)


def bucket_extent(bucket_ids: Tensor) -> Tensor:
    """(NB,) i32: one past each bucket's last member with id >= 0, 0 for an
    empty bucket.  Rows at or past it are padding, whatever holes lie below
    it."""
    nb, cap = bucket_ids.shape
    pos = torch.arange(1, cap + 1, dtype=torch.int32, device=bucket_ids.device)
    ext = torch.where(bucket_ids >= 0, pos, 0)
    return ext.amax(dim=1) if cap else ext.new_zeros((nb,))


def bucket_scan_phase_ref(
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
    """One bounded best-first scan phase: the JAX package's ``while_loop``
    over ``bucket_scan_topk_ref`` steps, in lockstep over the queries.

    order/lb_sorted (Q, S * beam) give each query's visit order and its
    ascending lower bounds; bucket_count (NB,) the live members per bucket;
    top_d/top_i (Q, kk) the carry the phase starts from.  Step t makes slot
    ``t * beam + b`` active where its bound is <= the query's k-th best
    distance at the step's start (+inf until kk are found); the loop runs
    while any query has an active slot.  Returns (top_d, top_i, and per
    query i32: visits, ndist, npad of this phase, and qsteps, the steps in
    which the query had an active slot).  A query's active steps form a
    prefix of the phase, so ``qsteps.max()`` is the loop's trip count.

    ``qmask`` (Q,) bool, if given, masks whole queries out: a False query
    has no active slot in any step (not even the +inf-bound ones an unfilled
    carry makes active), so it keeps its carry and its counters stay zero,
    as the JAX package's ``_scan_phase(qmask=)``.

    ``extent`` (NB,), if given, is one past each bucket's last live row
    (``bucket_extent``, held to [0, C]): members at or past it count as
    padding.  ``staged`` (Q,) int32, if given, has each query's staged rows
    added to it in place: the extents of its active slots whose bucket lies
    in [0, NB), the rows the kernel copies (``npad`` counts C for each).
    """
    qn = q.shape[0]
    nb, cap = bucket_ids.shape
    if extent is not None:
        extent = extent.to(torch.int32).clamp(0, cap)
        cols = torch.arange(cap, device=bucket_ids.device)
        bucket_ids = torch.where(cols[None, :] < extent[:, None], bucket_ids, -1)
    elif staged is not None:
        extent = bucket_extent(bucket_ids)
    zeros = torch.zeros((qn,), dtype=torch.int32, device=q.device)
    visits, ndist, qsteps = zeros, zeros, zeros
    n_steps = order.shape[1] // beam
    for t in range(n_steps):
        lo = t * beam
        kth = torch.sqrt(top_d[:, -1])  # inf until kk found
        act = lb_sorted[:, lo : lo + beam] <= kth[:, None]  # (Q, beam)
        if qmask is not None:
            act = act & qmask[:, None]
        if not bool(act.any()):
            break
        bsel = order[:, lo : lo + beam]
        top_d, top_i = bucket_scan_topk_ref(
            q, bucket_x, bucket_ids, bsel, act, top_d, top_i, scale
        )
        visits = visits + torch.sum(act, dim=1, dtype=torch.int32)
        n_members = torch.where(act, bucket_count[bsel.long()], 0)
        ndist = ndist + torch.sum(n_members, dim=1, dtype=torch.int32)
        qsteps = qsteps + act.any(dim=1).to(torch.int32)
        if staged is not None:
            inr = (bsel >= 0) & (bsel < nb)
            rows = torch.where(act & inr, extent[bsel.long().clamp(0, max(nb - 1, 0))], 0)
            staged += torch.sum(rows, dim=1, dtype=torch.int32)
    return top_d, top_i, visits, ndist, visits * cap, qsteps


# --- DBSCAN eps-graph reductions (the plain versions of K3-K5) --------------
# Each reduces a row of the same expansion ``pairwise_sq_l2_ref`` gives; the
# sentinel label is N = len(x), as in the JAX package.


def eps_count_ref(q: Tensor, x: Tensor, eps_sq) -> Tensor:
    """(Q,) i32 eps-neighbour counts, ``d2 <= eps_sq``: DBSCAN's core test."""
    d2 = pairwise_sq_l2_ref(q, x)
    return torch.sum(d2 <= eps_sq, dim=1).to(torch.int32)


def eps_min_label_ref(q: Tensor, x: Tensor, labels: Tensor, core: Tensor, eps_sq) -> Tensor:
    """(Q,) i32 min label over the core eps-neighbours; N (sentinel) if none."""
    d2 = pairwise_sq_l2_ref(q, x)
    adj = (d2 <= eps_sq) & (core != 0)[None, :]
    sentinel = torch.tensor(x.shape[0], dtype=torch.int32, device=d2.device)
    cand = torch.where(adj, labels[None, :].to(torch.int32), sentinel)
    return torch.min(cand, dim=1).values


def eps_nearest_core_ref(
    q: Tensor, x: Tensor, labels: Tensor, core: Tensor
) -> tuple[Tensor, Tensor]:
    """Per query: (d2 to the nearest core point, its label), the first index
    winning ties (``argmin``'s order); (+inf, N) when there is no core point."""
    d2 = pairwise_sq_l2_ref(q, x)
    d2 = torch.where((core != 0)[None, :], d2, float("inf"))
    j = torch.argmin(d2, dim=1)
    dmin = torch.gather(d2, 1, j[:, None])[:, 0]
    sentinel = torch.tensor(x.shape[0], dtype=torch.int32, device=d2.device)
    lab = torch.where(torch.isinf(dmin), sentinel, labels.to(torch.int32)[j])
    return dmin, lab
