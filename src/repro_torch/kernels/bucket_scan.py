"""K1: a whole forest-scan phase on the card (``csrc/bucket_scan.cu``): each
query walks its sorted bucket bounds, gathers, measures and merges into its
running top-k until its first inactive step, all in one launch.

Replaces ``repro/kernels/bucket_scan.py::bucket_scan_topk_pallas`` and the
``lax.while_loop`` the JAX package runs it in.  The plain version it is held
against is ``ref.bucket_scan_phase_ref`` (imported below), the lockstep loop
over ``ref.bucket_scan_topk_ref`` steps.  The TPU wrapper padded the
datastore to 128-lane tiles once at upload (``prepad_buckets``); the CUDA
kernel masks the ragged bucket edge itself, so the datastore is passed as it
is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bucket_extent
from repro_torch.kernels.ref import bucket_scan_phase_ref  # noqa: F401  (plain version)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("bucket_scan")
    if lib.bucket_scan_phase_f32.argtypes is None:
        lib.bucket_scan_phase_f32.argtypes = [_P] * 17 + [_I] * 7 + [_P]
        lib.bucket_scan_phase_f32.restype = _I
        lib.bucket_scan_phase_i8.argtypes = [_P] * 18 + [_I] * 7 + [_P]
        lib.bucket_scan_phase_i8.restype = _I
        lib.bucket_scan_smem_bytes.argtypes = [_I] * 5
        lib.bucket_scan_smem_bytes.restype = ctypes.c_size_t
        lib.bucket_scan_blocks_per_sm.argtypes = [_I] * 5
        lib.bucket_scan_blocks_per_sm.restype = _I
    return lib


_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use


def _extent(bucket_ids: Tensor) -> Tensor:
    """``ref.bucket_extent`` of a datastore's ids, derived once per ids
    tensor: it is kept on the tensor while the tensor is unchanged (its
    version counter), so a search over an uploaded forest launches nothing
    for it and no field set (the persisted arrays, ``DeviceForest``) gains
    a field."""
    memo = getattr(bucket_ids, "_bucket_extent", None)
    if memo is None or memo[0] != bucket_ids._version:
        memo = (bucket_ids._version, bucket_extent(bucket_ids))
        bucket_ids._bucket_extent = memo
    return memo[1]


def bucket_scan_phase_cuda(
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
    """One scan phase by the K1 kernel; returns (top_d, top_i, visits,
    ndist, npad, qsteps) as ``ref.bucket_scan_phase_ref`` does.

    q (Q, D); bucket_x (NB, C, D) f32, or int8 with ``scale`` (NB, C);
    bucket_ids (NB, C) i32 with -1 padding; bucket_count (NB,) live members
    per bucket; order/lb_sorted (Q, S * beam), lb ascending along each row;
    top_d/top_i (Q, kk) the carry.  Every operand must lie on one CUDA
    device.  The per-search operands are cast and made contiguous; the
    datastore-sized ones (bucket_x, bucket_ids, scale) must already have the
    kernel's dtype and layout, since a copy there would cost a datastore pass.
    ``qmask`` (Q,) bool, if given, masks queries out of the phase: a False
    query keeps its carry and has zero counters.  ``extent`` (NB,) is one
    past each bucket's last live row (``ref.bucket_extent``, derived from
    ``bucket_ids`` once per ids tensor when not given): the kernel stages
    and scores only rows below it.  ``staged`` (Q,) int32, if given, has each query's staged rows
    (the extents of its active in-range slots) added to it.
    """
    dev = q.device
    ops = [q, bucket_x, bucket_ids, bucket_count, order, lb_sorted, top_d, top_i]
    for t in (scale, qmask, extent, staged):
        if t is not None:
            ops.append(t)
    if not all(t.is_cuda and t.device == dev for t in ops):
        raise ValueError(
            "bucket_scan_phase_cuda needs every operand on one CUDA device, got "
            + ", ".join(str(t.device) for t in ops)
        )
    if bucket_x.ndim != 3 or q.ndim != 2 or q.shape[1] != bucket_x.shape[2]:
        raise ValueError(
            f"bucket_scan_phase_cuda takes q (Q, D) and bucket_x (NB, C, D), got "
            f"{tuple(q.shape)} and {tuple(bucket_x.shape)}"
        )
    nb, cap, dim = bucket_x.shape
    qn, kk = top_d.shape
    n_slots = order.shape[1] if order.ndim == 2 else -1
    if (
        bucket_ids.shape != (nb, cap) or bucket_count.shape != (nb,)
        or q.shape[0] != qn or top_i.shape != (qn, kk) or beam < 1
        or order.shape != (qn, n_slots) or lb_sorted.shape != (qn, n_slots)
        or n_slots % beam or (qmask is not None and qmask.shape != (qn,))
        or (extent is not None and extent.shape != (nb,))
        or (staged is not None and staged.shape != (qn,))
    ):
        raise ValueError(
            "bucket_scan_phase_cuda shape mismatch: q "
            f"{tuple(q.shape)}, bucket_ids {tuple(bucket_ids.shape)}, bucket_count "
            f"{tuple(bucket_count.shape)}, order {tuple(order.shape)}, lb_sorted "
            f"{tuple(lb_sorted.shape)}, beam {beam}, top_d {tuple(top_d.shape)}, "
            f"top_i {tuple(top_i.shape)}"
            + ("" if qmask is None else f", qmask {tuple(qmask.shape)}")
            + ("" if extent is None else f", extent {tuple(extent.shape)}")
            + ("" if staged is None else f", staged {tuple(staged.shape)}")
        )
    if bucket_ids.dtype != torch.int32 or not bucket_ids.is_contiguous():
        raise ValueError("bucket_ids must be contiguous int32")
    if not bucket_x.is_contiguous():
        raise ValueError("bucket_x must be contiguous")
    if scale is None:
        if bucket_x.dtype != torch.float32:
            raise ValueError(
                f"bucket_x must be float32 (or int8 with scale), got {bucket_x.dtype}"
            )
    else:
        if bucket_x.dtype != torch.int8:
            raise ValueError(f"scale given but bucket_x is {bucket_x.dtype}, not int8")
        if scale.shape != (nb, cap) or scale.dtype != torch.float32 or not scale.is_contiguous():
            raise ValueError("scale must be contiguous float32 (NB, C)")
    if staged is not None and (staged.dtype != torch.int32 or not staged.is_contiguous()):
        raise ValueError("staged must be contiguous int32: the kernel adds to it in place")

    q = q.to(torch.float32).contiguous()
    bucket_count = bucket_count.to(torch.int32).contiguous()
    extent = (_extent(bucket_ids) if extent is None else extent).to(torch.int32).contiguous()
    order = order.to(torch.int32).contiguous()
    lb_sorted = lb_sorted.to(torch.float32).contiguous()
    top_d = top_d.to(torch.float32).contiguous()
    top_i = top_i.to(torch.int32).contiguous()
    if qmask is not None:
        qmask = qmask.to(torch.bool).contiguous()  # one byte a query, 0 or 1
    out_d = torch.empty_like(top_d)
    out_i = torch.empty_like(top_i)
    counters = torch.empty((4, qn), dtype=torch.int32, device=dev)
    visits, ndist, npad, qsteps = counters.unbind(0)
    if qn == 0 or kk == 0 or nb == 0 or cap == 0:
        counters.zero_()
        return top_d.clone(), top_i.clone(), visits, ndist, npad, qsteps

    lib = _lib()
    smem = lib.bucket_scan_smem_bytes(cap, dim, 1 if scale is not None else 4, kk, beam)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"bucket_scan_phase_cuda: k={kk} at D={dim} needs {smem} bytes of "
            f"shared memory, above the {_MAX_SMEM} a block may use"
        )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        common = (
            bucket_ids.data_ptr(), bucket_count.data_ptr(), extent.data_ptr(),
            order.data_ptr(), lb_sorted.data_ptr(), top_d.data_ptr(), top_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), visits.data_ptr(), ndist.data_ptr(),
            npad.data_ptr(), qsteps.data_ptr(), None if staged is None else staged.data_ptr(),
            None if qmask is None else qmask.data_ptr(),
            qn, nb, cap, dim, beam, kk, n_slots, stream,
        )
        if scale is None:
            err = lib.bucket_scan_phase_f32(q.data_ptr(), bucket_x.data_ptr(), *common)
        else:
            err = lib.bucket_scan_phase_i8(
                q.data_ptr(), bucket_x.data_ptr(), scale.data_ptr(), *common
            )
    _build.check(lib, err, "bucket_scan_topk")
    bucket_scan_phase_cuda.launches += 1
    return out_d, out_i, visits, ndist, npad, qsteps


bucket_scan_phase_cuda.launches = 0  # kernel launches since the last reset


def blocks_per_sm(cap: int, dim: int, kk: int, beam: int, *, int8: bool = False) -> int:
    """Blocks of the K1 kernel that one SM of the current card holds at
    once at this shape (the runtime's occupancy calculator: registers and
    shared memory)."""
    got = _lib().bucket_scan_blocks_per_sm(cap, dim, 1 if int8 else 4, kk, beam)
    if got < 0:
        raise RuntimeError(f"bucket_scan_blocks_per_sm refused C={cap} D={dim} k={kk}")
    return got
