"""K1: fused bucket gather + squared L2 + running top-k merge on the card
(``csrc/bucket_scan.cu``).

Replaces ``repro/kernels/bucket_scan.py::bucket_scan_topk_pallas``.  The plain
version it is held against is ``ref.bucket_scan_topk_ref`` (imported below).
The TPU wrapper padded the datastore to 128-lane tiles once at upload
(``prepad_buckets``); the CUDA kernel masks the ragged bucket edge itself, so
the datastore is passed as it is.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bucket_scan_topk_ref  # noqa: F401  (plain version)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("bucket_scan")
    if lib.bucket_scan_topk_f32.argtypes is None:
        lib.bucket_scan_topk_f32.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.bucket_scan_topk_f32.restype = _I
        lib.bucket_scan_topk_i8.argtypes = [_P] * 10 + [_I] * 6 + [_P]
        lib.bucket_scan_topk_i8.restype = _I
        lib.bucket_scan_smem_bytes.argtypes = [_I, _I]
        lib.bucket_scan_smem_bytes.restype = ctypes.c_size_t
    return lib


_MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use


def bucket_scan_topk_cuda(
    q: Tensor,
    bucket_x: Tensor,
    bucket_ids: Tensor,
    bsel: Tensor,
    act: Tensor,
    top_d: Tensor,
    top_i: Tensor,
    scale: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """One fused scan step by the K1 kernel; returns the merged (top_d, top_i).

    Shapes as ``ref.bucket_scan_topk_ref``: q (Q, D); bucket_x (NB, C, D) f32,
    or int8 with ``scale`` (NB, C); bucket_ids (NB, C) i32 with -1 padding;
    bsel/act (Q, beam); top_d/top_i (Q, kk).  Every operand must lie on one
    CUDA device.  Small per-step operands are cast and made contiguous; the
    datastore-sized ones (bucket_x, bucket_ids, scale) must already have the
    kernel's dtype and layout, since a copy there would cost a whole
    datastore pass per step.
    """
    dev = q.device
    ops = [q, bucket_x, bucket_ids, bsel, act, top_d, top_i]
    if scale is not None:
        ops.append(scale)
    if not all(t.is_cuda and t.device == dev for t in ops):
        raise ValueError(
            "bucket_scan_topk_cuda needs every operand on one CUDA device, got "
            + ", ".join(str(t.device) for t in ops)
        )
    if bucket_x.ndim != 3 or q.ndim != 2 or q.shape[1] != bucket_x.shape[2]:
        raise ValueError(
            f"bucket_scan_topk_cuda takes q (Q, D) and bucket_x (NB, C, D), got "
            f"{tuple(q.shape)} and {tuple(bucket_x.shape)}"
        )
    nb, cap, dim = bucket_x.shape
    qn, kk = top_d.shape
    beam = bsel.shape[1] if bsel.ndim == 2 else -1
    if (
        bucket_ids.shape != (nb, cap) or q.shape[0] != qn or top_i.shape != (qn, kk)
        or bsel.shape != (qn, beam) or act.shape != (qn, beam)
    ):
        raise ValueError(
            "bucket_scan_topk_cuda shape mismatch: q "
            f"{tuple(q.shape)}, bucket_ids {tuple(bucket_ids.shape)}, bsel "
            f"{tuple(bsel.shape)}, act {tuple(act.shape)}, top_d "
            f"{tuple(top_d.shape)}, top_i {tuple(top_i.shape)}"
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

    q = q.to(torch.float32).contiguous()
    bsel = bsel.to(torch.int32).contiguous()
    act = act.to(torch.bool).contiguous()
    top_d = top_d.to(torch.float32).contiguous()
    top_i = top_i.to(torch.int32).contiguous()
    out_d = torch.empty_like(top_d)
    out_i = torch.empty_like(top_i)
    if qn == 0 or kk == 0:
        return out_d, out_i

    lib = _lib()
    smem = lib.bucket_scan_smem_bytes(dim, kk)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"bucket_scan_topk_cuda: k={kk} at D={dim} needs {smem} bytes of "
            f"shared memory, above the {_MAX_SMEM} a block may use"
        )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        common = (
            bucket_ids.data_ptr(), bsel.data_ptr(), act.data_ptr(),
            top_d.data_ptr(), top_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            qn, nb, cap, dim, beam, kk, stream,
        )
        if scale is None:
            err = lib.bucket_scan_topk_f32(q.data_ptr(), bucket_x.data_ptr(), *common)
        else:
            err = lib.bucket_scan_topk_i8(
                q.data_ptr(), bucket_x.data_ptr(), scale.data_ptr(), *common
            )
    _build.check(lib, err, "bucket_scan_topk")
    bucket_scan_topk_cuda.launches += 1
    return out_d, out_i


bucket_scan_topk_cuda.launches = 0  # kernel launches since the last reset
