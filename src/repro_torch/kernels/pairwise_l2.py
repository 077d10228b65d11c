"""K2: tiled squared-L2 distance matrix on the card (``csrc/pairwise_l2.cu``),
and K7: the same against int8 rows with per-row scales
(``csrc/pairwise_int8.cu``).

K2 replaces ``repro/kernels/pairwise_l2.py::pairwise_sq_l2_pallas``, K7
``pairwise_sq_l2_int8_pallas``.  The plain versions they are held against
are ``ref.pairwise_sq_l2_ref`` and ``ref.pairwise_sq_l2_int8_ref``
(imported below); each source's header says what bounds the kernel and what
its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    pairwise_sq_l2_int8_ref,
    pairwise_sq_l2_ref,
)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("pairwise_l2")
    fn = lib.pairwise_sq_l2_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def pairwise_sq_l2_cuda(q: Tensor, x: Tensor) -> Tensor:
    """(Q, D) x (N, D) -> (Q, N) f32 squared L2 distances, by the K2 kernel.

    Both operands must lie on the same CUDA device; they are cast to f32 and
    made contiguous (the kernel reads row-major f32).  Launches on the current
    stream and does not synchronise.
    """
    if not (q.is_cuda and x.is_cuda) or q.device != x.device:
        raise ValueError(
            f"pairwise_sq_l2_cuda needs both operands on one CUDA device, got "
            f"{q.device} and {x.device}"
        )
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"pairwise_sq_l2_cuda takes (Q, D) and (N, D), got {tuple(q.shape)} "
            f"and {tuple(x.shape)}"
        )
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    nq, dim = q.shape
    nx = x.shape[0]
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if nq == 0 or nx == 0:
        return out
    if dim == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_sq_l2_f32(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nx, dim, stream
        )
    _build.check(lib, err, "pairwise_sq_l2")
    pairwise_sq_l2_cuda.launches += 1
    return out


pairwise_sq_l2_cuda.launches = 0  # kernel launches since the last reset


def _lib_int8() -> ctypes.CDLL:
    lib = _build.library("pairwise_int8")
    fn = lib.pairwise_sq_l2_int8
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def pairwise_sq_l2_int8_cuda(q: Tensor, x_q: Tensor, scale: Tensor) -> Tensor:
    """(Q, D) f32 queries against (N, D) int8 rows with (N,) f32 per-row
    scales -> (Q, N) f32 squared L2 distances, by the K7 kernel (a query-norm
    pre-pass and the distance pass, counted as one launch).

    All three must lie on one CUDA device; ``q`` and ``scale`` are cast to
    f32 and everything is made contiguous.  Launches on the current stream
    and does not synchronise.
    """
    if not (q.is_cuda and x_q.is_cuda and scale.is_cuda) or not (
        q.device == x_q.device == scale.device
    ):
        raise ValueError(
            f"pairwise_sq_l2_int8_cuda needs q, x_q and scale on one CUDA device, got "
            f"{q.device}, {x_q.device} and {scale.device}"
        )
    if q.ndim != 2 or x_q.ndim != 2 or q.shape[1] != x_q.shape[1]:
        raise ValueError(
            f"pairwise_sq_l2_int8_cuda takes q (Q, D) and x_q (N, D), got "
            f"{tuple(q.shape)} and {tuple(x_q.shape)}"
        )
    if x_q.dtype != torch.int8 or scale.shape != (x_q.shape[0],):
        raise ValueError(
            f"pairwise_sq_l2_int8_cuda takes int8 rows and (N,) scales, got "
            f"{x_q.dtype} rows and scales of shape {tuple(scale.shape)}"
        )
    q = q.to(torch.float32).contiguous()
    x_q = x_q.contiguous()
    scale = scale.to(torch.float32).contiguous()
    nq, dim = q.shape
    nx = x_q.shape[0]
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if nq == 0 or nx == 0:
        return out
    vec = int(dim % 16 == 0 and x_q.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    qnorm = torch.empty((nq,), dtype=torch.float32, device=q.device)
    lib = _lib_int8()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_sq_l2_int8(
            q.data_ptr(), x_q.data_ptr(), scale.data_ptr(), qnorm.data_ptr(), out.data_ptr(),
            nq, nx, dim, vec, stream,
        )
    _build.check(lib, err, "pairwise_sq_l2_int8")
    pairwise_sq_l2_int8_cuda.launches += 1
    return out


pairwise_sq_l2_int8_cuda.launches = 0
